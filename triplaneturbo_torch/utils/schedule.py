"""Time-varying scalar schedule DSL ("C()").

The port's own copy of ``triplaneturbo_tpu/utils/schedule.py`` (pure Python;
the port imports nothing of the JAX package). The trainer evaluates its
gradient shrinks, teacher timestep percents, guidance scales and loss lambdas
through :func:`C` (``configs/triplaneturbo_v1.yaml``).

Spec accepted by :func:`C`:
  - scalar -> constant;
  - ``[start_val, end_val, end_step]`` -> ``[0, start_val, end_val, end_step]``;
  - ``[start_step, start_val, end_val, end_step]`` -> interpolate between
    (start_step, start_val) and (end_step, end_val), clamped outside;
  - 6+ elements -> piecewise milestones, pairs of (val, step) appended;
  - ``end_step: int`` interpolates in global-step, ``float`` in epoch;
  - interpolation 'linear' or 'exp'.

Also provides :func:`C_max` (the largest value a schedule takes, for capacity
planning).
"""

from __future__ import annotations

import math
from typing import Any, List, Union

Scalar = Union[int, float]


def C(value: Any, epoch: int = 0, global_step: int = 0, interpolation: str = "linear") -> float:
    if isinstance(value, (int, float)):
        return float(value)
    value = list(value)
    if len(value) == 3:
        value = [0] + value
    if len(value) >= 6:
        # milestone form: [s0, v0, v1, e1, v2, e2, ...]
        select_i = 3
        for i in range(3, len(value) - 2, 2):
            if global_step >= value[i]:
                select_i = i + 2
        if select_i != 3:
            start_value, start_step = value[select_i - 3], value[select_i - 2]
        else:
            start_step, start_value = value[:2]
        end_value, end_step = value[select_i - 1], value[select_i]
        value = [start_step, start_value, end_value, end_step]
    if len(value) != 4:
        raise ValueError(f"Schedule spec must have 3, 4 or >=6 entries, got {value}")
    start_step, start_value, end_value, end_step = value
    current = global_step if isinstance(end_step, int) else epoch
    t = max(min(1.0, (current - start_step) / (end_step - start_step)), 0.0)
    if interpolation == "linear":
        return start_value + (end_value - start_value) * t
    if interpolation == "exp":
        return math.exp(math.log(start_value) * (1 - t) + math.log(end_value) * t)
    raise ValueError(f"Unknown interpolation: {interpolation}")


def schedule_is_zero(value: Any) -> bool:
    """True iff the schedule is identically zero over its lifetime.

    Used to drop loss terms whose lambda can never be nonzero: a 0-lambda term
    still contributes its backward graph, and a 0 cotangent times a NaN/inf
    partial poisons every upstream gradient."""
    if isinstance(value, (int, float)):
        return value == 0
    value = list(value)
    if len(value) == 3:
        value = [0] + value
    vals: List[float] = [value[1], value[2]]
    for i in range(4, len(value), 2):
        vals.append(value[i])
    return all(v == 0 for v in vals)


def C_max(value: Any) -> float:
    """Maximum value a schedule can take over its lifetime."""
    if isinstance(value, (int, float)):
        return float(value)
    value = list(value)
    if len(value) == 3:
        value = [0] + value
    # values sit at odd/even positions depending on form; collect all numerics
    # that act as values: [s, v, v, e, (v, e)*]
    vals: List[float] = [value[1], value[2]]
    for i in range(4, len(value), 2):
        vals.append(value[i])
    return float(max(vals))
