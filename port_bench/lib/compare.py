"""The numbers the correctness check compares, and the verdict against their limits.

Each number is a gap between the program's output and the reference's. A cell's limits
live in ``limits/<workload>.json`` (``{"name": limit, ...}``, set in ``PERF.md`` from the
readings of sound runs and of the control); a number over its limit, or a number that
is not finite, makes the run not correct.
"""

from __future__ import annotations

import json
import math
import os
import sys
from typing import Dict, Optional

import torch


def rel_gap(prog: torch.Tensor, ref: torch.Tensor) -> float:
    """max |prog - ref| / max |ref|, in f64 on ``ref``'s device."""
    r = ref.detach().double()
    p = prog.detach().to(r.device).double()
    if p.shape != r.shape:
        return math.inf
    denom = r.abs().max().item()
    return (p - r).abs().max().item() / max(denom, 1e-30)


def abs_gap(prog: torch.Tensor, ref: torch.Tensor) -> float:
    r = ref.detach().double()
    p = prog.detach().to(r.device).double()
    if p.shape != r.shape:
        return math.inf
    return (p - r).abs().max().item() if r.numel() else 0.0


class Checks:
    """Worst readings by name, with their limits."""

    def __init__(self, limits: Dict[str, float]):
        self.limits = dict(limits)
        self.values: Dict[str, float] = {}

    def add(self, name: str, value: float) -> None:
        value = float(value)
        if not math.isfinite(value):
            value = math.inf
        self.values[name] = max(self.values.get(name, -math.inf), value)

    def correct(self) -> bool:
        """Every number that has a limit was read, and none is over it."""
        return all(k in self.values and self.values[k] <= lim for k, lim in self.limits.items())

    def table(self) -> Dict[str, Dict[str, Optional[float]]]:
        """The numbers compared (those with a limit), each beside its limit."""
        return {k: {"value": self.values.get(k), "limit": lim} for k, lim in self.limits.items()}

    def print_lines(self) -> None:
        for k, v in self.table().items():
            print(f"check {k} {v['value']!r} limit {v['limit']!r}", file=sys.stderr)


def load_limits(bench_dir: str, workload: str) -> Dict[str, float]:
    with open(os.path.join(bench_dir, "limits", f"{workload}.json")) as f:
        return {k: float(v) for k, v in json.load(f).items() if not k.startswith("_")}
