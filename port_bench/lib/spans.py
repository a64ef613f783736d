"""What the readers of the program's own spans share (``triplaneturbo_torch/utils/
profiling.py``: one record a span, with its request, its host times on
``time.time_ns()`` and its counts, kept while the profiler of a traced run is on).

The traced window's requests are the last ``ctx["calls"]`` that the program kept: the
trace's warm-up calls come before them, and nothing is kept once the profiler stops.
A reader returns None where the program keeps no spans (a program without the tracer)
or the window's are not all there."""

from __future__ import annotations

from typing import Any, Dict, List, Optional

from .work import attention_bound_s, field_grid_bound_s


def window_spans(ctx: Dict[str, Any]) -> Optional[List[Any]]:
    """The span records of the window's requests, or None."""
    try:
        from triplaneturbo_torch.utils import profiling
    except ImportError:
        return None
    kept = getattr(profiling, "spans", None)
    if kept is None:
        return None
    records = kept()
    requests = sorted({r.request for r in records})[-ctx["calls"]:]
    if len(requests) != ctx["calls"]:
        return None
    window = set(requests)
    return [r for r in records if r.request in window]


def host_ms(ctx: Dict[str, Any], name: str) -> Optional[float]:
    """Host ms a prompt (or a step) inside the spans named ``name``: Σ (end − start)."""
    records = window_spans(ctx)
    ns = [r.end_ns - r.start_ns for r in records or () if r.name == name]
    if not ns:
        return None
    return sum(ns) * 1e-6 / (ctx["calls"] * ctx["units_per_call"])


def counted(ctx: Dict[str, Any], key: str) -> Optional[float]:
    """Σ of the count ``key`` over the window's spans, a prompt (or a step); None where
    the program did not count it."""
    records = window_spans(ctx)
    values = [r.counts[key] for r in records or () if key in r.counts]
    if not values:
        return None
    return sum(values) / (ctx["calls"] * ctx["units_per_call"])


def op_roofline(ctx: Dict[str, Any], kind: str, op: str) -> Optional[float]:
    """Σ least time of the reference's ``kind`` sites over the device-busy time inside
    the program's span ``op`` in the window, in %: the op's roofline, whatever kernels
    (and copies) carry it."""
    t = ctx["trace"].busy_in([op])
    bound = {"attention": attention_bound_s, "field_grid": field_grid_bound_s}[kind]
    b = sum(bound(s) for s in ctx["work_sites"] if s["kind"] == kind) * ctx["calls"]
    if t <= 0 or b <= 0:
        return None
    return 100.0 * b / t
