"""Profiling hooks: per-phase timing and ``torch.profiler`` traces.

Counterpart of ``triplaneturbo_tpu/utils/profiling.py``. :func:`phase_timer`
adds a phase's host time, and where CUDA is in use the device time between two
``torch.cuda.Event`` s, to per-name totals that :func:`phase_report` returns;
:func:`maybe_trace` traces steps ``[start, start + num)`` with ``torch.profiler``
into ``$TTT_PROFILE_DIR`` (a Chrome trace a step) when that variable is set.
"""

from __future__ import annotations

import contextlib
import os
import time
from collections import defaultdict
from typing import Dict, List, Tuple

import torch

_PHASE_TOTALS: Dict[str, float] = defaultdict(float)
_PHASE_COUNTS: Dict[str, int] = defaultdict(int)
_PHASE_EVENTS: Dict[str, List[Tuple[torch.cuda.Event, torch.cuda.Event]]] = defaultdict(list)


def _cuda_in_use() -> bool:
    return torch.cuda.is_available() and torch.cuda.is_initialized()


@contextlib.contextmanager
def phase_timer(name: str):
    events = None
    if _cuda_in_use():
        events = (torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True))
        events[0].record()
    t0 = time.perf_counter()
    try:
        yield
    finally:
        _PHASE_TOTALS[name] += time.perf_counter() - t0
        _PHASE_COUNTS[name] += 1
        if events is not None:
            events[1].record()
            _PHASE_EVENTS[name].append(events)


def phase_report() -> Dict[str, Dict[str, float]]:
    """Per phase: total host seconds, count, mean host ms and, where CUDA events
    were recorded, the mean device ms between them (this synchronises)."""
    out = {}
    for k, v in _PHASE_TOTALS.items():
        n = max(_PHASE_COUNTS[k], 1)
        out[k] = {"total_s": round(v, 3), "count": _PHASE_COUNTS[k],
                  "mean_ms": round(1000 * v / n, 2)}
        if _PHASE_EVENTS[k]:
            torch.cuda.synchronize()
            out[k]["device_mean_ms"] = round(
                sum(a.elapsed_time(b) for a, b in _PHASE_EVENTS[k]) / len(_PHASE_EVENTS[k]), 3)
    return out


@contextlib.contextmanager
def maybe_trace(step: int, start: int = 5, num: int = 3):
    """Trace steps [start, start + num) when ``TTT_PROFILE_DIR`` is set."""
    d = os.environ.get("TTT_PROFILE_DIR")
    if not (d and start <= step < start + num):
        yield
        return
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities) as prof:
        yield
    os.makedirs(d, exist_ok=True)
    prof.export_chrome_trace(os.path.join(d, f"step_{step:06d}.json"))
