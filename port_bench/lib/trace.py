"""The reduction of a device trace to what the per-layer metrics read.

A traced run profiles whole calls (prompts or steps) of the window with
``torch.profiler`` recording device activity only, which adds little host time. The
program's ``record_function`` ranges and the window's two ends are placed on the device
timeline by marks: while the trace is on, the ``record_function`` the program's modules
use is replaced by one that launches a marker kernel (``torch.cuda._sleep``, one cycle)
at each end of a range, in the order the host logs them. From the kernels, copies and
sets between the window's marks: ``busy_s`` (their union), ``window_s`` (between the
marks), each range's device-busy time (the union of activity inside its instances),
each kernel name's time, and the idle gaps, each labelled with the innermost range open
on the device when it began.
"""

from __future__ import annotations

import re
import sys
import time
from collections import defaultdict
from dataclasses import dataclass, field
from typing import Dict, Iterable, List, Optional, Tuple

import torch

MARK_KERNEL = "spin_kernel"
OUTSIDE = "outside the program's ranges"
_DEVICE_ACTIVITY = ("kernel", "gpu_memcpy", "gpu_memset")


@dataclass
class TraceSummary:
    window_s: float
    busy_s: float
    range_busy_s: Dict[str, float] = field(default_factory=dict)
    kernel_s: Dict[str, float] = field(default_factory=dict)
    idle_by_range: Dict[str, float] = field(default_factory=dict)

    def busy_in(self, names: Iterable[str]) -> float:
        return sum(self.range_busy_s.get(n, 0.0) for n in names)

    def kernels_matching(self, symbols: Iterable[str]) -> float:
        """Device seconds of the kernels whose :func:`kernel_symbol` is one of
        ``symbols``: whole names, so that a library's kernel of a like name is not
        counted."""
        names = set(symbols)
        return sum(s for k, s in self.kernel_s.items() if kernel_symbol(k) in names)

    def breakdown(self) -> Dict[str, List[List]]:
        ops = sorted(self.kernel_s.items(), key=lambda kv: -kv[1])[:10]
        gaps = sorted(self.idle_by_range.items(), key=lambda kv: -kv[1])[:10]
        return {"device_ops": [[k[:120], v] for k, v in ops],
                "idle_gaps": [[k[:120], v] for k, v in gaps]}


def kernel_symbol(name: str) -> str:
    """A kernel's function name as the trace gives it, without its return type, its
    template and call arguments and an anonymous namespace: ``void (anonymous
    namespace)::flash_fwd_kernel_wgmma_d64<2, 64, 1>(...)`` is
    ``flash_fwd_kernel_wgmma_d64``; ``void pytorch_flash::flash_fwd_kernel<...>(...)``
    is ``pytorch_flash::flash_fwd_kernel``."""
    s = name[5:] if name.startswith("void ") else name
    s = s.replace("(anonymous namespace)::", "")
    return re.split(r"[<(]", s, maxsplit=1)[0].strip()


def _union(intervals) -> List[Tuple[float, float]]:
    out: List[Tuple[float, float]] = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            if b > out[-1][1]:
                out[-1] = (out[-1][0], b)
        else:
            out.append((a, b))
    return out


def _length(intervals) -> float:
    return sum(b - a for a, b in intervals)


def _intersect(xs, ys) -> float:
    """Length of the intersection of two sorted, disjoint interval lists."""
    i = j = 0
    total = 0.0
    while i < len(xs) and j < len(ys):
        a, b = max(xs[i][0], ys[j][0]), min(xs[i][1], ys[j][1])
        if b > a:
            total += b - a
        if xs[i][1] < ys[j][1]:
            i += 1
        else:
            j += 1
    return total


def summarize(device: List[Tuple[str, float, float]], marks: List[Tuple[str, str]]
              ) -> TraceSummary:
    """``device``: (name, start, end) in seconds of every kernel, copy and set;
    ``marks``: the host's log of (label, "enter" / "exit"), the window's as
    ("window", ...), one a marker kernel, in launch order."""
    device = sorted(device, key=lambda e: e[1])
    sentinels = [e for e in device if MARK_KERNEL in e[0]]
    work = [e for e in device if MARK_KERNEL not in e[0]]
    if len(sentinels) != len(marks):
        raise RuntimeError(f"{len(sentinels)} marker kernels for {len(marks)} marks")
    open_: Dict[str, List[float]] = defaultdict(list)
    spans: Dict[str, List[Tuple[float, float]]] = defaultdict(list)
    all_spans: List[Tuple[float, float, str]] = []
    w0 = w1 = None
    for (label, kind), (_, s, e) in zip(marks, sentinels):
        if label == "window":
            if kind == "enter":
                w0 = e
            else:
                w1 = s
        elif kind == "enter":
            open_[label].append(e)
        else:
            a = open_[label].pop()
            spans[label].append((a, s))
            all_spans.append((a, s, label))
    if w0 is None or w1 is None:
        raise RuntimeError("the trace has no window marks")
    clipped = [(n, max(s, w0), min(e, w1)) for n, s, e in work if s < w1 and e > w0]
    busy = _union((s, e) for _, s, e in clipped)
    kernel_s: Dict[str, float] = defaultdict(float)
    for n, s, e in clipped:
        kernel_s[n] += e - s
    all_spans.sort()
    idle: Dict[str, float] = defaultdict(float)
    prev = w0
    for a, b in busy + [(w1, w1)]:
        if a > prev:
            inner = [lab for s, e, lab in all_spans if s <= prev < e]
            idle[inner[-1] if inner else OUTSIDE] += a - prev
        prev = max(prev, b)
    return TraceSummary(window_s=w1 - w0, busy_s=_length(busy),
                        range_busy_s={k: _intersect(busy, _union(v)) for k, v in spans.items()},
                        kernel_s=dict(kernel_s), idle_by_range=dict(idle))


class _Marks:
    """The host's log of marks, each with its marker kernel on the device."""

    def __init__(self, device: torch.device):
        self.device = device
        self.log: List[Tuple[str, str]] = []
        self.host: List[float] = []

    def mark(self, label: str, kind: str) -> None:
        self.log.append((label, kind))
        self.host.append(time.perf_counter())
        if self.device.type == "cuda":
            torch.cuda._sleep(1)


class _MarkedRange:
    """Stands in for ``record_function`` while the trace is on."""

    marks: Optional[_Marks] = None

    def __init__(self, name: str, args: Optional[str] = None):
        self.name = name

    def __enter__(self):
        self.marks.mark(self.name, "enter")
        return self

    def __exit__(self, *exc):
        self.marks.mark(self.name, "exit")
        return False


class TracedWindow:
    """``start()`` (before the window), ``begin()`` and ``end()`` around the traced
    calls, ``stop()``, then ``summary()``."""

    def __init__(self, device: torch.device):
        from torch.profiler import ProfilerActivity, profile

        self.device = device
        self.marks = _Marks(device)
        acts = [ProfilerActivity.CUDA] if device.type == "cuda" else [ProfilerActivity.CPU]
        self.prof = profile(activities=acts)
        self._patched: List[Tuple[object, object]] = []

    def _patch(self) -> None:
        import torch.autograd.profiler as ap
        import torch.profiler as tp

        originals = {id(tp.record_function), id(ap.record_function)}
        _MarkedRange.marks = self.marks
        for name, mod in list(sys.modules.items()):
            if name.split(".")[0] == "triplaneturbo_torch" and mod is not None:
                rf = getattr(mod, "record_function", None)
                if rf is not None and id(rf) in originals:
                    self._patched.append((mod, rf))
                    mod.record_function = _MarkedRange

    def start(self) -> "TracedWindow":
        self._patch()
        self.prof.__enter__()
        return self

    def begin(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        self.marks.mark("window", "enter")

    def end(self) -> None:
        self.marks.mark("window", "exit")
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def stop(self) -> None:
        self.prof.__exit__(None, None, None)
        for mod, rf in self._patched:
            mod.record_function = rf
        self._patched.clear()
        _MarkedRange.marks = None

    def summary(self) -> TraceSummary:
        if self.device.type != "cuda":  # no device: the window's host time, nothing busy
            i0 = self.marks.log.index(("window", "enter"))
            i1 = self.marks.log.index(("window", "exit"))
            return TraceSummary(window_s=self.marks.host[i1] - self.marks.host[i0], busy_s=0.0)
        events = []
        cuda = torch.autograd.DeviceType.CUDA
        for e in self.prof.profiler.kineto_results.events():
            # on the device: kernels, copies and sets (the only CUDA-side activities
            # recorded when the host's are not); the activity's kind where torch says it
            if e.device_type() != cuda:
                continue
            kind = getattr(e, "activity_type", None)
            if kind is not None and kind() not in _DEVICE_ACTIVITY:
                continue
            s = e.start_ns() * 1e-9
            events.append((e.name(), s, s + e.duration_ns() * 1e-9))
        return summarize(events, self.marks.log)
