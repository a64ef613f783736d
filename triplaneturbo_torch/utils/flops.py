"""FLOP counts of what the port executes: the counterpart of the JAX package's
``step_cost_flops`` and of ``bench.py``'s count (XLA's ``cost_analysis``).

:func:`count_flops` runs a callable under ``torch.utils.flop_counter.FlopCounterMode``,
which counts the matrix products of the aten operators (``mm``, ``bmm``, ``addmm``,
the convolutions and SDPA, forward and backward) by their shapes. The rule is that a
call counts what its plain PyTorch route executes, so that it counts the same on the
CPU and on the card:

* a hand-written kernel, launched through ctypes, is invisible to the counter, so its
  wrapper reports at each launch what its plain version counts at those shapes
  (:func:`report`), under the kernel's name;
* where the card route runs other products than the plain version (the field grid's
  ``_prep`` folds the first layer into the planes), the wrapper drops what the counter
  saw and reports the plain version's count once (:func:`counted_as`);
* a kernel's internal recompute does not count (the flash backward kernels form the
  scores again), but a recompute in PyTorch does (``torch.utils.checkpoint``, as XLA
  counts remat).

Unlike ``cost_analysis``, which counts the body of a ``while`` loop once (the JAX
pipeline's 4-step DDIM ``scan``), the count is of every step that runs. The
``record_function`` ranges of the pipeline's and the trainer's stages split it
(``FlopCount.by_range``).
"""

from __future__ import annotations

import threading
from collections import defaultdict
from contextlib import contextmanager
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional, Tuple

from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.flop_counter import FlopCounterMode


@dataclass
class FlopCount:
    """A call's FLOPs: ``total``; ``by_op``, the aten operators' and the kernels' (under
    their names); ``by_kernel``, what each hand-written kernel reported (0 on the CPU
    route, where the plain versions count as aten operators); ``by_range``, by the
    innermost ``record_function`` range open at the operator ("" outside any)."""

    total: int = 0
    by_op: Dict[str, int] = field(default_factory=dict)
    by_kernel: Dict[str, int] = field(default_factory=dict)
    by_range: Dict[str, int] = field(default_factory=dict)

    def kernel_share(self) -> float:
        """The share of the total that the hand-written kernels reported."""
        return sum(self.by_kernel.values()) / self.total if self.total else 0.0


class _Counter:
    """One :func:`count_flops` call: its FlopCounterMode, the kernels' reports and the
    attribution to ranges."""

    def __init__(self, mode: FlopCounterMode):
        self.mode = mode
        self.kernels: Dict[str, int] = defaultdict(int)
        self.ranges: Dict[str, int] = defaultdict(int)
        self.stack: List[str] = []
        self.seen = 0  # the total at the last range boundary

    def total(self) -> int:
        return self.mode.get_total_flops() + sum(self.kernels.values())

    def boundary(self) -> None:
        """Attribute what was counted since the last boundary to the open range."""
        now = self.total()
        self.ranges[self.stack[-1] if self.stack else ""] += now - self.seen
        self.seen = now


# the counters of the count_flops calls in progress (a kernel's backward reports from
# autograd's thread, so this is not thread-local)
_ACTIVE: List[_Counter] = []
_LOCK = threading.RLock()


def report(kernel: str, flops: int) -> None:
    """Add ``flops`` under ``kernel`` to every count in progress: a wrapper calls this
    where it launches its kernel, with what its plain version counts."""
    if not _ACTIVE:
        return
    with _LOCK:
        for c in _ACTIVE:
            c.kernels[kernel] += int(flops)


@contextmanager
def counted_as(kernel: Optional[str], flops: int = 0):
    """Count the block as ``flops`` under ``kernel``: what the FlopCounterMode of every
    count in progress saw inside it is dropped, and ``flops`` is reported once (nothing
    when ``kernel`` is None: a recompute that the plain route does not run)."""
    if not _ACTIVE:
        yield
        return
    with _LOCK:
        saved = [(c, {k: dict(v) for k, v in c.mode.flop_counts.items()}) for c in _ACTIVE]
    yield
    with _LOCK:
        for c, counts in saved:
            c.mode.flop_counts.clear()
            for k, v in counts.items():
                c.mode.flop_counts[k] = defaultdict(int, v)
    if kernel is not None:
        report(kernel, flops)


class _Ranges(TorchDispatchMode):
    """Sees the ``record_function`` ranges open and close (they are profiler operators)
    and marks a boundary of the counter at each."""

    def __init__(self, counter: _Counter):
        super().__init__()
        self.counter = counter

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        name = str(getattr(func, "__name__", ""))
        if name.startswith("_record_function_enter"):
            with _LOCK:
                self.counter.boundary()
                self.counter.stack.append(str(args[0]))
        elif name.startswith("_record_function_exit"):
            with _LOCK:
                self.counter.boundary()
                if self.counter.stack:
                    self.counter.stack.pop()
        return out


class _GlobalOnly:
    """In place of FlopCounterMode's module tracker, whose backward hooks refuse a
    ``torch.autograd.grad`` over leaf tensors (the staged trainer's programs): every
    count goes to "Global" alone, the only entry read here."""

    parents = frozenset({"Global"})

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


def count_flops(fn: Callable, *args, **kwargs) -> Tuple[Any, FlopCount]:
    """``fn(*args, **kwargs)`` and its :class:`FlopCount`. Counts nest: a count inside
    another adds to both."""
    mode = FlopCounterMode(display=False)
    mode.mod_tracker = _GlobalOnly()
    counter = _Counter(mode)
    with mode, _Ranges(counter):
        with _LOCK:
            _ACTIVE.append(counter)
        try:
            result = fn(*args, **kwargs)
        finally:
            with _LOCK:
                counter.boundary()
                _ACTIVE.remove(counter)
    by_op = {str(k): int(v) for k, v in mode.get_flop_counts().get("Global", {}).items()}
    kernels = {k: int(v) for k, v in counter.kernels.items()}
    return result, FlopCount(total=counter.total(), by_op={**by_op, **kernels}, by_kernel=kernels,
                             by_range={k: int(v) for k, v in counter.ranges.items() if v})


def attention_flops(BH: int, L: int, Lk: int, D: int) -> int:
    """The two products of softmax(q kᵀ) v over ``[BH, L, D]`` queries and ``[BH, Lk,
    D]`` keys: 2·BH·L·Lk·D each."""
    return 2 * BH * L * Lk * D


def matmul_flops(M: int, K: int, N: int) -> int:
    """An [M, K] x [K, N] product: 2·M·K·N."""
    return 2 * M * K * N
