"""Hooks of the benchmark's work count in the plain reference.

``RECORDER``, when the benchmark sets it, receives each call of the plain
attention and the plain field grid with its shapes (``record``), so that the
rooflines read the work of each kernel site from the reference and not from the
program. :func:`checkpoint` is ``torch.utils.checkpoint.checkpoint`` that marks
the backward's recompute of a checkpointed region (``in_recompute``), so that
neither the site record nor the FLOP count takes it: the count is of the work the
configuration requires, whatever memory trade a program makes.
"""

from __future__ import annotations

from contextlib import contextmanager
from typing import Any, Callable, Optional

import torch.utils.checkpoint as _ckpt

RECORDER: Optional[Callable[..., None]] = None
_RECOMPUTE_DEPTH = 0


def in_recompute() -> bool:
    return _RECOMPUTE_DEPTH > 0


def record(kind: str, **shape: Any) -> None:
    if RECORDER is not None and not in_recompute():
        RECORDER(kind, **shape)


@contextmanager
def recompute():
    """Marks a forward that a backward runs again."""
    global _RECOMPUTE_DEPTH
    _RECOMPUTE_DEPTH += 1
    try:
        yield
    finally:
        _RECOMPUTE_DEPTH -= 1


def checkpoint(fn, *args, **kwargs):
    calls = [0]

    def run(*a, **k):
        calls[0] += 1
        if calls[0] == 1:
            return fn(*a, **k)
        with recompute():
            return fn(*a, **k)

    return _ckpt.checkpoint(run, *args, **kwargs)
