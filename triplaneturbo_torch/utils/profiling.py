"""The port's tracer: spans and counts on the host, and ``torch.profiler`` traces.

:func:`span` names a layer boundary, :func:`stage` one of the pipeline's and the
trainer's stages. Tracing is on while a ``torch.profiler`` is active (the benchmark's
traced window, :func:`maybe_trace`, an operator's own profile) and inside
``with recording():``; otherwise it is off.

* **Off**, a span does nothing beyond one check of that state, and a stage enters
  ``record_function`` as the stages always have (``utils/flops.py`` splits a count
  by those ranges).
* **On**, every span and stage enters ``record_function`` (this module's, looked up at
  each call, so whatever replaces it here sees every span) and keeps a :class:`Span`:
  its name, its id, its parent (the innermost span open), its request (the id of the
  outermost span open: one pipeline call or one train step), its start and end on
  ``time.time_ns()`` (the clock of the profiler's events, on the host and, converted,
  on the device) and the counts made inside it (:func:`count`). While a request is
  open on a process that uses CUDA, each blocking host-device synchronisation is
  counted (``"syncs"``) on the innermost span, through
  ``torch.cuda.set_sync_debug_mode("warn")``; both are set back when the request
  closes. :func:`spans` returns the kept records, oldest first; the oldest are dropped
  past ``MAX_SPANS`` (:func:`dropped` counts them); :func:`clear` empties both.
* No span or stage does anything while the current stream is captured into a CUDA
  graph: a replay would repeat its kernels without the host's marks.

Spans nest per process, not per thread: a checkpointed forward that autograd's thread
runs again opens its spans under the caller's, which waits for it.

:func:`maybe_trace` traces steps ``[start, start + num)`` with ``torch.profiler`` into
``$TTT_PROFILE_DIR`` (a Chrome trace a step) when that variable is set.
"""

from __future__ import annotations

import contextlib
import os
import time
import warnings
from collections import deque
from dataclasses import dataclass, field
from typing import Dict, List, Optional

import torch
import torch.autograd.profiler as _autograd_profiler
from torch.profiler import record_function

MAX_SPANS = 65536
SYNCS = "syncs"
_SYNC_WARNING = "called a synchronizing CUDA operation"


@dataclass(eq=False)
class Span:
    name: str
    id: int
    parent: Optional[int]
    request: int
    start_ns: int = 0
    end_ns: int = 0
    counts: Dict[str, int] = field(default_factory=dict)


class _Tracer:
    """The process's open spans, kept records and sync counting."""

    def __init__(self):
        self.kept: deque = deque(maxlen=MAX_SPANS)
        self.dropped = 0
        self.open: List[Span] = []
        self.next_id = 1
        self.recording = 0
        self._syncs = None  # (warnings context, previous sync debug mode) while counting

    def keep(self, rec: Span) -> None:
        if len(self.kept) == self.kept.maxlen:
            self.dropped += 1
        self.kept.append(rec)

    def count_syncs(self) -> bool:
        """Count synchronisations until :meth:`stop_syncs`; False without CUDA in use."""
        if not torch.cuda.is_initialized():
            return False
        catch = warnings.catch_warnings()
        catch.__enter__()
        warnings.filterwarnings("always", message=_SYNC_WARNING)
        shown = warnings.showwarning

        def showwarning(message, category, *args, **kwargs):
            if _SYNC_WARNING in str(message) and self.open:
                count(SYNCS)
            else:
                shown(message, category, *args, **kwargs)

        warnings.showwarning = showwarning
        self._syncs = (catch, torch.cuda.get_sync_debug_mode())
        torch.cuda.set_sync_debug_mode("warn")
        return True

    def stop_syncs(self) -> None:
        catch, mode = self._syncs
        self._syncs = None
        torch.cuda.set_sync_debug_mode(mode)
        catch.__exit__(None, None, None)


_TRACER = _Tracer()


def tracing() -> bool:
    """Whether spans record: inside :func:`recording` or while a profiler is active."""
    return bool(_TRACER.recording or _autograd_profiler._is_profiler_enabled
                or torch.autograd._profiler_enabled())


def _capturing() -> bool:
    return torch.cuda.is_initialized() and torch.cuda.is_current_stream_capturing()


class _Open:
    """A span while tracing is on."""

    __slots__ = ("name", "rec", "rf")

    def __init__(self, name: str):
        self.name = name

    def __enter__(self) -> Span:
        tr = _TRACER
        parent = tr.open[-1] if tr.open else None
        rid = tr.next_id
        tr.next_id += 1
        rec = Span(self.name, rid, parent.id if parent else None,
                   parent.request if parent else rid)
        if parent is None and tr.count_syncs():
            rec.counts[SYNCS] = 0  # the request's syncs are counted (0 is a count)
        tr.open.append(rec)
        self.rec = rec
        rec.start_ns = time.time_ns()
        self.rf = record_function(self.name)
        self.rf.__enter__()
        return rec

    def __exit__(self, *exc) -> bool:
        tr, rec = _TRACER, self.rec
        try:
            self.rf.__exit__(*exc)
        finally:
            rec.end_ns = time.time_ns()
            tr.open.remove(rec)
            tr.keep(rec)
            if not tr.open and tr._syncs is not None:
                tr.stop_syncs()
        return False


_OFF = contextlib.nullcontext()


def span(name: str):
    """A span: recorded while tracing is on, nothing otherwise. ``with span(...) as rec``
    gives the :class:`Span` (None when nothing is recorded)."""
    if not tracing() or _capturing():
        return _OFF
    return _Open(name)


def stage(name: str):
    """A stage's span: as :func:`span` while tracing is on, else ``record_function``."""
    if _capturing():
        return _OFF
    return _Open(name) if tracing() else record_function(name)


def count(name: str, n: int = 1) -> None:
    """Add ``n`` to ``name`` on the innermost open span (nothing when none is open)."""
    if _TRACER.open:
        c = _TRACER.open[-1].counts
        c[name] = c.get(name, 0) + n


@contextlib.contextmanager
def recording():
    """Tracing on inside the block, profiler or not."""
    _TRACER.recording += 1
    try:
        yield
    finally:
        _TRACER.recording -= 1


def spans() -> List[Span]:
    """The closed spans kept, oldest first (a span closes after its children)."""
    return list(_TRACER.kept)


def dropped() -> int:
    """Spans dropped, oldest first, past ``MAX_SPANS`` since the last :func:`clear`."""
    return _TRACER.dropped


def clear() -> None:
    _TRACER.kept.clear()
    _TRACER.dropped = 0


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
