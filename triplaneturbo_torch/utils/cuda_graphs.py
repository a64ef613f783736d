"""Piecewise CUDA graphs: one call of a callable captured as a chain of graphs, split at
each attention op, which runs eagerly between them.

A replay launches a piece's kernels with one host call, where an eager call pays the
host's Python and dispatch for each of them. The attention op stays out of the graphs
(vLLM's "piecewise" graphs): between two pieces ``ops/flash_attention.attention`` runs
as it always does, inside its own ``flash_attention`` span, so the host still sees each
call, the benchmark still places it on the device timeline, and the hand-written kernels
are launched as they are.

How a capture runs (:meth:`PiecewiseGraph.capture`): on a side stream, one eager call
(lazy workspaces, convolution plans and kernel builds happen there, not in a graph),
then a second call with the capture on. At each attention op :func:`split` ends the
piece being captured, runs the op eagerly on the inputs that piece leaves, copies its
result into a buffer kept for replays, and begins the next piece; the pieces read that
buffer where the op's result was. Every piece allocates from one memory pool, so the
pieces must replay in the order they were captured, and whole, which
:meth:`PiecewiseGraph.replay` does. A replay rewrites the output and every tensor the
pieces made: a caller copies out, or computes from the output, before the next replay.

The graphs read their static inputs (:attr:`PiecewiseGraph.inputs`) and the modules'
parameters where they lie: a parameter written in place (``copy_``, ``load_state_dict``) is
seen by the next replay, one replaced by another tensor is not.
"""

from __future__ import annotations

from typing import Any, Callable, List, Optional

import torch
from torch.utils._python_dispatch import _get_current_dispatch_mode

# the graph being captured, while one is: the attention op reads it on each call
active: Optional["PiecewiseGraph"] = None


def can_capture(x: torch.Tensor) -> bool:
    """Whether a call on ``x`` may be captured and replayed: ``x`` on the current CUDA
    device (the graphs are captured on it), no gradient recorded, the stream not captured
    already, and no dispatch mode active (a FLOP count would not see a replay's
    operators)."""
    return (x.is_cuda and x.get_device() == torch.cuda.current_device()
            and not torch.is_grad_enabled()
            and not torch.cuda.is_current_stream_capturing()
            and _get_current_dispatch_mode() is None)


class _Split:
    """One op run eagerly between two pieces: its inputs (written by the piece before)
    and the buffer its result is copied into (read by the piece after)."""

    __slots__ = ("op", "args", "out")

    def __init__(self, op: Callable[..., torch.Tensor], args, out: torch.Tensor):
        self.op, self.args, self.out = op, args, out

    def replay(self) -> None:
        self.out.copy_(self.op(*self.args))


class PiecewiseGraph:
    """``fn(*self.inputs)`` captured once (by :meth:`capture` or the first :meth:`replay`),
    then replayed on the current stream, with nothing synchronised. :attr:`inputs` are
    contiguous static buffers like ``inputs``, which a caller writes before a replay."""

    def __init__(self, fn: Callable[..., Any], *inputs: torch.Tensor):
        self.fn = fn
        self.inputs = tuple(torch.empty_like(x, memory_format=torch.contiguous_format)
                            for x in inputs)
        self.pool = torch.cuda.graph_pool_handle()
        self.steps: List[Any] = []  # the pieces (CUDA graphs) and the splits, in order
        self.output: Any = None
        self._piece: Optional[torch.cuda.CUDAGraph] = None
        self._caller: Optional[torch.cuda.Stream] = None

    @property
    def n_pieces(self) -> int:
        return sum(isinstance(s, torch.cuda.CUDAGraph) for s in self.steps)

    @property
    def n_splits(self) -> int:
        return sum(isinstance(s, _Split) for s in self.steps)

    def _begin(self) -> None:
        self._piece = torch.cuda.CUDAGraph()
        self._piece.capture_begin(pool=self.pool)

    def _end(self) -> None:
        piece, self._piece = self._piece, None
        piece.capture_end()
        self.steps.append(piece)

    def split(self, op: Callable[..., torch.Tensor], *args: torch.Tensor) -> torch.Tensor:
        """``op(*args)`` at a break between two pieces (the attention op calls this while
        the graph is :data:`active`): its result, in a contiguous buffer the next piece
        reads."""
        self._end()
        result = op(*args)
        out = torch.empty(result.shape, dtype=result.dtype, device=result.device)
        out.copy_(result)
        out.record_stream(self._caller)  # the replays write it on the caller's stream
        self.steps.append(_Split(op, args, out))
        self._begin()
        return out

    def capture(self) -> None:
        """Warm up and capture ``fn``. Nothing of the capture is computed: a
        :meth:`replay` computes the output."""
        global active
        if self.steps or active is not None:
            raise RuntimeError("a piecewise graph is captured once, one at a time")
        caller = self._caller = torch.cuda.current_stream()
        side = torch.cuda.Stream()
        side.wait_stream(caller)
        with torch.cuda.stream(side):
            self.fn(*self.inputs)
            torch.cuda.synchronize()  # the warm-up done, as torch.cuda.graph does
            active = self
            try:
                self._begin()
                self.output = self.fn(*self.inputs)
                self._end()
            except BaseException:
                if self._piece is not None:  # leave the stream out of capture mode
                    try:
                        self._piece.capture_end()
                    except RuntimeError:
                        pass
                self.steps, self.output, self._piece = [], None, None
                raise
            finally:
                active = None
        caller.wait_stream(side)

    def replay(self) -> Any:
        """Every piece and split in order (capturing first, at the first call); returns
        the output buffer(s)."""
        if not self.steps:
            self.capture()
        for step in self.steps:
            step.replay()
        return self.output
