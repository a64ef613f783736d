"""The reader of `unet_graph_share.serve` over a synthetic span list: the share of the
window's UNet calls that replayed a CUDA graph, from the counts on the `ddim_step`
spans, and None where the program counts neither."""

import pytest

from port_bench.lib import cells, trace
from triplaneturbo_torch.utils import profiling
from triplaneturbo_torch.utils.profiling import Span

MS = 1_000_000  # ns


def _ctx(calls, units=1):
    return {"trace": trace.TraceSummary(window_s=1.0, busy_s=0.5),
            "calls": calls, "units_per_call": units, "work_sites": []}


def _reader():
    return cells.load_reader("unet_graph_share.serve")


def _denoise_counts(rid, graph, eager):
    """One pipeline call whose four `ddim_step` spans count the UNet's calls."""
    t = rid * 1000 * MS
    steps = [Span("ddim_step", rid + 2 + i, rid + 1, rid, t + i * MS, t + (i + 1) * MS,
                  {"unet_graph_calls": graph, "unet_eager_calls": eager}) for i in range(4)]
    return steps + [Span("denoise", rid + 1, rid, rid, t, t + 5 * MS),
                    Span("pipeline", rid, None, rid, t, t + 9 * MS, {"syncs": 4})]


@pytest.mark.parametrize("graph,eager,share", [(1, 0, 100.0), (0, 1, 0.0)])
def test_unet_graph_share(graph, eager, share, monkeypatch):
    # warm-up requests that ran eagerly, then the window's two: only the window counts
    recs = (_denoise_counts(10, 0, 1) + _denoise_counts(20, graph, eager)
            + _denoise_counts(30, graph, eager))
    monkeypatch.setattr(profiling, "spans", lambda: list(recs))
    assert _reader().read(_ctx(2)) == pytest.approx(share)
    assert _reader().read(_ctx(2, units=8)) == pytest.approx(share)


def test_unet_graph_share_without_the_counts_reads_none(monkeypatch):
    # a program that does not count the UNet's calls
    t = 10 * 1000 * MS
    recs = [Span("ddim_step", 12, 11, 10, t, t + MS, {"syncs": 1}),
            Span("denoise", 11, 10, 10, t, t + 5 * MS),
            Span("pipeline", 10, None, 10, t, t + 9 * MS, {"syncs": 4})]
    monkeypatch.setattr(profiling, "spans", lambda: list(recs))
    assert _reader().read(_ctx(1)) is None
    monkeypatch.setattr(profiling, "spans", lambda: [])
    assert _reader().read(_ctx(1)) is None
