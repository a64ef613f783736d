"""The readers of the program's own spans over a synthetic span list and trace summary:
the window's requests are the last `calls` that the program kept, a window without
spans (or a program without the tracer) reads None, and the op rooflines take the
device-busy time inside the op's span."""

import importlib

import pytest

from port_bench.lib import cells, spans, trace, work
from triplaneturbo_torch.utils import profiling
from triplaneturbo_torch.utils.profiling import Span

MS = 1_000_000  # ns
SITE_ATT = dict(kind="attention", BH=2, L=128, Lk=256, D=64, dtype="bfloat16", grad=False,
                needs=(False, False, False))
SITE_FG = dict(kind="field_grid", R=16, C=32, concat=False, grad=False,
               widths=[(32, 64), (64, 64), (64, 1), (32, 64), (64, 64), (64, 3)])


def _request(rid, denoise_ms, syncs_root, syncs_inner):
    """One pipeline call: a root, a `denoise` stage with one `ddim_step`, the syncs."""
    t = rid * 1000 * MS
    return [Span("ddim_step", rid + 2, rid + 1, rid, t + MS, t + 2 * MS,
                 {"syncs": syncs_inner}),
            Span("denoise", rid + 1, rid, rid, t, t + int(denoise_ms * MS)),
            Span("pipeline", rid, None, rid, t, t + 500 * MS, {"syncs": syncs_root})]


def _ctx(calls, units=1, summary=None, sites=()):
    return {"trace": summary or trace.TraceSummary(window_s=1.0, busy_s=0.5),
            "calls": calls, "units_per_call": units, "work_sites": list(sites)}


@pytest.fixture
def kept(monkeypatch):
    """Warm-up requests 10 and 20 (long denoise, many syncs), then the window's 30 and 40."""
    recs = (_request(10, 900, 50, 50) + _request(20, 900, 50, 50)
            + _request(30, 100, 1, 2) + _request(40, 300, 1, 4))
    monkeypatch.setattr(profiling, "spans", lambda: list(recs))
    return recs


def _reader(name):
    return cells.load_reader(name)


def test_the_window_is_the_last_calls_requests(kept):
    got = spans.window_spans(_ctx(2))
    assert {r.request for r in got} == {30, 40} and len(got) == 6
    assert spans.window_spans(_ctx(5)) is None  # fewer requests kept than calls


def test_denoise_host_ms(kept):
    assert _reader("denoise_host_ms.serve").read(_ctx(2)) == pytest.approx(200.0)
    # a prompt of 4 a call: the same sum over 8 prompts
    assert _reader("denoise_host_ms.serve").read(_ctx(2, units=4)) == pytest.approx(50.0)


def test_host_syncs(kept):
    assert _reader("host_syncs.serve").read(_ctx(2)) == pytest.approx((1 + 2 + 1 + 4) / 2)
    assert _reader("host_syncs.serve").read(_ctx(1)) == pytest.approx(5.0)


def test_syncs_not_counted_read_none(monkeypatch):
    recs = [Span("pipeline", 1, None, 1, 0, MS)]  # no CUDA in use: no `syncs` key
    monkeypatch.setattr(profiling, "spans", lambda: recs)
    assert _reader("host_syncs.serve").read(_ctx(1)) is None
    assert _reader("denoise_host_ms.serve").read(_ctx(1)) is None  # no `denoise` span


@pytest.mark.parametrize("name", ["denoise_host_ms.serve", "host_syncs.serve"])
def test_no_spans_read_none(name, monkeypatch):
    monkeypatch.setattr(profiling, "spans", lambda: [])
    assert _reader(name).read(_ctx(2)) is None
    monkeypatch.delattr(profiling, "spans")  # a program without the tracer
    assert _reader(name).read(_ctx(2)) is None


def test_a_program_without_the_tracer_reads_none(monkeypatch):
    import builtins

    real = builtins.__import__

    def no_program(name, *args, **kwargs):
        if name.startswith("triplaneturbo_torch"):
            raise ImportError(name)
        return real(name, *args, **kwargs)

    monkeypatch.setattr(builtins, "__import__", no_program)
    assert spans.window_spans(_ctx(1)) is None


def _summary():
    """A 10 ms window: a `flash_attention` span from 1 to 4 ms holding a copy (1-1.5 ms)
    and the kernel (1.5-3 ms); a `fused_field_grid` span from 5 to 9 ms holding `_prep`
    (5-6 ms) and the kernel (6-8 ms)."""
    m = trace.MARK_KERNEL
    dev = [(m, -0.0001, 0.0), (m, 0.0009, 0.001), (m, 0.004, 0.0041), (m, 0.0049, 0.005),
           (m, 0.009, 0.0091), (m, 0.010, 0.0101),
           ("copy", 0.001, 0.0015), ("flash_fwd_kernel_wgmma_d64", 0.0015, 0.003),
           ("prep", 0.005, 0.006), ("field_grid_kernel", 0.006, 0.008)]
    marks = [("window", "enter"), ("flash_attention", "enter"), ("flash_attention", "exit"),
             ("fused_field_grid", "enter"), ("fused_field_grid", "exit"), ("window", "exit")]
    return trace.summarize(dev, marks)


def test_op_rooflines_take_the_ops_span():
    s = _summary()
    ctx = _ctx(2, summary=s, sites=[SITE_ATT, SITE_FG])
    att = _reader("flash_op_roofline.serve").read(ctx)
    assert att == pytest.approx(100 * 2 * work.attention_bound_s(SITE_ATT) / 0.002)
    fg = _reader("field_grid_op_roofline.serve").read(ctx)
    assert fg == pytest.approx(100 * 2 * work.field_grid_bound_s(SITE_FG) / 0.003)
    # the op holds its kernel: never above the kernel's own roofline
    sym = importlib.import_module("port_bench.lib.readers")
    assert att < sym.roofline(ctx, "attention", sym.FLASH_KERNELS)
    assert fg < sym.roofline(ctx, "field_grid", sym.FIELD_GRID_KERNELS)


def test_op_rooflines_without_the_span_or_sites_read_none():
    s = trace.TraceSummary(window_s=1.0, busy_s=0.5)  # a parent's trace: no op spans
    assert _reader("flash_op_roofline.serve").read(_ctx(2, summary=s, sites=[SITE_ATT])) is None
    assert _reader("field_grid_op_roofline.serve").read(_ctx(2, summary=_summary())) is None
