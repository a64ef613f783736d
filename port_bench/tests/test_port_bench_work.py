"""The rooflines', mfu's and the trace reduction's arithmetic against hand-computed values."""

import pytest

from port_bench.lib import readers, trace, work
from port_bench.lib.peaks import MFU_PEAK, PEAK_BYTES, PEAK_FLOPS


def test_attention_bound_forward_and_backward():
    site = dict(kind="attention", BH=2, L=128, Lk=256, D=64, dtype="bfloat16", grad=False,
                needs=(False, False, False))
    flops = 4 * 2 * 128 * 256 * 64
    nbytes = 2 * 2 * 64 * (2 * 128 + 2 * 256)
    assert work.attention_bound_s(site) == pytest.approx(max(flops / 989e12, nbytes / 3.35e12))
    site.update(grad=True, needs=(True, True, True))
    fwd = max(flops / 989e12, (nbytes + 4 * 2 * 128) / 3.35e12)
    bwd_flops = 8 * 2 * 128 * 256 * 64
    bwd_bytes = 2 * 2 * 64 * (3 * 128 + 2 * 256) + 8 * 2 * 128 + 2 * 2 * 64 * (128 + 2 * 256)
    assert work.attention_bound_s(site) == pytest.approx(
        fwd + max(bwd_flops / 989e12, bwd_bytes / 3.35e12))


def test_field_grid_bound_is_chip_smokes_k2_bound():
    R, C = 160, 32
    site = dict(kind="field_grid", R=R, C=C, concat=False, grad=False,
                widths=[(C, 64), (64, 64), (64, 1), (C, 64), (64, 64), (64, 3)])
    products = R ** 3 * 2 * 2 * 64 * 64
    rest = 3 * R * R * C * 128 * 2 + R ** 3 * (2 * 128 + 2 * 4 * 64)
    nbytes = (3 * R * R * C + 2 * C * 64 + 2 * 64 * 64 + 64 + 192 + 4 * R ** 3) * 4
    want = max(3 * products / PEAK_FLOPS["tfloat32"], rest / PEAK_FLOPS["float32"],
               nbytes / PEAK_BYTES)
    assert work.field_grid_bound_s(site) == pytest.approx(want)
    assert want * 1e3 == pytest.approx(0.4067, rel=1e-3)  # chip_smoke.py's K2 bound at R=160


def _device():
    """A 10 ms window between two marks; a `denoise` range from 1 to 4 ms and a
    `vae_decode` range from 4.5 to 9 ms; three kernels; marks are `spin_kernel`s."""
    m = trace.MARK_KERNEL
    dev = [(m, -0.0001, 0.0), (m, 0.0009, 0.001), (m, 0.004, 0.0041), (m, 0.0044, 0.0045),
           (m, 0.009, 0.0091), (m, 0.010, 0.0101),
           ("flash_fwd_kernel_wgmma_d64", 0.001, 0.003), ("gemm", 0.005, 0.006),
           ("gemm", 0.0055, 0.007), ("gemm", 0.011, 0.012)]
    marks = [("window", "enter"), ("denoise", "enter"), ("denoise", "exit"),
             ("vae_decode", "enter"), ("vae_decode", "exit"), ("window", "exit")]
    return dev, marks


def test_trace_summary():
    s = trace.summarize(*_device())
    assert s.window_s == pytest.approx(0.010)
    assert s.busy_s == pytest.approx(0.004)  # 1-3 ms and 5-7 ms
    assert s.range_busy_s["denoise"] == pytest.approx(0.002)
    assert s.range_busy_s["vae_decode"] == pytest.approx(0.002)
    assert s.kernel_s["gemm"] == pytest.approx(0.0025)
    assert sum(s.idle_by_range.values()) == pytest.approx(0.006)
    # each gap goes to the innermost range open on the device where it begins
    assert s.idle_by_range[trace.OUTSIDE] == pytest.approx(0.001)  # 0-1 ms
    assert s.idle_by_range["denoise"] == pytest.approx(0.002)  # 3-5 ms
    assert s.idle_by_range["vae_decode"] == pytest.approx(0.003)  # 7-10 ms
    b = s.breakdown()
    assert b["device_ops"][0] == ["gemm", pytest.approx(0.0025)]


def test_marks_must_match_marker_kernels():
    dev, marks = _device()
    with pytest.raises(RuntimeError):
        trace.summarize(dev, marks[:-1])


def test_readers():
    s = trace.summarize(*_device())
    site = dict(kind="attention", BH=2, L=128, Lk=256, D=64, dtype="bfloat16", grad=False,
                needs=(False, False, False))
    ctx = {"trace": s, "calls": 2, "units_per_call": 1, "work_flops": 1e9,
           "work_sites": [site]}
    assert readers.range_ms(ctx, ["denoise"]) == pytest.approx(1.0)
    assert readers.idle_share(ctx) == pytest.approx(60.0)
    assert readers.mfu(ctx) == pytest.approx(100 * 2e9 / (0.010 * MFU_PEAK))
    want = 100 * 2 * work.attention_bound_s(site) / 0.002
    assert readers.roofline(ctx, "attention", readers.FLASH_KERNELS) == pytest.approx(want)
    assert readers.roofline(ctx, "field_grid", readers.FIELD_GRID_KERNELS) is None


def test_work_counter_leaves_out_recompute():
    import torch

    from port_bench.reference.ttref.ops import sites

    lin = torch.nn.Linear(8, 8)
    x = torch.randn(4, 8, requires_grad=True)
    with work.WorkCounter() as w:
        y = sites.checkpoint(lambda t: lin(t).relu(), x, use_reentrant=False)
        y.sum().backward()
    # forward 2*4*8*8, backward twice that (input and weight gradients); no recompute
    assert w.flops == 2 * 4 * 8 * 8 * 3


def test_rooflines_count_only_the_ports_kernels():
    port = "void (anonymous namespace)::flash_fwd_kernel_wgmma_d64<2, 64, 1>(__nv_bfloat16 const*)"
    lib = ("void pytorch_flash::flash_fwd_kernel<Flash_fwd_kernel_traits<64, 128, 64, 4, "
           "false, false, cutlass::bfloat16_t> >(pytorch_flash::Flash_fwd_params)")
    assert trace.kernel_symbol(port) == "flash_fwd_kernel_wgmma_d64"
    assert trace.kernel_symbol(lib) == "pytorch_flash::flash_fwd_kernel"
    s = trace.TraceSummary(window_s=1.0, busy_s=0.5,
                           kernel_s={port: 0.002, lib: 0.004, "field_grid_kernel(float const*)": 0.1})
    assert s.kernels_matching(readers.FLASH_KERNELS) == pytest.approx(0.002)
    assert s.kernels_matching(readers.FIELD_GRID_KERNELS) == pytest.approx(0.1)
