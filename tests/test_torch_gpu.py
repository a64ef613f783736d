"""The port's CUDA kernels against their plain versions, on the card.

Every test here needs a CUDA device and skips without one. They import
neither JAX nor the JAX package, so they run where only PyTorch is
installed:

    python -m pytest tests/test_torch_gpu.py -m gpu -o "markers=gpu: needs a CUDA device" -q --noconftest -p no:cacheprovider

Float32 matmuls and cuDNN convolutions run with TF32 off, so the f32
comparisons are against full-f32 PyTorch.
"""

import contextlib
from collections import Counter

import numpy as np
import pytest
import torch

from triplaneturbo_torch.ops import field_grid as fg
from triplaneturbo_torch.ops import flash_attention as fa

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    prev = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    yield torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = prev


def _randn(gen, *shape, dtype=torch.float32, scale=1.0):
    return (torch.randn(*shape, generator=gen, device="cuda") * scale).to(dtype)


# Edges of the tensor-core forward's tiling: 64 query rows a warpgroup, 64 or 128 a CTA;
# 128 keys a tile at D = 64 and 64 at D = 512; one key; one batch-head. The 128-row CTA is
# taken when it gives more CTAs than the card has SMs (the last two D = 64 cases on an H100).
EDGE_CASES = [(2, 256, 77, 64), (2, 130, 1, 64), (1, 128, 128, 64), (2, 63, 127, 64),
              (2, 65, 129, 64), (3, 127, 255, 64), (3, 129, 257, 64), (40, 129, 64, 64),
              (70, 129, 129, 64), (34, 520, 77, 64),
              (1, 63, 63, 512), (2, 65, 65, 512), (1, 64, 129, 512)]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("BH,L,Lk,D", [(3, 256, 256, 64), (2, 700, 700, 64), (4, 300, 77, 64),
                                       (2, 1, 5, 64), (2, 200, 130, 512)] + EDGE_CASES)
def test_flash_attention_kernel_matches_plain(cuda, dtype, BH, L, Lk, D):
    gen = torch.Generator(device="cuda").manual_seed(L * 7 + Lk)
    q, k, v = (_randn(gen, BH, n, D, dtype=dtype) for n in (L, Lk, Lk))
    before = fa.LAUNCHES
    out = fa.flash_attention(q, k, v)
    torch.cuda.synchronize()
    assert fa.LAUNCHES == before + 1
    assert out.dtype == dtype and out.shape == (BH, L, D)
    ref = fa.flash_attention_reference(q.float(), k.float(), v.float())
    # bf16: the output's own rounding is at most 2^-9 of its largest value
    tol = 1e-4 if dtype == torch.float32 else 1e-2 * ref.abs().max().item()
    assert (out.float() - ref).abs().max().item() <= tol


# the VAE encoders' single-head mid attention with grad in program G: MV at 256² images
# (32² tokens), SD at 512² (64² tokens)
ENCODER_CASES = [(8, 1024, 1024, 512), (2, 4096, 4096, 512)]
BWD_CASES = [(3, 256, 256, 64), (2, 700, 700, 64), (2, 300, 1200, 64), (4, 300, 77, 64),
             (2, 1, 5, 64), (2, 200, 130, 512)] + ENCODER_CASES


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("BH,L,Lk,D", BWD_CASES + EDGE_CASES)
def test_flash_stats_forward_matches_plain(cuda, dtype, BH, L, Lk, D):
    gen = torch.Generator(device="cuda").manual_seed(L * 7 + Lk)
    q, k, v = (_randn(gen, BH, n, D, dtype=dtype) for n in (L, Lk, Lk))
    before = fa.LAUNCHES_STATS
    out, lse = fa._launch(q, k, v, return_stats=True)
    torch.cuda.synchronize()
    assert fa.LAUNCHES_STATS == before + 1
    ref, lse_ref = fa.flash_attention_reference(q.float(), k.float(), v.float(), return_stats=True)
    assert lse.dtype == torch.float32 and lse.shape == (BH, L)
    tol = 1e-4 if dtype == torch.float32 else 1e-2 * ref.abs().max().item()
    assert (out.float() - ref).abs().max().item() <= tol
    # lse is f32 for either input type: sums in another order than logsumexp
    assert (lse - lse_ref).abs().max().item() <= 1e-4
    # the same output as the forward without stats, bit for bit
    assert torch.equal(out, fa.flash_attention(q, k, v))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("BH,L,Lk,D", BWD_CASES)
def test_flash_backward_kernels_match_plain(cuda, dtype, BH, L, Lk, D):
    """Autograd through ``flash_attention`` on the card (stats forward, dq and
    dk/dv kernels) against the plain backward on the same inputs in f32."""
    gen = torch.Generator(device="cuda").manual_seed(L * 11 + Lk)
    q, k, v = (_randn(gen, BH, n, D, dtype=dtype).requires_grad_() for n in (L, Lk, Lk))
    g = _randn(gen, BH, L, D, dtype=dtype)
    counts = (fa.LAUNCHES, fa.LAUNCHES_STATS, fa.LAUNCHES_BWD_DQ, fa.LAUNCHES_BWD_DKDV)
    out = fa.flash_attention(q, k, v)
    # the cotangent arrives non-contiguous, as it does through the dispatcher's transpose
    g_nc = g.transpose(1, 2).contiguous().transpose(1, 2)
    dq, dk, dv = torch.autograd.grad(out, (q, k, v), g_nc)
    torch.cuda.synchronize()
    assert (fa.LAUNCHES, fa.LAUNCHES_STATS, fa.LAUNCHES_BWD_DQ, fa.LAUNCHES_BWD_DKDV) == (
        counts[0], counts[1] + 1, counts[2] + 1, counts[3] + 1)
    qf, kf, vf = (t.detach().float() for t in (q, k, v))
    o_ref, lse_ref = fa.flash_attention_reference(qf, kf, vf, return_stats=True)
    refs = fa.flash_attention_bwd_reference(qf, kf, vf, o_ref, lse_ref, g.float())
    for name, got, ref in zip(("dq", "dk", "dv"), (dq, dk, dv), refs):
        assert got.dtype == dtype and got.shape == ref.shape
        # f32: sums run in another order; bf16: the result's own rounding is 2^-9 of its
        # largest value, and delta is taken from the bf16-rounded output
        tol = 1e-4 if dtype == torch.float32 else 1e-2 * ref.abs().max().item()
        err = (got.float() - ref).abs().max().item()
        assert err <= tol, (name, err, tol)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_forward_holds_large_scores(cuda, dtype):
    """q scaled by 8: scores of std 8, so nearly one-hot rows and a wide range of exponents."""
    gen = torch.Generator(device="cuda").manual_seed(5)
    q = _randn(gen, 2, 700, 64, dtype=dtype, scale=8.0)
    k, v = _randn(gen, 2, 700, 64, dtype=dtype), _randn(gen, 2, 700, 64, dtype=dtype)
    out, lse = fa._launch(q, k, v, return_stats=True)
    ref, lse_ref = fa.flash_attention_reference(q.float(), k.float(), v.float(), return_stats=True)
    tol = 1e-4 if dtype == torch.float32 else 1e-2 * ref.abs().max().item()
    assert (out.float() - ref).abs().max().item() <= tol
    assert (lse - lse_ref).abs().max().item() <= 1e-4


@pytest.mark.parametrize("BH,L,Lk,D", [(2, 700, 700, 64), (2, 300, 1200, 64), (4, 256, 77, 64),
                                       (2, 200, 130, 512)])
def test_flash_forward_kernel_matches_its_tiled_emulation(cuda, BH, L, Lk, D):
    """bf16: the kernel and its plain tile-by-tile emulation differ only in the order of
    the f32 sums, so each output is at most one bf16 step (up to 2^-7 of its value) apart."""
    gen = torch.Generator(device="cuda").manual_seed(L + Lk)
    q, k, v = (_randn(gen, BH, n, D, dtype=torch.bfloat16) for n in (L, Lk, Lk))
    out, lse = fa._launch(q, k, v, return_stats=True)
    emu, lse_emu = fa.flash_attention_tiled_reference(q, k, v, return_stats=True)
    assert (out.float() - emu.float()).abs().max().item() <= 2 ** -7 * emu.float().abs().max().item()
    assert (lse - lse_emu).abs().max().item() <= 1e-4


@pytest.mark.parametrize("BH,L,Lk,D", [(4, 700, 333, 64), (70, 200, 300, 64), (2, 200, 130, 512)])
def test_flash_forward_is_the_same_from_run_to_run(cuda, BH, L, Lk, D):
    gen = torch.Generator(device="cuda").manual_seed(6)
    q, k, v = (_randn(gen, BH, n, D, dtype=torch.bfloat16) for n in (L, Lk, Lk))
    o1, lse1 = fa._launch(q, k, v, return_stats=True)
    o2, lse2 = fa._launch(q, k, v, return_stats=True)
    assert torch.equal(o1, o2) and torch.equal(lse1, lse2)
    assert torch.equal(o1, fa._launch(q, k, v))


def test_flash_function_gradients_match_plain_backward_bf16_ragged(cuda):
    """The whole autograd function at 700/700 in bf16: the tensor-core forward's lse feeds
    the backward kernels, which recompute P = exp(s * scale - lse). An lse left in base 2
    passes every check of ``o`` and fails here."""
    gen = torch.Generator(device="cuda").manual_seed(8)
    q, k, v = (_randn(gen, 2, 700, 64, dtype=torch.bfloat16).requires_grad_() for _ in range(3))
    g = _randn(gen, 2, 700, 64, dtype=torch.bfloat16)
    out = fa._FlashAttention.apply(q, k, v)
    grads = torch.autograd.grad(out, (q, k, v), g)
    qf, kf, vf = (t.detach().float().requires_grad_() for t in (q, k, v))
    o_ref, lse_ref = fa.flash_attention_reference(qf, kf, vf, return_stats=True)
    auto = torch.autograd.grad(o_ref, (qf, kf, vf), g.float())
    plain = fa.flash_attention_bwd_reference(qf.detach(), kf.detach(), vf.detach(), o_ref.detach(),
                                             lse_ref.detach(), g.float())
    for name, got, a, b in zip(("dq", "dk", "dv"), grads, auto, plain):
        # the plain backward is autograd's, to f32 rounding
        assert (a - b).abs().max().item() <= 1e-4, name
        tol = 1e-2 * a.abs().max().item()
        assert (got.float() - a).abs().max().item() <= tol, name


def test_flash_backward_is_the_same_from_run_to_run(cuda):
    gen = torch.Generator(device="cuda").manual_seed(3)
    q, k, v = (_randn(gen, 4, n, 64).requires_grad_() for n in (700, 333, 333))
    g = _randn(gen, 4, 700, 64)
    a = torch.autograd.grad(fa.flash_attention(q, k, v), (q, k, v), g)
    b = torch.autograd.grad(fa.flash_attention(q, k, v), (q, k, v), g)
    assert all(torch.equal(x, y) for x, y in zip(a, b))


# Edges of the tensor-core backward's tiling: 64 rows of the owned side a warpgroup (query
# rows for dq, keys for dk/dv), 64 rows of the streamed side a tile at D = 64 and 32 at
# D = 512, one row or key below and above each on both sides; Lk = 77, one key, one
# batch-head; a grid large enough for multi-warpgroup CTAs.
BWD_EDGE_CASES = [(2, 63, 63, 64), (2, 65, 65, 64), (2, 63, 129, 64), (2, 129, 63, 64),
                  (3, 127, 129, 64), (3, 129, 127, 64), (2, 191, 193, 64), (1, 128, 128, 64),
                  (2, 256, 77, 64), (2, 130, 1, 64), (70, 129, 129, 64), (34, 520, 77, 64),
                  (1, 63, 65, 512), (2, 65, 63, 512), (1, 129, 129, 512), (2, 31, 33, 512),
                  (1, 33, 31, 512), (2, 64, 1, 512)]


def _bwd_inputs(gen, BH, L, Lk, D, q_scale=1.0):
    """bf16 q, k, v, g; a negative q_scale makes every query that multiple of the first key."""
    k = _randn(gen, BH, Lk, D)
    if q_scale < 0:
        q = q_scale * k[:, :1] + _randn(gen, BH, L, D, scale=0.1)
    else:
        q = _randn(gen, BH, L, D, scale=q_scale)
    v, g = _randn(gen, BH, Lk, D), _randn(gen, BH, L, D)
    return tuple(t.bfloat16().contiguous() for t in (q, k, v, g))


def _bwd_kernels(q, k, v, g):
    out, lse = fa._launch(q, k, v, return_stats=True)
    delta = fa.flash_delta(out, g)
    dq = fa._launch_dq(q, k, v, g, lse, delta)
    dk, dv = fa._launch_dkdv(q, k, v, g, lse, delta)
    torch.cuda.synchronize()
    return (dq, dk, dv), out, lse


def _hold_bwd_against_plain(q, k, v, g, grads):
    """bf16 within 1e-2 of each output's largest reference value, never tighter than the
    1e-4 of f32 (an output that vanishes, as dq and dk do with one key, is rounding noise)."""
    qf, kf, vf = q.float(), k.float(), v.float()
    o_ref, lse_ref = fa.flash_attention_reference(qf, kf, vf, return_stats=True)
    refs = fa.flash_attention_bwd_reference(qf, kf, vf, o_ref, lse_ref, g.float())
    for name, got, ref in zip(("dq", "dk", "dv"), grads, refs):
        assert got.dtype == torch.bfloat16 and got.shape == ref.shape, name
        assert bool(torch.isfinite(got).all()), name
        tol = max(1e-2 * ref.abs().max().item(), 1e-4)
        err = (got.float() - ref).abs().max().item()
        assert err <= tol, (name, err, tol)


@pytest.mark.parametrize("BH,L,Lk,D", BWD_EDGE_CASES)
def test_flash_backward_kernels_at_the_edges_of_the_tiling(cuda, BH, L, Lk, D):
    gen = torch.Generator(device="cuda").manual_seed(L * 13 + Lk + D)
    q, k, v, g = _bwd_inputs(gen, BH, L, Lk, D)
    grads, _, _ = _bwd_kernels(q, k, v, g)
    _hold_bwd_against_plain(q, k, v, g, grads)


@pytest.mark.parametrize("BH,L,Lk,D,q_scale", [(2, 700, 700, 64, 8.0), (2, 130, 1, 64, -12.0),
                                               (1, 100, 77, 512, -12.0)])
def test_flash_backward_kernels_hold_extreme_scores(cuda, BH, L, Lk, D, q_scale):
    """q x 8: nearly one-hot rows, lse varying widely across the queries, which a mix-up
    of rows and columns of lse in dk/dv shows. q = -12 k0: lse about -96, where the
    zero-filled keys of a tile would give P = exp(96) = inf without the key mask."""
    gen = torch.Generator(device="cuda").manual_seed(L + Lk)
    q, k, v, g = _bwd_inputs(gen, BH, L, Lk, D, q_scale)
    grads, _, _ = _bwd_kernels(q, k, v, g)
    _hold_bwd_against_plain(q, k, v, g, grads)


@pytest.mark.parametrize("BH,L,Lk,D", [(2, 700, 700, 64), (2, 300, 1200, 64), (4, 256, 77, 64),
                                       (2, 200, 130, 512)])
def test_flash_backward_kernels_match_their_tiled_emulation(cuda, BH, L, Lk, D):
    """bf16: the kernels and their plain tile-by-tile emulation differ in the order of the
    f32 sums, and so where a rounded P or dS falls: each output is within 2^-7 of its
    largest emulated value."""
    gen = torch.Generator(device="cuda").manual_seed(L + 3 * Lk)
    q, k, v, g = _bwd_inputs(gen, BH, L, Lk, D)
    grads, out, lse = _bwd_kernels(q, k, v, g)
    emu = fa.flash_attention_bwd_tiled_reference(q, k, v, out, lse, g)
    for name, got, e in zip(("dq", "dk", "dv"), grads, emu):
        e = e.float()
        assert (got.float() - e).abs().max().item() <= 2 ** -7 * e.abs().max().item(), name


@pytest.mark.parametrize("BH,L,Lk,D", [(4, 700, 333, 64), (70, 200, 300, 64), (2, 200, 130, 512)])
def test_flash_backward_bf16_is_the_same_from_run_to_run(cuda, BH, L, Lk, D):
    gen = torch.Generator(device="cuda").manual_seed(9)
    q, k, v, g = _bwd_inputs(gen, BH, L, Lk, D)
    a, _, _ = _bwd_kernels(q, k, v, g)
    b, _, _ = _bwd_kernels(q, k, v, g)
    assert all(torch.equal(x, y) for x, y in zip(a, b))


def test_flash_attention_without_grad_keeps_the_plain_forward(cuda):
    gen = torch.Generator(device="cuda").manual_seed(4)
    q = _randn(gen, 2, 256, 64).requires_grad_()
    counts = (fa.LAUNCHES, fa.LAUNCHES_STATS)
    with torch.no_grad():
        fa.flash_attention(q, q, q)
    fa.flash_attention(q.detach(), q.detach(), q.detach())
    assert (fa.LAUNCHES, fa.LAUNCHES_STATS) == (counts[0] + 2, counts[1])


@pytest.mark.parametrize("R,concat", [(16, False), (24, True), (37, False)])
def test_field_grid_backward_matches_autograd_of_plain(cuda, R, concat):
    gen = torch.Generator(device="cuda").manual_seed(R)
    C = 32
    cin = 3 * C if concat else C
    ins = [_randn(gen, R, R, C, scale=0.3) for _ in range(3)]
    ins += [_randn(gen, cin, 64, scale=0.1), _randn(gen, 64, 64, scale=0.1),
            _randn(gen, 64, 1, scale=0.1), _randn(gen, cin, 64, scale=0.1),
            _randn(gen, 64, 64, scale=0.1), _randn(gen, 64, 3, scale=0.1)]
    ins = [t.requires_grad_() for t in ins]
    before = fg.LAUNCHES
    sdf, deform = fg.fused_field_grid(*ins, 1.0, 0.5, concat)
    assert fg.LAUNCHES == before + 1
    g_sdf, g_def = _randn(gen, R, R, R), _randn(gen, 3, R, R, R)
    got = torch.autograd.grad((sdf, deform), ins, (g_sdf, g_def))
    ref = torch.autograd.grad(fg.field_grid_reference(*ins, 1.0, 0.5, concat), ins, (g_sdf, g_def))
    for a, b in zip(got, ref):
        assert (a - b).abs().max().item() <= 1e-4 * max(1.0, b.abs().max().item())


def test_attention_dispatcher_gate_on_cuda(cuda):
    gen = torch.Generator(device="cuda").manual_seed(0)
    before = fa.LAUNCHES
    q = _randn(gen, 1, 128, 2, 64)
    fa.attention(q, q, q)  # D % 64 == 0 and L >= 128: the kernel
    fa.attention(q[:, :96], q, q)  # L < 128: the einsum path
    fa.attention(_randn(gen, 1, 256, 2, 32), _randn(gen, 1, 256, 2, 32),
                 _randn(gen, 1, 256, 2, 32))  # D % 64 != 0: the einsum path
    # D = 128: a multiple of 64 that the kernels are not built for, so the einsum path
    q, k, v = (_randn(gen, 1, 256, 2, 128) for _ in range(3))
    out = fa.attention(q, k, v)
    torch.cuda.synchronize()
    assert fa.LAUNCHES == before + 1
    scores = torch.einsum("bqhd,bkhd->bhqk", q, k) / 128 ** 0.5
    ref = torch.einsum("bhqk,bkhd->bqhd", torch.softmax(scores, dim=-1), v)
    assert (out - ref).abs().max().item() <= 1e-5


def test_flash_attention_refuses_what_it_does_not_take(cuda):
    q = torch.zeros(1, 128, 64, device="cuda", dtype=torch.float16)
    with pytest.raises(TypeError):
        fa.flash_attention(q, q, q)
    q = torch.zeros(1, 128, 128, device="cuda")
    with pytest.raises(ValueError):
        fa.flash_attention(q, q, q)
    q = torch.zeros(1, 64, 128, device="cuda").transpose(1, 2)
    with pytest.raises(ValueError):
        fa.flash_attention(q, q, q)


def _field_grid_inputs(gen, R, concat, C=32):
    cin = 3 * C if concat else C
    m = [_randn(gen, R, R, C, scale=0.3) for _ in range(3)]
    ws = [_randn(gen, cin, 64, scale=0.1), _randn(gen, 64, 64, scale=0.1),
          _randn(gen, 64, 1, scale=0.1), _randn(gen, cin, 64, scale=0.1),
          _randn(gen, 64, 64, scale=0.1), _randn(gen, 64, 3, scale=0.1)]
    return m + ws


def _prep_inputs(args, concat):
    m_xy, m_xz, m_zy, w1s, w2s, w3s, w1d, w2d, w3d = args
    return fg._prep(m_xy, m_xz, m_zy, w1s, w1d, w2s, w2d, w3s, w3d, concat)


# Edges of the tensor-core kernel's tiling: tiles of 8 x-values by 8 z-values at one y,
# so R = 1 (step 0), partial tiles (37, 63, 65, 129), whole ones (16, 64, 160).
@pytest.mark.parametrize("R,concat", [(R, c) for R in (1, 16, 37, 63, 64, 65, 129, 160)
                                      for c in (False, True)])
def test_field_grid_kernel_matches_plain(cuda, R, concat):
    """Against the plain f32 field the kernel keeps f32 accuracy (1e-5; a single TF32
    product misses by ten times on such inputs, tests/test_torch_field_grid_split.py);
    against its split-TF32 emulation it differs only in the order of the f32 sums (2e-6)."""
    gen = torch.Generator(device="cuda").manual_seed(R)
    args = _field_grid_inputs(gen, R, concat)
    before = fg.LAUNCHES
    sdf, deform = fg.fused_field_grid(*args, 1.0, 0.5, concat)
    torch.cuda.synchronize()
    assert fg.LAUNCHES == before + 1
    assert sdf.shape == (R, R, R) and deform.shape == (3, R, R, R)
    assert np.isfinite(sdf.cpu().numpy()).all() and np.isfinite(deform.cpu().numpy()).all()
    plain = fg.field_grid_reference(*args, 1.0, 0.5, concat)
    emu = fg.field_grid_split_tf32_reference(*_prep_inputs(args, concat), 1.0, 0.5)
    for got, p, e in zip((sdf, deform), plain, emu):
        assert (got - p).abs().max().item() <= 1e-5
        assert (got - e).abs().max().item() <= 2e-6


@pytest.mark.parametrize("k0", [0, 5, 19, 42, 63, 64, 70, 101, 127])
def test_field_grid_kernel_with_one_hot_hidden_column(cuda, k0):
    """h1 nonzero in one column k0 only: h2 = relu(h1[k0] W2[k0]). A mismatch between the
    permuted reduction index of the register A fragments and that of the staged W2 reads
    another row of W2 and shows here, where random h1 would average it out."""
    R = 16
    gen = torch.Generator(device="cuda").manual_seed(k0)
    planes = [torch.zeros(R, R, 128, device="cuda") for _ in range(3)]
    for p in planes:
        p[..., k0] = _randn(gen, R, R).abs()
    w2blk = torch.block_diag(_randn(gen, 64, 64, scale=0.1), _randn(gen, 64, 64, scale=0.1))
    w3t = torch.cat([torch.block_diag(_randn(gen, 64, 1), _randn(gen, 64, 3)).T,
                     torch.zeros(4, 128, device="cuda")])
    sdf, deform = fg._launch(*planes, w2blk, w3t, 1.0, 0.5)
    emu = fg.field_grid_split_tf32_reference(*planes, w2blk, w3t, 1.0, 0.5)
    h1 = planes[0][:, :, None, k0] + planes[1][:, None, :, k0] + planes[2][None, :, :, k0]
    h2 = torch.relu(h1[..., None].double() * w2blk[k0].double())
    heads = h2 @ w3t[:4].T.double()
    world = torch.linspace(-1.0, 1.0, R, device="cuda", dtype=torch.float64)
    g = torch.stack(torch.meshgrid(world, world, world, indexing="ij"), -1)
    want_sdf = heads[..., 0] + g.norm(dim=-1) - 0.5
    assert (sdf.double() - want_sdf).abs().max().item() <= 1e-5
    assert (deform.double() - heads[..., 1:].permute(3, 0, 1, 2)).abs().max().item() <= 1e-5
    assert (sdf - emu[0]).abs().max().item() <= 2e-6
    assert (deform - emu[1]).abs().max().item() <= 2e-6


def test_field_grid_kernel_is_the_same_from_run_to_run(cuda):
    gen = torch.Generator(device="cuda").manual_seed(65)
    prepped = _prep_inputs(_field_grid_inputs(gen, 65, True), True)
    a = fg._launch(*prepped, 1.0, 0.5)
    b = fg._launch(*prepped, 1.0, 0.5)
    assert all(torch.equal(x, y) for x, y in zip(a, b))


# -- the first renderer's plain PyTorch operations on the card -------------------------
# index_add (the gathers' backward) is atomic on the card and sums in another order, so
# gradients are held to 1e-4 of their largest value, not bit for bit.


def _mc_view(H=128):
    """A marching-cubes mesh at R = 32 and one training camera's clip-space vertices."""
    from triplaneturbo_torch.ops.isosurface import extract_isosurface
    from triplaneturbo_torch.utils.camera import camera_rig_np

    rng = np.random.default_rng(0)
    g = np.linspace(-1, 1, 32, dtype=np.float32)
    X, Y, Z = np.meshgrid(g, g, g, indexing="ij")
    sdf = np.sqrt(X ** 2 + (1.2 * Y) ** 2 + Z ** 2) - 0.55 + 0.05 * rng.normal(size=X.shape)
    m = extract_isosurface(torch.tensor(sdf.astype(np.float32)), method="mc", max_verts=16384,
                           max_faces=32768)
    verts = m.verts * 2 - 1
    mvp = torch.tensor(camera_rig_np([20.0], [30.0], 2.0, 50.0, 1.0, 0.1, 100.0)[0])
    clip = torch.cat([verts, torch.ones_like(verts[:, :1])], -1) @ mvp.T
    return clip, m.faces, m.face_mask, H


def test_rasterizer_on_the_card_matches_the_cpu(cuda):
    from triplaneturbo_torch.ops import rasterize as rz

    clip, faces, fmask, H = _mc_view()
    rng = np.random.default_rng(1)
    attr = torch.tensor(rng.normal(size=(clip.shape[0], 3)).astype(np.float32))
    bg = torch.tensor(rng.uniform(size=(H, H, 3)).astype(np.float32))
    w = torch.tensor(rng.normal(size=(H, H, 3)).astype(np.float32))
    kw = dict(tile=16, faces_per_tile=256, max_span=2, select_chunk=64)
    outs, grads = {}, {}
    for dev in ("cpu", "cuda"):
        c = clip.to(dev).requires_grad_()
        o = rz.rasterize(c, faces.to(dev), fmask.to(dev), H, H, **kw)
        img = rz.antialias(rz.interpolate(attr.to(dev), o, faces.to(dev)), o, bg.to(dev))
        (grads[dev],) = torch.autograd.grad((img * w.to(dev)).sum(), c)
        outs[dev] = o
    a, b = outs["cuda"], outs["cpu"]
    assert int(b.mask.sum()) > 2000
    # every operation is elementwise in the same order on both, so the winners agree
    assert torch.equal(a.face_id.cpu(), b.face_id)
    for name in ("bary", "depth", "edge_dist"):
        assert (getattr(a, name).cpu() - getattr(b, name)).abs().max().item() <= 1e-5, name
    assert int(a.n_list_overflow) == int(b.n_list_overflow)
    assert int(a.n_span_overflow) == int(b.n_span_overflow)
    ref = grads["cpu"]
    assert ref.abs().max() > 0
    assert (grads["cuda"].cpu() - ref).abs().max().item() <= 1e-4 * ref.abs().max().item()


def test_hashgrid_and_background_on_the_card_match_the_cpu(cuda):
    from triplaneturbo_torch.models.background.hashgrid_env_map import (
        HashgridEnvironmentMapBackground,
    )

    gen = torch.Generator().manual_seed(0)
    bgs = {"cpu": HashgridEnvironmentMapBackground()}
    with torch.no_grad():
        for p in bgs["cpu"].parameters():
            p.copy_(torch.randn(p.shape, generator=gen) * 0.1)
    bgs["cuda"] = HashgridEnvironmentMapBackground().to("cuda")
    bgs["cuda"].load_state_dict(bgs["cpu"].state_dict())
    dirs = torch.nn.functional.normalize(torch.randn(4, 64, 64, 3, generator=gen), dim=-1)
    text = torch.randn(2, 1024, generator=gen)
    w = torch.randn(4, 64, 64, 3, generator=gen)
    outs, grads = {}, {}
    for dev, bg in bgs.items():
        out = bg(dirs.to(dev), text.to(dev))
        grads[dev] = torch.autograd.grad((out * w.to(dev)).sum(), list(bg.parameters()))
        outs[dev] = out
    assert (outs["cuda"].cpu() - outs["cpu"]).abs().max().item() <= 1e-5
    for (name, _), a, b in zip(bgs["cpu"].named_parameters(), grads["cuda"], grads["cpu"]):
        assert b.abs().max() > 0, name
        assert (a.cpu() - b).abs().max().item() <= 1e-4 * b.abs().max().item(), name


# -- the second renderer's plain PyTorch operations on the card --------------------------
# The sampler's boundaries come from inverse CDFs whose values near 1 are rounded to 6e-8,
# so a boundary in an interval of little mass moves with the last bit; the antialiased
# resize of the rays rounds otherwise on the card; and a sample moved by a rounding can
# cross a texel edge or a ReLU kink of the field, where the analytic normal jumps. So the
# CPU renders at the card's boundaries and downsampled rays, which are held on their own
# (nearly all boundaries within 1e-4, the rays within 1e-5), and renders and gradients to
# 1e-4 of their largest value (the gathers' backward is an atomic scatter on the card).


def _volume_setup(dev, field_chunk):
    """A random triplane field on ``dev``, its query as the trainer builds it (one
    item, views regrouped into one row), rays of two views and draws."""
    from triplaneturbo_torch.models.geometry.triplane_field import TriplaneField, TriplaneFieldConfig
    from triplaneturbo_torch.models.renderers.volume_renderer import (
        GenerativeSpaceSDFVolumeRenderer,
        VolumeRendererConfig,
    )
    from triplaneturbo_torch.utils.camera import camera_to_world, get_ray_directions, get_rays
    from triplaneturbo_torch.utils.ops import safe_normalize

    gen = torch.Generator().manual_seed(0)
    field = TriplaneField(TriplaneFieldConfig())
    with torch.no_grad():
        for p in field.parameters():
            p.copy_(torch.randn(p.shape, generator=gen) / p.shape[-1] ** 0.5)
    field = field.to(dev)
    cache = (torch.randn(1, 6, 24, 24, 32, generator=gen) * 0.03).to(dev).requires_grad_()
    H = 24
    c2w = camera_to_world(torch.tensor([0.2, 0.5]), torch.tensor([0.3, 2.1]),
                          torch.full((2,), 1.9))
    ro, rd = get_rays(get_ray_directions(H, H, torch.full((2,), 0.8)), c2w)

    def field_fn(points, mode):
        B, M, _ = points.shape
        pts = points.reshape(1, B * M, 3)
        if mode == "sdf":
            return {"sdf": field.forward_sdf(pts, cache).reshape(B, M, 1)}
        outer = torch.is_grad_enabled()
        with torch.enable_grad():
            p = pts.detach().requires_grad_()
            out = field(p, cache)
            (g,) = torch.autograd.grad(out["sdf"].sum(), p, create_graph=outer)
        out = {k: (v if outer else v.detach()).reshape(B, M, -1) for k, v in out.items()}
        out["sdf_grad"] = g.reshape(B, M, 3)
        out["normal"] = safe_normalize(out["sdf_grad"])
        out["features"] = torch.sigmoid(out["features"])
        return out

    renderer = GenerativeSpaceSDFVolumeRenderer(VolumeRendererConfig(
        num_samples_per_ray=32, num_samples_per_ray_importance=32, learned_variance_init=0.3,
        field_chunk=field_chunk)).to(dev)
    return field, cache, field_fn, renderer, ro.to(dev), rd.to(dev), c2w.to(dev)


@pytest.mark.parametrize("field_chunk", [0, 700])
def test_volume_and_patch_renderers_on_the_card_match_the_cpu(cuda, field_chunk, monkeypatch):
    from dataclasses import replace

    from triplaneturbo_torch.models.renderers import patch_renderer as pr
    from triplaneturbo_torch.models.renderers import volume_renderer as vr
    from triplaneturbo_torch.models.renderers.patch_renderer import (
        PatchRenderer,
        PatchRendererConfig,
    )

    cfg = PatchRendererConfig(patch_size=10, global_downsample=3)
    gen = torch.Generator().manual_seed(1)
    sample, resize = vr.importance_sampling, pr.resize
    card, cpu_own, card_rays, cpu_rays = [], [], [], []

    def recording(*args, **kwargs):
        card.append(sample(*args, **kwargs))
        return card[-1]

    def replaying(*args, **kwargs):
        cpu_own.append(sample(*args, **kwargs))
        return tuple(t.cpu() for t in card[len(cpu_own) - 1])

    def recording_rays(x, h, w):  # a resize that shrinks is of the rays
        out = resize(x, h, w)
        if h < x.shape[1]:
            card_rays.append(out)
        return out

    def replaying_rays(x, h, w):
        out = resize(x, h, w)
        if h >= x.shape[1]:
            return out
        cpu_rays.append(out)
        return card_rays[len(cpu_rays) - 1].cpu()

    outs, grads, w, draws = {}, {}, None, None
    for dev in ("cuda", "cpu"):
        monkeypatch.setattr(vr, "importance_sampling", recording if dev == "cuda" else replaying)
        monkeypatch.setattr(pr, "resize", recording_rays if dev == "cuda" else replaying_rays)
        field, cache, field_fn, renderer, ro, rd, c2w = _volume_setup(dev, field_chunk)
        if draws is None:
            draws = PatchRenderer.draw(cfg, gen, 2, 24, 24,
                                       lambda n: renderer.draw_jitter(n, gen))
            w = {k: torch.randn((2, 24, 24, c), generator=gen)
                 for k, c in (("comp_rgb", 3), ("comp_normal_cam_vis", 3), ("disparity", 1))}
        d = replace(draws, jitter_global=tuple(u.to(dev) for u in draws.jitter_global),
                    jitter_patch=tuple(u.to(dev) for u in draws.jitter_patch))

        def base(ro_, rd_, jitter=None, train=True):
            return renderer(ro_, rd_, field_fn, lambda dirs, te: torch.ones_like(dirs) * 0.9,
                            camera_distances=torch.full((2,), 1.9, device=dev), c2w=c2w,
                            jitter=jitter, train=train,
                            field_inputs=[cache, *field.parameters()])

        out = PatchRenderer(cfg, base)(ro, rd, draws=d, train=True)
        loss = sum((out[k] * w[k].to(dev)).sum() for k in w) + out["eikonal"] + out["orient"]
        inputs = [cache, renderer.variance_inv_std, *field.parameters()]
        grads[dev] = torch.autograd.grad(loss, inputs, allow_unused=True)
        outs[dev] = out
    assert len(card) == len(cpu_own) == 2 and len(card_rays) == len(cpu_rays) == 2
    diffs = torch.cat([(c[0].cpu() - o[0]).abs().flatten() for c, o in zip(card, cpu_own)])
    assert float((diffs <= 1e-4).float().mean()) >= 0.99
    assert all((c.cpu() - o).abs().max().item() <= 1e-5 for c, o in zip(card_rays, cpu_rays))

    def held(got, ref, what):
        got, ref = got.detach().cpu(), ref.detach()
        assert torch.isfinite(got).all(), what
        assert (got - ref).abs().max().item() <= 1e-4 * ref.abs().max().item(), what

    op = outs["cpu"]["opacity"].detach()
    assert 0.9 < float(op.max()) and float(op.min()) < 0.1
    for k, ref in outs["cpu"].items():
        held(outs["cuda"][k], ref, k)
    for i, (ga, gb) in enumerate(zip(grads["cuda"], grads["cpu"])):
        if gb is None:  # the deformation network: the volume branch does not reach it
            assert ga is None
            continue
        assert gb.abs().max() > 0, i
        held(ga, gb, i)


def test_plane_sampler_second_order_gradients_on_the_card(cuda):
    """The eikonal term differentiates the SDF's input gradient: the gather-based
    plane sampler taken to the second order, checked by finite differences in
    float64 on the card, and its eikonal gradient against the CPU's."""
    from triplaneturbo_torch.ops.grid_sample import grid_sample_2d_packed, pack_2x2

    gen = torch.Generator().manual_seed(3)
    planes = torch.randn(2, 5, 6, 3, generator=gen, dtype=torch.float64)
    # points away from the cells' edges, where the sampler is smooth
    cells = torch.randint(0, 5, (2, 7, 2), generator=gen).double()
    grid = ((cells + 0.2 + 0.6 * torch.rand(2, 7, 2, generator=gen, dtype=torch.float64)) * 2
            / torch.tensor([6.0, 5.0], dtype=torch.float64)) - 1

    def sample(pl, g):
        return grid_sample_2d_packed(pack_2x2(pl), g)

    args = (planes.to("cuda").requires_grad_(), grid.to("cuda").requires_grad_())
    assert torch.autograd.gradgradcheck(sample, args)

    def eikonal_grad(dev):
        pl = planes.float().to(dev).requires_grad_()
        g = grid.float().to(dev).requires_grad_()
        (dg,) = torch.autograd.grad(sample(pl, g).sum(), g, create_graph=True)
        (d_pl,) = torch.autograd.grad(((dg.norm(dim=-1) - 1) ** 2).mean(), pl)
        return d_pl

    ref = eikonal_grad("cpu")
    assert ref.abs().max() > 0
    assert (eikonal_grad("cuda").cpu() - ref).abs().max().item() <= 1e-5 * ref.abs().max().item()


@pytest.mark.parametrize("parallel", [False, True], ids=["one_after_the_other", "stacked"])
def test_program_g_on_the_card_matches_the_cpu(cuda, parallel):
    """Program G of small teachers (head dim 64, VAE encoders to 64 channels, 32² latents,
    so that the MV and SD attention and the encoders' mid attention take the kernels;
    RichDreamer's 8 heads the einsum path) on the card against the CPU, f32, from the
    same teacher weights, images, cameras, text states and draws: fid and grad_norm_mv
    within 1e-3 relative, each image gradient within 1e-3 of its largest value (the
    kernels and cuDNN sum in other orders, and the "dmd" weighting divides by
    sqrt(alpha_bar), 0.07 at t = 999)."""
    from triplaneturbo_torch.data.multiview_multiprompt import (
        DataModuleConfig,
        MultiviewMultipromptDataModule,
    )
    from triplaneturbo_torch.models.background.hashgrid_env_map import (
        HashgridBackgroundConfig,
        HyperNetConfig,
    )
    from triplaneturbo_torch.models.guidance.asd_guidance import ASDConfig
    from triplaneturbo_torch.systems.trainer import TrainerConfig, TriplaneTurboTrainer

    teacher = dict(block_out_channels=(64, 128), layers_per_block=1, attention_head_dim=64,
                   cross_attention_dim=64)
    vae = dict(vae_block_out_channels=(32, 64), vae_layers_per_block=1)
    sizes = {"mv": {**teacher, **vae}, "rd": dict(teacher), "sd": {**teacher, **vae}}
    sg = dict(block_out_channels=(32, 64), layers_per_block=1, cross_attention_dim=64,
              attention_head_dim=32, vae_block_out_channels=(16, 32), vae_layers_per_block=1,
              output_dim=8)

    def build(dev):
        return TriplaneTurboTrainer.build(
            TrainerConfig(parallel_guidance=parallel), device=dev, space_generator_overrides=sg,
            background_cfg=HashgridBackgroundConfig(hypernet=HyperNetConfig(c_dim=64)),
            teacher_sizes=sizes, teacher_dtype="float32",
            guidance_cfg=ASDConfig(mv_image_size=64, rd_image_size=32, sd_image_size=64))

    trainers = {"cpu": build("cpu"), "cuda": build("cuda")}
    for kind in ("mv", "rd", "sd"):
        src, dst = (getattr(trainers[d].guidance, kind) for d in ("cpu", "cuda"))
        for a, b in ((src.unet, dst.unet), (src.vae, dst.vae)):
            if a is not None:
                b.load_state_dict(a.state_dict())
    dm = MultiviewMultipromptDataModule(DataModuleConfig(
        batch_size=8, n_view=4, height=64, width=64, ray_height=32, ray_width=32, n_steps=1),
        seed=0)
    host_batch = {k: v for k, v in dm.sample_train_batch()[0].items() if k != "noise"}
    gen = torch.Generator().manual_seed(8)
    images = {f"{k}_{side}": torch.rand((8, hw, hw, c), generator=gen)
              for k, c in (("comp_rgb", 3), ("comp_normal_cam_vis", 3), ("disparity", 1))
              for side, hw in (("1st", 64), ("2nd", 32))}
    text = {k: torch.randn((2, 77, 64), generator=gen)
            for k in ("cond_21", "uncond_21", "cond_15", "uncond_15")}
    scalars = trainers["cpu"].host_scalars()
    draws = trainers["cpu"].draw_guidance(
        MultiviewMultipromptDataModule.to_device(host_batch, "cpu"),
        torch.Generator().manual_seed(9))
    outs = {}
    for dev, tr in trainers.items():
        counts = (fa.LAUNCHES, fa.LAUNCHES_STATS, fa.LAUNCHES_BWD_DQ, fa.LAUNCHES_BWD_DKDV)
        d = {kind: [x.to(dev) for x in xs] for kind, xs in draws.items()}
        outs[dev] = tr._stage_teacher({k: v.to(dev) for k, v in images.items()},
                                      MultiviewMultipromptDataModule.to_device(host_batch, dev),
                                      {k: v.to(dev) for k, v in text.items()}, scalars, d)
        torch.cuda.synchronize()
        launched = tuple(a - b for a, b in zip(
            (fa.LAUNCHES, fa.LAUNCHES_STATS, fa.LAUNCHES_BWD_DQ, fa.LAUNCHES_BWD_DKDV), counts))
        calls = 1 if parallel else 2
        # 8 kernel sites a MV or SD UNet pass, one encoder mid attention a MV or SD call
        assert launched == ((0, 0, 0, 0) if dev == "cpu" else
                            (calls * 2 * 8, calls * 2, calls * 2, calls * 2)), (dev, launched)
    (fid_c, gn_c), g_c = outs["cuda"]
    (fid_r, gn_r), g_r = outs["cpu"]
    assert torch.isfinite(fid_c) and torch.isfinite(gn_c).all()
    assert abs(float(fid_c) - float(fid_r)) <= 1e-3 * abs(float(fid_r))
    assert (gn_c.cpu() - gn_r).abs().max().item() <= 1e-3 * gn_r.abs().max().item()
    for k, ref in g_r.items():
        got = g_c[k].cpu()
        assert torch.isfinite(got).all() and ref.abs().max() > 0, k
        assert (got - ref).abs().max().item() <= 1e-3 * ref.abs().max().item(), k


def _mc_mesh(R=48):
    """A colored marching-cubes mesh of a bumpy sphere (the port's own extractor)."""
    from triplaneturbo_torch.ops.isosurface import marching_cubes
    from triplaneturbo_torch.utils.mesh import Mesh

    g = torch.stack(torch.meshgrid(*[torch.linspace(0, 1, R)] * 3, indexing="ij"), -1)
    sdf = (g - 0.5).norm(dim=-1) - 0.3 - 0.03 * torch.sin(20 * g[..., 0])
    m = marching_cubes(sdf, None, max_verts=16384, max_faces=32768)
    v = m.verts * 2 - 1
    return Mesh(v_pos=v, t_pos_idx=m.faces, v_mask=m.vert_mask, t_mask=m.face_mask,
                v_rgb=(v * 0.5 + 0.5).clamp(0, 1))


def test_eval_views_on_the_card_match_the_cpu(cuda):
    """``render_mesh_views`` at 128² (4 views) on the card against the CPU route: the
    same overflow counts and images within 1e-5."""
    from dataclasses import fields

    from triplaneturbo_torch.evaluation.mesh_render import render_mesh_views

    mesh = _mc_mesh()
    assert int(mesh.t_mask.sum()) > 1000
    on = mesh.with_(**{f.name: getattr(mesh, f.name).to("cuda") for f in fields(mesh)
                       if getattr(mesh, f.name) is not None})
    a, b = render_mesh_views(on, height=128, width=128), render_mesh_views(mesh, height=128,
                                                                           width=128)
    assert a.images.shape == (4, 128, 128, 3) and a.images.is_cuda
    assert torch.equal(a.n_span_overflow.cpu(), b.n_span_overflow)
    assert torch.equal(a.n_list_overflow.cpu(), b.n_list_overflow)
    assert (b.images < 0.99).float().mean() > 0.05  # the mesh is in the frame
    assert (a.images.cpu() - b.images).abs().max().item() <= 1e-5


def test_hexa_locon_block_on_the_card_matches_the_cpu(cuda):
    """A ``hexa_v1`` resnet block (per-plane LoCon on both convs and the shortcut, ``up``
    drawn nonzero) on the card against the CPU, f32 and bf16 backbone."""
    from triplaneturbo_torch.models.unet_blocks import ResnetBlock2D
    from triplaneturbo_torch.utils.weights import init_random_

    gen = torch.Generator().manual_seed(0)
    x = torch.randn(12, 32, 16, 16, generator=gen)
    temb = torch.randn(12, 64, generator=gen)
    for dtype, tol in ((torch.float32, 1e-4), (torch.bfloat16, 2e-2)):
        block = ResnetBlock2D(32, 48, time_emb_dim=64, locon_type="hexa_v1", locon_rank=4,
                              dtype=dtype)
        init_random_(block, torch.Generator().manual_seed(1))
        with torch.no_grad():
            for name, p in block.named_parameters():
                if name.endswith("planes.up.weight"):
                    p.copy_(torch.randn(p.shape, generator=gen) * 0.2)
        ref = block(x.to(dtype), temb.to(dtype)).float()
        got = block.to("cuda")(x.to("cuda", dtype), temb.to("cuda", dtype)).float().cpu()
        assert (got - ref).abs().max().item() <= tol * ref.abs().max().item(), dtype


# -- the tracer on the card (utils/profiling.py) ----------------------------------------


def test_span_encloses_its_launch_on_the_profilers_clock(cuda):
    """A span's ``time.time_ns()`` interval holds the runtime call that launched its one
    kernel, and the kernel starts on the device after the span opened: the host spans
    and CUPTI's device times share the profiler's clock."""
    from torch.profiler import ProfilerActivity, profile

    from triplaneturbo_torch.utils import profiling

    torch.cuda._sleep(1000)  # the launch path warm
    torch.cuda.synchronize()
    profiling.clear()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        with profiling.span("sleep") as rec:
            torch.cuda._sleep(100000)
        torch.cuda.synchronize()
    assert rec is not None and profiling.spans() == [rec]
    events = list(prof.profiler.kineto_results.events())
    launches = [e for e in events if "LaunchKernel" in e.name()]
    kernels = [e for e in events if e.device_type() == torch.autograd.DeviceType.CUDA
               and "spin" in e.name()]
    assert len(launches) == 1 and len(kernels) == 1, [e.name() for e in events]
    launch, kernel = launches[0], kernels[0]
    assert rec.start_ns <= launch.start_ns()
    assert launch.start_ns() + launch.duration_ns() <= rec.end_ns
    assert kernel.start_ns() >= rec.start_ns
    profiling.clear()


def test_syncs_are_counted_on_the_innermost_span(cuda):
    from triplaneturbo_torch.utils import profiling

    x = torch.ones(4, device="cuda")
    torch.cuda.synchronize()
    before = torch.cuda.get_sync_debug_mode()
    with profiling.recording():
        with profiling.span("request") as root:
            assert torch.cuda.get_sync_debug_mode() == 1
            with profiling.span("inner") as inner:
                x.sum().item()
                x.max().item()
            y = x * 2  # no sync
    assert inner.counts == {"syncs": 2} and root.counts == {"syncs": 0}
    assert torch.cuda.get_sync_debug_mode() == before
    assert float(y.sum().item()) == 8.0  # outside any request: not counted, no warning raised
    profiling.clear()


def test_a_span_entered_during_graph_capture_records_nothing(cuda):
    from triplaneturbo_torch.utils import profiling

    x = torch.ones(8, device="cuda")
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        y = x * 2  # warm up outside the capture
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    profiling.clear()
    with profiling.recording():
        with torch.cuda.graph(graph):
            with profiling.span("captured") as rec, profiling.stage("denoise") as st:
                y = x * 2
        assert rec is None and st is None and profiling.spans() == []
        graph.replay()
        torch.cuda.synchronize()
    assert float(y.sum().item()) == 16.0


# -- the student UNet as a piecewise CUDA graph (utils/cuda_graphs.py) -----------------

# chip_smoke.py's small model: head size 64, so the joint self-attention and the 16²
# cross-attention take the kernels and the 8² cross-attention the einsum route
GRAPH_SG = dict(block_out_channels=(64, 128), layers_per_block=1, cross_attention_dim=64,
                attention_head_dim=64, vae_block_out_channels=(32, 64), vae_layers_per_block=1,
                output_dim=64)
GRAPH_TEXT = dict(width=64, layers=2, heads=1, intermediate=128)
GRAPH_KW = dict(latent_resolution=16, isosurface_resolution=64)


def _graph_pipe():
    from triplaneturbo_torch.models.clip_text import CLIPTextConfig
    from triplaneturbo_torch.pipelines.triplaneturbo_text_to_3d import (
        TriplaneTurboTextTo3DPipeline,
    )
    from triplaneturbo_torch.utils.weights import init_random_

    pipe = TriplaneTurboTextTo3DPipeline.from_pretrained(
        None, device="cuda", seed=0, space_generator_overrides=GRAPH_SG,
        text_config=CLIPTextConfig(**GRAPH_TEXT), **GRAPH_KW)
    with torch.no_grad():  # the adapters' `up` nonzero, so that every adapter adds
        gen = torch.Generator(device="cuda").manual_seed(3)
        for name, p in pipe.geometry.named_parameters():
            if name.endswith((".up", "up.weight")):
                p.copy_(torch.randn(p.shape, generator=gen, device="cuda") * 0.05)
    return pipe


def _graph_latents(seed):
    gen = torch.Generator(device="cuda").manual_seed(seed)
    return torch.randn((1, 6, 16, 16, 4), generator=gen, device="cuda")


def _rel(a, b):
    return ((a.float() - b.float()).abs().max() / b.float().abs().max()).item()


def _eager(monkeypatch):
    """The UNet eager, the adapters still folded: the fast path's UNet engages the fold
    and gives no graph."""
    from triplaneturbo_torch.pipelines import triplaneturbo_text_to_3d as pl

    @contextlib.contextmanager
    def unet(self, text, latents):
        with self.fold.engaged():
            yield None

    monkeypatch.setattr(pl._FastPath, "unet", unet)


def _unfolded(monkeypatch):
    """The route of a call without ``can_capture``: the UNet eager, the adapters as
    they are."""
    from triplaneturbo_torch.pipelines import triplaneturbo_text_to_3d as pl

    monkeypatch.setattr(pl, "can_capture", lambda x: False)


def test_piecewise_unet_matches_the_eager_call(cuda):
    """Two calls of the graphed UNet with other latents, timesteps and text states
    (the static buffers reused): ε within 1e-6 of the eager call's largest value, both
    folded; the pieces are the attention calls plus one."""
    from triplaneturbo_torch.pipelines import triplaneturbo_text_to_3d as pl
    from triplaneturbo_torch.utils import profiling

    pipe = _graph_pipe()
    fast = pl._FastPath(pipe.geometry)
    with torch.no_grad():
        for i, (prompt, t) in enumerate((("a hamburger", 999), ("a wooden chair", 499))):
            text = pipe.encode_prompt([prompt])
            lat = _graph_latents(i)
            with fast.unet(text, lat) as unet:
                got = unet(lat, t).clone()
                ref = pipe.geometry.denoise(lat, text, t)
            torch.cuda.synchronize()
            assert torch.isfinite(got).all() and ref.abs().max() > 0
            assert _rel(got, ref) <= 1e-6, (t, _rel(got, ref))
        assert len(fast.graphs) == 1
        graph = next(iter(fast.graphs.values()))
        profiling.clear()
        with profiling.recording():
            pipe.geometry.denoise(lat, text, t)
        n_attention = sum(r.name == "flash_attention" for r in profiling.spans())
        profiling.clear()
    # a transformer block down, one in the middle, two up: a self- and a cross-attention
    # call each (the middle's 8² cross-attention on the einsum route)
    assert n_attention == 8
    assert graph.n_splits == n_attention
    assert graph.n_pieces == n_attention + 1


def test_graphed_pipeline_returns_nothing_a_replay_rewrites(cuda, monkeypatch):
    """A graphed call's outputs stay as they were after the next call, and the graphed
    pipeline's x̂₀ and planes match the eager pipeline's."""
    pipe = _graph_pipe()
    out1 = pipe("a hamburger", latents=_graph_latents(1))
    assert len(pipe._fast.graphs) == 1  # the first call captured
    kept = {k: out1[k].clone() for k in ("latents", "space_cache")}
    out2 = pipe("a wooden chair", latents=_graph_latents(2))
    torch.cuda.synchronize()
    for k, v in kept.items():
        assert torch.equal(out1[k], v), k
    assert not torch.equal(out2["latents"], out1["latents"])
    _eager(monkeypatch)
    ref = pipe("a wooden chair", latents=_graph_latents(2))
    for k in ("latents", "space_cache"):
        assert _rel(out2[k], ref[k]) <= 1e-6, (k, _rel(out2[k], ref[k]))


def test_graphed_call_keeps_every_attention_span(cuda, monkeypatch):
    """Under ``recording()`` a graphed call keeps as many ``flash_attention`` spans as
    an eager one (the UNet's own spans go, they are in the graph) and counts its four
    replays; under the benchmark's ``TracedWindow`` every mark has its marker kernel,
    and the denoise stage's device-busy time is that of the eager call's (the
    profiler sees a replay's kernels)."""
    from port_bench.lib.trace import TracedWindow
    from triplaneturbo_torch.utils import profiling

    pipe = _graph_pipe()
    lat = _graph_latents(4)
    pipe("a hamburger", latents=lat)  # captures
    torch.cuda.synchronize()

    def call():
        profiling.clear()
        with profiling.recording():
            pipe("a hamburger", latents=lat)
        recs = profiling.spans()
        profiling.clear()
        names = Counter(r.name for r in recs)
        counts = Counter()
        for r in recs:
            counts.update(r.counts)
        return names, counts

    def traced():
        tw = TracedWindow(torch.device("cuda")).start()
        try:
            tw.begin()
            pipe("a hamburger", latents=lat)
            tw.end()
        finally:
            tw.stop()
        return tw.summary()  # raises unless every mark has its marker kernel

    graphed, g_counts = call()
    g_trace = traced()
    with monkeypatch.context() as m:
        _eager(m)
        eager, e_counts = call()
        e_trace = traced()
    assert graphed["flash_attention"] == eager["flash_attention"] == 4 * 8 + 1  # and the VAE
    assert graphed["ddim_step"] == eager["ddim_step"] == 4
    assert eager["unet.down"] == 4 and graphed["unet.down"] == 0
    assert g_counts["unet_graph_calls"] == 4 and g_counts["unet_eager_calls"] == 0
    assert e_counts["unet_graph_calls"] == 0 and e_counts["unet_eager_calls"] == 4
    assert g_counts["syncs"] == e_counts["syncs"] - 4  # the timestep's uploads
    g_busy, e_busy = g_trace.busy_in(["denoise"]), e_trace.busy_in(["denoise"])
    assert g_trace.busy_in(["flash_attention"]) > 0
    assert 0.7 * e_busy <= g_busy <= 1.3 * e_busy, (g_busy, e_busy)


# -- the frozen adapters folded into the bf16 weights (models/lora.py Fold) -------------


def _write_weights(pipe, seed):
    """Adapter and base weights scaled in place, as the benchmark's ``p.copy_`` and
    ``load_state_dict`` write them."""
    gen = torch.Generator(device="cuda").manual_seed(seed)
    with torch.no_grad():
        for name, p in pipe.geometry.space_generator.named_parameters():
            if name.endswith(("up", "up.weight", "conv.weight")):
                p.mul_(1.0 + 0.5 * torch.rand(p.shape, generator=gen, device="cuda"))


def _only_graph(pipe):
    (graph,) = pipe._fast.graphs.values()
    return graph


def test_a_weight_reload_between_two_graphed_calls_shows(cuda, monkeypatch):
    """Adapter and base weights written in place between two graphed, folded calls:
    the second call sees them (refolded in place, the graph kept) and matches the eager
    folded call bit for bit and the unfolded eager route in f32 (1e-3 of the largest
    value, chip_smoke.py's SMALL_REL_TOL: other summation orders, amplified by the DDIM
    step's x0)."""
    pipe = _graph_pipe()
    lat = _graph_latents(5)
    first = pipe("a hamburger", latents=lat)
    graph = _only_graph(pipe)
    kept = {k: first[k].clone() for k in ("latents", "space_cache")}
    _write_weights(pipe, 6)
    second = pipe("a hamburger", latents=lat)
    assert _only_graph(pipe) is graph  # not captured again
    for k, v in kept.items():
        assert _rel(second[k], v) > 1e-3, k
    with monkeypatch.context() as m:
        _eager(m)
        eager = pipe("a hamburger", latents=lat)
    with monkeypatch.context() as m:
        _unfolded(m)
        plain = pipe("a hamburger", latents=lat)
    for k in ("latents", "space_cache"):
        assert _rel(second[k], eager[k]) <= 1e-6, (k, _rel(second[k], eager[k]))
        assert _rel(second[k], plain[k]) <= 1e-3, (k, _rel(second[k], plain[k]))


def test_a_direct_denoise_refolds_before_it_replays(cuda, monkeypatch):
    """ROADMAP C6. After a graphed call and a weight write in place, a direct
    ``denoise_latents`` refolds before it replays the graph: its x̂₀ moves off the one
    before the write (by more than 1e-3 of its largest value) and matches the eager
    folded route (1e-6). Conversely, a first ``denoise_latents`` on a fresh pipeline
    captures the graph inside the fold, and the ``__call__`` after it replays that graph
    and matches the eager folded route (1e-6)."""
    pipe = _graph_pipe()
    lat = _graph_latents(8)
    before = pipe("a hamburger", latents=lat)["latents"].clone()
    _write_weights(pipe, 9)
    with torch.no_grad():
        text = pipe.encode_prompt(["a hamburger"])
        got = pipe.denoise_latents(text, lat).clone()
        assert _rel(got, before) > 1e-3, _rel(got, before)
        with monkeypatch.context() as m:
            _eager(m)
            ref = pipe.denoise_latents(text, lat)
    assert _rel(got, ref) <= 1e-6, _rel(got, ref)

    fresh = _graph_pipe()
    with torch.no_grad():
        first = fresh.denoise_latents(fresh.encode_prompt(["a wooden chair"]), lat).clone()
    graph = _only_graph(fresh)
    out = fresh("a wooden chair", latents=lat)
    assert _only_graph(fresh) is graph  # the call replays the direct call's graph
    with monkeypatch.context() as m:
        _eager(m)
        ref = fresh("a wooden chair", latents=lat)
    for x0 in (out["latents"], first):
        assert _rel(x0, ref["latents"]) <= 1e-6, _rel(x0, ref["latents"])


def test_full_width_folded_graphed_pipeline_against_the_unfolded_route(cuda, monkeypatch):
    """The full-width bf16 student, folded and graphed, against its unfolded eager route
    and both against the same weights in f32 (unfolded, eager, TF32 off): x̂₀ and the
    planes. The fold rounds each summed weight to bf16 once where the unfolded route
    rounds the adapter's f32 output before its add, so the folded route may sit at most
    twice as far from the f32 one as the unfolded route does."""
    from triplaneturbo_torch.pipelines.triplaneturbo_text_to_3d import (
        TriplaneTurboTextTo3DPipeline,
    )

    pipe = TriplaneTurboTextTo3DPipeline.from_pretrained(None, device="cuda",
                                                         dtype_str="bfloat16", seed=0)
    gen = torch.Generator(device="cuda").manual_seed(7)
    with torch.no_grad():  # the adapters' `up` nonzero, so that every adapter adds
        for name, p in pipe.geometry.named_parameters():
            if name.endswith((".up", "up.weight")):
                p.copy_(torch.randn(p.shape, generator=gen, device="cuda") * 0.02)
    lat = torch.randn((1, 6, 32, 32, 4), generator=gen, device="cuda")
    prompt = "a delicious hamburger"
    pipe(prompt, latents=lat)  # captures and folds
    folded = pipe(prompt, latents=lat)
    assert pipe._fast is not None and len(pipe._fast.fold.sites) > 0
    with monkeypatch.context() as m:
        _unfolded(m)
        plain = pipe(prompt, latents=lat)
        ref = TriplaneTurboTextTo3DPipeline.from_pretrained(None, device="cuda",
                                                            dtype_str="float32", seed=0)
        ref.geometry.load_state_dict(pipe.geometry.state_dict())
        ref.text_encoder.load_state_dict(pipe.text_encoder.state_dict())
        want = ref(prompt, latents=lat)
    gaps = {}
    for k in ("latents", "space_cache"):
        gaps[k] = (_rel(folded[k], want[k]), _rel(plain[k], want[k]), _rel(folded[k], plain[k]))
        assert torch.isfinite(folded[k]).all(), k
    print("folded, unfolded against f32; folded against unfolded:", gaps)
    for k, (f, u, _) in gaps.items():
        assert f <= 2.0 * u, (k, gaps[k])


# -- the field-and-mesh layer without host syncs -----------------------------------------


def test_the_mesh_stages_never_wait_on_the_host(cuda):
    """After a warm-up call, a full-width B=2 call syncs once, at the token upload: each
    prompt's field, marching cubes and colour read constants built once a device (the
    triangle tables, the field's bbox, the empty-field sphere) and upload nothing. Then
    one prompt's ``field_on_grid`` → ``extract_mesh`` → ``colorize`` runs with every sync
    an error, and gives that prompt's mesh and colours bit for bit."""
    from triplaneturbo_torch.pipelines.triplaneturbo_text_to_3d import (
        TriplaneTurboTextTo3DPipeline,
    )
    from triplaneturbo_torch.utils import profiling

    pipe = TriplaneTurboTextTo3DPipeline.from_pretrained(None, device="cuda",
                                                         dtype_str="bfloat16", seed=0)
    gen = torch.Generator(device="cuda").manual_seed(11)
    lat = torch.randn((2, 6, 32, 32, 4), generator=gen, device="cuda")
    prompts = ["a delicious hamburger", "a wooden chair"]
    pipe(prompts, latents=lat)  # captures, folds and builds the constants
    torch.cuda.synchronize()
    profiling.clear()
    with profiling.recording():
        out = pipe(prompts, latents=lat)
    recs = profiling.spans()
    profiling.clear()
    syncs = Counter()
    for r in recs:
        syncs[r.name] += r.counts.get("syncs", 0)
    assert sum(syncs.values()) == 1 and syncs["text_encoder"] == 1, dict(syncs)

    before = torch.cuda.get_sync_debug_mode()
    torch.cuda.set_sync_debug_mode("error")
    try:
        with torch.no_grad():
            sdf, deform = pipe.field_on_grid(out["space_cache"][0])
            m = pipe.extract_mesh(sdf, deform)
            color = pipe.colorize(m.verts, out["space_cache"][0])
    finally:
        torch.cuda.set_sync_debug_mode(before)
    mesh = out["mesh"][0]
    assert bool(mesh.t_mask.any())
    for got, want in ((m.verts, mesh.v_pos), (m.faces, mesh.t_pos_idx),
                      (m.face_mask, mesh.t_mask), (color, mesh.v_rgb)):
        assert torch.equal(got, want)


# every GroupNorm of the serving trunk at B=1 (six planes): (C, H, W, eps, silu); the
# UNet's at 32² latents, the student decoder's up to 256²
GN_TRUNK = [(320, 16, 16, 1e-5, True), (320, 32, 32, 1e-6, False), (320, 32, 32, 1e-5, True),
            (640, 8, 8, 1e-5, True), (640, 16, 16, 1e-6, False), (640, 16, 16, 1e-5, True),
            (640, 32, 32, 1e-5, True), (960, 16, 16, 1e-5, True), (960, 32, 32, 1e-5, True),
            (1280, 4, 4, 1e-6, False), (1280, 4, 4, 1e-5, True), (1280, 8, 8, 1e-6, False),
            (1280, 8, 8, 1e-5, True), (1280, 16, 16, 1e-5, True), (1920, 8, 8, 1e-5, True),
            (1920, 16, 16, 1e-5, True), (2560, 4, 4, 1e-5, True), (2560, 8, 8, 1e-5, True),
            (128, 256, 256, 1e-6, True), (256, 128, 128, 1e-6, True),
            (256, 256, 256, 1e-6, True), (512, 32, 32, 1e-6, False), (512, 32, 32, 1e-6, True),
            (512, 64, 64, 1e-6, True), (512, 128, 128, 1e-6, True),
            # fewer channels than a tile (the small model's decoder) and a partial tile
            (32, 128, 128, 1e-6, True), (96, 16, 16, 1e-5, False)]


@pytest.mark.parametrize("C,H,W,eps,silu", GN_TRUNK)
def test_group_norm_act_kernel_matches_plain(cuda, C, H, W, eps, silu):
    """The channels-last GroupNorm(+SiLU) kernels against their plain version (f32
    GroupNorm, rounded once): within one bf16 rounding of each value (2^-7 of it) plus
    2^-12 of the largest, for the sums' other order near zero. Six planes at every trunk
    shape, 48 (B=8) at the largest; the input offset from zero, so that a variance taken
    as E[x²] - E[x]² would cancel; with a shift per sample and channel (a conv's bias and
    the time embedding) where the block's norm2 takes one, and a shift per channel at the
    largest; f32 scale and shift, and also the bf16 ones a bf16 model stores (which the
    serving trunk passes as they are)."""
    from triplaneturbo_torch.ops import nhwc as gn

    gen = torch.Generator(device="cuda").manual_seed(C + H)
    for N in (6, 48) if H == 256 else (6,):
        x = (_randn(gen, N, H, W, C, scale=3.0) + 20.0).to(torch.bfloat16).permute(0, 3, 1, 2)
        w = _randn(gen, C) + 1.0
        b = _randn(gen, C, scale=0.1)
        cases = [(None, w, b), (None, w.bfloat16(), b.bfloat16())]
        if silu:
            cases.append((_randn(gen, N, C), w, b))
        if H == 256:
            cases.append((_randn(gen, C, scale=5.0), w, b))
        for shift, w_, b_ in cases:
            before = gn.LAUNCHES
            got = gn.group_norm_act(x, w_, b_, 32, eps, silu, shift)
            torch.cuda.synchronize()
            assert gn.LAUNCHES == before + 1
            assert got.dtype == torch.bfloat16 and got.shape == x.shape
            assert got.is_contiguous(memory_format=torch.channels_last)
            ref = gn.group_norm_act_reference(x, w_, b_, 32, eps, silu, shift).float()
            err = (got.float() - ref).abs()
            tol = ref.abs() * 2.0 ** -7 + ref.abs().max() * 2.0 ** -12
            assert bool((err <= tol).all()), (N, err.max().item(), ref.abs().max().item())


# every conv output of the serving trunk whose bias the kernel adds: (C, H, W), six planes
BIAS_TRUNK = [(320, 32, 32), (640, 16, 16), (1280, 8, 8), (1280, 4, 4), (4, 32, 32),
              (512, 32, 32), (512, 128, 128), (256, 256, 256), (128, 256, 256), (64, 256, 256),
              (96, 16, 16)]


@pytest.mark.parametrize("C,H,W", BIAS_TRUNK)
def test_bias_add_kernel_matches_plain(cuda, C, H, W):
    """The channels-last bias(+residual) add against its plain version (f32 sum rounded
    once): within one bf16 rounding of each value; written into its input."""
    from triplaneturbo_torch.ops import nhwc

    gen = torch.Generator(device="cuda").manual_seed(C * 3 + H)
    for residual in (False, True):
        y = _randn(gen, 6, H, W, C, dtype=torch.bfloat16).permute(0, 3, 1, 2)
        b = _randn(gen, C)
        r = (_randn(gen, 6, H, W, C, dtype=torch.bfloat16).permute(0, 3, 1, 2)
             if residual else None)
        ref = nhwc.bias_add_reference(y, b, r).float()
        before = nhwc.LAUNCHES_BIAS
        got = nhwc.bias_add(y, b, r)
        torch.cuda.synchronize()
        assert nhwc.LAUNCHES_BIAS == before + 1 and got.data_ptr() == y.data_ptr()
        err = (got.float() - ref).abs()
        assert bool((err <= ref.abs() * 2.0 ** -8).all()), err.max().item()
