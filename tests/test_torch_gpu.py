"""The port's CUDA kernels against their plain versions, on the card.

Every test here needs a CUDA device and skips without one. They import
neither JAX nor the JAX package, so they run where only PyTorch is
installed:

    python -m pytest tests/test_torch_gpu.py -m gpu -o "markers=gpu: needs a CUDA device" -q --noconftest -p no:cacheprovider

Float32 matmuls run with TF32 off, so the f32 comparisons are against
full-f32 PyTorch.
"""

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
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    yield torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = prev


def _randn(gen, *shape, dtype=torch.float32, scale=1.0):
    return (torch.randn(*shape, generator=gen, device="cuda") * scale).to(dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("BH,L,Lk,D", [(3, 256, 256, 64), (2, 700, 700, 64), (4, 300, 77, 64),
                                       (2, 1, 5, 64), (2, 200, 130, 512)])
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


BWD_CASES = [(3, 256, 256, 64), (2, 700, 700, 64), (2, 300, 1200, 64), (4, 300, 77, 64),
             (2, 1, 5, 64), (2, 200, 130, 512)]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("BH,L,Lk,D", BWD_CASES)
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


def test_flash_backward_is_the_same_from_run_to_run(cuda):
    gen = torch.Generator(device="cuda").manual_seed(3)
    q, k, v = (_randn(gen, 4, n, 64).requires_grad_() for n in (700, 333, 333))
    g = _randn(gen, 4, 700, 64)
    a = torch.autograd.grad(fa.flash_attention(q, k, v), (q, k, v), g)
    b = torch.autograd.grad(fa.flash_attention(q, k, v), (q, k, v), g)
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
    assert fa.LAUNCHES == before + 1


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


@pytest.mark.parametrize("R,concat", [(16, False), (37, True), (160, False)])
def test_field_grid_kernel_matches_plain(cuda, R, concat):
    gen = torch.Generator(device="cuda").manual_seed(R)
    C = 32
    cin = 3 * C if concat else C
    m = [_randn(gen, R, R, C, scale=0.3) for _ in range(3)]
    ws = [_randn(gen, cin, 64, scale=0.1), _randn(gen, 64, 64, scale=0.1),
          _randn(gen, 64, 1, scale=0.1), _randn(gen, cin, 64, scale=0.1),
          _randn(gen, 64, 64, scale=0.1), _randn(gen, 64, 3, scale=0.1)]
    before = fg.LAUNCHES
    sdf, deform = fg.fused_field_grid(*m, *ws, 1.0, 0.5, concat)
    torch.cuda.synchronize()
    assert fg.LAUNCHES == before + 1
    sdf_r, deform_r = fg.field_grid_reference(*m, *ws, 1.0, 0.5, concat)
    assert sdf.shape == (R, R, R) and deform.shape == (3, R, R, R)
    assert np.isfinite(sdf.cpu().numpy()).all()
    assert (sdf - sdf_r).abs().max().item() <= 1e-4
    assert (deform - deform_r).abs().max().item() <= 1e-4
