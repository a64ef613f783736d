"""The arithmetic of the port's tensor-core flash-attention backward, on the CPU.

``flash_attention_bwd_tiled_reference`` repeats in plain PyTorch what the CUDA
kernels do for bf16 inputs (query and key tiles zero-filled past L and Lk,
base-2 exponentials from lse·log2(e), P set to 0 past Lk and L, P and dS
rounded to bf16 before their products, f32 sums, scale at the store; dk and dv
from the transposes, so lse and δ are read by column). Here it is held against
the JAX package's ``_flash_bwd_impl`` (both Pallas kernels in interpret mode)
on the same numpy-seeded inputs, forward output and logsumexp, with the
tolerances the kernels are held to on the card: each of dq, dk, dv within 1e-2
of its largest reference value in bf16 (P and dS rounded to bf16 add about
2^-9 relative noise a term), but never tighter than the 1e-4 absolute that f32
is held to (sums run in another order). The floor matters only where an output
vanishes: with one key P = 1, so dS = dP - delta is the f32 rounding of a
difference of equals, and dq and dk are rounding noise of order 1e-6.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

import triplaneturbo_tpu.ops.attention_pallas as jap
from triplaneturbo_torch.ops import flash_attention as tfa

torch.set_num_threads(2)

# (case, BH, L, Lk, D, scale of q)
CASES = [
    ("ragged-700-700", 2, 700, 700, 64, 1.0),
    ("ragged-300-1200", 2, 300, 1200, 64, 1.0),
    ("cross-256-77", 2, 256, 77, 64, 1.0),
    ("one-key-130-1", 2, 130, 1, 64, 1.0),
    ("d512-96-130", 1, 96, 130, 512, 1.0),
    ("q-times-8-300-300", 2, 300, 300, 64, 8.0),
]
# A negative scale makes every query that multiple of the first key: one very negative
# score a row, so that lse is about -96 and the zero-filled keys of a tile would give
# P = exp(96), past the f32 range, without the mask. bf16 only: in f32 an exponent
# argument of -96 carries about 6e-6 of rounding in any formulation (the JAX kernel's
# too), which 130 queries sum past the 1e-4 absolute of f32.
LOW_SCORE = ("one-key-low-score-130-1", 2, 130, 1, 64, -12.0)
DTYPE_CASES = ([pytest.param(*c, dt, id=f"{c[0]}-{name}") for c in CASES
                for dt, name in ((torch.bfloat16, "bf16"), (torch.float32, "f32"))]
               + [pytest.param(*LOW_SCORE, torch.bfloat16, id=f"{LOW_SCORE[0]}-bf16")])


def _inputs(BH, L, Lk, D, q_scale, dtype):
    """q, k, v, g in both frameworks, and the JAX forward's o and lse (Pallas in
    interpret mode) as the saved residuals of both backwards."""
    rng = np.random.default_rng(L * 17 + Lk + D)
    k = rng.normal(size=(BH, Lk, D)).astype(np.float32)
    if q_scale < 0:
        q = (q_scale * k[:, :1] + 0.1 * rng.normal(size=(BH, L, D))).astype(np.float32)
    else:
        q = (rng.normal(size=(BH, L, D)) * q_scale).astype(np.float32)
    v = rng.normal(size=(BH, Lk, D)).astype(np.float32)
    g = rng.normal(size=(BH, L, D)).astype(np.float32)
    jdt = jnp.bfloat16 if dtype == torch.bfloat16 else jnp.float32
    jq, jk, jv, jg = (jnp.asarray(a, dtype=jdt) for a in (q, k, v, g))
    with pltpu.force_tpu_interpret_mode():
        o, lse = jap._fused_attention_fwd_impl(jq, jk, jv, return_stats=True)
    tq, tk, tv, tg = (torch.tensor(a).to(dtype) for a in (q, k, v, g))
    to = torch.tensor(np.asarray(o.astype(jnp.float32))).to(dtype)
    tlse = torch.tensor(np.asarray(lse, dtype=np.float32))
    return (jq, jk, jv, o, lse, jg), (tq, tk, tv, to, tlse, tg)


@pytest.mark.parametrize("case,BH,L,Lk,D,q_scale,dtype", DTYPE_CASES)
def test_bwd_tiled_emulation_matches_pallas_interpret(case, BH, L, Lk, D, q_scale, dtype):
    jax_in, torch_in = _inputs(BH, L, Lk, D, q_scale, dtype)
    with pltpu.force_tpu_interpret_mode():
        refs = jap._flash_bwd_impl(*jax_in)
    got = tfa.flash_attention_bwd_tiled_reference(*torch_in)
    for name, a, ref in zip(("dq", "dk", "dv"), got, refs):
        ref = np.asarray(ref.astype(jnp.float32))
        assert a.dtype == dtype and tuple(a.shape) == ref.shape, name
        assert np.isfinite(ref).all(), name
        tol = 1e-4 if dtype == torch.float32 else max(1e-2 * float(np.abs(ref).max()), 1e-4)
        err = float(np.abs(a.float().numpy() - ref).max())
        assert err <= tol, (name, err, tol)


@pytest.mark.parametrize("q_tile,kv_tile", [(16, 64), (64, 64), (64, 128), (128, 32), (1000, 1000)])
def test_bwd_tiled_emulation_does_not_depend_on_the_tiles(q_tile, kv_tile):
    """f32: every tiling gives the plain backward, to 1e-4 (sums in another order)."""
    _, (q, k, v, o, lse, g) = _inputs(2, 150, 333, 64, 1.0, torch.float32)
    refs = tfa.flash_attention_bwd_reference(q, k, v, o, lse, g)
    got = tfa.flash_attention_bwd_tiled_reference(q, k, v, o, lse, g, q_tile=q_tile,
                                                  kv_tile=kv_tile)
    for name, a, ref in zip(("dq", "dk", "dv"), got, refs):
        assert (a - ref).abs().max().item() <= 1e-4, name


def test_bwd_tiled_emulation_rounds_p_and_ds_only_for_bf16():
    """bf16 inputs: P and dS go through bf16, so the result differs from the f32-P
    one by rounding noise inside the bf16 tolerance; f32 inputs: nothing is rounded."""
    _, (q, k, v, o, lse, g) = _inputs(1, 128, 300, 64, 1.0, torch.bfloat16)
    f32 = [t.float() for t in (q, k, v, o, g)]
    refs = tfa.flash_attention_bwd_reference(*f32[:4], lse, f32[4])
    exact = tfa.flash_attention_bwd_tiled_reference(*f32[:4], lse, f32[4])
    rounded = tfa.flash_attention_bwd_tiled_reference(q, k, v, o, lse, g)
    moved = 0.0
    for a, b, ref in zip(exact, rounded, refs):
        assert (a - ref).abs().max().item() <= 1e-5
        assert (b.float() - ref).abs().max().item() <= 1e-2 * ref.abs().max().item()
        moved = max(moved, (b.float() - a).abs().max().item())
    assert moved > 0.0


def test_bwd_args_refuse_an_unaligned_cotangent():
    """The backward kernels stage g with 16-byte copies, as they do q, k and v."""
    flat = torch.zeros(128 * 64 + 8, dtype=torch.bfloat16)
    good = flat[8:].view(1, 128, 64)
    lse = torch.zeros(1, 128)
    tfa._bwd_args(good, good, good, good, lse, lse)
    bad = flat[1:1 + 128 * 64].view(1, 128, 64)
    assert bad.is_contiguous()
    with pytest.raises(ValueError, match="aligned g"):
        tfa._bwd_args(good, good, good, bad, lse, lse)
