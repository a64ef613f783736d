"""The arithmetic of the port's tensor-core flash-attention forward, on the CPU.

``flash_attention_tiled_reference`` repeats in plain PyTorch what the CUDA
kernel does for bf16 inputs (key tiles, base-2 online softmax with the folded
scale, -1e30 mask before the row max, P rounded to bf16 before P·V, the
normalizer from the f32 exponentials, the logsumexp back in natural log). Here
it is held against the JAX package's ``_fused_attention_fwd_impl`` (Pallas in
interpret mode) on the same numpy-seeded inputs, with the tolerances the
kernel is held to on the card: ``o`` within 1e-2 of the largest reference value
in bf16 (its own rounding is 2^-9 of it) and 1e-4 absolute in f32 (sums run in
another order), ``lse`` within 1e-4 absolute in both.
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
IDS = [c[0] for c in CASES]


def _inputs(BH, L, Lk, D, q_scale, dtype):
    rng = np.random.default_rng(L * 13 + Lk + D)
    q = (rng.normal(size=(BH, L, D)) * q_scale).astype(np.float32)
    k = rng.normal(size=(BH, Lk, D)).astype(np.float32)
    v = rng.normal(size=(BH, Lk, D)).astype(np.float32)
    jdt = jnp.bfloat16 if dtype == torch.bfloat16 else jnp.float32
    jax_in = tuple(jnp.asarray(a, dtype=jdt) for a in (q, k, v))
    torch_in = tuple(torch.tensor(a).to(dtype) for a in (q, k, v))
    return jax_in, torch_in


def _np(x):
    return np.asarray(x.astype(jnp.float32))


@pytest.mark.parametrize("return_stats", [False, True], ids=["plain", "stats"])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32], ids=["bf16", "f32"])
@pytest.mark.parametrize("case,BH,L,Lk,D,q_scale", CASES, ids=IDS)
def test_tiled_emulation_matches_pallas_interpret(case, BH, L, Lk, D, q_scale, dtype,
                                                  return_stats):
    jax_in, torch_in = _inputs(BH, L, Lk, D, q_scale, dtype)
    with pltpu.force_tpu_interpret_mode():
        ref = jap._fused_attention_fwd_impl(*jax_in, return_stats=return_stats)
    got = tfa.flash_attention_tiled_reference(*torch_in, return_stats=return_stats)
    o_ref = _np(ref[0] if return_stats else ref)
    o_got = got[0] if return_stats else got
    assert o_got.dtype == dtype and tuple(o_got.shape) == (BH, L, D)
    tol = 1e-4 if dtype == torch.float32 else 1e-2 * float(np.abs(o_ref).max())
    assert float(np.abs(o_got.float().numpy() - o_ref).max()) <= tol
    if return_stats:
        lse = got[1]
        assert lse.dtype == torch.float32 and tuple(lse.shape) == (BH, L)
        np.testing.assert_allclose(lse.numpy(), _np(ref[1]), atol=1e-4)


@pytest.mark.parametrize("kv_tile", [16, 64, 128, 1000])
def test_tiled_emulation_does_not_depend_on_the_tile(kv_tile):
    """The online softmax gives the plain softmax whatever the key tile: f32, 1e-4
    (sums in another order)."""
    _, (q, k, v) = _inputs(2, 150, 333, 64, 1.0, torch.float32)
    o_ref, lse_ref = tfa.flash_attention_reference(q, k, v, return_stats=True)
    o, lse = tfa.flash_attention_tiled_reference(q, k, v, return_stats=True, kv_tile=kv_tile)
    assert (o - o_ref).abs().max().item() <= 1e-4
    assert (lse - lse_ref).abs().max().item() <= 1e-4


def test_tiled_emulation_lse_is_in_natural_log():
    """A base-2 logsumexp would be off by a factor ln 2; the backward reads it as natural."""
    _, (q, k, v) = _inputs(1, 64, 200, 64, 1.0, torch.bfloat16)
    _, lse = tfa.flash_attention_tiled_reference(q, k, v, return_stats=True)
    s = torch.einsum("bld,bkd->blk", q.float(), k.float()) / 8.0
    assert (lse - torch.logsumexp(s, -1)).abs().max().item() <= 1e-4
    p = torch.exp(s - lse[..., None])
    assert (p.sum(-1) - 1.0).abs().max().item() <= 1e-4


def test_tiled_emulation_rounds_p_only_for_bf16():
    """bf16 inputs: P goes through bf16, so the result differs from the f32-P one by
    rounding noise but stays inside the bf16 tolerance; f32 inputs: P is not rounded."""
    _, (q, k, v) = _inputs(1, 128, 700, 64, 1.0, torch.bfloat16)
    ref = tfa.flash_attention_reference(q.float(), k.float(), v.float())
    rounded = tfa.flash_attention_tiled_reference(q, k, v).float()
    exact = tfa.flash_attention_tiled_reference(q.float(), k.float(), v.float())
    assert (exact - ref).abs().max().item() <= 1e-5
    assert (rounded - ref).abs().max().item() <= 1e-2 * ref.abs().max().item()


def test_flash_check_refuses_unaligned_inputs():
    """The kernel's 16-byte copies need 16-byte aligned rows."""
    flat = torch.zeros(128 * 64 + 8, dtype=torch.bfloat16)
    good = flat[8:].view(1, 128, 64)
    tfa._check(good, good, good)
    bad = flat[1:1 + 128 * 64].view(1, 128, 64)
    assert bad.is_contiguous()
    with pytest.raises(ValueError, match="aligned"):
        tfa._check(bad, good, good)
