"""The split-TF32 arithmetic of the tensor-core field-grid kernel, on the CPU.

``field_grid_split_tf32_reference`` repeats what ``csrc/field_grid.cu`` computes:
h1 and the W2 blocks split into TF32 hi and lo parts, three products summed in
f32. It is held here against the JAX package on numpy-seeded inputs: the unfused
``_reference_field_grid`` at every R, and the Pallas kernel in interpret mode
where its tiles divide R (``_pallas_forward`` takes R % 8 == 0).

Tolerance: 2e-6 absolute. Measured on these inputs the three-product form is
within 2.4e-7 of the JAX reference (the f32 field's own rounding, as the plain
PyTorch version is), the one-product form (lo parts dropped, plain TF32) 2.0e-5
(R = 1) to 1.8e-4 (R = 37): the limit sits eight times above the first and ten
times below the second, so the test sees whether the split is there.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import triplaneturbo_tpu.ops.field_grid_pallas as jfg
from triplaneturbo_torch.ops import field_grid as tfg

TOL = 2e-6


def _inputs(seed, R, C=32, concat=False):
    rng = np.random.default_rng(seed)
    cin = 3 * C if concat else C

    def normal(*shape, scale):
        return (rng.standard_normal(shape) * scale).astype(np.float32)

    return [normal(R, R, C, scale=0.3) for _ in range(3)] + [
        normal(cin, 64, scale=0.1), normal(64, 64, scale=0.1), normal(64, 1, scale=0.1),
        normal(cin, 64, scale=0.1), normal(64, 64, scale=0.1), normal(64, 3, scale=0.1)]


def _split_field(args, concat):
    m_xy, m_xz, m_zy, w1s, w2s, w3s, w1d, w2d, w3d = (torch.from_numpy(a) for a in args)
    prepped = tfg._prep(m_xy, m_xz, m_zy, w1s, w1d, w2s, w2d, w3s, w3d, concat)
    return tfg.field_grid_split_tf32_reference(*prepped, 1.0, 0.5)


def _err(got, want):
    return max(float(np.abs(g.numpy() - np.asarray(w)).max()) for g, w in zip(got, want))


@pytest.mark.parametrize("concat", [False, True])
@pytest.mark.parametrize("R", [1, 8, 37])
def test_split_tf32_field_matches_the_jax_package(R, concat):
    args = _inputs(R + concat, R, concat=concat)
    sdf, deform = _split_field(args, concat)
    assert sdf.shape == (R, R, R) and deform.shape == (3, R, R, R)
    assert sdf.dtype == torch.float32 and deform.dtype == torch.float32
    ref = jfg._reference_field_grid(*map(jnp.asarray, args), 1.0, 0.5, concat)
    assert _err((sdf, deform), ref) <= TOL
    if R % 8 == 0:
        pallas = jfg.fused_field_grid(*map(jnp.asarray, args), 1.0, 0.5, concat, True)
        assert _err((sdf, deform), pallas) <= TOL


@pytest.mark.parametrize("concat", [False, True])
def test_one_tf32_product_exceeds_the_tolerance(concat, monkeypatch):
    """With the lo parts dropped (a plain TF32 product) the same inputs miss the limit:
    the tolerance is tight enough to see the split."""
    monkeypatch.setattr(tfg, "_tf32_split", lambda x: (tfg._tf32_rna(x), torch.zeros_like(x)))
    args = _inputs(8 + concat, 8, concat=concat)
    ref = jfg._reference_field_grid(*map(jnp.asarray, args), 1.0, 0.5, concat)
    assert _err(_split_field(args, concat), ref) > 10 * TOL


def test_tf32_rounding_is_to_nearest_with_ties_away_from_zero():
    ulp = 2.0 ** -10  # TF32's step at 1
    x = torch.tensor([1 + ulp / 2, -(1 + ulp / 2), 1 + ulp / 2 - 2.0 ** -23, 1 + 3 * ulp / 4,
                      3.0, 0.0], dtype=torch.float32)
    want = torch.tensor([1 + ulp, -(1 + ulp), 1.0, 1 + ulp, 3.0, 0.0], dtype=torch.float32)
    got = tfg._tf32_rna(x)
    assert torch.equal(got, want)
    assert not bool((got.view(torch.int32) & 0x1FFF).any())


def test_tf32_split_keeps_the_value_to_f32_rounding():
    x = torch.from_numpy(np.random.default_rng(0).standard_normal(4096).astype(np.float32))
    hi, lo = tfg._tf32_split(x)
    assert not bool((hi.view(torch.int32) & 0x1FFF).any())
    assert not bool((lo.view(torch.int32) & 0x1FFF).any())
    # hi + lo carries 22 of the 24 bits: within 2^-21 of |x|
    assert bool(((hi + lo - x).abs() <= 2.0 ** -21 * x.abs()).all())
    assert bool(((hi - x).abs() <= 2.0 ** -11 * x.abs()).all())


def test_split_reference_reads_only_the_diagonal_blocks_of_w2():
    """Like the kernel, it never multiplies W2blk's zero blocks: filling them changes nothing."""
    args = _inputs(5, 8)
    m_xy, m_xz, m_zy, w1s, w2s, w3s, w1d, w2d, w3d = (torch.from_numpy(a) for a in args)
    a_xy, a_xz, a_zy, w2blk, w3t = tfg._prep(m_xy, m_xz, m_zy, w1s, w1d, w2s, w2d, w3s, w3d,
                                             False)
    filled = w2blk.clone()
    filled[:64, 64:] = 1.0
    filled[64:, :64] = -1.0
    a = tfg.field_grid_split_tf32_reference(a_xy, a_xz, a_zy, w2blk, w3t, 1.0, 0.5)
    b = tfg.field_grid_split_tf32_reference(a_xy, a_xz, a_zy, filled, w3t, 1.0, 0.5)
    assert all(torch.equal(x, y) for x, y in zip(a, b))
