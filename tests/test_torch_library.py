"""The port's library functions that no path calls yet, against the JAX package's (CPU).

``ops/triplane.py``'s quaplane and h-plane samplers (every variant) and
``get_trilinear_feature``; ``ops/grid_sample.py``'s ``grid_sample_2d`` and
``grid_sample_3d`` with points outside the map; ``utils/mesh.py``'s capacities,
``with_``, ``vertex_tangents`` (degenerate UVs: the signed clamp of the determinant)
and ``remove_outliers`` (an int and a float threshold); ``utils/ops.py``'s
``specify_gradient`` (the injected gradient), ``binary_cross_entropy``,
``perpendicular_component`` and ``dot``. Inputs come from numpy with a seed; f32 on
both sides, 1e-6 absolute, masks and indices exactly.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from triplaneturbo_tpu.ops import grid_sample as jgs
from triplaneturbo_tpu.ops import triplane as jtri
from triplaneturbo_tpu.utils import ops as jops
from triplaneturbo_tpu.utils.mesh import Mesh as JaxMesh
from triplaneturbo_torch.ops import grid_sample as tgs
from triplaneturbo_torch.ops import triplane as ttri
from triplaneturbo_torch.utils import ops as tops
from triplaneturbo_torch.utils.mesh import Mesh

TOL = 1e-6


def _close(got, want):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), atol=TOL, rtol=0)


def _planes(seed, P, C=5, N=2, H=6, W=7):
    rng = np.random.default_rng(seed)
    feats = rng.normal(size=(N, P, H, W, C)).astype(np.float32)
    # points inside the box and past it, on every axis
    pts = rng.uniform(-1.3, 1.3, size=(N, 40, 3)).astype(np.float32)
    return feats, pts


@pytest.mark.parametrize("kind, variant", [("hplanes", v) for v in
                                           (None, "v1", "v2", "v3", "v4", "v5", "v6", "v7")]
                         + [("quaplanes", v) for v in (None, "v1")])
def test_plane_samplers_match(kind, variant):
    P = 3 if kind == "hplanes" else 4
    feats, pts = _planes(sum(map(ord, f"{kind}{variant}")), P)
    fn_t = getattr(ttri, f"sample_from_{kind}")
    fn_j = getattr(jtri, f"sample_from_{kind}")
    for box_warp in (2.0, 1.5):
        want = fn_j(jnp.asarray(feats), jnp.asarray(pts), variant, box_warp)
        got = fn_t(torch.from_numpy(feats), torch.from_numpy(pts), variant, box_warp)
        assert got.shape == want.shape
        _close(got, want)


@pytest.mark.parametrize("dims", [2, 3])
def test_grid_samples_match_out_of_bounds(dims):
    rng = np.random.default_rng(dims)
    shape = (2, 5, 6, 3) if dims == 2 else (2, 4, 5, 6, 3)
    feats = rng.normal(size=shape).astype(np.float32)
    grid = rng.uniform(-1.6, 1.6, size=(2, 50, dims)).astype(np.float32)
    grid[:, :4] = [[-1.0] * dims, [1.0] * dims, [1.2] * dims, [-1.21] * dims]  # edges, past
    fn = "grid_sample_2d" if dims == 2 else "grid_sample_3d"
    want = getattr(jgs, fn)(jnp.asarray(feats), jnp.asarray(grid))
    got = getattr(tgs, fn)(torch.from_numpy(feats), torch.from_numpy(grid))
    _close(got, want)
    # a point whose every corner is outside reads zero
    assert float(got[:, 2].abs().max()) == 0.0
    if dims == 3:
        _close(ttri.get_trilinear_feature(torch.from_numpy(grid), torch.from_numpy(feats)),
               jtri.get_trilinear_feature(jnp.asarray(grid), jnp.asarray(feats)))
    else:  # and the 2x2-packed sampler, which the model uses, agrees with it
        packed = tgs.grid_sample_2d_packed(tgs.pack_2x2(torch.from_numpy(feats)),
                                           torch.from_numpy(grid))
        _close(packed, want)


def _mesh_arrays(seed):
    """A small fixed-capacity mesh: a grid of quads, two far islands, padded slots, and
    UVs with degenerate triangles (repeated and collinear UVs)."""
    rng = np.random.default_rng(seed)
    n = 4
    xs, ys = np.meshgrid(np.arange(n), np.arange(n), indexing="ij")
    v = np.stack([xs.ravel(), ys.ravel(), rng.normal(size=n * n) * 0.1], -1)
    faces = []
    for i in range(n - 1):
        for j in range(n - 1):
            a, b, c, d = i * n + j, i * n + j + 1, (i + 1) * n + j, (i + 1) * n + j + 1
            faces += [[a, b, c], [b, d, c]]
    islands = np.array([[10, 10, 0], [11, 10, 0], [10, 11, 0], [20, 0, 0], [21, 0, 0],
                        [20, 1, 0], [21, 1, 0]], float)
    base = len(v)
    faces += [[base, base + 1, base + 2], [base + 3, base + 4, base + 5],
              [base + 4, base + 6, base + 5]]
    v = np.concatenate([v, islands])
    V, F = len(v) + 3, len(faces) + 4  # padded capacity
    v_pos = np.zeros((V, 3), np.float32)
    v_pos[:len(v)] = v
    t_idx = np.zeros((F, 3), np.int32)
    t_idx[:len(faces)] = faces
    v_mask = np.zeros(V, bool)
    v_mask[:len(v)] = True
    t_mask = np.zeros(F, bool)
    t_mask[:len(faces)] = True
    uv = rng.uniform(size=(V, 2)).astype(np.float32)
    uv[1] = uv[0]  # face 0 has a repeated UV: determinant 0
    uv[5] = uv[4] + 0.5 * (uv[6] - uv[4])  # collinear UVs on another face
    return v_pos, t_idx, v_mask, t_mask, uv


def test_mesh_capacities_with_and_vertex_tangents_on_degenerate_uvs():
    v_pos, t_idx, v_mask, t_mask, uv = _mesh_arrays(0)
    jm = JaxMesh(v_pos=jnp.asarray(v_pos), t_pos_idx=jnp.asarray(t_idx),
                 v_mask=jnp.asarray(v_mask), t_mask=jnp.asarray(t_mask), v_tex=jnp.asarray(uv))
    tm = Mesh(v_pos=torch.from_numpy(v_pos), t_pos_idx=torch.from_numpy(t_idx).long(),
              v_mask=torch.from_numpy(v_mask), t_mask=torch.from_numpy(t_mask),
              v_tex=torch.from_numpy(uv))
    assert (tm.num_capacity_verts, tm.num_capacity_faces) == (jm.num_capacity_verts,
                                                              jm.num_capacity_faces)
    _close(tm.vertex_tangents(), jm.vertex_tangents())
    # given normals, and UV indices of their own
    nrm = np.random.default_rng(1).normal(size=v_pos.shape).astype(np.float32)
    nrm /= np.linalg.norm(nrm, axis=-1, keepdims=True)
    tex_idx = t_idx[:, ::-1].copy()
    _close(tm.with_(v_nrm=torch.from_numpy(nrm)).vertex_tangents(
        torch.from_numpy(tex_idx).long()),
        jm.with_(v_nrm=jnp.asarray(nrm)).vertex_tangents(jnp.asarray(tex_idx)))
    assert tm.with_(v_tex=None).v_tex is None and tm.v_tex is not None
    with pytest.raises(ValueError, match="v_tex"):
        tm.with_(v_tex=None).vertex_tangents()


# the mesh's components have 18, 2 and 1 faces: an int threshold counts faces, a float
# one is a share of the largest component's
@pytest.mark.parametrize("threshold, kept", [(2, 20), (3, 18), (0.05, 21), (0.1, 20),
                                             (0.3, 18)])
def test_remove_outliers_matches(threshold, kept):
    v_pos, t_idx, v_mask, t_mask, _ = _mesh_arrays(2)
    jm = JaxMesh(v_pos=jnp.asarray(v_pos), t_pos_idx=jnp.asarray(t_idx),
                 v_mask=jnp.asarray(v_mask), t_mask=jnp.asarray(t_mask)).remove_outliers(threshold)
    tm = Mesh(v_pos=torch.from_numpy(v_pos), t_pos_idx=torch.from_numpy(t_idx).long(),
              v_mask=torch.from_numpy(v_mask),
              t_mask=torch.from_numpy(t_mask)).remove_outliers(threshold)
    np.testing.assert_array_equal(tm.t_mask.numpy(), np.asarray(jm.t_mask))
    np.testing.assert_array_equal(tm.v_mask.numpy(), np.asarray(jm.v_mask))
    assert tm.v_pos.shape == v_pos.shape and tm.t_pos_idx.shape == t_idx.shape
    assert int(tm.t_mask.sum()) == kept


def test_specify_gradient_injects_its_gradient():
    rng = np.random.default_rng(5)
    x = rng.normal(size=(2, 3, 4)).astype(np.float32)
    g = rng.normal(size=(2, 3, 4)).astype(np.float32)

    def jax_loss(x_):
        return 3.0 * jops.specify_gradient(x_ * 2.0, jnp.asarray(g))

    want = jax.grad(jax_loss)(jnp.asarray(x))
    xt = torch.from_numpy(x).requires_grad_(True)
    gt = torch.from_numpy(g).requires_grad_(True)
    out = 3.0 * tops.specify_gradient(xt * 2.0, gt)
    assert out.shape == () and float(out.detach()) == 0.0 and out.dtype == torch.float32
    out.backward()
    _close(xt.grad, want)
    assert float(gt.grad.abs().max()) == 0.0


def test_loss_helpers_match():
    rng = np.random.default_rng(6)
    p = rng.uniform(-0.1, 1.1, size=(3, 7)).astype(np.float32)
    t = rng.uniform(size=(3, 7)).astype(np.float32)
    _close(tops.binary_cross_entropy(torch.from_numpy(p), torch.from_numpy(t)),
           jops.binary_cross_entropy(jnp.asarray(p), jnp.asarray(t)))
    for shape in ((5,), (4, 3), (2, 3, 4)):
        x = rng.normal(size=shape).astype(np.float32)
        y = rng.normal(size=shape).astype(np.float32)
        y[0] = 0.0  # a zero row: the 1e-8 clamp
        _close(tops.perpendicular_component(torch.from_numpy(x), torch.from_numpy(y)),
               jops.perpendicular_component(jnp.asarray(x), jnp.asarray(y)))
        _close(tops.dot(torch.from_numpy(x), torch.from_numpy(y)),
               jops.dot(jnp.asarray(x), jnp.asarray(y)))
