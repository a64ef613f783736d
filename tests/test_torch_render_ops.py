"""The first renderer's operations in the PyTorch port against the JAX package
on the CPU: cameras, the data module, the mesh quantities, the rasterizer
(bin, select, recompute, interpolate, antialias), the hash grid and the
background, each fed the same numpy inputs at a small size.

The rasterizer's winner (``face_id``) must be equal on every pixel: both
packages evaluate the same float32 expressions in the same order, so a
difference would be a porting error, not rounding.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from triplaneturbo_tpu.data import multiview_multiprompt as jdata
from triplaneturbo_tpu.models.background import hashgrid_env_map as jbg
from triplaneturbo_tpu.ops import hashgrid as jhash
from triplaneturbo_tpu.ops import rasterize as jr
from triplaneturbo_tpu.utils import camera as jcam
from triplaneturbo_tpu.utils import ops as jops
from triplaneturbo_tpu.utils.mesh import Mesh as JMesh
from triplaneturbo_torch.data import multiview_multiprompt as tdata
from triplaneturbo_torch.models.background import hashgrid_env_map as tbg
from triplaneturbo_torch.ops import hashgrid as thash
from triplaneturbo_torch.ops import rasterize as tr
from triplaneturbo_torch.ops.isosurface import extract_isosurface
from triplaneturbo_torch.utils import camera as tcam
from triplaneturbo_torch.utils import ops as tops
from triplaneturbo_torch.utils.mesh import Mesh as TMesh
from triplaneturbo_torch.utils.weights import (
    flax_tree_to_named,
    load_flax_params,
    named_to_flax_tree,
)

torch.set_num_threads(2)
CAM_TOL = 1e-6
RIG_TOL = 1e-5
RASTER_TOL = 1e-5
# f32 sums over many terms taken in other orders: 1e-4 of each leaf's largest value
REL_TOL = 1e-4


def _t(x):
    return torch.tensor(np.asarray(x))


# JAX runs jitted: op by op it compiles every primitive on first use
_RAST_STATIC = ("H", "W", "tile", "faces_per_tile", "max_span", "select_chunk", "big_face_cap")
j_rasterize = jax.jit(jr.rasterize, static_argnames=_RAST_STATIC)


def _extract(sdf, deform=None, **cap):
    """A fixed-capacity marching-cubes mesh (the port's extraction, which the
    isosurface tests hold against the JAX package's), as numpy."""
    m = extract_isosurface(_t(sdf), None if deform is None else _t(deform), method="mc", **cap)
    return (m.verts.numpy() * 2 - 1, m.faces.numpy().astype(np.int32), m.vert_mask.numpy(),
            m.face_mask.numpy())


def _close(got, want, tol, what="", rel=False):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    assert np.isfinite(got).all(), what
    atol = tol * max(float(np.abs(want).max()), 1e-12) if rel else tol
    np.testing.assert_allclose(got, want, atol=atol, rtol=0, err_msg=what)


# -- cameras -----------------------------------------------------------------


def _angles(rng, B=5):
    return (rng.uniform(-0.3, 1.2, B).astype(np.float32), rng.uniform(-3.2, 6.3, B).astype(np.float32),
            rng.uniform(1.0, 3.5, B).astype(np.float32), rng.uniform(0.5, 1.2, B).astype(np.float32))


def test_camera_functions_match():
    rng = np.random.default_rng(0)
    elev, azim, dist, fovy = _angles(rng)
    center = rng.normal(size=(5, 3)).astype(np.float32) * 0.1
    c2w_j = jcam.camera_to_world(jnp.asarray(elev), jnp.asarray(azim), jnp.asarray(dist),
                                 jnp.asarray(center))
    c2w_t = tcam.camera_to_world(_t(elev), _t(azim), _t(dist), _t(center))
    _close(c2w_t, c2w_j, CAM_TOL, "camera_to_world")
    c2w = np.asarray(c2w_j)
    _close(tcam.rigid_inverse(_t(c2w)), jcam.rigid_inverse(jnp.asarray(c2w)), CAM_TOL,
           "rigid_inverse")
    proj_j = jcam.get_projection_matrix(jnp.asarray(fovy), 1.5, 0.1, 100.0)
    _close(tcam.get_projection_matrix(_t(fovy), 1.5, 0.1, 100.0), proj_j, CAM_TOL, "projection")
    _close(tcam.get_mvp_matrix(_t(c2w), _t(proj_j)), jcam.get_mvp_matrix(jnp.asarray(c2w), proj_j),
           CAM_TOL * 100, "mvp")  # entries up to ~100: 1e-6 relative
    _close(tcam.mvdream_normalize_camera(_t(c2w)), jcam.mvdream_normalize_camera(jnp.asarray(c2w)),
           CAM_TOL, "mvdream_normalize_camera")
    dirs_j = jcam.get_ray_directions(6, 10, jnp.asarray(fovy))
    dirs_t = tcam.get_ray_directions(6, 10, _t(fovy))
    _close(dirs_t, dirs_j, CAM_TOL, "get_ray_directions")
    for keepdim in (True, False):
        for normalize in (True, False):
            ro_j, rd_j = jcam.get_rays(dirs_j, jnp.asarray(c2w), keepdim, normalize)
            ro_t, rd_t = tcam.get_rays(_t(dirs_j), _t(c2w), keepdim, normalize)
            _close(ro_t, ro_j, CAM_TOL, "rays_o")
            _close(rd_t, rd_j, CAM_TOL, "rays_d")


def test_camera_rig_np_matches_the_traced_path():
    """The host rig equals mvp(camera_to_world, projection) of the port's tensor path."""
    elev = np.array([0.0, 15.0, 30.0, -10.0, 89.0])
    azim = np.array([0.0, 90.0, 180.0, 270.0, 360.0])
    for radius, fovy in ((3.0, 40.0), (1.5, 60.0)):
        rig = tcam.camera_rig_np(elev, azim, radius, fovy, 1.0, 0.1, 100.0)
        np.testing.assert_array_equal(rig, jcam.camera_rig_np(elev, azim, radius, fovy, 1.0,
                                                              0.1, 100.0))
        c2w = tcam.camera_to_world(_t(np.deg2rad(elev)), _t(np.deg2rad(azim)),
                                   torch.full((5,), radius, dtype=torch.float64))
        proj = tcam.get_projection_matrix(torch.full((5,), np.deg2rad(fovy), dtype=torch.float64),
                                          1.0, 0.1, 100.0)
        mvp = tcam.get_mvp_matrix(c2w, proj).float()
        _close(mvp, rig, RIG_TOL, f"rig r={radius}")


# -- data module ---------------------------------------------------------------


def _assert_batches_equal(a, b):
    assert set(a) == set(b)
    for k in a:
        if isinstance(a[k], np.ndarray):
            assert a[k].dtype == b[k].dtype, k
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)
        else:
            assert a[k] == b[k], k


@pytest.mark.parametrize("seed", [0, 5])
def test_data_module_gives_the_jax_batches(seed):
    kw = dict(height=32, width=32, ray_height=8, ray_width=8, n_steps=3, batch_size=8)
    jdm = jdata.MultiviewMultipromptDataModule(jdata.DataModuleConfig(**kw), seed=seed)
    tdm = tdata.MultiviewMultipromptDataModule(tdata.DataModuleConfig(**kw), seed=seed)
    assert tdm.library == jdm.library and len(tdm.library["train"]) == 415
    for _ in range(2):
        for a, b in zip(tdm.sample_train_batch(), jdm.sample_train_batch()):
            _assert_batches_equal(a, b)
    _assert_batches_equal(tdm.eval_views("a chair", 5), jdm.eval_views("a chair", 5))
    tdm.update_step(3)
    jdm.update_step(3)
    assert tdm.sup_or_unsup == jdm.sup_or_unsup == "unsup"
    batch = tdm.to_device(tdm.sample_train_batch()[0], "cpu")
    assert batch["mvp_mtx"].dtype == torch.float32 and len(batch["prompt"]) == 2
    assert batch["height"] == 32 and tuple(batch["noise"].shape) == (2, 6, 32, 32, 4)


@pytest.mark.parametrize("library", ["objaverse_debug", "None"])
def test_data_module_refuses_the_supervised_branch(library):
    """No trainer of either package consumes supervised batches, so a library other than
    "none" (in any case) is refused."""
    cfg = tdata.DataModuleConfig(obj_library=library)
    if library.lower() == "none":
        assert tdata.MultiviewMultipromptDataModule(cfg).data_schedule == ["unsup"]
        return
    with pytest.raises(ValueError, match="no loss path"):
        tdata.MultiviewMultipromptDataModule(cfg)


# -- safe_normalize, chunk_batch, mesh -----------------------------------------


def test_safe_normalize_and_chunk_batch():
    rng = np.random.default_rng(1)
    x = rng.normal(size=(7, 5, 3)).astype(np.float32)
    x[2] = 0.0
    _close(tops.safe_normalize(_t(x)), jops.safe_normalize(jnp.asarray(x)), 1e-6, "value")
    xt = _t(x).requires_grad_()
    (g,) = torch.autograd.grad(tops.safe_normalize(xt).sum(), xt)
    gj = jax.grad(lambda v: jops.safe_normalize(v).sum())(jnp.asarray(x))
    _close(g, gj, 1e-5, "gradient")  # finite on the zero row (1/eps there, as in JAX)
    y = rng.normal(size=(10, 4)).astype(np.float32)
    for chunk in (0, 3, 4, 10, 64):
        out = tops.chunk_batch(lambda v, s: v * s + v.sum(-1, keepdim=True), chunk, _t(y), 2.0)
        want = jops.chunk_batch(lambda v, s: v * s + v.sum(-1, keepdims=True), chunk,
                                jnp.asarray(y), 2.0)
        _close(out, want, 1e-6, f"chunk {chunk}")


def _padded_mesh(rng):
    """A marching-cubes sphere in a fixed-capacity buffer with padded slots."""
    g = np.linspace(-1, 1, 10, dtype=np.float32)
    X, Y, Z = np.meshgrid(g, g, g, indexing="ij")
    sdf = np.sqrt(X ** 2 + Y ** 2 + (1.3 * Z) ** 2) - 0.6 + 0.05 * rng.normal(size=X.shape)
    return _extract(sdf.astype(np.float32), max_verts=1024, max_faces=2048)


def test_mesh_normals_and_regularizers_match():
    v, f, vm, fm = _padded_mesh(np.random.default_rng(2))
    assert (~vm).any() and (~fm).any()
    jm = JMesh(v_pos=jnp.asarray(v), t_pos_idx=jnp.asarray(f), v_mask=jnp.asarray(vm),
               t_mask=jnp.asarray(fm))
    vt = _t(v).requires_grad_()
    tm = TMesh(v_pos=vt, t_pos_idx=_t(f).long(), v_mask=_t(vm), t_mask=_t(fm))
    for name, tol in (("face_normals", 1e-5), ("vertex_normals", 1e-5),
                      ("normal_consistency", 1e-6), ("laplacian", 1e-6)):
        _close(getattr(tm, name)(), jax.jit(lambda m: getattr(m, name)())(jm), tol, name)
    for name in ("normal_consistency", "laplacian"):
        (g,) = torch.autograd.grad(getattr(tm, name)(), vt)
        gj = jax.jit(jax.grad(lambda p: getattr(JMesh(
            v_pos=p, t_pos_idx=jnp.asarray(f), v_mask=jnp.asarray(vm), t_mask=jnp.asarray(fm)),
            name)()))(jnp.asarray(v))
        _close(g, gj, REL_TOL, name, rel=True)
        # padded slots sit at the origin: zero rows with finite, zero gradients
        assert not g[~_t(vm)].any()


# -- rasterizer ----------------------------------------------------------------


def _simple_cam():
    c2w = jcam.camera_to_world(jnp.asarray([0.0]), jnp.asarray([0.0]), jnp.asarray([3.0]))
    proj = jcam.get_projection_matrix(jnp.asarray([jnp.deg2rad(45.0)]), 1.0, 0.1, 100.0)
    return np.asarray(jcam.get_mvp_matrix(c2w, proj)[0])


def _clip(verts, mvp=None):
    verts = np.asarray(verts, np.float32)
    vh = np.concatenate([verts, np.ones_like(verts[:, :1])], -1)
    return (vh @ (np.eye(4, dtype=np.float32) if mvp is None else mvp).T).astype(np.float32)


_TRI = np.array([[0.0, -0.5, -0.5], [0.0, 0.5, -0.5], [0.0, 0.0, 0.6]], np.float32)


def _scenes():
    cam = _simple_cam()
    near, far = _TRI.copy(), _TRI.copy()
    near[:, 0], far[:, 0] = 0.5, -0.5
    big = [[-4.0, -4.0, 0.8], [4.0, -4.0, 0.8], [0.0, 4.0, 0.8],
           [-0.2, -0.2, 0.1], [0.2, -0.2, 0.1], [0.0, 0.2, 0.1]]
    small = np.array([[-0.1, -0.1, 0.0], [0.1, -0.1, 0.0], [0.0, 0.1, 0.0]], np.float32)
    collapsed = np.array([[-0.8, -0.8, 0.5, 1.0], [0.8, -0.8, 0.5, 1.0], [0.0, 0.8, 0.5, 1.0],
                          [0.1, 0.1, -0.9, 1.0]], np.float32)
    padded = np.concatenate([_TRI, np.zeros((1, 3), np.float32)])
    rng = np.random.default_rng(0)
    soup = rng.uniform(-0.5, 0.5, (300, 3)).astype(np.float32)
    one = np.array([[0, 1, 2]])
    return {
        "single triangle": (_clip(_TRI, cam), one, None, 64, dict(tile=16, faces_per_tile=16)),
        "depth order": (_clip(np.concatenate([far, near]), cam), np.array([[0, 1, 2], [3, 4, 5]]),
                        None, 64, dict(tile=16, faces_per_tile=16)),
        "face mask": (_clip(_TRI, cam), one, np.array([False]), 32,
                      dict(tile=16, faces_per_tile=16)),
        "collapsed face": (collapsed, np.array([[0, 1, 2], [3, 3, 3]]), np.array([True, True]), 32,
                           dict(tile=8, faces_per_tile=16, max_span=4)),
        "padded degenerate faces": (_clip(padded, cam), np.array([[0, 1, 2], [0, 0, 0], [3, 3, 3]]),
                                    np.array([True, False, False]), 32,
                                    dict(tile=16, faces_per_tile=8)),
        "span overflow": (_clip(big[:3]), one, None, 64, dict(tile=8, faces_per_tile=16)),
        "big-face list": (_clip(big), np.array([[0, 1, 2], [3, 4, 5]]), None, 64,
                          dict(tile=8, faces_per_tile=16, big_face_cap=8)),
        "list overflow": (_clip(small), np.tile(one, (40, 1)), None, 32,
                          dict(tile=16, faces_per_tile=4)),
        # three distinct corners a face: with two equal corners the area is a·b − b·a,
        # which jitted XLA contracts into an FMA and leaves at rounding level, where
        # the port (and JAX op by op) give 0; the scenes above hold the degenerate faces
        "face soup": (_clip(soup, cam), np.stack([rng.choice(300, 3, replace=False)
                                                  for _ in range(500)]), None, 64,
                      dict(tile=16, faces_per_tile=32, select_chunk=8)),
    }


def _mc_scene():
    """A marching-cubes mesh at R = 12 seen by a training camera at 32²."""
    rng = np.random.default_rng(3)
    g = np.linspace(-1, 1, 12, dtype=np.float32)
    X, Y, Z = np.meshgrid(g, g, g, indexing="ij")
    sdf = np.sqrt(X ** 2 + (1.2 * Y) ** 2 + Z ** 2) - 0.55 + 0.08 * rng.normal(size=X.shape)
    deform = rng.normal(size=(12, 12, 12, 3)).astype(np.float32) * 0.1
    verts, faces, _, fmask = _extract(sdf.astype(np.float32), deform, max_verts=2048,
                                      max_faces=4096)
    cfg = jdata.DataModuleConfig(height=32, width=32, ray_height=8, ray_width=8, n_steps=1)
    batch = jdata.MultiviewMultipromptDataModule(cfg, seed=1).sample_train_batch()[0]
    clips = [_clip(verts, batch["mvp_mtx"][v]) for v in range(2)]
    return verts, faces, fmask, clips


def _rast_both(clip, faces, valid, H, kw):
    jout = j_rasterize(jnp.asarray(clip), jnp.asarray(faces, jnp.int32),
                       None if valid is None else jnp.asarray(valid), H=H, W=H, **kw)
    tout = tr.rasterize(_t(clip), _t(faces), None if valid is None else _t(valid), H, H, **kw)
    return jout, tout


def _assert_raster_equal(jout, tout, what):
    fid_j, fid_t = np.asarray(jout.face_id), tout.face_id.numpy()
    bad = np.argwhere(fid_j != fid_t)
    assert not len(bad), f"{what}: face_id differs at {bad[:10].tolist()} " \
        f"(JAX {fid_j[tuple(bad[:10].T)]}, port {fid_t[tuple(bad[:10].T)]})"
    np.testing.assert_array_equal(tout.mask.numpy(), np.asarray(jout.mask))
    for name in ("bary", "depth", "edge_dist"):
        _close(getattr(tout, name), getattr(jout, name), RASTER_TOL, f"{what}: {name}")
    for name in ("n_span_overflow", "n_list_overflow"):
        assert int(getattr(tout, name)) == int(getattr(jout, name)), (what, name)


@pytest.mark.parametrize("scene", list(_scenes()))
def test_rasterize_interpolate_antialias_match_on_hand_built_scenes(scene):
    clip, faces, valid, H, kw = _scenes()[scene]
    jout, tout = _rast_both(clip, faces, valid, H, kw)
    _assert_raster_equal(jout, tout, scene)
    expect = {"span overflow": (1, 0), "list overflow": (0, None), "big-face list": (0, 0)}
    if scene in expect:
        span, lst = expect[scene]
        assert int(tout.n_span_overflow) == span
        assert lst is not None or int(tout.n_list_overflow) > 0
    if scene == "collapsed face":
        assert not (tout.face_id == 1).any() and (tout.face_id == 0).sum() > 200
    rng = np.random.default_rng(4)
    attr = rng.normal(size=(clip.shape[0], 3)).astype(np.float32)
    bg = rng.uniform(size=(H, H, 3)).astype(np.float32)
    img_j, aa_j = jax.jit(lambda o: (lambda im: (im, jr.antialias(im, o, jnp.asarray(bg))))(
        jr.interpolate(jnp.asarray(attr), o, jnp.asarray(faces, jnp.int32))))(jout)
    img_t = tr.interpolate(_t(attr), tout, _t(faces))
    _close(img_t, img_j, RASTER_TOL, "interpolate")
    _close(tr.antialias(img_t, tout, _t(bg)), aa_j, RASTER_TOL, "antialias")


def test_rasterize_matches_on_a_marching_cubes_mesh_with_vertex_gradients():
    verts, faces, fmask, clips = _mc_scene()
    rng = np.random.default_rng(5)
    attr = rng.normal(size=(verts.shape[0], 3)).astype(np.float32)
    bg = rng.uniform(size=(32, 32, 3)).astype(np.float32)
    w = rng.normal(size=(32, 32, 3)).astype(np.float32)
    kw = dict(tile=16, faces_per_tile=1024, max_span=2)
    for v, clip in enumerate(clips):
        jout, tout = _rast_both(clip, faces, fmask, 32, kw)
        assert int(tout.mask.sum()) > 100
        _assert_raster_equal(jout, tout, f"view {v}")

        def j_loss(c):
            o = jr.rasterize(c, jnp.asarray(faces), jnp.asarray(fmask), 32, 32, **kw)
            img = jr.antialias(jr.interpolate(jnp.asarray(attr), o, jnp.asarray(faces)), o,
                               jnp.asarray(bg))
            return (img * w).sum()

        ct = _t(clip).requires_grad_()
        o = tr.rasterize(ct, _t(faces), _t(fmask), 32, 32, **kw)
        img = tr.antialias(tr.interpolate(_t(attr), o, _t(faces)), o, _t(bg))
        (g,) = torch.autograd.grad((img * _t(w)).sum(), ct)
        gj = jax.jit(jax.grad(j_loss))(jnp.asarray(clip))
        assert np.abs(np.asarray(gj)).max() > 0
        _close(g, gj, REL_TOL, f"view {v}: clip-vertex gradient", rel=True)


# -- hash grid and background --------------------------------------------------


def test_hashgrid_dense_and_hashed_levels_match():
    cfg_j = jhash.HashGridConfig(n_levels=2, log2_hashmap_size=8, base_resolution=4,
                                 per_level_scale=2.0)
    cfg_t = thash.HashGridConfig(n_levels=2, log2_hashmap_size=8, base_resolution=4,
                                 per_level_scale=2.0)
    assert [cfg_t.is_dense(r) for r in cfg_t.resolutions] == [True, False]
    rng = np.random.default_rng(6)
    table = rng.uniform(-1, 1, (2, 256, 2)).astype(np.float32)
    x = rng.uniform(0, 1, (500, 3)).astype(np.float32)
    x[:3] = [[0.0, 0.0, 0.0], [1.0, 1.0, 1.0], [0.5, 0.25, 1.0]]
    w = rng.normal(size=(500, 4)).astype(np.float32)
    tt, xt = _t(table).requires_grad_(), _t(x).requires_grad_()
    out = thash.hashgrid_encode(tt, xt, cfg_t)
    want = jax.jit(lambda a, b: jhash.hashgrid_encode(a, b, cfg_j))(table, x)
    _close(out, want, 1e-6, "value")
    g_table, g_x = torch.autograd.grad((out * _t(w)).sum(), (tt, xt))
    gj_table, gj_x = jax.jit(jax.grad(lambda a, b: (jhash.hashgrid_encode(a, b, cfg_j) * w).sum(),
                                      argnums=(0, 1)))(table, x)
    _close(g_table, gj_table, REL_TOL, "table gradient", rel=True)
    _close(g_x, gj_x, REL_TOL, "x gradient", rel=True)


def _backgrounds():
    kw = dict(encoding=dict(n_levels=2, log2_hashmap_size=8), hypernet=dict(c_dim=32))
    jcfg = jbg.HashgridBackgroundConfig(encoding=jhash.HashGridConfig(**kw["encoding"]),
                                        hypernet=jbg.HyperNetConfig(**kw["hypernet"]))
    tcfg = tbg.HashgridBackgroundConfig(encoding=thash.HashGridConfig(**kw["encoding"]),
                                        hypernet=tbg.HyperNetConfig(**kw["hypernet"]))
    jmod = jbg.HashgridEnvironmentMapBackground(jcfg)
    rng = np.random.default_rng(7)
    dirs = rng.normal(size=(4, 6, 5, 3)).astype(np.float32)
    dirs /= np.linalg.norm(dirs, axis=-1, keepdims=True)
    text = rng.normal(size=(2, 32)).astype(np.float32)
    params = jax.tree_util.tree_map(np.asarray, jmod.init(jax.random.PRNGKey(0), jnp.asarray(dirs),
                                                          jnp.asarray(text))["params"])
    # a table at the scale of a trained one, so that the colour varies with direction
    params["encoding"]["table"] = rng.uniform(-1, 1, params["encoding"]["table"].shape).astype(
        np.float32)
    tmod = tbg.HashgridEnvironmentMapBackground(tcfg)
    load_flax_params(tmod, params)
    return jmod, params, tmod, dirs, text


def test_background_matches_through_the_weight_bridge():
    jmod, params, tmod, dirs, text = _backgrounds()
    w = np.random.default_rng(8).normal(size=(4, 6, 5, 3)).astype(np.float32)
    out = tmod(_t(dirs), _t(text))
    want = jax.jit(lambda p: jmod.apply({"params": p}, dirs, text))(params)
    _close(out, want, 1e-5, "train colour")
    _close(tmod(_t(dirs), _t(text), train=False),
           jmod.apply({"params": params}, jnp.asarray(dirs), jnp.asarray(text), train=False), 0,
           "eval colour")
    grads = torch.autograd.grad((out * _t(w)).sum(), list(tmod.parameters()))
    gj = jax.jit(jax.grad(lambda p: (jmod.apply({"params": p}, dirs, text) * w).sum()))(params)
    want = flax_tree_to_named(jax.tree_util.tree_map(np.asarray, gj))
    got = dict(zip([n for n, _ in tmod.named_parameters()], grads))
    assert set(got) == set(want) == {"encoding.table", "hypernet.fc_in.weight",
                                     "hypernet.ln_in.weight", "hypernet.ln_in.bias",
                                     "hypernet.fc_out.weight", "hypernet.fc_out.bias"}
    for name, ref in want.items():
        assert np.abs(ref).max() > 0, name
        _close(got[name], ref, REL_TOL, name, rel=True)
    back = named_to_flax_tree(dict(tmod.named_parameters()), params)
    for path, leaf in jax.tree_util.tree_leaves_with_path(params):
        node = back
        for p in path:
            node = node[p.key]
        np.testing.assert_array_equal(node, leaf)


def test_background_random_aug_draws_from_its_generator():
    _, _, tmod, dirs, text = _backgrounds()
    tmod.cfg.random_aug, tmod.cfg.random_aug_prob = True, 1.0
    a = tmod(_t(dirs), _t(text), aug_generator=torch.Generator().manual_seed(3))
    b = tmod(_t(dirs), _t(text), aug_generator=torch.Generator().manual_seed(3))
    assert torch.equal(a, b) and torch.equal(a[:, :1, :1].expand_as(a), a)
    tmod.cfg.random_aug = False
    assert not torch.equal(tmod(_t(dirs), _t(text)), a)
