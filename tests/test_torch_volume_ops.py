"""The second renderer's operations in the PyTorch port against the JAX package
on the CPU: the ray primitives, the field's point queries, the antialiased
resize, the patch renderer and the NeuS volume renderer, each fed the same
numpy inputs and the same random draws at a small size.

The JAX functions draw their jitter from keys; the port takes it as tensors,
so each test draws the JAX package's arrays from the same keys the JAX
function splits and hands them to the port.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from triplaneturbo_tpu.models.geometry.triplane_field import (
    TriplaneField as JaxTriplaneField,
    TriplaneFieldConfig as JaxTriplaneFieldConfig,
    analytic_normal as jax_analytic_normal,
)
from triplaneturbo_tpu.models.renderers import patch_renderer as jpatch
from triplaneturbo_tpu.models.renderers import volume_renderer as jvol
from triplaneturbo_tpu.ops import ray as jray
from triplaneturbo_tpu.utils import camera as jcam
from triplaneturbo_tpu.utils.ops import safe_normalize as jax_safe_normalize
from triplaneturbo_torch.models.geometry.triplane_field import (
    TriplaneField,
    TriplaneFieldConfig,
    analytic_normal,
)
from triplaneturbo_torch.models.renderers import patch_renderer as tpatch
from triplaneturbo_torch.models.renderers import volume_renderer as tvol
from triplaneturbo_torch.ops import ray as tray
from triplaneturbo_torch.utils.ops import safe_normalize
from triplaneturbo_torch.utils.weights import load_flax_params

torch.set_num_threads(2)
# f32 on both sides; XLA's cumulative products and sums associate in another order
# than PyTorch's sequential ones, so the ray primitives agree to rounding, not bits
RAY_TOL = 1e-6
# the renders sum over many samples and go through the field's MLPs and gathers, so
# each output is held to 1e-5 of its own largest value
RENDER_REL_TOL = 1e-5


def _rng(seed):
    return np.random.default_rng(seed)


def _t(x):
    return torch.from_numpy(np.array(x))


def _close(got, want, atol, what=""):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    assert np.isfinite(got).all(), what
    np.testing.assert_allclose(got, want, atol=atol, rtol=0, err_msg=what)


def _rel_close(got, want, what):
    _close(got, want, RENDER_REL_TOL * max(float(np.abs(np.asarray(want)).max()), 1e-12), what)


def _jax_jitter(key, n_rays, n_prop, n_fine):
    """The two uniform draws ``importance_sampling(key=key)`` makes."""
    k1, k2 = jax.random.split(key)
    return (np.asarray(jax.random.uniform(k1, (n_rays, n_prop + 1))),
            np.asarray(jax.random.uniform(k2, (n_rays, n_fine + 1))))


# -- ray primitives ---------------------------------------------------------------


def test_weights_accumulation_and_transmittance_match():
    rng = _rng(0)
    alpha = rng.uniform(0, 1, size=(9, 33)).astype(np.float32)
    alpha[0, 3] = 1.0
    alpha[1] = 0.0
    values = rng.normal(size=(9, 33, 4)).astype(np.float32)
    w_t = tray.render_weight_from_alpha(_t(alpha))
    _close(w_t, jray.render_weight_from_alpha(jnp.asarray(alpha)), RAY_TOL, "weights")
    _close(tray.accumulate_along_rays(w_t), jray.accumulate_along_rays(jnp.asarray(w_t.numpy())),
           RAY_TOL, "opacity")
    _close(tray.accumulate_along_rays(w_t, _t(values)),
           jray.accumulate_along_rays(jnp.asarray(w_t.numpy()), jnp.asarray(values)),
           RAY_TOL, "accumulated values")
    t0 = np.sort(rng.uniform(0.1, 4, size=(9, 33)), -1).astype(np.float32)
    t1 = t0 + rng.uniform(0, 0.2, size=t0.shape).astype(np.float32)
    sigma = rng.uniform(0, 5, size=t0.shape).astype(np.float32)
    _close(tray.render_transmittance_from_density(_t(t0), _t(t1), _t(sigma)),
           jray.render_transmittance_from_density(*map(jnp.asarray, (t0, t1, sigma))),
           RAY_TOL, "transmittance")


def _cdf_rows(rng, n_rays, K):
    """Monotone CDF rows over sorted boundaries, with flat stretches and a row
    holding all its mass in one interval."""
    pdf = rng.uniform(0, 1, size=(n_rays, K)) * (rng.uniform(size=(n_rays, K)) > 0.3)
    pdf[0] = 0.0
    pdf[0, K // 2] = 1.0
    pdf[:, 0] += 1e-3
    cdf = np.cumsum(pdf, -1)
    cdf = np.concatenate([np.zeros((n_rays, 1)), cdf / cdf[:, -1:]], -1).astype(np.float32)
    cdf[:, -1] = 1.0
    bins = np.sort(rng.uniform(0, 1, size=(n_rays, K + 1)), -1).astype(np.float32)
    return bins, cdf


@pytest.mark.parametrize("jittered", [False, True])
def test_sample_pdf_indices_equal_and_boundaries_match(jittered):
    rng = _rng(1)
    bins, cdfs = _cdf_rows(rng, 40, 64)
    n = 32
    key = jax.random.PRNGKey(3)
    u_jit = np.asarray(jax.random.uniform(key, (40, n + 1))) if jittered else None
    want = jray.sample_pdf(jnp.asarray(bins), jnp.asarray(cdfs), n, key if jittered else None)
    got = tray.sample_pdf(_t(bins), _t(cdfs), n, None if u_jit is None else _t(u_jit))
    _close(got, want, RAY_TOL, "boundaries")
    # the JAX function's interval index (its dense compare-count) against the port's
    # searchsorted, on the same u, bit for bit
    strata = np.arange(n + 1, dtype=np.float32)
    u = (strata + u_jit) / (n + 1) if jittered else np.broadcast_to((strata + 0.5) / (n + 1),
                                                                    (40, n + 1))
    u = np.asarray(jnp.clip(jnp.asarray(u, jnp.float32), 1e-7, 1.0 - 1e-7))
    idx_j = np.clip(np.asarray((jnp.asarray(u)[..., None] >= jnp.asarray(cdfs)[..., None, :]
                                ).sum(-1)), 0, cdfs.shape[-1] - 1)
    idx_t = tray.pdf_interval(_t(cdfs), _t(u)).numpy()
    np.testing.assert_array_equal(idx_t, idx_j)
    assert len(np.unique(idx_t)) > 30


@pytest.mark.parametrize("jittered", [False, True])
def test_importance_sampling_matches(jittered):
    def prop(t0, t1, xp):
        mid = (t0 + t1) / 2
        return xp.exp(-((mid - 2.0) ** 2) * 10.0) * 5.0 + 0.01 * mid

    key = jax.random.PRNGKey(5) if jittered else None
    n_rays, P, F = 11, 16, 24
    s_j, e_j = jray.importance_sampling(lambda a, b: prop(a, b, jnp), n_rays, P, F, 0.1, 4.0,
                                        key=key)
    jitter = (tuple(_t(a) for a in _jax_jitter(key, n_rays, P, F)) if jittered else None)
    s_t, e_t = tray.importance_sampling(lambda a, b: prop(a, b, torch), n_rays, P, F, 0.1, 4.0,
                                        jitter=jitter)
    assert s_t.shape == (n_rays, P + F + 1)
    _close(s_t, s_j, RAY_TOL * 4, "t_starts")
    _close(e_t, e_j, RAY_TOL * 4, "t_ends")
    # a generator draws the same-shaped jitter itself
    g1, g2 = (torch.Generator().manual_seed(9) for _ in range(2))
    a = tray.importance_sampling(lambda a, b: prop(a, b, torch), n_rays, P, F, 0.1, 4.0,
                                 generator=g1)
    b = tray.importance_sampling(lambda a, b: prop(a, b, torch), n_rays, P, F, 0.1, 4.0,
                                 jitter=tray.draw_jitter(n_rays, P, F, g2))
    assert all(torch.equal(x, y) for x, y in zip(a, b))


@pytest.mark.parametrize("cos_anneal", [1.0, 0.4])
def test_neus_alpha_and_densities_match(cos_anneal):
    rng = _rng(2)
    sdf = rng.normal(scale=0.2, size=(50, 7, 1)).astype(np.float32)
    normal = rng.normal(size=(50, 7, 3)).astype(np.float32)
    dirs = rng.normal(size=(50, 7, 3)).astype(np.float32)
    dists = rng.uniform(0, 0.1, size=(50, 7, 1)).astype(np.float32)
    inv_std = np.float32(37.5)
    _close(tray.neus_alpha(*map(_t, (sdf, normal, dirs, dists)), torch.tensor(inv_std), cos_anneal),
           jray.neus_alpha(*map(jnp.asarray, (sdf, normal, dirs, dists)), jnp.asarray(inv_std),
                           cos_anneal), RAY_TOL, "alpha")
    for s in (inv_std, np.float32(120.0)):  # 120 is clamped to 80 by VolSDF
        _close(tray.volsdf_density(_t(sdf), torch.tensor(s)),
               jray.volsdf_density(jnp.asarray(sdf), jnp.asarray(s)), RAY_TOL * 80, "volsdf")
    _close(tray.neus_density_from_sdf(_t(sdf), torch.tensor(inv_std), 0.054),
           jray.neus_density_from_sdf(jnp.asarray(sdf), jnp.asarray(inv_std), 0.054),
           RAY_TOL * 20, "neus density")


# -- the field's point queries ----------------------------------------------------------


@pytest.fixture(scope="module")
def fields():
    """A JAX TriplaneField with random weights, the port's copy, and a cache."""
    jfield = JaxTriplaneField(JaxTriplaneFieldConfig())
    cache = (_rng(5).normal(size=(2, 6, 24, 24, 32)) * 0.3).astype(np.float32)
    params = jfield.init(jax.random.PRNGKey(1), jnp.zeros((1, 4, 3)), jnp.asarray(cache[:1]),
                         method=jfield.init_all)
    tfield = TriplaneField(TriplaneFieldConfig())
    load_flax_params(tfield, jax.tree_util.tree_map(np.asarray, params["params"]))
    return jfield, params, tfield, cache


def test_field_point_queries_and_analytic_normal_match(fields):
    jfield, params, tfield, cache = fields
    pts = _rng(6).uniform(-1.2, 1.2, size=(2, 300, 3)).astype(np.float32)
    pj, cj = jnp.asarray(pts), jnp.asarray(cache)
    pt, ct = _t(pts), _t(cache)
    np.testing.assert_array_equal(tfield.bbox.numpy(), np.asarray(jfield.bbox))
    _close(tfield.forward_sdf(pt, ct), jfield.apply(params, pj, cj, method=jfield.forward_sdf),
           1e-5, "forward_sdf")
    out_j = jfield.apply(params, pj, cj)
    out_t = tfield(pt, ct)
    assert set(out_t) == set(out_j) == {"sdf", "features"}
    for k in out_j:
        _close(out_t[k], out_j[k], 1e-5, k)

    def apply_j(p, sc):
        return jfield.apply(params, p, sc, method=jfield.forward_sdf)

    for normalize in (True, False):
        want = jax_analytic_normal(apply_j, pj, cj, normalize=normalize)
        with torch.no_grad():
            got = analytic_normal(tfield.forward_sdf, pt, ct, normalize=normalize)
        assert not got.requires_grad
        _close(got, want, 1e-5 * max(1.0, float(np.abs(np.asarray(want)).max())),
               f"analytic normal, normalize={normalize}")
    # with grad on, the normal keeps its graph: the second derivative through the
    # gathers, against JAX's
    ct_g = ct.clone().requires_grad_()
    (g_sc,) = torch.autograd.grad(analytic_normal(tfield.forward_sdf, pt, ct_g).sum(), ct_g)
    want = jax.grad(lambda sc: jax_analytic_normal(apply_j, pj, sc).sum())(cj)
    assert np.abs(np.asarray(want)).max() > 0
    _close(g_sc, want, 1e-5 * float(np.abs(np.asarray(want)).max()), "d normal / d cache")


# -- the antialiased resize and the patch renderer --------------------------------------


@pytest.mark.parametrize("src,dst", [(128, 42), (42, 128), (36, 12), (12, 36)])
def test_resize_matches_jax_image_resize(src, dst):
    x = _rng(src).normal(size=(2, src, src, 3)).astype(np.float32)
    want = jax.image.resize(jnp.asarray(x), (2, dst, dst, 3), method="bilinear")
    _close(tpatch.resize(_t(x), dst, dst), want, 1e-6, f"{src} -> {dst}")


def _patch_inputs():
    rng = _rng(8)
    ro = rng.normal(size=(2, 24, 24, 3)).astype(np.float32)
    rd = rng.normal(size=(2, 24, 24, 3)).astype(np.float32)
    return ro, rd


def _base(xp, s):
    """A base renderer whose images are smooth in the rays, scaled by ``s``."""
    def fn(ro, rd, key=None, jitter=None, train=True):
        return {"comp_rgb": (xp.tanh(rd) + 0.5 * ro) * s, "opacity": (rd[..., :1] ** 2) * s,
                "eikonal": (rd ** 2).mean() * s, "inv_std": s * 2.0}
    return fn


def test_patch_renderer_on_a_known_origin_matches():
    ro, rd = _patch_inputs()
    cfg_j = jpatch.PatchRendererConfig(patch_size=8, global_downsample=3)
    key = jax.random.PRNGKey(4)
    # the origin the JAX renderer draws from its key
    k_patch = jax.random.split(key, 3)[0]
    py = int(jax.random.randint(k_patch, (), 0, 24 - 8))
    px = int(jax.random.randint(jax.random.fold_in(k_patch, 1), (), 0, 24 - 8))

    def loss_j(s):
        out = jpatch.PatchRenderer(cfg_j, _base(jnp, s))(jnp.asarray(ro), jnp.asarray(rd),
                                                          key=key, train=True)
        return out["comp_rgb"].sum() + 2 * out["opacity"].sum() + out["eikonal"], out

    (_, out_j), g_j = jax.value_and_grad(loss_j, has_aux=True)(jnp.asarray(1.3))
    s = torch.tensor(1.3, requires_grad=True)
    pr = tpatch.PatchRenderer(tpatch.PatchRendererConfig(patch_size=8, global_downsample=3),
                              _base(torch, s))
    out_t = pr(_t(ro), _t(rd), draws=tpatch.PatchDraws(py, px), train=True)
    assert set(out_t) == set(out_j)
    for k in out_j:
        _close(out_t[k], out_j[k], 1e-6, k)
    # the patch is the full-resolution render, the rest the resized global one
    np.testing.assert_array_equal(out_t["comp_rgb"][:, py:py + 8, px:px + 8].detach().numpy(),
                                  ((torch.tanh(_t(rd)) + 0.5 * _t(ro)) * s)[:, py:py + 8,
                                                                              px:px + 8].detach()
                                  .numpy())
    # autograd reaches both the patch and the global image
    (g_t,) = torch.autograd.grad(out_t["comp_rgb"].sum() + 2 * out_t["opacity"].sum()
                                 + out_t["eikonal"], s)
    np.testing.assert_allclose(float(g_t), float(g_j), rtol=1e-5)
    out_eval = pr(_t(ro), _t(rd), train=False)
    assert out_eval["comp_rgb"].shape == (2, 24, 24, 3)
    with pytest.raises(ValueError):
        pr(_t(ro), _t(rd), train=True)


def test_patch_draws_cover_the_image():
    cfg = tpatch.PatchRendererConfig(patch_size=40, global_downsample=3)
    gen = torch.Generator().manual_seed(0)
    seen = set()
    for _ in range(50):
        d = tpatch.PatchRenderer.draw(cfg, gen, 8, 128, 128,
                                      lambda n: tray.draw_jitter(n, 128, 64, gen))
        assert 0 <= d.patch_y < 88 and 0 <= d.patch_x < 88
        assert d.jitter_global[0].shape == (8 * 42 * 42, 129)
        assert d.jitter_global[1].shape == (8 * 42 * 42, 65)
        assert d.jitter_patch[0].shape == (8 * 40 * 40, 129)
        seen.add((d.patch_y, d.patch_x))
    assert len(seen) > 40


# -- the volume renderer ------------------------------------------------------------------

N_PROP, N_FINE = 12, 16
# The fine samples' positions come from the proposal pass's CDF, which the two packages
# round differently in the last bit: a boundary in an interval of little mass moves by
# that rounding over the mass, the NeuS alpha multiplies a position's error by the SDF's
# slope and by inv_std, and a moved sample can cross a texel edge or a ReLU kink of the
# field, where the analytic normal jumps. With the fixture's cache (std 0.3, |grad sdf|
# several times a distance function's) and inv_std = e^4.6 these differences reach well
# past 1e-5 of an output's largest value; a cache at std 0.03 and inv_std = e^3 keep the
# slope near a distance function's, and all outputs within 1e-5.
RENDER_CACHE_SCALE, RENDER_VARIANCE = 0.1, 0.3


def _views(n=2, H=10):
    """Rays of n views of one item at distance 1.9 (numpy), c2w, distances."""
    fovy = jnp.full((n,), jnp.deg2rad(45.0))
    dirs = jcam.get_ray_directions(H, H, fovy)
    c2w = jcam.camera_to_world(jnp.asarray([0.2, 0.5][:n]), jnp.asarray([0.3, 2.1][:n]),
                               jnp.full((n,), 1.9))
    ro, rd = jcam.get_rays(dirs, c2w)
    return tuple(np.asarray(a) for a in (ro, rd, c2w, jnp.full((n,), 1.9)))


def _white(xp):
    return lambda dirs, te=None: xp.ones_like(dirs) * 0.9


def _jax_field_fn(jfield, params, cache):
    """The JAX trainer's field query on one item: views regrouped into one row."""
    def field_fn(points, mode):
        B, M, _ = points.shape
        pts = points.reshape(1, B * M, 3)
        if mode == "sdf":
            return {"sdf": jfield.apply(params, pts, cache, method=jfield.forward_sdf
                                        ).reshape(B, M, 1)}

        def f(p):
            o = jfield.apply(params, p, cache)
            return o["sdf"].sum(), o

        (_, out), grad = jax.value_and_grad(f, has_aux=True)(pts)
        out = {k: v.reshape(B, M, -1) for k, v in out.items()}
        out["sdf_grad"] = grad.reshape(B, M, 3)
        out["normal"] = jax_safe_normalize(out["sdf_grad"])
        out["features"] = jax.nn.sigmoid(out["features"])
        return out

    return field_fn


def _torch_field_fn(tfield, cache):
    def field_fn(points, mode):
        B, M, _ = points.shape
        pts = points.reshape(1, B * M, 3)
        if mode == "sdf":
            return {"sdf": tfield.forward_sdf(pts, cache).reshape(B, M, 1)}
        outer = torch.is_grad_enabled()
        with torch.enable_grad():
            p = pts.detach().requires_grad_()
            out = tfield(p, cache)
            (grad,) = torch.autograd.grad(out["sdf"].sum(), p, create_graph=outer)
        if not outer:
            out = {k: v.detach() for k, v in out.items()}
        out = {k: v.reshape(B, M, -1) for k, v in out.items()}
        out["sdf_grad"] = grad.reshape(B, M, 3)
        out["normal"] = safe_normalize(out["sdf_grad"])
        out["features"] = torch.sigmoid(out["features"])
        return out

    return field_fn


@pytest.mark.parametrize("field_chunk,train", [(0, True), (37, True), (0, False)])
def test_volume_renderer_matches(fields, field_chunk, train):
    jfield, params, tfield, cache = fields
    ro, rd, c2w, dist = _views()
    cfg = dict(num_samples_per_ray=N_FINE, num_samples_per_ray_importance=N_PROP)
    jr = jvol.GenerativeSpaceSDFVolumeRenderer(jvol.VolumeRendererConfig(**cfg))
    cache = cache[:1] * RENDER_CACHE_SCALE
    cj = jnp.asarray(cache)
    key = jax.random.PRNGKey(11)
    jparams = {"params": {"variance_inv_std": jnp.asarray(RENDER_VARIANCE)}}
    out_j = jax.jit(lambda ro_, rd_: jr.apply(
        jparams, ro_, rd_, _jax_field_fn(jfield, params, cj), _white(jnp),
        camera_distances=jnp.asarray(dist), c2w=jnp.asarray(c2w), key=key, train=train))(
        jnp.asarray(ro), jnp.asarray(rd))

    tr = tvol.GenerativeSpaceSDFVolumeRenderer(tvol.VolumeRendererConfig(field_chunk=field_chunk,
                                                                         **cfg))
    load_flax_params(tr, {"variance_inv_std": np.float32(RENDER_VARIANCE)})
    jitter = tuple(_t(a) for a in _jax_jitter(key, ro.shape[0] * 100, N_PROP, N_FINE))
    with torch.no_grad():
        out_t = tr(_t(ro), _t(rd), _torch_field_fn(tfield, _t(cache)), _white(torch),
                   camera_distances=_t(dist), c2w=_t(c2w), jitter=jitter, train=train)
    assert set(out_t) == set(out_j)
    for k, want in out_j.items():
        _rel_close(out_t[k], want, k)
    op = out_t["opacity"].numpy()
    assert op.max() > 0.9 and op.min() < 0.1, "the views should see surface and background"


def _degenerate_field(shift):
    """SDF > 0 everywhere (empty rays), its gradient exactly zero outside a small box."""
    def field_fn(points, mode):
        inside = (points.abs() < 0.3).all(-1, keepdim=True)
        sdf = torch.where(inside, 0.5 + shift * points[..., :1], 0.8 + 0 * points[..., :1])
        if mode == "sdf":
            return {"sdf": sdf}
        color = torch.tensor([1.0, 0.2, 0.2]).expand(points.shape)
        return {"sdf": sdf, "features": color * (1 + shift), "normal": torch.zeros_like(points),
                "sdf_grad": torch.where(inside, shift * torch.ones_like(points),
                                        torch.zeros_like(points))}
    return field_fn


@pytest.mark.parametrize("recompute", [False, True])
def test_volume_renderer_backward_finite_with_degenerate_geometry(recompute):
    """The eikonal norm's backward at exactly zero SDF gradients and the
    composited normal's on empty rays stay finite, as in the JAX package."""
    ro, rd, c2w, dist = _views(1, 8)
    r = tvol.GenerativeSpaceSDFVolumeRenderer(tvol.VolumeRendererConfig(
        num_samples_per_ray=16, num_samples_per_ray_importance=8, field_chunk=50))
    shift = torch.zeros((), requires_grad=True)
    out = r(_t(ro), _t(rd), _degenerate_field(shift), _white(torch), camera_distances=_t(dist),
            c2w=_t(c2w), train=False, field_inputs=[shift] if recompute else ())
    loss = (out["eikonal"] + out["comp_normal"].sum() + out["comp_normal_cam_vis"].sum()
            + out["comp_rgb"].sum())
    (g,) = torch.autograd.grad(loss, shift)
    assert torch.isfinite(g), g


def test_field_with_normals_is_evaluated_once_forward_and_once_backward(fields):
    """With ``field_inputs`` each chunk keeps only its inputs: one evaluation in the
    forward and one in the backward, and the same gradients as keeping the graph."""
    _, _, tfield, cache = fields
    ro, rd, c2w, dist = _views(2, 6)
    r = tvol.GenerativeSpaceSDFVolumeRenderer(tvol.VolumeRendererConfig(
        num_samples_per_ray=N_FINE, num_samples_per_ray_importance=N_PROP, field_chunk=400))
    calls = []
    grads = {}
    for recompute in (False, True):
        sc = _t(cache[:1]).clone().requires_grad_()

        def field_fn(points, mode):
            calls.append(mode)
            return _torch_field_fn(tfield, sc)(points, mode)

        calls.clear()
        inputs = [sc, *tfield.parameters()]
        out = r(_t(ro), _t(rd), field_fn, _white(torch), camera_distances=_t(dist), c2w=_t(c2w),
                train=False, field_inputs=inputs if recompute else ())
        n_fwd = calls.count(True)
        loss = (out["comp_rgb"].sum() + out["eikonal"] + out["orient"] + out["sdf_abs"]
                + out["comp_normal_cam_vis"].sum() + out["disparity"].sum())
        grads[recompute] = torch.autograd.grad(loss, inputs, allow_unused=True)
        n_chunks = -(-6 * 6 * (N_PROP + N_FINE + 1) // 400)
        assert n_fwd == n_chunks
        assert calls.count(True) == (2 * n_chunks if recompute else n_chunks)
        assert calls.count("sdf") == 1
    for a, b in zip(grads[False], grads[True]):
        if a is None:
            assert b is None
            continue
        scale = float(a.abs().max())
        assert scale > 0
        assert float((a - b).abs().max()) <= 1e-6 * scale
