"""The training ops of the PyTorch port against the JAX package on the CPU:
the plain versions of the flash forward-with-stats and backward kernels against
the Pallas kernels in interpret mode, autograd through the attention
dispatcher, the field-grid slab backward, the differentiable isosurface, the
noise schedule helpers, the C() schedules, the timestep strata, Adan with its
armor against optax, and the trainable set.

Inputs come from numpy with a seed and go through both packages.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

import triplaneturbo_tpu.ops.attention_pallas as jap
import triplaneturbo_tpu.ops.field_grid_pallas as jfg
import triplaneturbo_tpu.ops.isosurface as jiso
from triplaneturbo_tpu.models import schedulers as jsched
from triplaneturbo_tpu.models.geometry.space_generator import (
    SpaceGeneratorConfig as JaxSpaceGeneratorConfig,
)
from triplaneturbo_tpu.models.geometry.triplane_geometry import (
    TriplaneGeometry as JaxTriplaneGeometry,
    TriplaneGeometryConfig as JaxTriplaneGeometryConfig,
    trainable_mask,
)
from triplaneturbo_tpu.systems import optimizers as jopt
from triplaneturbo_tpu.systems.trainer import sample_timesteps as j_sample_timesteps
from triplaneturbo_tpu.utils import schedule as jschedule
from triplaneturbo_torch.models import schedulers as tsched
from triplaneturbo_torch.models.geometry.space_generator import SpaceGeneratorConfig
from triplaneturbo_torch.models.geometry.triplane_geometry import (
    TriplaneGeometry,
    TriplaneGeometryConfig,
    is_trainable,
    mark_trainable,
)
from triplaneturbo_torch.ops import field_grid as tfg
from triplaneturbo_torch.ops import flash_attention as tfa
from triplaneturbo_torch.ops import isosurface as tiso
from triplaneturbo_torch.systems import optimizers as topt
from triplaneturbo_torch.systems.trainer import sample_timesteps
from triplaneturbo_torch.utils import schedule as tschedule
from triplaneturbo_torch.utils.weights import flax_tree_to_named, load_adan_state

torch.set_num_threads(2)

TINY_SG = dict(
    block_out_channels=(32, 64), layers_per_block=1, cross_attention_dim=32,
    attention_head_dim=8, vae_block_out_channels=(16, 32), vae_layers_per_block=1,
    output_dim=8, training_type="self_lora_rank_4-cross_lora_rank_4-locon_rank_4",
)


def _rng(seed):
    return np.random.default_rng(seed)


def _normal(rng, *shape, scale=1.0):
    return (rng.normal(size=shape) * scale).astype(np.float32)


def _t(a):
    return torch.tensor(np.asarray(a))


# -- flash attention: forward with stats, and the backward ------------------------


@pytest.mark.parametrize("BH,L,Lk,D", [(3, 256, 256, 64), (2, 700, 700, 64),
                                       (2, 300, 1200, 64), (2, 300, 77, 64),
                                       (2, 128, 96, 512)])
def test_flash_stats_and_backward_plain_match_pallas_interpret(BH, L, Lk, D):
    """f32, 1e-4: the Pallas kernels sum tile by tile, the plain version row by row."""
    rng = _rng(L + Lk + D)
    q, k, v = _normal(rng, BH, L, D), _normal(rng, BH, Lk, D), _normal(rng, BH, Lk, D)
    g = _normal(rng, BH, L, D)
    with pltpu.force_tpu_interpret_mode():
        o_j, lse_j = jap._fused_attention_fwd_impl(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                                   return_stats=True)
        grads_j = jap._flash_bwd_impl(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), o_j, lse_j,
                                      jnp.asarray(g))
    o_t, lse_t = tfa.flash_attention_reference(_t(q), _t(k), _t(v), return_stats=True)
    assert lse_t.shape == (BH, L) and lse_t.dtype == torch.float32
    np.testing.assert_allclose(o_t.numpy(), np.asarray(o_j), atol=1e-4)
    np.testing.assert_allclose(lse_t.numpy(), np.asarray(lse_j), atol=1e-4)
    grads_t = tfa.flash_attention_bwd_reference(_t(q), _t(k), _t(v), o_t, lse_t, _t(g))
    for name, a, b in zip(("dq", "dk", "dv"), grads_t, grads_j):
        assert a.shape == b.shape, name
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-4, err_msg=name)


def test_flash_backward_plain_keeps_the_input_types():
    rng = _rng(0)
    q, k, v = (_t(_normal(rng, 2, 130, 64)).bfloat16() for _ in range(3))
    o, lse = tfa.flash_attention_reference(q, k, v, return_stats=True)
    dq, dk, dv = tfa.flash_attention_bwd_reference(q, k, v, o, lse, torch.ones_like(o))
    assert o.dtype == dq.dtype == dk.dtype == dv.dtype == torch.bfloat16
    assert lse.dtype == torch.float32


@pytest.mark.parametrize("L,Lk,D", [(128, 128, 64), (300, 77, 64), (40, 40, 64), (96, 77, 64),
                                    (256, 256, 32)])
def test_attention_dispatcher_grads_match_jax(L, Lk, D):
    """Autograd through the port's dispatcher against jax.grad through the JAX
    one, on both sides of the gate (the flash side in interpret mode)."""
    rng = _rng(L + D)
    B, H = 2, 2
    q, k, v = _normal(rng, B, L, H, D), _normal(rng, B, Lk, H, D), _normal(rng, B, Lk, H, D)
    w = _normal(rng, B, L, H, D)
    flash = D % 64 == 0 and L >= 128

    def j_attention(q_, k_, v_):
        if not flash:
            return jap.attention(q_, k_, v_, use_pallas=False)
        # the dispatcher's flash branch (attention_pallas.py:310-314), which it takes on a TPU
        qf = jnp.moveaxis(q_, 2, 1).reshape(B * H, L, D)
        kf = jnp.moveaxis(k_, 2, 1).reshape(B * H, Lk, D)
        vf = jnp.moveaxis(v_, 2, 1).reshape(B * H, Lk, D)
        return jnp.moveaxis(jap.fused_attention(qf, kf, vf).reshape(B, H, L, D), 1, 2)

    def j_loss(q_, k_, v_):
        return (jnp.sin(j_attention(q_, k_, v_)) * w).sum()

    with pltpu.force_tpu_interpret_mode():
        grads_j = jax.grad(j_loss, argnums=(0, 1, 2))(jnp.asarray(q), jnp.asarray(k),
                                                      jnp.asarray(v))
    leaves = [_t(a).requires_grad_() for a in (q, k, v)]
    loss = (torch.sin(tfa.attention(*leaves)) * _t(w)).sum()
    grads_t = torch.autograd.grad(loss, leaves)
    for a, b in zip(grads_t, grads_j):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-4)


# -- field grid: gradients --------------------------------------------------------------


def _field_grid_inputs(seed, R=16, C=8, concat=False):
    rng = _rng(seed)
    cin = 3 * C if concat else C
    m = [_normal(rng, R, R, C, scale=0.3) for _ in range(3)]
    ws = [_normal(rng, cin, 64, scale=0.1), _normal(rng, 64, 64, scale=0.1),
          _normal(rng, 64, 1, scale=0.1), _normal(rng, cin, 64, scale=0.1),
          _normal(rng, 64, 64, scale=0.1), _normal(rng, 64, 3, scale=0.1)]
    g_sdf, g_def = _normal(rng, R, R, R), _normal(rng, 3, R, R, R)
    return m + ws, g_sdf, g_def


@pytest.mark.parametrize("concat", [False, True])
@pytest.mark.parametrize("R", [16, 10])
def test_field_grid_grads_match_jax(concat, R):
    """All nine inputs, through autograd of the wrapper (the plain version on
    the CPU) and through the slab backward the CUDA autograd function calls;
    R = 16 takes 8 slabs, R = 10 one."""
    args, g_sdf, g_def = _field_grid_inputs(int(concat) + R, R=R, concat=concat)

    def j_loss(*a):
        sdf, deform = jfg._reference_field_grid(*a, 1.0, 0.5, concat)
        return (sdf * g_sdf).sum() + (deform * g_def).sum()

    grads_j = jax.grad(j_loss, argnums=tuple(range(9)))(*map(jnp.asarray, args))
    leaves = [_t(a).requires_grad_() for a in args]
    sdf, deform = tfg.fused_field_grid(*leaves, 1.0, 0.5, concat)
    grads_auto = torch.autograd.grad((sdf, deform), leaves, (_t(g_sdf), _t(g_def)))
    grads_slab = tfg.field_grid_slab_backward([_t(a) for a in args], _t(g_sdf), _t(g_def),
                                              1.0, 0.5, concat)
    for i, (a, s, b) in enumerate(zip(grads_auto, grads_slab, grads_j)):
        tol = 1e-4 * max(1.0, float(np.abs(np.asarray(b)).max()))
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=tol, err_msg=f"input {i}")
        np.testing.assert_allclose(s.numpy(), np.asarray(b), atol=tol, err_msg=f"input {i}")


@pytest.mark.parametrize("slabs", [1, 2, 4])
def test_field_grid_slab_count_does_not_change_the_gradients(slabs, monkeypatch):
    args, g_sdf, g_def = _field_grid_inputs(3, R=16)
    ins = [_t(a) for a in args]
    ref = tfg.field_grid_slab_backward(ins, _t(g_sdf), _t(g_def), 1.0, 0.5, False)
    assert tfg.BWD_SLABS == jfg.BWD_SLABS == 8
    monkeypatch.setattr(tfg, "BWD_SLABS", slabs)
    got = tfg.field_grid_slab_backward(ins, _t(g_sdf), _t(g_def), 1.0, 0.5, False)
    for a, b in zip(got, ref):
        np.testing.assert_allclose(a.numpy(), b.numpy(), atol=1e-5 * max(1.0, float(b.abs().max())))


# -- isosurface: the empty-field fallback and vertex gradients ------------------------------


def _sphere_field(R, rng, noise=0.1):
    lin = np.linspace(-1, 1, R, dtype=np.float32)
    g = np.stack(np.meshgrid(lin, lin, lin, indexing="ij"), -1)
    return (np.linalg.norm(g, axis=-1) - 0.6 + noise * rng.normal(size=(R, R, R))).astype(np.float32)


@pytest.mark.parametrize("field", ["crossing", "all_positive", "all_negative"])
def test_force_field_crossing_matches(field):
    R = 12
    sdf = _sphere_field(R, _rng(1)).reshape(-1)
    if field == "all_positive":
        sdf = np.abs(sdf) + 0.1
    elif field == "all_negative":
        sdf = -np.abs(sdf) - 0.1
    w = _normal(_rng(2), R ** 3)
    out_j = jiso.force_field_crossing(jnp.asarray(sdf), R)
    grad_j = jax.grad(lambda s: (jiso.force_field_crossing(s, R) * w).sum())(jnp.asarray(sdf))
    leaf = _t(sdf).requires_grad_()
    out_t = tiso.force_field_crossing(leaf, R)
    np.testing.assert_allclose(out_t.detach().numpy(), np.asarray(out_j), atol=1e-6)
    if field != "crossing":
        assert (out_t > 0).any() and (out_t < 0).any()
    (grad_t,) = torch.autograd.grad((out_t * _t(w)).sum(), leaf)
    np.testing.assert_allclose(grad_t.numpy(), np.asarray(grad_j), atol=1e-5)


@pytest.mark.parametrize("method", ["mc", "mt"])
def test_isosurface_vertex_grads_match(method):
    """d(vertices)/d(sdf) and /d(deformation): the interpolation weight and the
    tanh-bounded deformation, with the occupancy detached on both sides."""
    R = 14
    rng = _rng(5)
    sdf, deform = _sphere_field(R, rng), _normal(rng, R, R, R, 3)
    kw = dict(max_verts=4096, max_faces=8192)
    w = _normal(rng, 4096, 3)

    def j_loss(s, d):
        with np.testing.suppress_warnings() as sup:
            sup.filter(UserWarning)
            return (jiso.extract_isosurface(s, d, method=method, **kw).verts * w).sum()

    gs_j, gd_j = jax.grad(j_loss, argnums=(0, 1))(jnp.asarray(sdf), jnp.asarray(deform))
    s_t, d_t = _t(sdf).requires_grad_(), _t(deform).requires_grad_()
    with np.testing.suppress_warnings() as sup:
        sup.filter(UserWarning)
        mesh = tiso.extract_isosurface(s_t, d_t, method=method, **kw)
    assert int(mesh.n_verts) > 100
    gs_t, gd_t = torch.autograd.grad((mesh.verts * _t(w)).sum(), (s_t, d_t))
    assert gs_t.abs().max() > 0 and gd_t.abs().max() > 0
    np.testing.assert_allclose(gs_t.numpy(), np.asarray(gs_j),
                               atol=1e-4 * float(np.abs(np.asarray(gs_j)).max()))
    np.testing.assert_allclose(gd_t.numpy(), np.asarray(gd_j), atol=1e-6)


def test_extract_isosurface_refuses_an_unknown_method():
    with pytest.raises(ValueError):
        tiso.extract_isosurface(torch.zeros(4, 4, 4), method="dmtet")


# -- the noise schedule helpers, C() and the timestep strata --------------------------------


@pytest.mark.parametrize("prediction_type", ["epsilon", "v_prediction", "sample"])
def test_add_noise_and_pred_original_match(prediction_type):
    ts_ = tsched.make_schedule(tsched.SchedulerConfig(prediction_type=prediction_type))
    js_ = jsched.make_schedule(jsched.SchedulerConfig(prediction_type=prediction_type))
    rng = _rng(3)
    x0, noise, out = (_normal(rng, 2, 6, 8, 8, 4) for _ in range(3))
    for t in (np.int64(999), np.array([749, 20])):
        noisy_j = jsched.add_noise(js_, jnp.asarray(x0), jnp.asarray(noise), jnp.asarray(t))
        noisy_t = tsched.add_noise(ts_, _t(x0), _t(noise), t)
        np.testing.assert_allclose(noisy_t.numpy(), np.asarray(noisy_j), atol=1e-6)
        pred_j = jsched.pred_original(js_, jnp.asarray(out), jnp.asarray(t), noisy_j)
        pred_t = tsched.pred_original(ts_, _t(out), tsched.alpha_at(ts_, t, 5), noisy_t)
        np.testing.assert_allclose(pred_t.numpy(), np.asarray(pred_j), atol=1e-5)


SPECS = [0.5, 3, 0, [0.0, 1.0, 100], [10, 0.2, 0.8, 110], [0, 0.0, 0.0, 10],
         [0, 1.0, 0.5, 100, 0.1, 200, 2.0, 400], [0, 0.0, 0.0, 5, 0.0, 9], [0.0, 1.0, 2.5]]


@pytest.mark.parametrize("spec", SPECS, ids=[str(s) for s in SPECS])
def test_schedule_dsl_matches(spec):
    for step in (0, 7, 50, 100, 150, 250, 1000):
        for epoch in (0, 2):
            assert tschedule.C(spec, epoch, step) == jschedule.C(spec, epoch, step)
    if not isinstance(spec, (int, float)):
        lo = [1.0 if v == 0 else v for v in spec]  # the exp form needs nonzero values
        assert tschedule.C(lo, 0, 30, "exp") == jschedule.C(lo, 0, 30, "exp")
    assert tschedule.schedule_is_zero(spec) == jschedule.schedule_is_zero(spec)
    assert tschedule.C_max(spec) == jschedule.C_max(spec)


def test_schedule_dsl_refuses_a_bad_spec():
    with pytest.raises(ValueError):
        tschedule.C([1, 2, 3, 4, 5])
    with pytest.raises(ValueError):
        tschedule.C([0, 1.0, 2.0, 10], interpolation="cubic")


@pytest.mark.parametrize("n_steps,num_parts", [(4, 4), (4, 2), (50, 4), (7, 3)])
def test_sample_timesteps_draws_the_same(n_steps, num_parts):
    sched = tsched.make_schedule()
    all_t = tsched.ddim_timesteps(sched, n_steps)
    np.testing.assert_array_equal(
        all_t, jsched.ddim_timesteps(jsched.make_schedule(), n_steps))
    ra, rb = np.random.RandomState(0), np.random.RandomState(0)
    for _ in range(5):
        a = sample_timesteps(all_t, num_parts, ra)
        b = j_sample_timesteps(all_t, num_parts, rb)
        np.testing.assert_array_equal(a, b)
        assert len(a) == num_parts and (np.diff(a) < 0).all()


# -- Adan and its armor against optax ----------------------------------------------------------


def _adan_problem(seed, steps):
    rng = _rng(seed)
    params = {"a": _normal(rng, 5, 3), "b": {"c": _normal(rng, 7)}}
    grads = [{"a": _normal(rng, 5, 3, scale=3.0), "b": {"c": _normal(rng, 7, scale=3.0)}}
             for _ in range(steps)]
    return params, grads


def _run_both(kw_j, kw_t, params, grads):
    """The same gradient sequence through optax and the port; yields both
    parameter sets after every call."""
    tx = jopt.guarded_adan(learning_rate=1e-2, **kw_j)
    p_j = jax.tree_util.tree_map(jnp.asarray, params)
    state = tx.init(p_j)
    p_t = [torch.nn.Parameter(_t(params["a"]).clone()), torch.nn.Parameter(_t(params["b"]["c"]).clone())]
    opt = topt.GuardedAdan(p_t, learning_rate=1e-2, **kw_t)
    for g in grads:
        updates, state = tx.update(jax.tree_util.tree_map(jnp.asarray, g), state, p_j)
        p_j = optax.apply_updates(p_j, updates)
        changed = opt.step([_t(g["a"]), _t(g["b"]["c"])])
        yield p_j, p_t, state, opt, changed


@pytest.mark.parametrize("kw", [dict(), dict(grad_clip_norm=1.0), dict(weight_decay=0.1),
                                dict(grad_clip_norm=100.0, skip_nonfinite=False)],
                         ids=["plain", "clip", "weight_decay", "loose_clip_no_gate"])
def test_guarded_adan_matches_optax(kw):
    params, grads = _adan_problem(0, 6)
    for p_j, p_t, _, _, changed in _run_both(kw, kw, params, grads):
        assert changed
        np.testing.assert_allclose(p_t[0].detach().numpy(), np.asarray(p_j["a"]), atol=1e-6)
        np.testing.assert_allclose(p_t[1].detach().numpy(), np.asarray(p_j["b"]["c"]), atol=1e-6)
    assert not np.allclose(p_t[0].detach().numpy(), params["a"], atol=1e-3)


def test_guarded_adan_accumulates_like_multisteps():
    params, grads = _adan_problem(1, 7)
    kw = dict(accumulation_steps=2, grad_clip_norm=2.0)
    before = [params["a"], params["b"]["c"]]
    for i, (p_j, p_t, _, _, changed) in enumerate(_run_both(kw, kw, params, grads)):
        assert changed == (i % 2 == 1)
        now = [p.detach().numpy().copy() for p in p_t]
        if i % 2 == 0:  # mid-cycle: nothing moves
            for a, b in zip(now, before):
                np.testing.assert_array_equal(a, b)
        before = now
        np.testing.assert_allclose(now[0], np.asarray(p_j["a"]), atol=1e-6)
        np.testing.assert_allclose(now[1], np.asarray(p_j["b"]["c"]), atol=1e-6)


@pytest.mark.parametrize("bad", [np.nan, np.inf])
def test_guarded_adan_skips_and_counts_a_nonfinite_batch(bad):
    params, grads = _adan_problem(2, 6)
    grads[2]["b"]["c"][3] = bad
    before = None
    for i, (p_j, p_t, state, opt, changed) in enumerate(_run_both({}, {}, params, grads)):
        now = [p.detach().numpy().copy() for p in p_t]
        assert changed == (i != 2)
        if i == 2:
            for a, b in zip(now, before):
                np.testing.assert_array_equal(a, b)
        before = now
        assert all(np.isfinite(a).all() for a in now)
        assert opt.total_notfinite == int(state.total_notfinite) == int(i >= 2)
        np.testing.assert_allclose(now[0], np.asarray(p_j["a"]), atol=1e-6)
        np.testing.assert_allclose(now[1], np.asarray(p_j["b"]["c"]), atol=1e-6)


def test_adan_first_difference_is_zero_and_missing_grads_count_as_zero():
    p = torch.nn.Parameter(torch.ones(3))
    q = torch.nn.Parameter(torch.ones(2))
    opt = topt.Adan([p, q], lr=0.1)
    p.grad = torch.tensor([1.0, -2.0, 0.5])
    opt.step()
    st = opt.state[p]
    assert torch.count_nonzero(st["v"]) == 0 and opt.count == 1
    # first step: m̂ = g, n̂ = g², so the update is lr * sign(g)
    np.testing.assert_allclose(p.detach().numpy(), 1.0 - 0.1 * np.sign([1.0, -2.0, 0.5]),
                               atol=1e-6)
    np.testing.assert_array_equal(q.detach().numpy(), np.ones(2))  # 0 / (0 + eps)
    with pytest.raises(ValueError):
        opt.step(closure=lambda: 0.0)


def test_load_adan_state_carries_the_moments_across():
    """Three optax steps, the state carried into the port, then two more on each side."""
    params, grads = _adan_problem(4, 5)
    tx = jopt.adan(learning_rate=1e-2)
    p_j = jax.tree_util.tree_map(jnp.asarray, params)
    state = tx.init(p_j)
    for g in grads[:3]:
        updates, state = tx.update(jax.tree_util.tree_map(jnp.asarray, g), state, p_j)
        p_j = optax.apply_updates(p_j, updates)
    adan_state = state[0]
    names = ["a", "b.c"]
    p_t = [torch.nn.Parameter(_t(np.asarray(p_j["a"])).clone()),
           torch.nn.Parameter(_t(np.asarray(p_j["b"]["c"])).clone())]
    opt = topt.Adan(p_t, lr=1e-2)
    to_np = lambda tree: jax.tree_util.tree_map(np.asarray, tree)  # noqa: E731
    load_adan_state(opt, names, int(adan_state.count), to_np(adan_state.m), to_np(adan_state.v),
                    to_np(adan_state.n), to_np(adan_state.prev_grad))
    assert opt.count == 3
    for g in grads[3:]:
        updates, state = tx.update(jax.tree_util.tree_map(jnp.asarray, g), state, p_j)
        p_j = optax.apply_updates(p_j, updates)
        p_t[0].grad, p_t[1].grad = _t(g["a"]), _t(g["b"]["c"])
        opt.step()
    np.testing.assert_allclose(p_t[0].detach().numpy(), np.asarray(p_j["a"]), atol=1e-6)
    np.testing.assert_allclose(p_t[1].detach().numpy(), np.asarray(p_j["b"]["c"]), atol=1e-6)
    with pytest.raises(ValueError):
        load_adan_state(opt, ["a"], 0, {}, {}, {}, {})


# -- the trainable set -------------------------------------------------------------------


def test_trainable_set_equals_the_jax_mask_leaf_for_leaf():
    jgeo = JaxTriplaneGeometry(JaxTriplaneGeometryConfig(
        space_generator=JaxSpaceGeneratorConfig(**TINY_SG)))
    shapes = jax.eval_shape(
        lambda k: jgeo.init(k, jnp.zeros((1, 6, 8, 8, 4)), jnp.zeros((1, 7, 32)), jnp.zeros(()),
                            jnp.zeros((1, 4, 3)), method=jgeo.init_all), jax.random.PRNGKey(0))
    mask = trainable_mask(shapes["params"])
    named_mask = flax_tree_to_named(jax.tree_util.tree_map(
        lambda m, leaf: np.full(leaf.shape, m), mask, shapes["params"]))
    named_mask = {n: bool(m.all()) for n, m in named_mask.items()}
    geo = TriplaneGeometry(TriplaneGeometryConfig(space_generator=SpaceGeneratorConfig(**TINY_SG)))
    names = mark_trainable(geo)
    assert set(named_mask) == {n for n, _ in geo.named_parameters()}
    assert set(names) == {n for n, m in named_mask.items() if bool(m)}
    assert 0 < len(names) < len(named_mask)
    for n, p in geo.named_parameters():
        assert p.requires_grad == bool(named_mask[n]) == is_trainable(n), n
    assert any("retrofit" in n for n in names) and any(n.startswith("field.") for n in names)
    assert not is_trainable("space_generator.unet.conv_in.conv.weight")


def test_every_trainable_leaf_of_a_bf16_student_is_f32():
    """The recipe keeps every trainable in f32, and the JAX package stores the bf16
    student's so (flax's ``param_dtype``): the retrofit conv too, cast to bf16 only in
    its forward."""
    geo = TriplaneGeometry(TriplaneGeometryConfig(
        space_generator=SpaceGeneratorConfig(dtype_str="bfloat16", **TINY_SG)))
    names = mark_trainable(geo)
    params = dict(geo.named_parameters())
    assert any("retrofit" in n for n in names)
    assert {n: params[n].dtype for n in names} == {n: torch.float32 for n in names}
    assert params["space_generator.unet.conv_in.conv.weight"].dtype == torch.bfloat16
    z = torch.randn(6, 4, 8, 8)
    with torch.no_grad():
        assert geo.space_generator.vae.decoder(z).dtype == torch.float32


def test_mark_trainable_rounds_frozen_f32_leaves_to_bf16_values():
    geo = TriplaneGeometry(TriplaneGeometryConfig(
        space_generator=SpaceGeneratorConfig(dtype_str="bfloat16", **TINY_SG)))
    w = geo.space_generator.vae.post_quant_conv.weight
    with torch.no_grad():
        w.copy_(torch.full_like(w, 1.0 + 2.0 ** -10))
    lora = next(p for n, p in geo.named_parameters() if n.endswith("lora_q.down"))
    with torch.no_grad():
        lora.copy_(torch.full_like(lora, 1.0 + 2.0 ** -10))
    mark_trainable(geo)
    assert w.dtype == torch.float32 and bool((w == 1.0).all())  # frozen: bf16 values
    assert bool((lora == 1.0 + 2.0 ** -10).all())  # trainable: untouched f32
