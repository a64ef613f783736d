"""The port's whole training step against the JAX trainer's ``train_step`` on the CPU.

Both packages build the tiny system of ``tests/test_trainer_staged.py`` with their
own ``build_system`` (two parts, tiny student, background, renderers and teachers);
the port's then takes the JAX system's weights through the bridge (every adapter
``up`` leaf drawn nonzero first, so that every adapter gradient is). Both run two
steps from the same step-batches (the JAX data module's) and text states, and the
same draws: the JAX step splits its key into one key a part and each of those into
the noise's, the renders' and the teachers' keys; the test repeats those splits to
make the port's :class:`PartDraws` (the noise, the volume branch's patch origin and
jitter, program G's draws). The timesteps come from both trainers' ``RandomState(0)``.
The monolithic step's comparison is ``tests/test_torch_train_step_monolithic.py``.

Tolerances, f32 on both sides: each metric within 1e-5 relative; each step's gradient
within 1e-3 and every trainable leaf within 1e-4 of its largest value
(:func:`check_train_step_matches_jax` says which elements are held looser, and why).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_trainer import _trainable_leaves, nonzero_adapters
from triplaneturbo_tpu.data import DataModuleConfig as JaxDataModuleConfig
from triplaneturbo_tpu.data import MultiviewMultipromptDataModule as JaxDataModule
from triplaneturbo_tpu.models.networks import get_activation as jax_get_activation
from triplaneturbo_tpu.systems.builder import build_system as jax_build_system
from triplaneturbo_tpu.systems.optimizers import AdanState
from triplaneturbo_tpu.systems.trainer import split_params
from triplaneturbo_torch.models.guidance.asd_guidance import GuidanceDraws
from triplaneturbo_torch.models.networks import get_activation
from triplaneturbo_torch.models.renderers.patch_renderer import PatchDraws
from triplaneturbo_torch.systems.builder import build_system
from triplaneturbo_torch.systems.trainer import PartDraws
from triplaneturbo_torch.utils.weights import flax_tree_to_named, load_flax_params

torch.set_num_threads(2)

REL = 1e-5
LEAF_REL = 1e-4
GRAD_REL = 1e-3
STEPS = 2
TINY_SG = dict(block_out_channels=[16, 32], layers_per_block=1, cross_attention_dim=32,
               attention_head_dim=8, vae_block_out_channels=[8, 16], vae_layers_per_block=1,
               output_dim=8, training_type="self_lora_rank_4-cross_lora_rank_4-locon_rank_4")
TINY_TEACHER = dict(block_out_channels=[16, 32], layers_per_block=1, attention_head_dim=8,
                    cross_attention_dim=32)
TINY_VAE = dict(vae_block_out_channels=[8, 16], vae_layers_per_block=1)


def tiny_config(auto_grad: bool):
    """The system config of ``tests/test_trainer_staged.py``, with ``auto_grad``."""
    return {"system": {
        "auto_grad": auto_grad, "rasterize_hw": 8, "n_view": 4,
        "geometry": {"space_generator_config": dict(TINY_SG)},
        "background": {"c_dim": 32, "encoding": {"n_levels": 2, "log2_hashmap_size": 8}},
        "renderer": {"isosurface_resolution": 10, "max_verts": 1024, "max_faces": 2048,
                     "field_chunk": 1024, "tile": 8, "faces_per_tile": 64},
        "renderer_2nd": {"num_samples_per_ray": 8, "num_samples_per_ray_importance": 4},
        "patch": {"patch_size": 4, "global_downsample": 2},
        "guidance": {"mv_image_size": 16, "rd_image_size": 8, "sd_image_size": 16},
        "num_parts_training": 2, "num_steps_training": 2,
        "teacher_sizes": {"mv": {**TINY_TEACHER, **TINY_VAE}, "rd": dict(TINY_TEACHER),
                          "sd": {**TINY_TEACHER, **TINY_VAE}},
        "teacher_dtype": "float32",
        "loss": {"lambda_sparsity_2nd": 0.1, "lambda_eikonal_2nd": 0.1},
    }}


def step_inputs(seed: int):
    """The JAX data module's step-batches (arrays only) and seeded text states."""
    dm = JaxDataModule(JaxDataModuleConfig(batch_size=4, n_view=4, n_steps=2, height=8,
                                           width=8, ray_height=8, ray_width=8,
                                           dim_gaussian=(6, 4, 8, 8)), seed=seed)
    batch_list = [{k: v for k, v in b.items() if isinstance(v, np.ndarray)}
                  for b in dm.sample_train_batch()]
    key = jax.random.PRNGKey(seed)
    embeds = {"cond_local": jax.random.normal(key, (1, 7, 32)),
              "cond_21": jax.random.normal(jax.random.fold_in(key, 1), (1, 7, 32)),
              "uncond_21": jnp.zeros((1, 7, 32)),
              "cond_15": jax.random.normal(jax.random.fold_in(key, 2), (1, 7, 32)),
              "uncond_15": jnp.zeros((1, 7, 32)),
              "global_21": jax.random.normal(jax.random.fold_in(key, 3), (1, 32))}
    return batch_list, embeds


def bridge(jtrainer, trainer):
    """The JAX system's weights (adapter ``up`` leaves drawn nonzero) into the port's."""
    geo = nonzero_adapters(jtrainer.params["geometry"], np.random.default_rng(0))
    jtrainer.params["geometry"] = jax.tree_util.tree_map(jnp.asarray, geo)
    load_flax_params(trainer.geometry, geo["params"])
    for part, module in (("background", trainer.background),
                         ("renderer", trainer.volume_renderer)):
        load_flax_params(module, jax.tree_util.tree_map(np.asarray,
                                                        jtrainer.params[part])["params"])
    for kind in ("mv", "rd", "sd"):
        jb, mine = getattr(jtrainer.guidance, kind), getattr(trainer.guidance, kind)
        load_flax_params(mine.unet, jax.tree_util.tree_map(np.asarray, jb.unet_params)["params"])
        if mine.vae is not None:
            load_flax_params(mine.vae, jax.tree_util.tree_map(np.asarray,
                                                              jb.vae_params)["params"])


def _t(x, dtype=torch.float32):
    return None if x is None else torch.tensor(np.asarray(x)).to(dtype)


def _volume_draws(trainer, k_render, views, rays):
    """What the JAX ``_render_branch(key=k_render)`` draws for the second branch."""
    k_patch, k_a, k_b = jax.random.split(jax.random.split(k_render)[1], 3)
    ps, ds = trainer.patch_cfg.patch_size, trainer.patch_cfg.global_downsample
    vcfg = trainer.volume_renderer.cfg
    py = int(jax.random.randint(k_patch, (), 0, rays - ps))
    px = int(jax.random.randint(jax.random.fold_in(k_patch, 1), (), 0, rays - ps))

    def jitter(k, n_rays):
        k1, k2 = jax.random.split(k)
        return (_t(jax.random.uniform(k1, (n_rays, vcfg.num_samples_per_ray_importance + 1))),
                _t(jax.random.uniform(k2, (n_rays, vcfg.num_samples_per_ray + 1))))

    g = rays // ds
    return PatchDraws(py, px, jitter(k_a, views * g * g), jitter(k_b, views * ps * ps))


def _guidance_draws(trainer, k_guid, views, scalars):
    """What the JAX ``_guidance_losses(k_guid, ...)`` draws, the renderers one after
    the other: a teacher's key split in two, one call a renderer."""
    n_view = trainer.guidance.cfg.n_view
    prompts = views // n_view
    out = {}
    for kind, k_kind in zip(("mv", "rd", "sd"), jax.random.split(k_guid, 3)):
        hw = trainer.guidance._latent_hw(kind)
        lo, hi = scalars[f"{kind}_min_step"], scalars[f"{kind}_max_step"]
        calls = []
        for key in jax.random.split(k_kind, 2):
            view = k_e = None
            images = views
            if kind == "mv":
                k_t, k_p, k_n, k_e = jax.random.split(key, 4)
            elif kind == "rd":
                k_t, k_p, k_n = jax.random.split(key, 3)
            else:
                k_v, k_t, k_p, k_n, k_e = jax.random.split(key, 5)
                view = jax.random.randint(k_v, (prompts,), 0, n_view)
                images = prompts
            n_t = images if kind == "sd" else images // n_view
            shape = (images, hw, hw, 4)
            calls.append(GuidanceDraws(
                _t(jax.random.randint(k_t, (n_t,), lo, hi), torch.long),
                _t(jax.random.uniform(k_p, (n_t,))), _t(jax.random.normal(k_n, shape)),
                None if k_e is None else _t(jax.random.normal(k_e, shape)),
                _t(view, torch.long)))
        out[kind] = calls
    return out


def draws_from_key(trainer, key, batch_list):
    """The port's draws for every part of a JAX ``train_step(..., key)``."""
    assert not trainer.cfg.parallel_guidance
    scalars = trainer.host_scalars()
    latent_shape = batch_list[0]["noise"].shape
    views, rays = batch_list[0]["rays_o"].shape[:2]
    out = []
    for k in jax.random.split(key, trainer.cfg.num_parts_training):
        k_noise, k_render, k_guid = jax.random.split(k, 3)
        out.append(PartDraws(_t(jax.random.normal(k_noise, latent_shape)),
                             _volume_draws(trainer, k_render, views, rays),
                             _guidance_draws(trainer, k_guid, views, scalars)))
    return out


def _assert_leaves_close(got, want, what, unsettled=None, slack=0.0, rel=LEAF_REL):
    """Each leaf of ``got`` within ``rel`` of the largest value of its ``want``; where
    ``unsettled`` marks an element, within ``slack`` more. Returns each leaf's largest
    error over its largest value."""
    assert set(got) == set(want), what
    errs = {}
    for name, ref in want.items():
        a = got[name].detach().numpy()
        assert np.isfinite(a).all(), (what, name)
        scale = max(float(np.abs(ref).max()), 1e-12)
        errs[name] = float(np.abs(a - ref).max()) / scale
        tol = np.full(ref.shape, rel * scale, np.float32)
        if unsettled is not None:
            tol[unsettled[name]] += slack
        err = np.abs(a - ref)
        worst = np.unravel_index(np.argmax(err - tol), ref.shape)
        assert (err <= tol).all(), (f"{what}: {name} at {worst}: {a[worst]} vs {ref[worst]}, "
                                    f"tolerance {tol[worst]}")
    return errs


def _jax_adan_state(state):
    """The Adan state inside the JAX guarded optimizer's nested state."""
    if isinstance(state, AdanState):
        return state
    if isinstance(state, tuple):
        for s in state:
            found = _jax_adan_state(s)
            if found is not None:
                return found
    return None


def check_train_step_matches_jax(auto_grad, pair=None):
    """Two steps of both packages' ``train_step``. After each: the metrics; the step's
    gradient (Adan's ``prev_grad``: the parts' mean gradient) of every trainable leaf,
    within 1e-3 of its largest value (the mesh branch's gradients pass through
    marching cubes, which divides the packages' rounding of the field by its slope at a
    crossing); and every trainable leaf within 1e-4 of its largest value. Adan divides
    each element's update by the size of that element's own gradient (its first step
    moves an element by the learning rate times the sign of its gradient), so where an
    element's gradient is small against its leaf's largest (under 1e-2 of it in a step so
    far) the gradient's rounding becomes a visible share of its update, and at rounding
    level its sign: such elements are held within four learning rates more. The second
    step starts from the JAX trainer's parameters and optimizer state, so that it is
    compared from one state."""
    jtrainer, trainer = pair or build_both(auto_grad)
    assert trainer.cfg.auto_grad == jtrainer.cfg.auto_grad == auto_grad
    bridge(jtrainer, trainer)
    start = {n: p.detach().clone() for n, p in trainer.params_train.items()}
    unsettled = {n: np.zeros(tuple(p.shape), bool) for n, p in start.items()}
    for step in range(STEPS):
        batch_list, embeds = step_inputs(step)
        key = jax.random.PRNGKey(42 + step)
        draws = draws_from_key(trainer, key, batch_list)
        want = jtrainer.train_step([dict(b) for b in batch_list], dict(embeds), key)
        got = trainer.train_step(batch_list, {k: _t(v) for k, v in embeds.items()}, draws=draws)
        assert set(got) == set(want)
        for k, v in want.items():
            assert np.isfinite(float(got[k])), k
            np.testing.assert_allclose(float(got[k]), float(v), rtol=REL, atol=0,
                                       err_msg=f"step {step}: {k}")
        grads_j = _trainable_leaves(_jax_adan_state(jtrainer.opt_state).prev_grad)
        adan = trainer.optimizer.adan
        _assert_leaves_close({n: adan.state[p]["prev_grad"] for n, p in
                              trainer.params_train.items()}, grads_j,
                             f"gradients of step {step}", rel=GRAD_REL)
        for n, g in grads_j.items():
            unsettled[n] |= np.abs(g) < 1e-2 * np.abs(g).max()
        params_j = _trainable_leaves(split_params(jtrainer.params, jtrainer.train_mask)[0])
        _assert_leaves_close(dict(trainer.params_train), params_j,
                             f"parameters after step {step}", unsettled,
                             4 * trainer.cfg.learning_rate)
        # the next step starts from the JAX trainer's state: the elements whose sign
        # was noise would otherwise carry their difference into its loss
        state_j = _jax_adan_state(jtrainer.opt_state)
        moments = {k: _trainable_leaves(getattr(state_j, k)) for k in ("m", "v", "n", "prev_grad")}
        with torch.no_grad():
            for n, p in trainer.params_train.items():
                p.copy_(torch.tensor(params_j[n]))
                for k, named in moments.items():
                    adan.state[p][k] = torch.tensor(named[n])
    assert trainer.global_step == jtrainer.global_step == STEPS
    assert trainer.optimizer.adan.count == STEPS and trainer.optimizer.total_notfinite == 0
    moved = [n for n, p in trainer.params_train.items() if not torch.equal(p, start[n])]
    assert len(moved) > 0.9 * len(start), f"{len(moved)} of {len(start)} leaves moved"


def build_both(auto_grad):
    """Both packages' ``build_system`` of the tiny config (the JAX trainer, the port's)."""
    cfg = tiny_config(auto_grad)
    return jax_build_system(cfg, seed=0), build_system(cfg, seed=0, device="cpu")


@pytest.fixture(scope="module")
def staged_pair():
    return build_both(auto_grad=True)


def test_build_system_matches_jax_trainable_partition(staged_pair):
    """The port's ``build_system`` gives the JAX builder's trainable partition, and the
    frozen student's and the teachers' parameters, name for name and shape for shape."""
    jtrainer, trainer = staged_pair
    want = _trainable_leaves(split_params(jtrainer.params, jtrainer.train_mask)[0])
    got = trainer.params_train
    assert set(got) == set(want)
    assert all(tuple(got[n].shape) == want[n].shape for n in want)
    jgeo = flax_tree_to_named(jax.tree_util.tree_map(np.asarray,
                                                     jtrainer.params["geometry"])["params"])
    assert {n: tuple(p.shape) for n, p in trainer.geometry.named_parameters()} == {
        n: a.shape for n, a in jgeo.items()}
    for kind in ("mv", "rd", "sd"):
        mine, ref = getattr(trainer.guidance, kind), getattr(jtrainer.guidance, kind)
        for module, tree in ((mine.unet, ref.unet_params), (mine.vae, ref.vae_params)):
            if module is None:
                assert tree is None
                continue
            named = flax_tree_to_named(jax.tree_util.tree_map(np.asarray, tree)["params"])
            assert {n: tuple(p.shape) for n, p in module.named_parameters()} == {
                n: a.shape for n, a in named.items()}
    assert trainer.cfg.auto_grad and trainer.volume_renderer.cfg.num_samples_per_ray == 8
    assert trainer.patch_cfg.patch_size == 4 and trainer.guidance.cfg.mv_image_size == 16


def test_train_step_matches_jax_staged(staged_pair):
    check_train_step_matches_jax(True, staged_pair)


def _port_pair():
    """Two port systems with the same weights, staged and monolithic."""
    staged = build_system(tiny_config(True), seed=0, device="cpu")
    mono = build_system(tiny_config(False), seed=0, device="cpu")
    gen = torch.Generator().manual_seed(3)
    with torch.no_grad():
        for n, p in staged.geometry.named_parameters():
            if n.endswith(".up") or ".up." in n:
                p.copy_(torch.randn(p.shape, generator=gen) * 0.2)
    mono.geometry.load_state_dict(staged.geometry.state_dict())
    return staged, mono


def test_staged_step_matches_monolithic():
    staged, mono = _port_pair()
    batch_list, embeds = step_inputs(5)
    text = {k: _t(v) for k, v in embeds.items()}
    draws = [staged.draw_part(staged_b, batch_list[0]["noise"].shape,
                              torch.Generator().manual_seed(9 + i))
             for i, staged_b in enumerate(
                 {k: torch.tensor(v) for k, v in b.items() if k != "noise"} for b in batch_list)]
    m_staged = staged.train_step(batch_list, text, draws=draws)
    m_mono = mono.train_step(batch_list, text, draws=draws)
    assert set(m_staged) == set(m_mono)
    assert "grad_norm_0" in m_staged and "skipped_nonfinite" in m_staged
    for k, v in m_mono.items():
        np.testing.assert_allclose(float(m_staged[k]), float(v), rtol=REL, atol=0, err_msg=k)
    _assert_leaves_close(dict(staged.params_train),
                         {n: p.detach().numpy() for n, p in mono.params_train.items()},
                         "staged against monolithic")


def test_poisoned_batch_is_skipped_and_training_goes_on():
    trainer = build_system(tiny_config(True), seed=0, device="cpu")
    batch_list, embeds = step_inputs(6)
    text = {k: _t(v) for k, v in embeds.items()}
    before = {n: p.detach().clone() for n, p in trainer.params_train.items()}
    poisoned = [dict(b) for b in batch_list]
    poisoned[0]["noise"] = np.full_like(poisoned[0]["noise"], np.nan)
    m = trainer.train_step(poisoned, text, torch.Generator().manual_seed(1))
    assert m["skipped_nonfinite"] == 1 and not np.isfinite(float(m["loss"]))
    assert all(torch.equal(p, before[n]) for n, p in trainer.params_train.items())
    assert trainer.global_step == 1
    m = trainer.train_step(batch_list, text, torch.Generator().manual_seed(2))
    assert m["skipped_nonfinite"] == 1 and np.isfinite(float(m["loss"]))
    assert any(not torch.equal(p, before[n]) for n, p in trainer.params_train.items())
    with pytest.raises(ValueError, match="generator or explicit draws"):
        trainer.train_step(batch_list, text)
    with pytest.raises(ValueError, match="step-batches"):
        trainer.train_step(batch_list[:1], text, torch.Generator())


@pytest.mark.parametrize("name,shift", [("trunc_exp", 0.0), ("shifted_trunc_exp", 1.0)])
def test_trunc_exp_matches_jax_custom_vjp(name, shift):
    x = np.concatenate([np.linspace(-40, 40, 161), [88.0, 100.0, -100.0]]).astype(np.float32)
    g = np.random.default_rng(0).normal(size=x.shape).astype(np.float32)
    fj = jax_get_activation(name)
    want, vjp = jax.vjp(fj, jnp.asarray(x))
    (want_grad,) = vjp(jnp.asarray(g))
    xt = torch.tensor(x, requires_grad=True)
    got = get_activation(name)(xt)
    (got_grad,) = torch.autograd.grad(got, xt, torch.tensor(g))
    # exp(-100) is subnormal in f32, which XLA's CPU kernels flush to zero
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), rtol=1e-6,
                               atol=np.finfo(np.float32).tiny)
    np.testing.assert_allclose(got_grad.numpy(), np.asarray(want_grad), rtol=1e-6)
    # the gradient stays finite where the value overflows, clipped at exp(15 - shift)
    assert np.isinf(got.detach().numpy()[-2]) and np.isfinite(got_grad.numpy()).all()
    np.testing.assert_allclose(got_grad.numpy()[-2], g[-2] * np.exp(np.float32(15)), rtol=1e-6)


@pytest.mark.parametrize("auto_grad", [True, False], ids=["staged", "monolithic"])
def test_train_step_keeps_nothing_alive_and_runs_each_part_twice(auto_grad, monkeypatch):
    """After a step no tensor of it stays alive (the optimizer's state aside), and each
    part's field grid runs twice: in programs R and B-R, or in the monolithic part's
    forward and its recompute (no more: the normals' inner gradient inside a
    checkpointed part must not recompute it). The volume renderer's fields run in chunks
    (``field_chunk``), each evaluated again in the backward."""
    import gc
    import warnings

    from triplaneturbo_torch.models.geometry.triplane_geometry import TriplaneGeometry

    cfg = tiny_config(auto_grad)
    cfg["system"]["renderer_2nd"]["field_chunk"] = 50
    trainer = build_system(cfg, seed=0, device="cpu")
    batch_list, embeds = step_inputs(7)
    text = {k: _t(v) for k, v in embeds.items()}
    grid_calls = []
    grid = TriplaneGeometry.forward_field_grid
    monkeypatch.setattr(TriplaneGeometry, "forward_field_grid",
                        lambda self, *a: grid_calls.append(1) or grid(self, *a))

    def live_bytes():
        gc.collect()
        with warnings.catch_warnings():  # torch.distributed's deprecated names
            warnings.simplefilter("ignore", FutureWarning)
            return sum(o.numel() * o.element_size() for o in gc.get_objects()
                       if isinstance(o, torch.Tensor))

    trainer.train_step(batch_list, text, torch.Generator().manual_seed(0))
    after_one = live_bytes()
    trainer.train_step(batch_list, text, torch.Generator().manual_seed(1))
    assert live_bytes() == after_one
    parts = trainer.cfg.num_parts_training
    assert len(grid_calls) == 2 * 2 * parts  # two steps, one prompt
