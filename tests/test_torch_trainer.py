"""The training slice of the PyTorch port against the JAX trainer on the CPU:
the generator backward (program B-G, ``_stage_student_space``) and the guarded
Adan update (``_stage_update``), on the tiny config.

The JAX side runs the JAX trainer's own methods on a stand-in that carries
only what those methods read (geometry, schedule, config, optimizer): the
full trainer also builds the renderers and three teachers, which this slice
does not reach. Both packages get the same weights (the flax trees bridged
into the port, every adapter ``up`` leaf nonzero so that every adapter
gradient is; a small hash-grid background and the volume renderer's
variance, which the trainable partition holds and B-G does not reach), the
same latent, timestep, text states and
space-cache cotangents, and the same noise: the JAX side draws it from
``k_noise`` inside ``_denoise_decode``, and the test reproduces that array
for the port.
"""

import os
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from triplaneturbo_tpu.models import schedulers as jsched
from triplaneturbo_tpu.models.background.hashgrid_env_map import (
    HashgridBackgroundConfig as JaxBackgroundConfig,
    HashgridEnvironmentMapBackground as JaxBackground,
    HyperNetConfig as JaxHyperNetConfig,
)
from triplaneturbo_tpu.models.geometry.space_generator import (
    SpaceGeneratorConfig as JaxSpaceGeneratorConfig,
)
from triplaneturbo_tpu.models.geometry.triplane_geometry import (
    TriplaneGeometry as JaxTriplaneGeometry,
    TriplaneGeometryConfig as JaxTriplaneGeometryConfig,
    trainable_mask,
)
from triplaneturbo_tpu.ops.hashgrid import HashGridConfig as JaxHashGridConfig
from triplaneturbo_tpu.systems.optimizers import guarded_adan as j_guarded_adan
from triplaneturbo_tpu.systems.trainer import (
    LossConfig as JaxLossConfig,
    TrainerConfig as JaxTrainerConfig,
    TriplaneTurboTrainer as JaxTrainer,
    combine_params,
    split_params,
)
from triplaneturbo_torch.models.background.hashgrid_env_map import (
    HashgridBackgroundConfig,
    HashgridEnvironmentMapBackground,
    HyperNetConfig,
)
from triplaneturbo_torch.models.geometry.space_generator import SpaceGeneratorConfig
from triplaneturbo_torch.models.geometry.triplane_geometry import (
    TriplaneGeometry,
    TriplaneGeometryConfig,
)
from triplaneturbo_torch.models.schedulers import SchedulerConfig, make_schedule
from triplaneturbo_torch.ops.hashgrid import HashGridConfig
from triplaneturbo_torch.models.renderers.rasterize_renderer import (
    GenerativeSpaceMeshRasterizeRenderer as TorchRenderer,
    RasterizeRendererConfig as TorchRendererConfig,
)
from triplaneturbo_torch.models.renderers.volume_renderer import GenerativeSpaceSDFVolumeRenderer
from triplaneturbo_torch.systems.trainer import (
    LossConfig,
    TrainerConfig,
    TriplaneTurboTrainer,
)
from triplaneturbo_torch.utils.weights import (
    flax_tree_to_named,
    load_flax_params,
    named_to_flax_tree,
)

torch.set_num_threads(2)

TINY_SG = dict(
    block_out_channels=(32, 64), layers_per_block=1, cross_attention_dim=32,
    attention_head_dim=8, vae_block_out_channels=(16, 32), vae_layers_per_block=1,
    output_dim=8, training_type="self_lora_rank_4-cross_lora_rank_4-locon_rank_4",
)
TINY_HASH = dict(n_levels=2, log2_hashmap_size=8)
NUM_PARTS = 2
B, RES, T_TEXT = 2, 8, 7
PLANE = RES * 2 ** (len(TINY_SG["vae_block_out_channels"]) - 1)  # the tiny VAE upsamples once
# f32 on both sides; a gradient leaf is a sum over thousands of positions taken in
# another order by XLA and by PyTorch's CPU kernels, so each leaf is held to 1e-4 of
# its own largest value
REL_TOL = 1e-4
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def nonzero_adapters(tree, rng):
    """numpy copy of a flax tree with every adapter ``up`` leaf drawn at random."""
    out = {}
    for k, v in tree.items():
        if hasattr(v, "items"):
            sub = nonzero_adapters(v, rng)
            if k == "up":  # LoCon: the 1x1 ``up`` conv
                sub = {kk: rng.normal(size=a.shape).astype(np.float32) * 0.2
                       for kk, a in sub.items()}
            out[k] = sub
        elif k == "up":  # LoRA
            out[k] = rng.normal(size=v.shape).astype(np.float32) * 0.2
        else:
            out[k] = np.asarray(v)
    return out


class _JaxStage(SimpleNamespace):
    """The JAX trainer's generator-backward and update methods, unbound, over
    the attributes they read."""

    _denoise_decode = JaxTrainer._denoise_decode
    _stage_student_space = JaxTrainer._stage_student_space
    _stage_update = JaxTrainer._stage_update


def _build_pair(gradient_checkpoint=False, prediction_type="epsilon", **opt_kw):
    jgeo = JaxTriplaneGeometry(JaxTriplaneGeometryConfig(
        space_generator=JaxSpaceGeneratorConfig(**TINY_SG)))
    variables = jgeo.init(jax.random.PRNGKey(0), jnp.zeros((1, 6, RES, RES, 4)),
                          jnp.zeros((1, T_TEXT, 32)), jnp.zeros(()), jnp.zeros((1, 4, 3)),
                          method=jgeo.init_all)
    tree = nonzero_adapters(variables, np.random.default_rng(0))
    jbg = JaxBackground(JaxBackgroundConfig(encoding=JaxHashGridConfig(**TINY_HASH),
                                            hypernet=JaxHyperNetConfig(c_dim=32)))
    bg_tree = jax.tree_util.tree_map(np.asarray, jax.jit(lambda k: jbg.init(
        k, jnp.zeros((1, 2, 2, 3)), jnp.zeros((1, 32))))(jax.random.PRNGKey(1)))
    # the volume renderer's one leaf, away from its init so that the bridge carries it
    vol_tree = {"params": {"variance_inv_std": np.float32(0.35)}}
    # the JAX trainer's parameter tree: the geometry, the background and the renderer
    jparams = {"geometry": jax.tree_util.tree_map(jnp.asarray, tree),
               "background": jax.tree_util.tree_map(jnp.asarray, bg_tree),
               "renderer": jax.tree_util.tree_map(jnp.asarray, vol_tree)}
    jcfg = JaxTrainerConfig(num_parts_training=NUM_PARTS, num_steps_training=NUM_PARTS,
                            prediction_type=prediction_type, **opt_kw)
    jstage = _JaxStage(
        cfg=jcfg, geometry=jgeo,
        schedule=jsched.make_schedule(jsched.SchedulerConfig(prediction_type=prediction_type)),
        tx=j_guarded_adan(jcfg.learning_rate, jcfg.adan_betas, jcfg.adan_eps,
                          grad_clip_norm=jcfg.grad_clip_norm,
                          accumulation_steps=jcfg.gradient_accumulation_steps,
                          skip_nonfinite=jcfg.skip_nonfinite_grads))
    train, frozen = split_params(jparams, {
        "geometry": trainable_mask(jparams["geometry"]),
        "background": jax.tree_util.tree_map(lambda _: True, jparams["background"]),
        "renderer": jax.tree_util.tree_map(lambda _: True, jparams["renderer"])})

    geo = TriplaneGeometry(TriplaneGeometryConfig(space_generator=SpaceGeneratorConfig(
        gradient_checkpoint=gradient_checkpoint, **TINY_SG)))
    load_flax_params(geo, tree["params"])
    bg = HashgridEnvironmentMapBackground(HashgridBackgroundConfig(
        encoding=HashGridConfig(**TINY_HASH), hypernet=HyperNetConfig(c_dim=32)))
    load_flax_params(bg, bg_tree["params"])
    vol = GenerativeSpaceSDFVolumeRenderer()
    load_flax_params(vol, vol_tree["params"])
    cfg = TrainerConfig(num_parts_training=NUM_PARTS, num_steps_training=NUM_PARTS,
                        prediction_type=prediction_type, **opt_kw)
    trainer = TriplaneTurboTrainer(
        cfg, geo, make_schedule(SchedulerConfig(prediction_type=prediction_type)), background=bg,
        volume_renderer=vol)
    return jstage, train, frozen, trainer


def _inputs(seed):
    rng = np.random.default_rng(seed)
    f32 = lambda *s: rng.normal(size=s).astype(np.float32)  # noqa: E731
    return dict(latent=f32(B, 6, RES, RES, 4), text=f32(B, T_TEXT, 32),
                g1=f32(B, 6, PLANE, PLANE, 4) * 0.1, g2=f32(B, 6, PLANE, PLANE, 4) * 0.1)


def _jax_noise(key, shape):
    """The array ``_denoise_decode`` draws from the part's key."""
    k_noise, _, _ = jax.random.split(key, 3)
    return np.asarray(jax.random.normal(k_noise, shape))


def _trainable_leaves(tree):
    """name -> array (the port's names and layout) of the non-None leaves of a
    JAX trainable-partition tree; the background's under ``background.``, the
    volume renderer's under ``renderer.``."""
    dense = _prune_to_numpy(tree)
    return {**flax_tree_to_named(dense["geometry"]["params"]),
            **{f"{part}.{n}": a for part in ("background", "renderer")
               for n, a in flax_tree_to_named(dense[part]["params"]).items()}}


def _assert_leaves_close(got, want, what):
    assert set(got) == set(want), what
    for name, ref in want.items():
        a = got[name].detach().numpy() if isinstance(got[name], torch.Tensor) else got[name]
        assert np.isfinite(a).all(), (what, name)
        tol = REL_TOL * max(float(np.abs(ref).max()), 1e-12)
        np.testing.assert_allclose(a, ref, atol=tol, rtol=0, err_msg=f"{what}: {name}")


@pytest.fixture(scope="module")
def pair():
    return _build_pair()


def test_trainable_partition_and_timesteps_match(pair):
    jstage, train, _, trainer = pair
    assert set(_trainable_leaves(train)) == set(trainer.trainable)
    np.testing.assert_array_equal(
        trainer.all_timesteps, jsched.ddim_timesteps(jstage.schedule, NUM_PARTS))


@pytest.mark.parametrize("t", [999, 499])
def test_denoise_decode_matches(pair, t):
    jstage, train, frozen, trainer = pair
    x = _inputs(t)
    key = jax.random.PRNGKey(t)
    den_j, sc_j = jax.jit(lambda p, lat, txt: jstage._denoise_decode(
        p, lat, jnp.asarray(t), {"cond_local": txt}, jax.random.split(key, 3)[0]))(
        combine_params(train, frozen), jnp.asarray(x["latent"]), jnp.asarray(x["text"]))
    noise = torch.tensor(_jax_noise(key, x["latent"].shape))
    with torch.no_grad():
        den_t, sc_t = trainer._denoise_decode(torch.tensor(x["latent"]), t,
                                              {"cond_local": torch.tensor(x["text"])}, noise)
    assert sc_t.shape == (B, 6, PLANE, PLANE, 4)
    for a, b in ((den_t, den_j), (sc_t, sc_j)):
        b = np.asarray(b)
        np.testing.assert_allclose(a.numpy(), b, atol=REL_TOL * np.abs(b).max())


def _jax_space_grads(jstage, train, frozen, x, t, key):
    return jax.jit(lambda tr, fr, lat, txt, g1, g2: jstage._stage_student_space(
        tr, fr, lat, jnp.asarray(t), {"cond_local": txt}, g1, g2, key))(
        train, frozen, jnp.asarray(x["latent"]), jnp.asarray(x["text"]),
        jnp.asarray(x["g1"]), jnp.asarray(x["g2"]))


def _torch_space_grads(trainer, x, t, key):
    noise = torch.tensor(_jax_noise(key, x["latent"].shape))
    return trainer._stage_student_space(
        torch.tensor(x["latent"]), t, {"cond_local": torch.tensor(x["text"])},
        torch.tensor(x["g1"]), torch.tensor(x["g2"]), noise)


def test_stage_student_space_grads_and_two_updates_match(pair):
    """The slice as a whole: B-G gradients for both parts of a step, the
    update, and a second step, leaf by leaf against the JAX trainer."""
    jstage, train, frozen, trainer = pair
    opt_state = jstage.tx.init(train)
    frozen_before = {n: p.detach().clone() for n, p in trainer.geometry.named_parameters()
                     if n not in trainer.params_train}
    for step in range(2):
        acc_j, acc_t = None, None
        for part, t in enumerate(trainer.all_timesteps):
            x = _inputs(10 * step + part)
            key = jax.random.PRNGKey(100 * step + part)
            grads_j = _jax_space_grads(jstage, train, frozen, x, int(t), key)
            grads_t = _torch_space_grads(trainer, x, int(t), key)
            want = _trainable_leaves(grads_j)
            _assert_leaves_close(grads_t, want, f"step {step} part {part} gradients")
            if step == 0 and part == 0:
                # every adapter leaf gets a gradient; the field MLPs, the background
                # and the renderer, which the generator does not reach, get zeros on
                # both sides
                for name, g in grads_t.items():
                    reached = not name.startswith(("field.", "background.", "renderer."))
                    assert bool(g.abs().max() > 0) == reached, name
            acc_j = grads_j if acc_j is None else jax.tree_util.tree_map(jnp.add, acc_j, grads_j)
            acc_t = trainer.accumulate(acc_t, grads_t)
        train, opt_state = jax.jit(jstage._stage_update)(train, opt_state, acc_j)
        assert trainer._stage_update(acc_t)
        _assert_leaves_close(dict(trainer.params_train), _trainable_leaves(train),
                             f"parameters after update {step}")
    assert trainer.optimizer.total_notfinite == int(opt_state.total_notfinite) == 0
    assert trainer.optimizer.adan.count == 2
    for n, p in trainer.geometry.named_parameters():
        if n in frozen_before:
            assert torch.equal(p, frozen_before[n]), n


def test_gradient_checkpoint_gives_the_same_gradients(pair):
    _, _, _, trainer = pair
    _, _, _, ckpt = _build_pair(gradient_checkpoint=True)
    ckpt.geometry.load_state_dict(trainer.geometry.state_dict())
    x, key = _inputs(7), jax.random.PRNGKey(7)
    a = _torch_space_grads(trainer, x, 499, key)
    b = _torch_space_grads(ckpt, x, 499, key)
    for name in a:
        tol = 1e-5 * max(float(a[name].abs().max()), 1e-12)
        np.testing.assert_allclose(b[name].numpy(), a[name].numpy(), atol=tol, rtol=0,
                                   err_msg=name)


def test_v_prediction_and_accumulation_with_clip_match():
    """Another parameterization, and the update with a clip and a 2-call cycle."""
    jstage, train, frozen, trainer = _build_pair(
        prediction_type="v_prediction", grad_clip_norm=0.5, gradient_accumulation_steps=2)
    opt_state = jstage.tx.init(train)
    start = {n: p.detach().clone() for n, p in trainer.params_train.items()}
    for call in range(2):
        x, key = _inputs(20 + call), jax.random.PRNGKey(20 + call)
        grads_j = _jax_space_grads(jstage, train, frozen, x, 999, key)
        grads_t = _torch_space_grads(trainer, x, 999, key)
        _assert_leaves_close(grads_t, _trainable_leaves(grads_j), f"call {call} gradients")
        train, opt_state = jax.jit(jstage._stage_update)(train, opt_state, grads_j)
        assert trainer._stage_update(grads_t) == (call == 1)
        if call == 0:
            assert all(torch.equal(p, start[n]) for n, p in trainer.params_train.items())
        _assert_leaves_close(dict(trainer.params_train), _trainable_leaves(train),
                             f"parameters after call {call}")


def test_host_scalars_and_step_metrics_match():
    loss = dict(lambda_sparsity_2nd=[0, 0.1, 1.0, 100], lambda_eikonal_2nd=0.1)
    kw = dict(num_parts_training=NUM_PARTS, num_steps_training=NUM_PARTS,
              sdf_grad_shrink=[0, 0.001, 0.1, 50], mv_max_step_percent=[0, 0.98, 0.5, 200],
              rd_guidance_scale=[10, 5.0, 50.0, 60])
    jstage = _JaxStage(cfg=JaxTrainerConfig(loss=JaxLossConfig(**loss), **kw),
                       schedule=jsched.make_schedule(), global_step=0)
    jstage.host_scalars = lambda: JaxTrainer.host_scalars(jstage)
    geo = TriplaneGeometry(TriplaneGeometryConfig(space_generator=SpaceGeneratorConfig(**TINY_SG)))
    trainer = TriplaneTurboTrainer(TrainerConfig(loss=LossConfig(**loss), **kw), geo,
                                   make_schedule())
    for step in (0, 25, 75, 300):
        jstage.global_step = trainer.global_step = step
        want, got = jstage.host_scalars(), trainer.host_scalars()
        assert set(want) == set(got)
        for name, v in want.items():
            if name.endswith("_step"):
                assert isinstance(got[name], int) and got[name] == int(v), name
            else:
                np.testing.assert_allclose(got[name], float(v), rtol=1e-6, err_msg=name)
    rng = np.random.default_rng(0)
    fids, regus, gns = (rng.normal(size=NUM_PARTS).astype(np.float32) for _ in range(3))
    want = JaxTrainer._step_metrics(jstage, jnp.asarray(fids), jnp.asarray(regus), jnp.asarray(gns))
    got = trainer._step_metrics(torch.tensor(fids), torch.tensor(regus), torch.tensor(gns))
    assert set(want) == set(got)
    for name, v in want.items():
        np.testing.assert_allclose(float(got[name]), float(v), rtol=1e-6, err_msg=name)


def test_mesh_branch_vertices_and_space_cache_cotangent_match_jax(pair):
    """The isosurface half of the mesh branch (the renderer's ``isosurface``):
    field on the grid -> grad shrink -> empty-field fallback -> marching cubes,
    differentiated from a vertex cotangent back to the space cache and the
    field MLPs."""
    from triplaneturbo_tpu.models.renderers.rasterize_renderer import (
        GenerativeSpaceMeshRasterizeRenderer,
        RasterizeRendererConfig,
    )
    jstage, train, frozen, trainer = _build_pair()
    rng = np.random.default_rng(3)
    cache = (rng.normal(size=(B, 6, 24, 24, 4)) * 0.5).astype(np.float32)
    R, cap = 12, dict(max_verts=2048, max_faces=4096)
    w = rng.normal(size=(B, cap["max_verts"], 3)).astype(np.float32)
    renderer = GenerativeSpaceMeshRasterizeRenderer(RasterizeRendererConfig(
        isosurface_resolution=R, **cap))
    jgeo = jstage.geometry

    def j_loss(tr, sc):
        p = combine_params(tr, frozen)["geometry"]
        meshes = renderer.isosurface(
            sc, lambda pts, c: jgeo.apply(p, pts, c, method=jgeo.forward_field), 0.01, 0.02,
            forward_field_grid=lambda c, r: jgeo.apply(p, c, r, method=jgeo.forward_field_grid))
        return sum((m.v_pos * w[i]).sum() for i, m in enumerate(meshes)), meshes

    (_, meshes_j), (g_train_j, g_sc_j) = jax.value_and_grad(j_loss, argnums=(0, 1), has_aux=True)(
        train, jnp.asarray(cache))
    sc = torch.tensor(cache).requires_grad_()
    geo = trainer.geometry
    meshes_t = TorchRenderer(TorchRendererConfig(isosurface_resolution=R, **cap)).isosurface(
        sc, geo.forward_field, 0.01, 0.02, forward_field_grid=geo.forward_field_grid)
    for mt, mj in zip(meshes_t, meshes_j):
        np.testing.assert_array_equal(mt.v_mask.numpy(), np.asarray(mj.v_mask))
        np.testing.assert_array_equal(mt.t_pos_idx.numpy(), np.asarray(mj.t_pos_idx))
        np.testing.assert_allclose(mt.v_pos.detach().numpy(), np.asarray(mj.v_pos), atol=1e-5)
        assert int(mt.v_mask.sum()) > 0
    field = {n: p for n, p in trainer.params_train.items() if n.startswith("field.")}
    verts = torch.stack([m.v_pos for m in meshes_t])
    grads = torch.autograd.grad(verts, [sc, *field.values()], torch.tensor(w), allow_unused=True)
    want_sc = np.asarray(g_sc_j)
    assert np.abs(want_sc).max() > 0
    np.testing.assert_allclose(grads[0].numpy(), want_sc, atol=REL_TOL * np.abs(want_sc).max())
    want = _trainable_leaves(g_train_j)
    for (name, p), g in zip(field.items(), grads[1:]):
        ref = want[name]
        if g is None:  # the feature MLP colours vertices; positions do not depend on it
            assert "feature_network" in name and not ref.any()
            continue
        np.testing.assert_allclose(g.numpy(), ref, atol=REL_TOL * np.abs(ref).max(), err_msg=name)


def test_round_trip_of_the_bridge(pair):
    _, train, _, trainer = pair
    dense = _prune_to_numpy(train)
    named_geo = flax_tree_to_named(dense["geometry"]["params"])
    named_bg = dict(trainer.background.named_parameters())
    named_vol = dict(trainer.volume_renderer.named_parameters())
    assert set(named_vol) == {"variance_inv_std"}
    v = named_vol["variance_inv_std"].detach()
    assert v.shape == () and float(v) == np.float32(0.35)
    assert set(named_geo) | {f"background.{n}" for n in named_bg} | {
        f"renderer.{n}" for n in named_vol} == set(trainer.trainable)
    for named, like in ((named_geo, dense["geometry"]["params"]),
                        (named_bg, dense["background"]["params"]),
                        (named_vol, dense["renderer"]["params"])):
        if named is named_geo:
            named = {n: torch.tensor(a) for n, a in named.items()}
        back = named_to_flax_tree(named, like)
        for (pa, a), (pb, b) in zip(sorted(_leaves(back).items()), sorted(_leaves(like).items())):
            assert pa == pb and a.shape == b.shape
            np.testing.assert_array_equal(a, b)
        with pytest.raises(KeyError):
            named_to_flax_tree({}, like)


def _prune_to_numpy(tree):
    if isinstance(tree, dict):
        out = {k: _prune_to_numpy(v) for k, v in tree.items() if v is not None}
        return {k: v for k, v in out.items() if not (isinstance(v, dict) and not v)}
    return np.asarray(tree)


def _leaves(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        path = f"{prefix}/{k}"
        if isinstance(v, dict):
            out.update(_leaves(v, path))
        else:
            out[path] = v
    return out


def _tiny_batch():
    from triplaneturbo_torch.data.multiview_multiprompt import (
        DataModuleConfig,
        MultiviewMultipromptDataModule,
    )

    dm = MultiviewMultipromptDataModule(DataModuleConfig(
        batch_size=B * 2, n_view=2, height=16, width=16, ray_height=64, ray_width=64,
        n_steps=1), seed=0)
    return dm.to_device({k: v for k, v in dm.sample_train_batch()[0].items() if k != "noise"},
                        "cpu")


def test_trainer_builds_on_cuda_by_default_and_leaves_the_rest_unported():
    if torch.cuda.is_available():
        pytest.skip("this host has a CUDA device")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        TriplaneTurboTrainer.build(space_generator_overrides=TINY_SG)
    trainer = TriplaneTurboTrainer.build(
        TrainerConfig(num_parts_training=NUM_PARTS, num_steps_training=NUM_PARTS),
        space_generator_overrides=TINY_SG, device="cpu")
    assert all(not bool(p.any()) for n, p in trainer.params_train.items() if n.endswith(".up"))
    assert {n for n in trainer.trainable if n.startswith("background.")} == {
        f"background.{n}" for n, _ in trainer.background.named_parameters()}
    assert [n for n in trainer.trainable if n.startswith("renderer.")] == [
        "renderer.variance_inv_std"]
    np.testing.assert_allclose(float(trainer.params_train["renderer.variance_inv_std"].detach()),
                               trainer.volume_renderer.cfg.learned_variance_init, rtol=1e-7)
    assert all(p.device.type == "cpu" and bool(torch.isfinite(p).all())
               for p in trainer.params_train.values())
    # the whole step runs on the CPU: the tiny config's system, one monolithic step
    from triplaneturbo_torch.data.multiview_multiprompt import (
        DataModuleConfig,
        MultiviewMultipromptDataModule,
    )
    from triplaneturbo_torch.systems.builder import build_system
    from triplaneturbo_torch.utils.config import load_config, parse_structured

    cfg = load_config(os.path.join(REPO, "configs", "smoke_tiny.yaml"))
    system = build_system(cfg, device="cpu")
    dm = MultiviewMultipromptDataModule(parse_structured(DataModuleConfig, cfg.data))
    gen = torch.Generator().manual_seed(0)
    text = {k: torch.randn(s, generator=gen) * (0 if k.startswith("uncond") else 1)
            for k, s in (("cond_local", (1, 77, 32)), ("cond_21", (1, 77, 32)),
                         ("uncond_21", (1, 77, 32)), ("cond_15", (1, 77, 32)),
                         ("uncond_15", (1, 77, 32)), ("global_21", (1, 32)))}
    metrics = system.train_step(dm.sample_train_batch(), text, gen)
    assert system.global_step == 1 and np.isfinite(float(metrics["loss"]))
    assert system.optimizer.adan.count == 1 and metrics["skipped_nonfinite"] == 0
    # the JAX package's msgpack weights load since A20b: a missing one raises, before
    # the system is built
    with pytest.raises(FileNotFoundError):
        build_system({"system": {"weights": "geometry.msgpack"}}, device="cpu")
    # built without teacher_sizes, the trainer has no teachers: program G refuses
    assert trainer.guidance is None
    with pytest.raises(RuntimeError, match="without teachers"):
        trainer._stage_teacher({}, {}, {}, {}, {})
    # both renderers run: the second branch needs its draws, and a branch by name
    with pytest.raises(ValueError, match="draws"):
        trainer._render_branch(_tiny_batch(), torch.zeros(B, 6, PLANE, PLANE, 4), {
            "rgb_grad_shrink": 1.0}, torch.zeros(B, 1024), "2nd")
    with pytest.raises(ValueError, match="unknown branch"):
        trainer._render_branch({}, None, {}, None, "3rd")
    with pytest.raises(ValueError, match="one branch"):
        trainer._stage_student_render({}, torch.zeros(1), {}, {}, {}, branch="both")
    with pytest.raises(ValueError):
        trainer._stage_update({})
