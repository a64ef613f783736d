"""Program R with both branches and program B-R "2nd" of the PyTorch port
against the JAX trainer on the CPU.

The JAX side runs the JAX trainer's own ``_render_branch`` and
``_stage_student_render`` on a stand-in that carries what they read (config,
geometry, background, both renderers, the patch config, material): the full
trainer also builds three teachers, which this slice does not reach. Both
packages get the same weights (flax trees bridged into the port, the volume
renderer's ``variance_inv_std`` too), the same cameras and rays (the JAX data
module's step-batch), the same space cache, pooled text states and image
cotangents, and the same volume draws: the JAX side derives the patch origin and
the sampler jitter from the part's key, and the test draws those arrays from the
same keys for the port. Tiny sizes: R = 12, 2 prompts x 2 views, 32² mesh renders,
12² rays (a 4² global render and one 4² patch), 8 proposal and 8 fine samples.
"""

from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from triplaneturbo_tpu.data.multiview_multiprompt import (
    DataModuleConfig as JaxDataModuleConfig,
    MultiviewMultipromptDataModule as JaxDataModule,
)
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
)
from triplaneturbo_tpu.models.materials.no_material import NoMaterial as JaxNoMaterial
from triplaneturbo_tpu.models.renderers.patch_renderer import (
    PatchRendererConfig as JaxPatchConfig,
)
from triplaneturbo_tpu.models.renderers.rasterize_renderer import (
    GenerativeSpaceMeshRasterizeRenderer as JaxRasterizer,
    RasterizeRendererConfig as JaxRasterizerConfig,
)
from triplaneturbo_tpu.models.renderers.volume_renderer import (
    GenerativeSpaceSDFVolumeRenderer as JaxVolumeRenderer,
    VolumeRendererConfig as JaxVolumeConfig,
)
from triplaneturbo_tpu.ops.hashgrid import HashGridConfig as JaxHashGridConfig
from triplaneturbo_tpu.systems.trainer import (
    LossConfig as JaxLossConfig,
    TrainerConfig as JaxTrainerConfig,
    TriplaneTurboTrainer as JaxTrainer,
    combine_params,
    split_params,
)
from triplaneturbo_torch.data.multiview_multiprompt import MultiviewMultipromptDataModule
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
from triplaneturbo_torch.models.renderers.patch_renderer import PatchDraws, PatchRendererConfig
from triplaneturbo_torch.models.renderers.rasterize_renderer import (
    GenerativeSpaceMeshRasterizeRenderer,
    RasterizeRendererConfig,
)
from triplaneturbo_torch.models.renderers.volume_renderer import (
    GenerativeSpaceSDFVolumeRenderer,
    VolumeRendererConfig,
)
from triplaneturbo_torch.models.schedulers import make_schedule
from triplaneturbo_torch.ops.hashgrid import HashGridConfig
from triplaneturbo_torch.systems.trainer import LossConfig, TrainerConfig, TriplaneTurboTrainer
from triplaneturbo_torch.utils.weights import flax_tree_to_named, init_random_, load_flax_params

torch.set_num_threads(2)

TINY_SG = dict(
    block_out_channels=(32, 64), layers_per_block=1, cross_attention_dim=32,
    attention_head_dim=8, vae_block_out_channels=(16, 32), vae_layers_per_block=1,
    output_dim=8, training_type="self_lora_rank_4-cross_lora_rank_4-locon_rank_4",
)
BSC, NV, HW, RAYS, R, C_DIM = 2, 2, 32, 12, 12, 32
RENDER = dict(isosurface_resolution=R, max_verts=2048, max_faces=4096, field_chunk=900)
VOLUME = dict(num_samples_per_ray=8, num_samples_per_ray_importance=8)
PATCH = dict(patch_size=4, global_downsample=3)
HASH = dict(n_levels=2, log2_hashmap_size=8)
KEYS = ("comp_rgb", "comp_normal_cam_vis", "disparity")
# f32 on both sides; a gradient leaf is a sum over many samples, pixels and vertices
# taken in another order by XLA and by PyTorch, and the fine samples' positions carry
# the proposal pass's rounding, so each output and leaf is held to 1e-4 of its own
# largest value
REL_TOL = 1e-4
REGULARIZERS_2ND = dict(lambda_sparsity_2nd=0.3, lambda_opaque_2nd=0.2,
                        lambda_z_variance_2nd=0.5, lambda_eikonal_2nd=0.1,
                        lambda_orient_2nd=2.0, lambda_sdf_abs=0.4)


class _JaxStage(SimpleNamespace):
    """The JAX trainer's render methods, unbound, over the attributes they read."""

    _render_branch = JaxTrainer._render_branch
    _stage_student_render = JaxTrainer._stage_student_render
    _regularizers_1st = JaxTrainer._regularizers_1st
    _regularizers_2nd = JaxTrainer._regularizers_2nd
    _term_on = JaxTrainer._term_on
    _GUIDANCE_IMAGE_KEYS = JaxTrainer._GUIDANCE_IMAGE_KEYS


def _build(loss, trainable_variance=True, field_chunk=0):
    """The JAX stand-in and its (train, frozen) partition, and the port's trainer
    with the same field MLPs, background and variance. Only the geometry's field
    is initialised on the JAX side: the renders reach nothing else of it."""
    rng = np.random.default_rng(0)
    jgeo = JaxTriplaneGeometry(JaxTriplaneGeometryConfig(
        space_generator=JaxSpaceGeneratorConfig(**TINY_SG)))
    field_tree = jax.tree_util.tree_map(np.asarray, jax.jit(lambda k: jgeo.init(
        k, jnp.zeros((1, 4, 3)), jnp.zeros((1, 6, 16, 16, 4)),
        method=lambda m, p, c: m.field.init_all(p, c)))(jax.random.PRNGKey(0)))["params"]
    jbg = JaxBackground(JaxBackgroundConfig(encoding=JaxHashGridConfig(**HASH),
                                            hypernet=JaxHyperNetConfig(c_dim=C_DIM)))
    bg_tree = jax.tree_util.tree_map(np.asarray, jax.jit(lambda k: jbg.init(
        k, jnp.zeros((1, 2, 2, 3)), jnp.zeros((1, C_DIM))))(jax.random.PRNGKey(1)))["params"]
    # a table at the scale of a trained one, so that the colour varies with direction
    bg_tree["encoding"]["table"] = rng.uniform(-1, 1, bg_tree["encoding"]["table"].shape
                                               ).astype(np.float32)
    jvol = JaxVolumeRenderer(JaxVolumeConfig(trainable_variance=trainable_variance, **VOLUME))
    # inv_std e^3 in place of the init's e^4.6: a sample's position carries the proposal
    # CDF's last-bit rounding, which the NeuS alpha multiplies by inv_std; at e^4.6 one of
    # these images differs between the packages by more than 1e-4 of its largest value
    vol_tree = {"variance_inv_std": np.float32(0.3)}
    params = {"geometry": {"params": field_tree}, "background": {"params": bg_tree},
              "renderer": {"params": vol_tree}}
    params = jax.tree_util.tree_map(jnp.asarray, params)
    train, frozen = split_params(params, jax.tree_util.tree_map(lambda _: True, params))
    jstage = _JaxStage(cfg=JaxTrainerConfig(loss=JaxLossConfig(**loss)), geometry=jgeo,
                       background=jbg,
                       rasterize_renderer=JaxRasterizer(JaxRasterizerConfig(**RENDER)),
                       volume_renderer=jvol, patch_cfg=JaxPatchConfig(**PATCH),
                       material_fn=JaxNoMaterial())

    geo = TriplaneGeometry(TriplaneGeometryConfig(space_generator=SpaceGeneratorConfig(**TINY_SG)))
    init_random_(geo, torch.Generator().manual_seed(0))
    load_flax_params(geo.field, field_tree["field"])
    bg = HashgridEnvironmentMapBackground(HashgridBackgroundConfig(
        encoding=HashGridConfig(**HASH), hypernet=HyperNetConfig(c_dim=C_DIM)))
    load_flax_params(bg, bg_tree)
    vol = GenerativeSpaceSDFVolumeRenderer(VolumeRendererConfig(
        trainable_variance=trainable_variance, field_chunk=field_chunk, **VOLUME))
    load_flax_params(vol, vol_tree)
    trainer = TriplaneTurboTrainer(
        TrainerConfig(loss=LossConfig(**loss)), geo, make_schedule(), background=bg,
        rasterize_renderer=GenerativeSpaceMeshRasterizeRenderer(RasterizeRendererConfig(**RENDER)),
        volume_renderer=vol, patch_cfg=PatchRendererConfig(**PATCH))
    return jstage, train, frozen, trainer


def _inputs(seed):
    rng = np.random.default_rng(seed)
    cfg = JaxDataModuleConfig(batch_size=BSC * NV, n_view=NV, height=HW, width=HW,
                              ray_height=RAYS, ray_width=RAYS, n_steps=1)
    batch = {k: v for k, v in JaxDataModule(cfg, seed=seed).sample_train_batch()[0].items()
             if isinstance(v, np.ndarray) and k != "noise"}
    f32 = lambda *s: rng.normal(size=s).astype(np.float32)  # noqa: E731
    grads = {f"{k}_{side}": f32(BSC * NV, n, n, 1 if k == "disparity" else 3)
             for k in KEYS for side, n in (("1st", HW), ("2nd", RAYS))}
    # the cache at 0.2, as the first branch's CPU test takes it: marching cubes divides
    # the packages' field rounding by the SDF's slope at the crossing
    return dict(batch=batch, cache=f32(BSC, 6, 16, 16, 4) * 0.2, text=f32(BSC, C_DIM),
                grads=grads, scalars=dict(sdf_grad_shrink=0.1, def_grad_shrink=0.2,
                                          rgb_grad_shrink=0.7))


def _jax_draws(key_render):
    """The draws the JAX ``_render_branch(key=key_render)`` makes for the second
    branch: the patch origin and both base renders' jitter."""
    k2 = jax.random.split(key_render)[1]
    k_patch, k_a, k_b = jax.random.split(k2, 3)
    ps, ds = PATCH["patch_size"], PATCH["global_downsample"]
    py = int(jax.random.randint(k_patch, (), 0, RAYS - ps))
    px = int(jax.random.randint(jax.random.fold_in(k_patch, 1), (), 0, RAYS - ps))
    B, g = BSC * NV, RAYS // ds

    def jitter(k, n_rays):
        k1, k2_ = jax.random.split(k)
        return (torch.tensor(np.asarray(jax.random.uniform(
                    k1, (n_rays, VOLUME["num_samples_per_ray_importance"] + 1)))),
                torch.tensor(np.asarray(jax.random.uniform(
                    k2_, (n_rays, VOLUME["num_samples_per_ray"] + 1)))))

    return PatchDraws(py, px, jitter(k_a, B * g * g), jitter(k_b, B * ps * ps))


def _port_args(x):
    batch = MultiviewMultipromptDataModule.to_device(x["batch"], "cpu")
    return batch, torch.tensor(x["cache"]), {"global_21": torch.tensor(x["text"])}


def _jax_scalars(x, loss=()):
    return {k: jnp.asarray(v, jnp.float32) for k, v in {**x["scalars"], **dict(loss)}.items()}


def _close(got, want, what):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    assert np.isfinite(got).all(), what
    np.testing.assert_allclose(got, want, atol=REL_TOL * max(float(np.abs(want).max()), 1e-12),
                               rtol=0, err_msg=what)


@pytest.fixture(scope="module")
def pair():
    return _build({})


def test_render_branch_both_matches_and_branches_are_independent(pair):
    jstage, train, frozen, trainer = pair
    x = _inputs(0)
    key = jax.random.PRNGKey(4)
    out1_j, out2_j = jax.jit(lambda p, b, sc, s, te: jstage._render_branch(
        p, b, sc, s, key, te, "both"))(
        combine_params(train, frozen), x["batch"], x["cache"], _jax_scalars(x), x["text"])
    batch, cache, text = _port_args(x)
    draws = _jax_draws(key)
    with torch.no_grad():
        out1_t, out2_t = trainer._render_branch(batch, cache, x["scalars"], text["global_21"],
                                                "both", draws)
    assert set(out2_t) == set(out2_j)
    for name, want in out2_j.items():
        _close(out2_t[name], want, f"2nd {name}")
    for name in KEYS:
        _close(out1_t[name], out1_j[name], f"1st {name}")
    op = out2_t["opacity"].numpy()
    assert op.max() > 0.5 and op.min() < 0.2, "the rays should see surface and background"
    # the patch carries the full-resolution render: it differs from the resized global one
    assert out2_t["comp_rgb"].shape == (BSC * NV, RAYS, RAYS, 3)
    # each branch alone renders as it does in "both"
    with torch.no_grad():
        one, none = trainer._render_branch(batch, cache, x["scalars"], text["global_21"], "1st")
        none2, two = trainer._render_branch(batch, cache, x["scalars"], text["global_21"], "2nd",
                                            draws)
    assert none is None and none2 is None
    for name in KEYS:
        assert torch.equal(one[name], out1_t[name]), name
    for name, v in out2_t.items():
        assert torch.equal(two[name], v), name


@pytest.mark.parametrize("regularizers,trainable_variance,field_chunk",
                         [(False, True, 0), (True, True, 50), (True, False, 0)])
def test_stage_student_render_2nd_gradients_match(regularizers, trainable_variance, field_chunk):
    loss = REGULARIZERS_2ND if regularizers else {}
    jstage, train, frozen, trainer = _build(loss, trainable_variance, field_chunk)
    x = _inputs(1)
    k = jax.random.PRNGKey(7)
    (grads_j, g_space_j, regu_j) = jax.jit(
        lambda tr, fr, b, sc, te, s, gi: jstage._stage_student_render(
            tr, fr, b, sc, {"global_21": te}, s, gi, k, "2nd"))(
        train, frozen, x["batch"], x["cache"], x["text"], _jax_scalars(x, loss), x["grads"])
    batch, cache, text = _port_args(x)
    draws = _jax_draws(jax.random.split(k, 3)[1])
    grads_t, g_space_t, regu_t = trainer._stage_student_render(
        batch, cache, text, {**x["scalars"], **loss},
        {kk: torch.tensor(v) for kk, v in x["grads"].items()}, branch="2nd", draws=draws)
    assert (float(regu_j) > 0) == regularizers
    np.testing.assert_allclose(float(regu_t), float(regu_j), rtol=1e-5)
    assert np.abs(np.asarray(g_space_j)).max() > 0
    _close(g_space_t, g_space_j, "g_space_2nd")
    dense = jax.tree_util.tree_map(np.asarray, grads_j)
    want = {**flax_tree_to_named(dense["geometry"]["params"]),
            **{f"background.{n}": a
               for n, a in flax_tree_to_named(dense["background"]["params"]).items()},
            **{f"renderer.{n}": a
               for n, a in flax_tree_to_named(dense["renderer"]["params"]).items()}}
    assert set(grads_t) == set(trainer.trainable) and set(want) <= set(grads_t)
    # the sdf, deformation and feature MLPs (3 layers each), 6 background leaves, the variance
    assert len(want) == 16
    for name, ref in want.items():
        reached = not ("deformation_network" in name
                       or (name == "renderer.variance_inv_std" and not trainable_variance))
        assert bool(np.abs(ref).max() > 0) == reached, name
        if reached:
            _close(grads_t[name], ref, name)
        else:
            assert not grads_t[name].any(), name
    # the adapters are reached through g_space, in program B-G
    for name in set(grads_t) - set(want):
        assert not grads_t[name].any(), name
