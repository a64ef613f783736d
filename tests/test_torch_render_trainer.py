"""Programs R and B-R "1st" of the PyTorch port against the JAX trainer on the CPU.

The JAX side runs the JAX trainer's own ``_render_branch`` and
``_stage_student_render`` on a stand-in that carries what they read (config,
geometry, background, rasterize renderer, material): the full trainer also
builds the volume renderer and three teachers, which this slice does not
reach. Both packages get the same weights (flax trees bridged into the
port), the same cameras (the JAX data module's step-batch), the same space
cache, pooled text states and image cotangents, at a tiny size: R = 12,
2 prompts x 2 views at 32².
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
from triplaneturbo_tpu.models.renderers.rasterize_renderer import (
    GenerativeSpaceMeshRasterizeRenderer as JaxRenderer,
    RasterizeRendererConfig as JaxRendererConfig,
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
from triplaneturbo_torch.models.renderers.patch_renderer import PatchRendererConfig
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
BSC, NV, HW, R, C_DIM = 2, 2, 32, 12, 32
RENDER = dict(isosurface_resolution=R, max_verts=2048, max_faces=4096, field_chunk=900)
HASH = dict(n_levels=2, log2_hashmap_size=8)
KEYS = ("comp_rgb", "comp_normal_cam_vis", "disparity")
# f32 on both sides; a gradient leaf is a sum over many pixels and vertices taken in
# another order by XLA and by PyTorch, so each output and leaf is held to 1e-4 of its
# own largest value
REL_TOL = 1e-4
REGULARIZERS = dict(lambda_sparsity=0.3, lambda_opaque=0.2, lambda_normal_consistency=0.5,
                    lambda_laplacian_smoothness=2.0)


class _JaxStage(SimpleNamespace):
    """The JAX trainer's first-renderer methods, unbound, over the attributes they read."""

    _render_branch = JaxTrainer._render_branch
    _stage_student_render = JaxTrainer._stage_student_render
    _regularizers_1st = JaxTrainer._regularizers_1st
    _term_on = JaxTrainer._term_on
    _GUIDANCE_IMAGE_KEYS = JaxTrainer._GUIDANCE_IMAGE_KEYS


def _build(loss):
    """The JAX stand-in and its (train, frozen) partition, and the port's trainer
    with the same field MLPs and background. Only the geometry's field is
    initialised on the JAX side: the render reaches nothing else of it."""
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
    params = {"geometry": {"params": field_tree}, "background": {"params": bg_tree}}
    params = jax.tree_util.tree_map(jnp.asarray, params)
    train, frozen = split_params(params, jax.tree_util.tree_map(lambda _: True, params))
    jstage = _JaxStage(cfg=JaxTrainerConfig(loss=JaxLossConfig(**loss)), geometry=jgeo,
                       background=jbg, rasterize_renderer=JaxRenderer(JaxRendererConfig(**RENDER)),
                       material_fn=JaxNoMaterial())

    geo = TriplaneGeometry(TriplaneGeometryConfig(space_generator=SpaceGeneratorConfig(**TINY_SG)))
    init_random_(geo, torch.Generator().manual_seed(0))
    load_flax_params(geo.field, field_tree["field"])
    bg = HashgridEnvironmentMapBackground(HashgridBackgroundConfig(
        encoding=HashGridConfig(**HASH), hypernet=HyperNetConfig(c_dim=C_DIM)))
    load_flax_params(bg, bg_tree)
    renderer = GenerativeSpaceMeshRasterizeRenderer(RasterizeRendererConfig(**RENDER))
    # the second branch at the 8² rays of these batches: a 2² global render and a 4² patch
    volume = GenerativeSpaceSDFVolumeRenderer(VolumeRendererConfig(
        num_samples_per_ray=8, num_samples_per_ray_importance=8))
    trainer = TriplaneTurboTrainer(TrainerConfig(loss=LossConfig(**loss)), geo, make_schedule(),
                                   background=bg, rasterize_renderer=renderer,
                                   volume_renderer=volume, patch_cfg=PatchRendererConfig(4))
    return jstage, train, frozen, trainer


def _inputs(seed):
    rng = np.random.default_rng(seed)
    cfg = JaxDataModuleConfig(batch_size=BSC * NV, n_view=NV, height=HW, width=HW, ray_height=8,
                              ray_width=8, n_steps=1)
    batch = {k: v for k, v in JaxDataModule(cfg, seed=seed).sample_train_batch()[0].items()
             if isinstance(v, np.ndarray) and k != "noise"}
    f32 = lambda *s: rng.normal(size=s).astype(np.float32)  # noqa: E731
    grads = {f"{k}_1st": f32(BSC * NV, HW, HW, 1 if k == "disparity" else 3) for k in KEYS}
    # The two packages' fields differ by f32 rounding (1e-6 of the SDF here); marching
    # cubes divides that by the SDF's slope at the crossing. A cache at 0.2 keeps the
    # slope near a distance function's (vertices agree to 3e-6); at 0.5 the random
    # field has flat crossings that take vertices to 4e-5 apart, and the vertex normals
    # of the slivers there to 1.3e-4, in both packages' arithmetic alike.
    return dict(batch=batch, cache=f32(BSC, 6, 16, 16, 4) * 0.2, text=f32(BSC, C_DIM),
                grads=grads, scalars=dict(sdf_grad_shrink=0.1, def_grad_shrink=0.2,
                                          **{k: float(v) for k, v in REGULARIZERS.items()}))


def _port_args(x):
    batch = MultiviewMultipromptDataModule.to_device(x["batch"], "cpu")
    return batch, torch.tensor(x["cache"]), {"global_21": torch.tensor(x["text"])}


def _jax_scalars(x):
    return {k: jnp.asarray(v, jnp.float32) for k, v in x["scalars"].items()}


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


def test_render_branch_1st_matches(pair):
    jstage, train, frozen, trainer = pair
    x = _inputs(0)
    out_j, none_j = jax.jit(lambda p, b, sc, s, te: jstage._render_branch(
        p, b, sc, s, jax.random.PRNGKey(0), te, "1st"))(
        combine_params(train, frozen), x["batch"], x["cache"], _jax_scalars(x), x["text"])
    batch, cache, text = _port_args(x)
    with torch.no_grad():
        out_t, none_t = trainer._render_branch(batch, cache, x["scalars"], text["global_21"], "1st")
    assert none_j is None and none_t is None
    assert set(out_t) == set(out_j) | {"n_span_overflow", "n_list_overflow"}
    for i, (mt, mj) in enumerate(zip(out_t["mesh"], out_j["mesh"])):
        np.testing.assert_array_equal(mt.t_pos_idx.numpy(), np.asarray(mj.t_pos_idx))
        np.testing.assert_array_equal(mt.t_mask.numpy(), np.asarray(mj.t_mask))
        _close(mt.v_pos, mj.v_pos, f"mesh {i} vertices")
        assert int(mt.t_mask.sum()) > 50
    for name, want in out_j.items():
        if name != "mesh":
            _close(out_t[name], want, name)
    assert float(out_t["opacity"].mean()) > 0.05
    assert out_t["n_span_overflow"].shape == (BSC * NV,) and not out_t["n_list_overflow"].any()


@pytest.mark.parametrize("regularizers", [False, True])
def test_stage_student_render_1st_gradients_match(regularizers):
    jstage, train, frozen, trainer = _build(REGULARIZERS if regularizers else {})
    x = _inputs(1)
    (grads_j, g_space_j, regu_j) = jax.jit(lambda tr, fr, b, sc, te, s, gi: jstage._stage_student_render(
        tr, fr, b, sc, {"global_21": te}, s, gi, jax.random.PRNGKey(0), "1st"))(
        train, frozen, x["batch"], x["cache"], x["text"], _jax_scalars(x), x["grads"])
    batch, cache, text = _port_args(x)
    grads_t, g_space_t, regu_t = trainer._stage_student_render(
        batch, cache, text, x["scalars"], {k: torch.tensor(v) for k, v in x["grads"].items()},
        branch="1st")
    assert (float(regu_j) > 0) == regularizers
    np.testing.assert_allclose(float(regu_t), float(regu_j), rtol=1e-5)
    assert np.abs(np.asarray(g_space_j)).max() > 0
    _close(g_space_t, g_space_j, "g_space_1st")
    dense = jax.tree_util.tree_map(np.asarray, grads_j)

    def prune(node):
        if isinstance(node, dict):
            out = {k: prune(v) for k, v in node.items() if v is not None}
            return {k: v for k, v in out.items() if not (isinstance(v, dict) and not v)}
        return node

    dense = prune(dense)
    want = {**flax_tree_to_named(dense["geometry"]["params"]),
            **{f"background.{n}": a
               for n, a in flax_tree_to_named(dense["background"]["params"]).items()}}
    assert set(grads_t) == set(trainer.trainable) and set(want) <= set(grads_t)
    # the sdf, deformation and feature MLPs (3 layers each) and the 6 background leaves
    assert len(want) == 15
    for name, ref in want.items():
        assert np.abs(ref).max() > 0, name
        _close(grads_t[name], ref, name)
    # the adapters are reached through g_space, in program B-G
    for name in set(grads_t) - set(want):
        assert not grads_t[name].any(), name


def test_stage_render_is_the_no_grad_render_of_the_decoded_cache(pair):
    _, _, _, trainer = pair
    x = _inputs(2)
    batch, _, text = _port_args(x)
    rng = np.random.default_rng(3)
    latent = torch.tensor(rng.normal(size=(BSC, 6, 8, 8, 4)).astype(np.float32))
    noise = torch.tensor(rng.normal(size=(BSC, 6, 8, 8, 4)).astype(np.float32))
    text["cond_local"] = torch.tensor(rng.normal(size=(BSC, 7, 32)).astype(np.float32))
    scalars = dict(x["scalars"], rgb_grad_shrink=1.0)
    draws = trainer.draw_volume(batch, torch.Generator().manual_seed(4))
    denoised, space_cache, images, overflow = trainer._stage_render(
        batch, latent, 499, text, scalars, noise, draws)
    assert not space_cache.requires_grad and not any(v.requires_grad for v in images.values())
    assert set(images) == {f"{k}_{side}" for k in KEYS for side in ("1st", "2nd")}
    with torch.no_grad():
        want_den, want_sc = trainer._denoise_decode(latent, 499, text, noise)
        out_1st, out_2nd = trainer._render_branch(batch, want_sc, scalars, text["global_21"],
                                                  "both", draws)
    assert torch.equal(denoised, want_den) and torch.equal(space_cache, want_sc)
    for k in KEYS:
        assert torch.equal(images[f"{k}_1st"], out_1st[k]), k
        assert torch.equal(images[f"{k}_2nd"], out_2nd[k]), k
    assert images["comp_rgb_2nd"].shape == (BSC * NV, 8, 8, 3)
    assert set(overflow) == {"n_span_overflow", "n_list_overflow"}
    assert all(v.shape == (BSC * NV,) for v in overflow.values())
