"""Program G of the PyTorch port against the JAX trainer on the CPU.

The JAX side runs the JAX trainer's own ``_stage_teacher`` (over
``_guidance_losses``) on a stand-in that carries what it reads (the config and the
guidance with three tiny teachers from the JAX package's ``build_teacher``, sized as
``tests/test_trainer_staged.py`` sizes them); the port's trainer is built with
``teacher_sizes`` and its teachers then take the JAX teachers' weights through the
bridge. Both get the same six images, cameras (the JAX data module's step-batch),
text states and scalars, and the same draws: the test repeats the JAX splits
(``_stage_teacher``'s ``split(k, 3)``, ``_guidance_losses``' ``split(k_guid, 3)`` and,
with the renderers one after the other, ``split(k_teacher, 2)``; the branches'
``split(key, 4 | 3 | 5)``) to draw the port's :class:`GuidanceDraws`.

Tolerances, f32 on both sides: ``fid`` and ``grad_norm_mv`` 1e-5 relative; each image
gradient within 1e-4 of its own largest value.
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
from triplaneturbo_tpu.models.guidance.asd_guidance import (
    ASDConfig as JaxASDConfig,
    ASDGuidance as JaxASDGuidance,
)
from triplaneturbo_tpu.systems.builder import build_teacher as jax_build_teacher
from triplaneturbo_tpu.systems.trainer import (
    TrainerConfig as JaxTrainerConfig,
    TriplaneTurboTrainer as JaxTrainer,
)
from triplaneturbo_torch.data.multiview_multiprompt import MultiviewMultipromptDataModule
from triplaneturbo_torch.models.background.hashgrid_env_map import (
    HashgridBackgroundConfig,
    HyperNetConfig,
)
from triplaneturbo_torch.models.guidance.asd_guidance import ASDConfig, GuidanceDraws
from triplaneturbo_torch.ops.hashgrid import HashGridConfig
from triplaneturbo_torch.systems.trainer import LossConfig, TrainerConfig, TriplaneTurboTrainer
from triplaneturbo_torch.utils.weights import load_flax_params

torch.set_num_threads(2)

REL = 1e-5
GRAD_REL = 1e-4
TINY_SG = dict(block_out_channels=(16, 32), layers_per_block=1, cross_attention_dim=32,
               attention_head_dim=8, vae_block_out_channels=(8, 16), vae_layers_per_block=1,
               output_dim=8, training_type="self_lora_rank_4-cross_lora_rank_4-locon_rank_4")
TINY_TEACHER = dict(block_out_channels=(16, 32), layers_per_block=1, attention_head_dim=8,
                    cross_attention_dim=32)
TEACHER_SIZES = {"mv": {**TINY_TEACHER, "vae_block_out_channels": (8, 16),
                        "vae_layers_per_block": 1},
                 "rd": dict(TINY_TEACHER),
                 "sd": {**TINY_TEACHER, "vae_block_out_channels": (8, 16),
                        "vae_layers_per_block": 1}}
IMAGE_SIZES = dict(mv_image_size=16, rd_image_size=8, sd_image_size=16)
VIEWS, HW1, HW2 = 8, 32, 16
LATENT_HW = {"mv": 8, "rd": 8, "sd": 8}
KEYS = ("comp_rgb", "comp_normal_cam_vis", "disparity")
LOSS = dict(lambda_asd=1.0, lambda_asd_2nd=0.5)


class _JaxStage(SimpleNamespace):
    """The JAX trainer's program G, unbound, over the attributes it reads."""

    _stage_teacher = JaxTrainer._stage_teacher
    _guidance_losses = JaxTrainer._guidance_losses
    _GUIDANCE_IMAGE_KEYS = JaxTrainer._GUIDANCE_IMAGE_KEYS


@pytest.fixture(scope="module")
def teachers():
    jb = {kind: jax_build_teacher(kind, jax.random.PRNGKey(10 + i), TEACHER_SIZES[kind],
                                  "float32")
          for i, kind in enumerate(("mv", "rd", "sd"))}
    return jb, JaxASDGuidance(JaxASDConfig(**IMAGE_SIZES), **jb)


def _build(jb, parallel):
    trainer = TriplaneTurboTrainer.build(
        TrainerConfig(parallel_guidance=parallel, loss=LossConfig(**LOSS)), seed=0,
        device="cpu", space_generator_overrides=TINY_SG,
        background_cfg=HashgridBackgroundConfig(
            encoding=HashGridConfig(n_levels=2, log2_hashmap_size=8),
            hypernet=HyperNetConfig(c_dim=32)),
        teacher_sizes=TEACHER_SIZES, teacher_dtype="float32",
        guidance_cfg=ASDConfig(**IMAGE_SIZES))
    for kind, b in jb.items():
        mine = getattr(trainer.guidance, kind)
        load_flax_params(mine.unet, jax.tree_util.tree_map(np.asarray, b.unet_params)["params"])
        if mine.vae is not None:
            load_flax_params(mine.vae, jax.tree_util.tree_map(np.asarray, b.vae_params)["params"])
    return trainer


def _branch_draws(kind, key, dual, min_step, max_step, n_view=4):
    """The draws the JAX branch of ``kind`` makes from ``key``."""
    prompts = VIEWS // n_view
    images = VIEWS * (2 if dual else 1)
    view = k_e = None
    if kind == "mv":
        k_t, k_p, k_n, k_e = jax.random.split(key, 4)
    elif kind == "rd":
        k_t, k_p, k_n = jax.random.split(key, 3)
    else:
        k_v, k_t, k_p, k_n, k_e = jax.random.split(key, 5)
        view = jax.random.randint(k_v, (prompts,), 0, n_view)
        images = prompts * (2 if dual else 1)
    n_t = images if kind == "sd" else images // n_view
    shape = (images, LATENT_HW[kind], LATENT_HW[kind], 4)

    def tt(x, dtype=torch.float32):
        return None if x is None else torch.tensor(np.asarray(x)).to(dtype)

    return GuidanceDraws(
        tt(jax.random.randint(k_t, (n_t,), min_step, max_step), torch.long),
        tt(jax.random.uniform(k_p, (n_t,))), tt(jax.random.normal(k_n, shape)),
        None if k_e is None else tt(jax.random.normal(k_e, shape)), tt(view, torch.long))


def _draws_from_key(k, parallel, scalars):
    """Program G's draws, from the part's key as the JAX trainer splits it."""
    _, _, k_guid = jax.random.split(k, 3)
    out = {}
    for kind, k_kind in zip(("mv", "rd", "sd"), jax.random.split(k_guid, 3)):
        keys = [k_kind] if parallel else list(jax.random.split(k_kind, 2))
        out[kind] = [_branch_draws(kind, key, parallel, scalars[f"{kind}_min_step"],
                                   scalars[f"{kind}_max_step"]) for key in keys]
    return out


def _inputs(seed):
    rng = np.random.default_rng(seed)
    cfg = JaxDataModuleConfig(batch_size=VIEWS, n_view=4, height=HW1, width=HW1,
                              ray_height=HW2, ray_width=HW2, n_steps=1)
    batch = {k: v for k, v in JaxDataModule(cfg, seed=seed).sample_train_batch()[0].items()
             if isinstance(v, np.ndarray) and k != "noise"}
    images = {f"{k}_{side}": rng.uniform(size=(VIEWS, hw, hw, 1 if k == "disparity" else 3)
                                         ).astype(np.float32)
              for k in KEYS for side, hw in (("1st", HW1), ("2nd", HW2))}
    text = {k: rng.normal(size=(2, 77, 32)).astype(np.float32) * (0.1 if "uncond" in k else 1)
            for k in ("cond_21", "uncond_21", "cond_15", "uncond_15")}
    return batch, images, text


def _jax_scalars(scalars):
    return {k: jnp.asarray(v, jnp.int32 if isinstance(v, int) else jnp.float32)
            for k, v in scalars.items()}


def _close(got, want, what):
    got, want = got.detach().numpy(), np.asarray(want)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    assert np.isfinite(got).all() and np.abs(got).max() > 0, what
    np.testing.assert_allclose(got, want, atol=GRAD_REL * float(np.abs(want).max()), rtol=0,
                               err_msg=what)


@pytest.mark.parametrize("parallel", [False, True], ids=["one_after_the_other", "stacked"])
def test_stage_teacher_matches(teachers, parallel):
    jb, jguidance = teachers
    trainer = _build(jb, parallel)
    jstage = _JaxStage(cfg=JaxTrainerConfig(parallel_guidance=parallel), guidance=jguidance)
    batch, images, text = _inputs(0)
    scalars = trainer.host_scalars()
    k = jax.random.PRNGKey(21)
    (fid_j, gn_j), grads_j = jax.jit(lambda tp, im, b, te, s: jstage._stage_teacher(
        tp, im, b, te, s, k))(jguidance.teacher_params(), images, batch, text,
                              _jax_scalars(scalars))
    draws = _draws_from_key(k, parallel, scalars)
    (fid_t, gn_t), grads_t = trainer._stage_teacher(
        {n: torch.tensor(v) for n, v in images.items()},
        MultiviewMultipromptDataModule.to_device(batch, "cpu"),
        {n: torch.tensor(v) for n, v in text.items()}, scalars, draws)
    np.testing.assert_allclose(float(fid_t), float(fid_j), rtol=REL, atol=0)
    assert tuple(gn_t.shape) == ((2,) if parallel else ())
    np.testing.assert_allclose(gn_t.numpy(), np.asarray(gn_j), rtol=REL, atol=0)
    assert set(grads_t) == set(grads_j) == set(images)
    for n, g in grads_t.items():
        assert g.shape == images[n].shape
        _close(g, grads_j[n], f"d fid / d {n}")


def test_draw_guidance_shapes_and_ranges(teachers):
    jb, _ = teachers
    batch, _, _ = _inputs(1)
    for parallel in (False, True):
        trainer = _build(jb, parallel)
        scalars = trainer.host_scalars()
        b = MultiviewMultipromptDataModule.to_device(batch, "cpu")
        draws = trainer.draw_guidance(b, torch.Generator().manual_seed(3))
        again = trainer.draw_guidance(b, torch.Generator().manual_seed(3))
        n = 2 if parallel else 1
        for kind in ("mv", "rd", "sd"):
            assert len(draws[kind]) == (1 if parallel else 2)
            for d, e in zip(draws[kind], again[kind]):
                assert torch.equal(d.t, e.t) and torch.equal(d.noise, e.noise)
                assert int(d.t.min()) >= scalars[f"{kind}_min_step"]
                assert int(d.t.max()) < scalars[f"{kind}_max_step"]
                assert float(d.u.min()) >= 0 and float(d.u.max()) < 1
                images = (VIEWS // 4 if kind == "sd" else VIEWS) * n
                assert tuple(d.noise.shape) == (images, 8, 8, 4)
                assert (d.eps is None) == (kind == "rd")
                assert (d.view is None) == (kind != "sd")
                assert tuple(d.t.shape) == ((images,) if kind == "sd" else (images // 4,))
