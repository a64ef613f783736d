"""System builder: config dict → the assembled training system.

Counterpart of ``triplaneturbo_tpu/systems/builder.py``. :func:`build_system`
reads a config (``configs/*.yaml`` through ``utils.config.load_config``) in the
JAX builder's order -- geometry, background, the two renderers and the patch
config, the three teachers and the guidance, the trainer's and the loss's
configs -- and assembles the trainer through ``TriplaneTurboTrainer.build``, on
the meta device and then on ``device``, with random weights from ``seed``.

:func:`build_teacher` builds one frozen teacher: on the meta device, materialised
on ``device``, given random weights from a seeded generator, stored in its dtype
(bf16 by default: the frozen weights need no f32 copy) and frozen. MVDream and
SD-2.1 get their VAE encoders (encoder and ``quant_conv``); RichDreamer scores
normals and disparity directly and has none.
"""

from __future__ import annotations

import dataclasses
from dataclasses import replace
from typing import Any, Dict, Optional, Union

import torch

from ..models.guidance.asd_guidance import TeacherBundle
from ..models.unet import (
    DTYPES,
    UNet2DConditionModel,
    mvdream_config,
    richdreamer_config,
    sd21_teacher_config,
)
from ..models.vae import AutoencoderKLEncoder, VAEConfig
from ..utils.config import parse_structured
from ..utils.weights import init_random_

_CONFIGS = {"mv": mvdream_config, "rd": richdreamer_config, "sd": sd21_teacher_config}


def _materialise(module: torch.nn.Module, device: torch.device, dtype: torch.dtype,
                 generator: torch.Generator) -> torch.nn.Module:
    module = module.to_empty(device=device)
    init_random_(module, generator)
    return module.to(dtype).eval().requires_grad_(False)


def build_teacher(kind: str, generator: torch.Generator, sizes: Optional[Dict[str, Any]] = None,
                  dtype_str: str = "bfloat16", device: Union[str, torch.device] = "cuda",
                  ckpt_path: Optional[str] = None) -> TeacherBundle:
    """One frozen teacher, ``kind`` in ("mv", "rd", "sd"), with random weights drawn
    from ``generator`` (on ``device``), then, given ``ckpt_path``, the weights of that
    checkpoint in any layout ``utils/checkpoint.py`` ``load_teacher_params`` reads.
    ``sizes`` overrides fields of the UNet config; its ``vae_``-prefixed keys override
    the VAE's."""
    if kind not in _CONFIGS:
        raise ValueError(kind)
    device = torch.device(device)
    sizes = {k: tuple(v) if isinstance(v, list) else v for k, v in dict(sizes or {}).items()}
    vae_sizes = {k[4:]: sizes.pop(k) for k in list(sizes) if k.startswith("vae_")}
    ucfg = replace(_CONFIGS[kind](dtype_str), **sizes)
    dtype = DTYPES[dtype_str]
    with torch.device("meta"):
        unet = UNet2DConditionModel(ucfg)
        vae = (AutoencoderKLEncoder(VAEConfig(dtype_str=dtype_str, **vae_sizes))
               if kind in ("mv", "sd") else None)
    unet = _materialise(unet, device, dtype, generator)
    if vae is not None:
        vae = _materialise(vae, device, dtype, generator)
    if ckpt_path:
        raise ValueError("the reference takes its weights from the benchmark, not a checkpoint")
    return TeacherBundle(unet, vae)


def _sub(cfg: Dict, key: str) -> Dict:
    return dict(cfg.get(key, {}) or {})


# the geometry's own keys in a config's ``system.geometry``
_GEOMETRY_KEYS = ("n_feature_dims", "sdf_bias", "sdf_bias_params", "rotate_planes",
                  "split_channels", "geo_interpolate", "tex_interpolate", "radius")


def build_system(cfg: Dict[str, Any], seed: int = 0,
                 device: Union[str, torch.device] = "cuda"):
    """The training system a config describes (see ``configs/triplaneturbo_v1.yaml``),
    on ``device`` with random weights from ``seed``; ``system.weights`` then loads the
    geometry from a ``geometry.pt``, a ``geometry.msgpack`` (either package's) or the
    reference's adapter ``.pth``,
    and the guidance's ``{mv,rd,sd}_ckpt_path`` keys load the teachers (any layout of
    ``load_teacher_params``); the ``*_model_name_or_path`` keys are dropped, as in the
    JAX builder."""
    from ..models.background.hashgrid_env_map import HashgridBackgroundConfig, HyperNetConfig
    from ..models.geometry.space_generator import SpaceGeneratorConfig
    from ..models.guidance.asd_guidance import ASDConfig
    from ..models.renderers.patch_renderer import PatchRendererConfig
    from ..models.renderers.rasterize_renderer import RasterizeRendererConfig
    from ..models.renderers.volume_renderer import VolumeRendererConfig
    from ..ops.hashgrid import HashGridConfig
    from .trainer import LossConfig, TrainerConfig, TriplaneTurboTrainer

    sys_cfg = _sub(cfg, "system")
    if sys_cfg.get("weights"):
        raise ValueError("the reference takes its weights from the benchmark, not system.weights")
    # -- geometry (student)
    geo_d = _sub(sys_cfg, "geometry")
    sg = parse_structured(SpaceGeneratorConfig, _sub(geo_d, "space_generator_config"))
    # -- background
    bg_d = _sub(sys_cfg, "background")
    bg_cfg = HashgridBackgroundConfig(
        hypernet=HyperNetConfig(c_dim=bg_d.get("c_dim", sg.cross_attention_dim)),
        encoding=parse_structured(HashGridConfig, _sub(bg_d, "encoding")))
    # -- renderers
    volume_cfg = parse_structured(VolumeRendererConfig, _sub(sys_cfg, "renderer_2nd"))
    renderer_cfg = parse_structured(RasterizeRendererConfig, _sub(sys_cfg, "renderer"))
    patch_cfg = parse_structured(PatchRendererConfig, _sub(sys_cfg, "patch"))
    # -- teachers and guidance
    guidance_d = _sub(sys_cfg, "guidance")
    ckpt_paths = {kind: guidance_d.pop(f"{kind}_ckpt_path", None) for kind in ("mv", "rd", "sd")}
    for kind in ("mv", "rd", "sd"):
        guidance_d.pop(f"{kind}_model_name_or_path", None)
    # -- the trainer's and the loss's configs
    trainer_cfg = parse_structured(TrainerConfig, sys_cfg)
    trainer_cfg.loss = parse_structured(LossConfig, _sub(sys_cfg, "loss"))
    trainer = TriplaneTurboTrainer.build(
        trainer_cfg, seed=seed, device=device,
        space_generator_overrides=dataclasses.asdict(sg),
        geometry_overrides={k: geo_d[k] for k in _GEOMETRY_KEYS if k in geo_d},
        background_cfg=bg_cfg, renderer_cfg=renderer_cfg, volume_cfg=volume_cfg,
        patch_cfg=patch_cfg, teacher_sizes=_sub(sys_cfg, "teacher_sizes"),
        teacher_dtype=sys_cfg.get("teacher_dtype", "bfloat16"), teacher_ckpt_paths=ckpt_paths,
        guidance_cfg=parse_structured(ASDConfig, guidance_d),
        color_activation=sys_cfg.get("color_activation", "sigmoid-mipnerf"))
    return trainer

