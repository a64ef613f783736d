"""Frozen teachers for the ASD guidance.

Counterpart of ``build_teacher`` in ``triplaneturbo_tpu/systems/builder.py`` (the
rest of that builder, ``build_system``, is not ported). A teacher is built on the
meta device, materialised on ``device``, given random weights from a seeded
generator, stored in its dtype (bf16 by default: the frozen weights need no f32
copy) and frozen. MVDream and SD-2.1 get their VAE encoders (encoder and
``quant_conv``); RichDreamer scores normals and disparity directly and has none.
"""

from __future__ import annotations

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
    from ``generator`` (on ``device``). ``sizes`` overrides fields of the UNet config;
    its ``vae_``-prefixed keys override the VAE's."""
    if ckpt_path:
        raise NotImplementedError(
            f"loading the {kind} teacher from {ckpt_path} waits for ROADMAP A20")
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
    return TeacherBundle(unet, vae)
