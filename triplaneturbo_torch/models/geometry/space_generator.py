"""Triplane space generator: adapted SD-2.1 UNet + retrofitted VAE decoder.

Counterpart of ``triplaneturbo_tpu/models/geometry/space_generator.py``:

* ``denoise``: UNet ε over ``B x 6`` plane latents ``[B, P, H, W, 4]``, with
  the text embedding repeated per plane and t broadcast to every plane;
* ``decode``: VAE-decode latents to ``[B, P, 8H, 8W, output_dim]`` planes,
  without latent scaling.

With ``gradient_checkpoint`` (training memory) the UNet and VAE blocks are
checkpointed and the six planes decode one after another, each under its own
checkpoint, as in the JAX decode.
"""

from __future__ import annotations

import re
from dataclasses import dataclass, replace

import torch
from torch import nn

from ..unet import UNet2DConditionModel, sd21_student_config
from ..vae import AutoencoderKL, student_vae_config


@dataclass(frozen=True)
class SpaceGeneratorConfig:
    training_type: str = "self_lora_rank_16-cross_lora_rank_16-locon_rank_16"
    output_dim: int = 64
    self_lora_type: str = "hexa_v1"
    cross_lora_type: str = "vanilla"
    locon_type: str = "vanilla_v1"
    n_planes: int = 6
    gradient_checkpoint: bool = False
    dtype_str: str = "float32"
    # architecture size knobs (defaults = SD-2.1-base; small values for tests)
    block_out_channels: tuple = (320, 640, 1280, 1280)
    layers_per_block: int = 2
    cross_attention_dim: int = 1024
    attention_head_dim: int = 64
    vae_block_out_channels: tuple = (128, 256, 512, 512)
    vae_layers_per_block: int = 2

    def rank(self, which: str) -> int:
        """The adapter rank named in ``training_type`` (16 when absent)."""
        m = re.search(rf"{which}_rank_(\d+)", self.training_type)
        return int(m.group(1)) if m else 16


class TriplaneSpaceGenerator(nn.Module):
    def __init__(self, cfg: SpaceGeneratorConfig = SpaceGeneratorConfig()):
        super().__init__()
        c = cfg
        self.cfg = cfg
        unet_cfg = replace(
            sd21_student_config(self_lora_type=c.self_lora_type,
                                cross_lora_type=c.cross_lora_type, locon_type=c.locon_type,
                                rank=c.rank("self_lora"), n_planes=c.n_planes,
                                remat=c.gradient_checkpoint, dtype_str=c.dtype_str),
            block_out_channels=tuple(c.block_out_channels),
            layers_per_block=c.layers_per_block,
            cross_attention_dim=c.cross_attention_dim,
            attention_head_dim=c.attention_head_dim,
        )
        self.unet = UNet2DConditionModel(unet_cfg)
        vae_cfg = replace(
            student_vae_config(output_dim=c.output_dim, rank=c.rank("locon"),
                               dtype_str=c.dtype_str, remat=c.gradient_checkpoint),
            block_out_channels=tuple(c.vae_block_out_channels),
            layers_per_block=c.vae_layers_per_block,
        )
        self.vae = AutoencoderKL(vae_cfg)

    def denoise(self, noisy_input: torch.Tensor, text_embed: torch.Tensor, t) -> torch.Tensor:
        """noisy [B, P, H, W, C], text [B, L, D] or [B, P, L, D], t [] / [B] / [B*P]."""
        c = self.cfg
        B, P, H, W, C = noisy_input.shape
        if P != c.n_planes:
            raise ValueError(f"expected {c.n_planes} planes, got {P}")
        x = noisy_input.reshape(B * P, H, W, C)
        if text_embed.ndim == 3:
            ctx = text_embed.repeat_interleave(P, dim=0)
        elif text_embed.ndim == 4:
            ctx = text_embed.reshape(B * P, *text_embed.shape[-2:])
        else:
            raise ValueError("text_embed must be [B, L, D] or [B, P, L, D]")
        t = torch.as_tensor(t, device=noisy_input.device)
        if t.ndim == 0:
            t = t.expand(B * P)
        elif t.shape[0] == B:
            t = t.repeat_interleave(P, dim=0)
        eps = self.unet(x, t, ctx)
        return eps.reshape(B, P, H, W, C)

    def decode(self, latents: torch.Tensor) -> torch.Tensor:
        """[B, P, h, w, 4] -> [B, P, 8h, 8w, output_dim] feature planes, float32."""
        B, P, h, w, C = latents.shape
        if self.cfg.gradient_checkpoint and torch.is_grad_enabled():
            # the decoder is plane-independent: one plane at a time cuts the
            # peak activation memory sixfold for the same arithmetic
            from torch.utils.checkpoint import checkpoint

            return torch.stack([checkpoint(self.vae.decode, latents[:, p], use_reentrant=False)
                                for p in range(P)], dim=1)
        planes = self.vae.decode(latents.reshape(B * P, h, w, C))
        return planes.reshape(B, P, *planes.shape[-3:])
