"""Conditional diffusion UNet (SD-2.1 family): the triplane student and the teachers.

Counterpart of ``triplaneturbo_tpu/models/unet.py``. One module covers four UNets:
the triplane student (SD-2.1-base with hexa self-LoRA, vanilla cross-LoRA,
vanilla_v1 LoCon and 6-plane joint self-attention), the SD-2.1 teacher (no
adapters), MVDream (a 16-d camera embedding added to the time embedding, 4-view
joint self-attention) and RichDreamer (MVDream's layout over the SD-1.5 768-d
text space, with a fixed count of 8 heads). The public ``forward`` keeps the JAX
layout (``sample [N, H, W, C]``); inside, the convolutions run NCHW.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ..utils.profiling import span
from .attention import NO_ADAPTERS, AdapterSpec, Transformer2D
from .unet_blocks import (
    AdaptedConv,
    Downsample2D,
    GroupNorm,
    ResnetBlock2D,
    Upsample2D,
    _n_groups,
    run_block,
    timestep_embedding,
)

DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


@dataclass(frozen=True)
class UNetConfig:
    in_channels: int = 4
    out_channels: int = 4
    block_out_channels: Tuple[int, ...] = (320, 640, 1280, 1280)
    layers_per_block: int = 2
    cross_attention_dim: int = 1024
    attention_head_dim: int = 64  # per-head dim; heads = channels // this
    # a fixed head count (RichDreamer: 8, so dim_head = channels // 8 at each level);
    # overrides attention_head_dim
    attention_num_heads: Optional[int] = None
    transformer_depth: int = 1
    camera_dim: Optional[int] = None  # MVDream / RichDreamer camera conditioning
    adapters: AdapterSpec = NO_ADAPTERS
    locon_type: str = "none"
    locon_rank: int = 16
    remat: bool = False  # checkpoint every resnet and transformer block (training memory)
    dtype_str: str = "float32"

    @property
    def dtype(self) -> torch.dtype:
        return DTYPES[self.dtype_str]


class UNet2DConditionModel(nn.Module):
    """SD-style UNet. sample [N, H, W, C_in], context [N, L, D] -> eps [N, H, W, C_out]."""

    def __init__(self, cfg: UNetConfig = UNetConfig()):
        super().__init__()
        self.cfg = cfg
        dtype = cfg.dtype
        ch0 = cfg.block_out_channels[0]
        time_dim = ch0 * 4
        n_blocks = len(cfg.block_out_channels)
        res_kw = dict(time_emb_dim=time_dim, locon_type=cfg.locon_type,
                      locon_rank=cfg.locon_rank, n_planes=cfg.adapters.n_planes, dtype=dtype)

        def attn(ch: int) -> Transformer2D:
            if cfg.attention_num_heads is not None:
                heads, dim_head = cfg.attention_num_heads, ch // cfg.attention_num_heads
            else:
                heads, dim_head = ch // cfg.attention_head_dim, cfg.attention_head_dim
            return Transformer2D(ch, heads, dim_head, cfg.transformer_depth,
                                 cfg.cross_attention_dim, adapters=cfg.adapters, dtype=dtype)

        self.time_embedding_linear_1 = nn.Linear(ch0, time_dim, dtype=dtype)
        self.time_embedding_linear_2 = nn.Linear(time_dim, time_dim, dtype=dtype)
        if cfg.camera_dim is not None:
            self.camera_embedding_linear_1 = nn.Linear(cfg.camera_dim, time_dim, dtype=dtype)
            self.camera_embedding_linear_2 = nn.Linear(time_dim, time_dim, dtype=dtype)
        self.conv_in = AdaptedConv(cfg.in_channels, ch0, dtype=dtype)

        cur = ch0
        skip_channels = [ch0]
        for i, ch in enumerate(cfg.block_out_channels):
            for j in range(cfg.layers_per_block):
                self.add_module(f"down_{i}_res_{j}", ResnetBlock2D(cur, ch, **res_kw))
                cur = ch
                if i < n_blocks - 1:
                    self.add_module(f"down_{i}_attn_{j}", attn(ch))
                skip_channels.append(ch)
            if i < n_blocks - 1:
                self.add_module(f"down_{i}_downsample", Downsample2D(
                    ch, locon_type=cfg.locon_type, locon_rank=cfg.locon_rank,
                    n_planes=cfg.adapters.n_planes, dtype=dtype))
                skip_channels.append(ch)

        mid = cfg.block_out_channels[-1]
        self.mid_res_0 = ResnetBlock2D(cur, mid, **res_kw)
        self.mid_attn = attn(mid)
        self.mid_res_1 = ResnetBlock2D(mid, mid, **res_kw)
        cur = mid

        for i, ch in enumerate(reversed(cfg.block_out_channels)):
            for j in range(cfg.layers_per_block + 1):
                self.add_module(f"up_{i}_res_{j}",
                                ResnetBlock2D(cur + skip_channels.pop(), ch, **res_kw))
                cur = ch
                if i > 0:
                    self.add_module(f"up_{i}_attn_{j}", attn(ch))
            if i < n_blocks - 1:
                self.add_module(f"up_{i}_upsample", Upsample2D(
                    ch, locon_type=cfg.locon_type, locon_rank=cfg.locon_rank,
                    n_planes=cfg.adapters.n_planes, dtype=dtype))

        self.conv_norm_out = GroupNorm(_n_groups(32, ch0), ch0, eps=1e-5, dtype=dtype)
        self.conv_out = AdaptedConv(ch0, cfg.out_channels, dtype=dtype)

    def forward(self, sample: torch.Tensor, timesteps: torch.Tensor,
                encoder_hidden_states: torch.Tensor,
                camera: Optional[torch.Tensor] = None) -> torch.Tensor:
        """``camera`` [N, camera_dim] is added through its embedding when the config
        has a ``camera_dim``; without one, or without a camera, it is not."""
        cfg = self.cfg
        dtype = cfg.dtype
        n_blocks = len(cfg.block_out_channels)
        timesteps = torch.as_tensor(timesteps, device=sample.device)
        if timesteps.ndim == 0:
            timesteps = timesteps.expand(sample.shape[0])

        temb = timestep_embedding(timesteps, cfg.block_out_channels[0]).to(dtype)
        temb = self.time_embedding_linear_2(F.silu(self.time_embedding_linear_1(temb)))
        if cfg.camera_dim is not None and camera is not None:
            cemb = F.silu(self.camera_embedding_linear_1(camera.to(dtype)))
            temb = temb + self.camera_embedding_linear_2(cemb)
        ctx = encoder_hidden_states.to(dtype)

        h = self.conv_in(sample.to(dtype).permute(0, 3, 1, 2))
        residuals = [h]
        with span("unet.down"):
            for i in range(n_blocks):
                for j in range(cfg.layers_per_block):
                    h = run_block(getattr(self, f"down_{i}_res_{j}"), cfg.remat, h, temb)
                    if i < n_blocks - 1:
                        h = run_block(getattr(self, f"down_{i}_attn_{j}"), cfg.remat, h, ctx)
                    residuals.append(h)
                if i < n_blocks - 1:
                    h = getattr(self, f"down_{i}_downsample")(h)
                    residuals.append(h)

        with span("unet.mid"):
            h = run_block(self.mid_res_0, cfg.remat, h, temb)
            h = run_block(self.mid_attn, cfg.remat, h, ctx)
            h = run_block(self.mid_res_1, cfg.remat, h, temb)

        with span("unet.up"):
            for i in range(n_blocks):
                for j in range(cfg.layers_per_block + 1):
                    h = torch.cat([h, residuals.pop()], dim=1)
                    h = run_block(getattr(self, f"up_{i}_res_{j}"), cfg.remat, h, temb)
                    if i > 0:
                        h = run_block(getattr(self, f"up_{i}_attn_{j}"), cfg.remat, h, ctx)
                if i < n_blocks - 1:
                    h = getattr(self, f"up_{i}_upsample")(h)

        h = self.conv_out(self.conv_norm_out(h, silu=True))
        return h.permute(0, 2, 3, 1).float()


def sd21_student_config(self_lora_type: str = "hexa_v1", cross_lora_type: str = "vanilla",
                        locon_type: str = "vanilla_v1", rank: int = 16, n_planes: int = 6,
                        remat: bool = False, dtype_str: str = "float32") -> UNetConfig:
    """The triplane student UNet: SD-2.1-base plus adapters."""
    return UNetConfig(
        adapters=AdapterSpec(
            self_lora_type=self_lora_type,
            cross_lora_type=cross_lora_type,
            self_rank=rank,
            cross_rank=rank,
            n_planes=n_planes,
            joint_self_attention=True,
            joint_group=n_planes,
        ),
        locon_type=locon_type,
        locon_rank=rank,
        remat=remat,
        dtype_str=dtype_str,
    )


def sd21_teacher_config(dtype_str: str = "bfloat16", remat: bool = False) -> UNetConfig:
    return UNetConfig(dtype_str=dtype_str, remat=remat)


def mvdream_config(dtype_str: str = "bfloat16", remat: bool = False) -> UNetConfig:
    """MVDream sd-v2.1-base-4view: camera_dim 16, 4-view joint self-attention."""
    return UNetConfig(camera_dim=16, adapters=AdapterSpec(joint_self_attention=True, joint_group=4),
                      dtype_str=dtype_str, remat=remat)


def richdreamer_config(dtype_str: str = "bfloat16", remat: bool = False) -> UNetConfig:
    """RichDreamer nd-mv: the SD-1.5 text space (768), camera conditioning, 4-view
    joint self-attention, a fixed count of 8 heads."""
    return UNetConfig(cross_attention_dim=768, camera_dim=16, attention_num_heads=8,
                      adapters=AdapterSpec(joint_self_attention=True, joint_group=4),
                      dtype_str=dtype_str, remat=remat)
