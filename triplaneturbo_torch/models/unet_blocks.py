"""UNet building blocks: adapted convs, resnets, up/down sampling, embeddings.

Counterpart of ``triplaneturbo_tpu/models/unet_blocks.py``, on NCHW tensors.
Module and parameter names follow the flax modules, so
:func:`triplaneturbo_torch.utils.weights.load_flax_params` maps them one to
one.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.nhwc import bias_add, group_norm_act
from .lora import FoldSite, LoConAdapter, PlaneLoConAdapter, bias_sum, fold_locon


def _n_groups(groups: int, channels: int) -> int:
    """Largest divisor of ``channels`` not exceeding ``groups``."""
    g = min(groups, channels)
    while channels % g:
        g -= 1
    return g


def run_block(block: nn.Module, remat: bool, *args):
    """Call ``block``; with ``remat`` under autograd, through
    ``torch.utils.checkpoint`` (the JAX package's ``nn.remat``): the block's
    activations are dropped after the forward and recomputed in the backward."""
    if remat and torch.is_grad_enabled():
        from torch.utils.checkpoint import checkpoint

        return checkpoint(block, *args, use_reentrant=False)
    return block(*args)


def timestep_embedding(timesteps: torch.Tensor, dim: int, flip_sin_to_cos: bool = True,
                       downscale_freq_shift: float = 0.0,
                       max_period: float = 10000.0) -> torch.Tensor:
    """Sinusoidal timestep embedding [N] -> [N, dim], float32."""
    half = dim // 2
    exponent = -math.log(max_period) * torch.arange(half, dtype=torch.float32,
                                                     device=timesteps.device)
    exponent = exponent / (half - downscale_freq_shift)
    emb = torch.exp(exponent)[None, :] * timesteps.float()[:, None]
    sin, cos = torch.sin(emb), torch.cos(emb)
    if flip_sin_to_cos:
        return torch.cat([cos, sin], dim=-1)
    return torch.cat([sin, cos], dim=-1)


class GroupNorm(FoldSite, nn.GroupNorm):
    """``nn.GroupNorm`` that can take the SiLU after it (``silu``). Folded
    (``lora.Fold``), the channels-last kernels of ``ops/nhwc.py`` on its own scale and
    shift, which also take a per-channel ``shift`` of the input (the bias of the conv
    before, left out of that conv)."""

    def fold_weights(self):
        return self.weight, self.bias

    def forward(self, x: torch.Tensor, silu: bool = False,
                shift: Optional[torch.Tensor] = None) -> torch.Tensor:
        folded = self.folded_now()
        if folded is not None:
            return group_norm_act(x, *folded, self.num_groups, self.eps, silu, shift)
        if shift is not None:
            raise ValueError("a shift is taken only while the fold is engaged")
        y = super().forward(x)
        return F.silu(y) if silu else y


class AdaptedConv(FoldSite, nn.Module):
    """Conv with an optional LoCon low-rank delta.

    locon_type: "none", "vanilla_v1" (shared) or "hexa_v1" (per plane: the
    input's batch is ``n_planes`` planes an item, plane-major). Folded
    (``lora.Fold``), a shared LoCon adds into the conv's channels-last weight; a conv
    with the per-plane one is no fold site and runs as it is.
    """

    def __init__(self, in_channels: int, features: int, kernel_size: int = 3, stride: int = 1,
                 padding: int = 1, use_bias: bool = True, locon_type: str = "none",
                 locon_rank: int = 16, locon_bias: bool = False, n_planes: int = 6,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.conv = nn.Conv2d(in_channels, features, kernel_size, stride=stride,
                              padding=padding, bias=use_bias, dtype=dtype)
        self.locon_type = locon_type
        if locon_type in ("vanilla_v1", "vanilla"):
            self.locon = LoConAdapter(in_channels, features, rank=locon_rank,
                                      kernel_size=kernel_size, stride=stride, padding=padding,
                                      with_bias=locon_bias)
        elif locon_type == "hexa_v1":
            self.locon = PlaneLoConAdapter(in_channels, features, n_planes=n_planes,
                                           rank=locon_rank, kernel_size=kernel_size,
                                           stride=stride, padding=padding, with_bias=locon_bias)
        elif locon_type not in ("none", None):
            raise ValueError(f"Unknown locon type {locon_type}")

    @property
    def foldable(self) -> bool:
        return self.locon_type != "hexa_v1"

    def fold_weights(self):
        return fold_locon(self.conv, getattr(self, "locon", None), self.conv.weight.dtype)

    def conv_without_bias(self, x: torch.Tensor, weight: torch.Tensor) -> torch.Tensor:
        """The conv of ``x`` with a folded ``weight``, its bias left to the caller."""
        return F.conv2d(x, weight, None, self.conv.stride, self.conv.padding)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        folded = self.folded_now()
        if folded is not None:
            weight, bias = folded
            return bias_add(self.conv_without_bias(x, weight), bias)
        y = self.conv(x)
        if self.locon_type in ("vanilla_v1", "vanilla", "hexa_v1"):
            return y + self.locon(x)
        return y


class ResnetBlock2D(nn.Module):
    """GN -> silu -> conv -> (+time emb) -> GN -> silu -> conv, residual."""

    def __init__(self, in_channels: int, out_channels: int, time_emb_dim: Optional[int] = None,
                 groups: int = 32, eps: float = 1e-5, locon_type: str = "none",
                 locon_rank: int = 16, n_planes: int = 6, dtype: torch.dtype = torch.float32):
        super().__init__()
        conv_kw = dict(locon_type=locon_type, locon_rank=locon_rank, n_planes=n_planes,
                       dtype=dtype)
        self.norm1 = GroupNorm(_n_groups(groups, in_channels), in_channels, eps=eps,
                               dtype=dtype)
        self.conv1 = AdaptedConv(in_channels, out_channels, **conv_kw)
        self.time_emb_proj = (nn.Linear(time_emb_dim, out_channels, dtype=dtype)
                              if time_emb_dim is not None else None)
        self.norm2 = GroupNorm(_n_groups(groups, out_channels), out_channels, eps=eps,
                               dtype=dtype)
        self.conv2 = AdaptedConv(out_channels, out_channels, **conv_kw)
        self.conv_shortcut = (AdaptedConv(in_channels, out_channels, kernel_size=1, padding=0,
                                          **conv_kw)
                              if in_channels != out_channels else None)

    def forward(self, x: torch.Tensor, temb: Optional[torch.Tensor] = None) -> torch.Tensor:
        folded = self.conv1.folded_now()
        if folded is not None:
            return self._forward_folded(x, temb, folded)
        h = self.conv1(self.norm1(x, silu=True))
        if temb is not None and self.time_emb_proj is not None:
            h = h + self.time_emb_proj(F.silu(temb))[:, :, None, None]
        h = self.conv2(self.norm2(h, silu=True))
        if self.conv_shortcut is not None:
            x = self.conv_shortcut(x)
        return x + h

    def _forward_folded(self, x: torch.Tensor, temb: Optional[torch.Tensor],
                        folded: tuple) -> torch.Tensor:
        """The folded block: conv1's bias and the time embedding are ``norm2``'s shift,
        and conv2's bias (with the shortcut's) is added with the residual in one pass."""
        w1, b1 = folded
        w2, b2 = self.conv2.folded_now()
        h = self.conv1.conv_without_bias(self.norm1(x, silu=True), w1)
        shift = b1
        if temb is not None and self.time_emb_proj is not None:
            shift = bias_sum(self.time_emb_proj(F.silu(temb)), b1)
        h = self.conv2.conv_without_bias(self.norm2(h, silu=True, shift=shift), w2)
        if self.conv_shortcut is not None:
            ws, bs = self.conv_shortcut.folded_now()
            x = self.conv_shortcut.conv_without_bias(x, ws)
            b2 = bias_sum(b2, bs)
        return bias_add(h, b2, residual=x)


class Downsample2D(nn.Module):
    """Stride-2 3x3 conv with symmetric (1, 1) padding."""

    def __init__(self, channels: int, locon_type: str = "none", locon_rank: int = 16,
                 n_planes: int = 6, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.conv = AdaptedConv(channels, channels, stride=2, padding=1, locon_type=locon_type,
                                locon_rank=locon_rank, n_planes=n_planes, dtype=dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.conv(x)


class Upsample2D(nn.Module):
    """Nearest 2x upsample (``jax.image.resize(..., "nearest")``), then a 3x3 conv."""

    def __init__(self, channels: int, locon_type: str = "none", locon_rank: int = 16,
                 n_planes: int = 6, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.conv = AdaptedConv(channels, channels, locon_type=locon_type,
                                locon_rank=locon_rank, n_planes=n_planes, dtype=dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.conv(F.interpolate(x, scale_factor=2, mode="nearest"))
