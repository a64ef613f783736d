"""SD AutoencoderKL decoder with the triplane ``conv_out`` retrofit.

Counterpart of the decode half of ``triplaneturbo_tpu/models/vae.py``: the
student decoder with vanilla_v1 LoCon adapters, "basic" LoRA on the mid
attention, and ``conv_out`` replaced by a 128 -> ``output_dim`` (64) conv.
No latent scaling is applied before decoding. The public ``decode`` keeps the
JAX layout (``[N, h, w, 4] -> [N, 8h, 8w, output_dim]``); inside, NCHW.
The encoder (used only by the teachers) is not ported yet. ``remat``
checkpoints every resnet block, as the JAX module does for training.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Tuple

import torch
import torch.nn.functional as F
from torch import nn

from .attention import AdapterSpec, Attention
from .unet import DTYPES
from .unet_blocks import AdaptedConv, ResnetBlock2D, Upsample2D, _n_groups, run_block


@dataclass(frozen=True)
class VAEConfig:
    latent_channels: int = 4
    block_out_channels: Tuple[int, ...] = (128, 256, 512, 512)
    layers_per_block: int = 2
    output_dim: int = 64  # the retrofit conv_out maps 128 -> output_dim feature channels
    attn_lora_type: str = "none"
    locon_type: str = "none"
    rank: int = 16
    remat: bool = False  # checkpoint every resnet block (training memory)
    dtype_str: str = "float32"

    @property
    def dtype(self) -> torch.dtype:
        return DTYPES[self.dtype_str]


class VAEAttnBlock(nn.Module):
    """Single-head self-attention over spatial tokens (head dim = channels)."""

    def __init__(self, channels: int, lora_type: str = "none", rank: int = 16,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        C = channels
        self.group_norm = nn.GroupNorm(_n_groups(32, C), C, eps=1e-6, dtype=dtype)
        self.attention = Attention(C, heads=1, dim_head=C, qkv_bias=True,
                                   adapters=AdapterSpec(self_lora_type=lora_type, self_rank=rank),
                                   dtype=dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        N, C, H, W = x.shape
        h = self.group_norm(x).permute(0, 2, 3, 1).reshape(N, H * W, C)
        h = self.attention(h)
        return x + h.reshape(N, H, W, C).permute(0, 3, 1, 2)


class Decoder(nn.Module):
    def __init__(self, cfg: VAEConfig = VAEConfig()):
        super().__init__()
        self.cfg = cfg
        dtype = cfg.dtype
        res_kw = dict(time_emb_dim=None, groups=32, eps=1e-6, locon_type=cfg.locon_type,
                      locon_rank=cfg.rank, dtype=dtype)
        ch_top = cfg.block_out_channels[-1]
        self.conv_in = AdaptedConv(cfg.latent_channels, ch_top, dtype=dtype)
        self.mid_res_0 = ResnetBlock2D(ch_top, ch_top, **res_kw)
        self.mid_attn = VAEAttnBlock(ch_top, lora_type=cfg.attn_lora_type, rank=cfg.rank,
                                     dtype=dtype)
        self.mid_res_1 = ResnetBlock2D(ch_top, ch_top, **res_kw)
        rev = tuple(reversed(cfg.block_out_channels))
        cur = ch_top
        for i, ch in enumerate(rev):
            for j in range(cfg.layers_per_block + 1):
                self.add_module(f"up_{i}_res_{j}", ResnetBlock2D(cur, ch, **res_kw))
                cur = ch
            if i < len(rev) - 1:
                self.add_module(f"up_{i}_upsample", Upsample2D(
                    ch, locon_type=cfg.locon_type, locon_rank=cfg.rank, dtype=dtype))
        self.conv_norm_out = nn.GroupNorm(_n_groups(32, rev[-1]), rev[-1], eps=1e-6, dtype=dtype)
        self.conv_out_retrofit = nn.Conv2d(rev[-1], cfg.output_dim, 3, padding=1, dtype=dtype)

    def forward(self, z: torch.Tensor) -> torch.Tensor:
        """z [N, 4, h, w] -> [N, C_out, 8h, 8w] float32."""
        cfg = self.cfg
        h = self.conv_in(z.to(cfg.dtype))
        h = run_block(self.mid_res_0, cfg.remat, h, None)
        h = self.mid_attn(h)
        h = run_block(self.mid_res_1, cfg.remat, h, None)
        n_up = len(cfg.block_out_channels)
        for i in range(n_up):
            for j in range(cfg.layers_per_block + 1):
                h = run_block(getattr(self, f"up_{i}_res_{j}"), cfg.remat, h, None)
            if i < n_up - 1:
                h = getattr(self, f"up_{i}_upsample")(h)
        return self.conv_out_retrofit(F.silu(self.conv_norm_out(h))).float()


class AutoencoderKL(nn.Module):
    """post_quant_conv + decoder, SD layout."""

    def __init__(self, cfg: VAEConfig = VAEConfig()):
        super().__init__()
        self.cfg = cfg
        self.decoder = Decoder(cfg)
        # float32 like the flax module, which gives this conv no dtype
        self.post_quant_conv = nn.Conv2d(cfg.latent_channels, cfg.latent_channels, 1,
                                         dtype=torch.float32)

    def decode(self, z: torch.Tensor) -> torch.Tensor:
        """z [N, h, w, 4] -> [N, 8h, 8w, C_out] float32."""
        h = self.post_quant_conv(z.float().permute(0, 3, 1, 2))
        return self.decoder(h).permute(0, 2, 3, 1)


def student_vae_config(output_dim: int = 64, rank: int = 16, dtype_str: str = "float32",
                       remat: bool = False) -> VAEConfig:
    """The retrofitted student decoder ('basic' attention LoRA, vanilla_v1 LoCon)."""
    return VAEConfig(output_dim=output_dim, attn_lora_type="basic", locon_type="vanilla_v1",
                     rank=rank, remat=remat, dtype_str=dtype_str)
