"""SD AutoencoderKL: the decoder with the triplane ``conv_out`` retrofit, and the
teachers' encoder.

Counterpart of ``triplaneturbo_tpu/models/vae.py``. Decode half: the student
decoder with vanilla_v1 LoCon adapters, "basic" LoRA on the mid attention, and
``conv_out`` replaced by a 128 -> ``output_dim`` (64) conv; no latent scaling is
applied before decoding. Encode half (:class:`AutoencoderKLEncoder`, the MVDream
and SD-2.1 teachers' image -> latent path): the plain SD encoder and
``quant_conv``, which is all a teacher's VAE holds, as the flax tree the JAX
builder inits (``method=vae.encode``). The public ``decode`` and ``encode`` keep
the JAX layout (``[N, h, w, C]``); inside, NCHW. ``remat`` checkpoints every
resnet block of the decoder, as the JAX module does for training.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.nhwc import bias_add
from .attention import AdapterSpec, Attention
from .lora import FoldSite, fold_locon
from .unet import DTYPES
from .unet_blocks import (
    AdaptedConv,
    GroupNorm,
    ResnetBlock2D,
    Upsample2D,
    _n_groups,
    run_block,
)


@dataclass(frozen=True)
class VAEConfig:
    in_channels: int = 3  # image channels the encoder reads
    latent_channels: int = 4
    block_out_channels: Tuple[int, ...] = (128, 256, 512, 512)
    layers_per_block: int = 2
    output_dim: int = 64  # the retrofit conv_out maps 128 -> output_dim feature channels
    attn_lora_type: str = "none"
    locon_type: str = "none"
    rank: int = 16
    scaling_factor: float = 0.18215
    remat: bool = False  # checkpoint every resnet block (training memory)
    dtype_str: str = "float32"

    @property
    def dtype(self) -> torch.dtype:
        return DTYPES[self.dtype_str]


class CastConv2d(FoldSite, nn.Conv2d):
    """A conv whose parameters are cast to its input's dtype in the forward: flax's
    conv with ``param_dtype`` f32 and ``dtype`` the model's (``compute_dtype``). Folded
    (``lora.Fold``), on a channels-last copy of its weight in ``compute_dtype``."""

    def __init__(self, *args, compute_dtype: torch.dtype, **kwargs):
        super().__init__(*args, **kwargs)
        self.compute_dtype = compute_dtype

    def fold_weights(self):
        return fold_locon(self, None, self.compute_dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        folded = self.folded_now()
        if folded is not None:
            weight, bias = folded
            return bias_add(F.conv2d(x, weight, None, self.stride, self.padding), bias)
        bias = None if self.bias is None else self.bias.to(x.dtype)
        return self._conv_forward(x, self.weight.to(x.dtype), bias)


class VAEAttnBlock(nn.Module):
    """Single-head self-attention over spatial tokens (head dim = channels)."""

    def __init__(self, channels: int, lora_type: str = "none", rank: int = 16,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        C = channels
        self.group_norm = GroupNorm(_n_groups(32, C), C, eps=1e-6, dtype=dtype)
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
        self.conv_norm_out = GroupNorm(_n_groups(32, rev[-1]), rev[-1], eps=1e-6, dtype=dtype)
        # trainable, so stored in f32 (as the recipe and the flax conv keep it)
        self.conv_out_retrofit = CastConv2d(rev[-1], cfg.output_dim, 3, padding=1,
                                            dtype=torch.float32, compute_dtype=dtype)

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
        return self.conv_out_retrofit(self.conv_norm_out(h, silu=True)).float()


class Encoder(nn.Module):
    """conv_in, the down blocks, mid res / attention / res, norm, silu, conv_out to
    ``2 * latent_channels`` moments (mean ++ logvar)."""

    def __init__(self, cfg: VAEConfig = VAEConfig()):
        super().__init__()
        self.cfg = cfg
        dtype = cfg.dtype
        res_kw = dict(time_emb_dim=None, groups=32, eps=1e-6, dtype=dtype)
        chs = cfg.block_out_channels
        self.conv_in = AdaptedConv(cfg.in_channels, chs[0], dtype=dtype)
        cur = chs[0]
        for i, ch in enumerate(chs):
            for j in range(cfg.layers_per_block):
                self.add_module(f"down_{i}_res_{j}", ResnetBlock2D(cur, ch, **res_kw))
                cur = ch
            if i < len(chs) - 1:
                self.add_module(f"down_{i}_downsample",
                                AdaptedConv(ch, ch, stride=2, padding=0, dtype=dtype))
        ch_top = chs[-1]
        self.mid_res_0 = ResnetBlock2D(cur, ch_top, **res_kw)
        self.mid_attn = VAEAttnBlock(ch_top, dtype=dtype)
        self.mid_res_1 = ResnetBlock2D(ch_top, ch_top, **res_kw)
        self.conv_norm_out = nn.GroupNorm(_n_groups(32, ch_top), ch_top, eps=1e-6, dtype=dtype)
        self.conv_out = nn.Conv2d(ch_top, 2 * cfg.latent_channels, 3, padding=1, dtype=dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """x [N, C_in, H, W] -> moments [N, 2 * latent_channels, H / f, W / f] float32."""
        cfg = self.cfg
        n = len(cfg.block_out_channels)
        h = self.conv_in(x.to(cfg.dtype))
        for i in range(n):
            for j in range(cfg.layers_per_block):
                h = getattr(self, f"down_{i}_res_{j}")(h, None)
            if i < n - 1:
                # the SD VAE's downsample pads right and bottom only, then a stride-2
                # conv without padding: symmetric padding would shift every window a pixel
                h = getattr(self, f"down_{i}_downsample")(F.pad(h, (0, 1, 0, 1)))
        h = self.mid_res_1(self.mid_attn(self.mid_res_0(h, None)), None)
        return self.conv_out(F.silu(self.conv_norm_out(h))).float()


class AutoencoderKLEncoder(nn.Module):
    """The encode half of the SD AutoencoderKL: encoder + quant_conv."""

    def __init__(self, cfg: VAEConfig = VAEConfig()):
        super().__init__()
        self.cfg = cfg
        self.encoder = Encoder(cfg)
        # stored in the model's dtype, computed in f32: the flax conv has no dtype, so
        # it promotes the f32 moments against the bf16 kernel the builder stores
        self.quant_conv = nn.Conv2d(2 * cfg.latent_channels, 2 * cfg.latent_channels, 1,
                                    dtype=cfg.dtype)

    def encode_moments(self, x: torch.Tensor) -> torch.Tensor:
        """x [N, H, W, C_in] -> moments [N, h, w, 2 * latent_channels] float32."""
        h = self.encoder(x.permute(0, 3, 1, 2))
        w, b = self.quant_conv.weight, self.quant_conv.bias
        return F.conv2d(h, w.float(), b.float()).permute(0, 2, 3, 1)

    def encode(self, x: torch.Tensor, eps: Optional[torch.Tensor] = None,
               scale: bool = True) -> torch.Tensor:
        """Latents of ``x`` [N, H, W, C_in]: a posterior sample mean + std * ``eps``
        when the noise ``eps`` [N, h, w, latent_channels] is given, else the mean;
        times ``scaling_factor`` when ``scale``."""
        mean, logvar = self.encode_moments(x).chunk(2, dim=-1)
        if eps is not None:
            std = torch.exp(0.5 * torch.clamp(logvar, -30.0, 20.0))
            mean = mean + std * eps
        if scale:
            mean = mean * self.cfg.scaling_factor
        return mean


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
