"""CLIP ViT image encoder: the evaluation harness's image tower (ViT-B/32 by default).

Counterpart of ``triplaneturbo_tpu/models/clip_vision.py``: a bias-free patch-embed
conv, the class token, position embeddings and ``pre_layernorm``, then the text
tower's pre-LN :class:`~triplaneturbo_torch.models.clip_text.CLIPLayer` with no
causal mask and quick GELU, ``post_layernorm`` on token 0 and ``visual_projection``.
At 224² ViT-B/32 has 50 tokens, so its attention is the plain einsum, as the text
tower's and the JAX tower's.

:func:`preprocess_for_clip` resizes as ``jax.image.resize(..., "bilinear")`` does: a
triangle kernel widened by the downscale factor (antialiased when it shrinks), each
output row's weights normalised, applied as one matrix an axis
(:func:`resize_matrix`, built in numpy).
"""

from __future__ import annotations

import functools
from dataclasses import dataclass

import numpy as np
import torch
from torch import nn

from .clip_text import CLIPLayer, CLIPTextConfig


@dataclass(frozen=True)
class CLIPVisionConfig:
    image_size: int = 224
    patch_size: int = 32
    width: int = 768
    layers: int = 12
    heads: int = 12
    intermediate: int = 3072
    projection_dim: int = 512
    eps: float = 1e-5


class CLIPVisionEncoder(nn.Module):
    """pixels [B, H, W, 3] (CLIP-normalised) -> image features [B, projection_dim]."""

    def __init__(self, cfg: CLIPVisionConfig = CLIPVisionConfig()):
        super().__init__()
        c = cfg
        self.cfg = cfg
        self.patch_embedding = nn.Conv2d(3, c.width, c.patch_size, stride=c.patch_size,
                                         bias=False)
        self.class_embedding = nn.Parameter(torch.empty(c.width))
        n_pos = (c.image_size // c.patch_size) ** 2 + 1
        self.position_embedding = nn.Parameter(torch.empty(n_pos, c.width))
        self.pre_layernorm = nn.LayerNorm(c.width, eps=c.eps)
        layer_cfg = CLIPTextConfig(width=c.width, layers=c.layers, heads=c.heads,
                                   intermediate=c.intermediate, hidden_act="quick_gelu",
                                   eps=c.eps)
        for i in range(c.layers):
            self.add_module(f"layers_{i}", CLIPLayer(layer_cfg))
        self.post_layernorm = nn.LayerNorm(c.width, eps=c.eps)
        self.visual_projection = nn.Linear(c.width, c.projection_dim, bias=False)

    def forward(self, pixels: torch.Tensor) -> torch.Tensor:
        c = self.cfg
        B = pixels.shape[0]
        x = self.patch_embedding(pixels.permute(0, 3, 1, 2))  # [B, width, h, w]
        x = x.flatten(2).transpose(1, 2)  # row-major patches, as the NHWC reshape
        x = torch.cat([self.class_embedding.expand(B, 1, c.width), x], dim=1)
        x = self.pre_layernorm(x + self.position_embedding[None, :x.shape[1]])
        full = torch.ones((1, 1, 1, 1), dtype=torch.bool, device=x.device)
        for i in range(c.layers):
            x = getattr(self, f"layers_{i}")(x, full)
        return self.visual_projection(self.post_layernorm(x[:, 0]))


CLIP_IMAGE_MEAN = (0.48145466, 0.4578275, 0.40821073)
CLIP_IMAGE_STD = (0.26862954, 0.26130258, 0.27577711)


@functools.lru_cache(maxsize=16)
def resize_matrix(in_size: int, out_size: int) -> np.ndarray:
    """[in_size, out_size] float32 weights of ``jax.image.resize``'s "bilinear" along
    one axis (``jax.image.scale_and_translate`` with translation 0 and antialiasing):
    output sample j sits at (j + 0.5) / scale - 0.5 of the input; the triangle kernel
    is widened by max(1 / scale, 1); each column is normalised to sum 1."""
    scale = np.float32(out_size) / np.float32(in_size)
    inv_scale = np.float32(1.0) / scale
    kernel_scale = max(inv_scale, np.float32(1.0))
    sample = (np.arange(out_size, dtype=np.float32) + 0.5) * inv_scale - 0.5
    x = np.abs(sample[None, :] - np.arange(in_size, dtype=np.float32)[:, None]) / kernel_scale
    w = np.maximum(0.0, 1.0 - x).astype(np.float32)
    total = w.sum(axis=0, keepdims=True)
    w = np.where(np.abs(total) > 1000.0 * np.finfo(np.float32).eps,
                 w / np.where(total != 0, total, 1), 0.0)
    inside = (sample >= -0.5) & (sample <= in_size - 0.5)
    return np.where(inside[None, :], w, 0.0).astype(np.float32)


def resize_bilinear(images: torch.Tensor, height: int, width: int) -> torch.Tensor:
    """[B, H, W, C] -> [B, height, width, C], as ``jax.image.resize(..., "bilinear")``;
    an axis whose size does not change is left as it is."""
    _, H, W, _ = images.shape
    x = images
    if H != height:
        wh = torch.from_numpy(resize_matrix(H, height)).to(images.device, images.dtype)
        x = torch.einsum("bhwc,hy->bywc", x, wh)
    if W != width:
        ww = torch.from_numpy(resize_matrix(W, width)).to(images.device, images.dtype)
        x = torch.einsum("bywc,wx->byxc", x, ww)
    return x


def preprocess_for_clip(images: torch.Tensor, image_size: int = 224) -> torch.Tensor:
    """[B, H, W, 3] in [0, 1] -> resized to ``image_size``² and CLIP-normalised."""
    x = resize_bilinear(images, image_size, image_size)
    mean = torch.tensor(CLIP_IMAGE_MEAN, device=x.device, dtype=x.dtype)
    std = torch.tensor(CLIP_IMAGE_STD, device=x.device, dtype=x.dtype)
    return (x - mean) / std
