"""The triplane geometry: space generator + implicit field, one module.

Counterpart of ``triplaneturbo_tpu/models/geometry/triplane_geometry.py``
(the JAX package's registry decorator is not carried over). The trainable
set -- the adapters, the VAE ``conv_out`` retrofit and the field MLPs -- is a
predicate on parameter names (:func:`is_trainable`), applied to a module by
:func:`mark_trainable`.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, List, Optional

import torch
from torch import nn

from ..networks import MLPConfig
from .space_generator import SpaceGeneratorConfig, TriplaneSpaceGenerator
from .triplane_field import TriplaneField, TriplaneFieldConfig, decode_space_cache


@dataclass
class TriplaneGeometryConfig:
    n_feature_dims: int = 3
    sdf_bias: Any = "sphere"
    sdf_bias_params: Any = 0.5
    rotate_planes: Optional[str] = "v1"
    split_channels: Optional[str] = "v1"
    geo_interpolate: str = "v1"
    tex_interpolate: str = "v2"
    isosurface_deformable_grid: bool = True
    radius: float = 1.0
    space_generator: SpaceGeneratorConfig = field(default_factory=SpaceGeneratorConfig)
    mlp: MLPConfig = field(default_factory=MLPConfig)


class TriplaneGeometry(nn.Module):
    def __init__(self, cfg: TriplaneGeometryConfig = TriplaneGeometryConfig()):
        super().__init__()
        self.cfg = c = cfg
        self.space_generator = TriplaneSpaceGenerator(c.space_generator)
        per_plane_dim = c.space_generator.output_dim // (2 if c.split_channels == "v1" else 1)
        self.field = TriplaneField(TriplaneFieldConfig(
            n_feature_dims=c.n_feature_dims,
            sdf_bias=c.sdf_bias,
            sdf_bias_params=c.sdf_bias_params,
            rotate_planes=c.rotate_planes,
            split_channels=c.split_channels,
            geo_interpolate=c.geo_interpolate,
            tex_interpolate=c.tex_interpolate,
            isosurface_deformable_grid=c.isosurface_deformable_grid,
            radius=c.radius,
            input_dim=per_plane_dim,
            mlp=c.mlp,
        ))

    def denoise(self, noisy_input, text_embed, t):
        return self.space_generator.denoise(noisy_input, text_embed, t)

    def decode(self, latents):
        """latents [B, 6, h, w, 4] -> dual space cache [B, 6, H, W, C/2]."""
        planes = self.space_generator.decode(latents)
        return decode_space_cache(planes, self.cfg.split_channels)

    def forward_field(self, points, space_cache):
        """SDF and deformation at points [B, N, 3]: the renderer's fallback
        where no grid path is given."""
        return self.field.forward_field(points, space_cache)

    def forward_field_grid(self, space_cache, resolution: int):
        return self.field.forward_field_grid(space_cache, resolution)

    def forward_sdf(self, points, space_cache):
        return self.field.forward_sdf(points, space_cache)

    def forward(self, points, space_cache):
        """SDF and texture features at points [B, N, 3]."""
        return self.field(points, space_cache)

    def export(self, points, space_cache):
        return self.field.export(points, space_cache)


def is_trainable(name: str) -> bool:
    """The JAX ``trainable_mask`` rule on a dotted parameter name: adapter
    parameters (lora / locon), the VAE ``conv_out`` retrofit, and everything
    under ``field`` (the sdf, feature and deformation MLPs)."""
    low = name.lower()
    if "lora" in low or "locon" in low or "retrofit" in low:
        return True
    return "field" in low.split(".")


@torch.no_grad()
def mark_trainable(geometry: TriplaneGeometry) -> List[str]:
    """Set ``requires_grad`` by :func:`is_trainable`; return the trainable names.

    With ``dtype_str == "bfloat16"`` the JAX trainer stores every frozen f32
    leaf in bf16. The port's frozen backbone is built in bf16 already; the few
    frozen leaves that compute in f32 (``post_quant_conv``) take the same
    bf16-rounded values and keep f32 storage, which their f32 input needs.
    """
    bf16 = geometry.cfg.space_generator.dtype_str == "bfloat16"
    names = []
    for name, p in geometry.named_parameters():
        train = is_trainable(name)
        p.requires_grad_(train)
        if train:
            names.append(name)
        elif bf16 and p.dtype == torch.float32:
            p.copy_(p.to(torch.bfloat16).float())
    return names
