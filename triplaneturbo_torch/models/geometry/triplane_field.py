"""Triplane implicit field: plane-sampled features -> SDF / deformation / color.

Counterpart of ``triplaneturbo_tpu/models/geometry/triplane_field.py``
``decode_space_cache`` splits the decoded 6x64-channel planes into a geometry
and a texture triplane; ``forward_field_grid`` evaluates SDF and deformation on
the dense marching-cubes grid, through the fused CUDA kernel for CUDA tensors
and through the plain gather-free expression otherwise; ``export`` gives the
texture features at mesh vertices; ``forward_sdf`` and the module call give the
SDF (and the features) at ray samples, and :func:`analytic_normal` the SDF's
gradient there through autograd. The plane sampler is built on gathers, so
autograd takes these to the second order. Space caches are channels-last
``[B, 6, H, W, C]``.
"""

from __future__ import annotations

import functools
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, Optional, Tuple

import torch
from torch import nn

from ...ops.field_grid import fused_field_grid
from ...ops.triplane import (
    contract_to_unisphere,
    resample_triplane_axes,
    rotate_planes,
    sample_from_planes,
    sample_triplane_on_grid,
)
from ..networks import MLPConfig, get_mlp


@dataclass
class TriplaneFieldConfig:
    n_feature_dims: int = 3
    sdf_bias: Any = "sphere"  # "sphere" | "ellipsoid" | float
    sdf_bias_params: Any = 0.5
    rotate_planes: Optional[str] = "v1"
    split_channels: Optional[str] = "v1"
    geo_interpolate: str = "v1"
    tex_interpolate: str = "v2"
    isosurface_deformable_grid: bool = True
    radius: float = 1.0
    input_dim: int = 32  # per-plane channels after the split
    mlp: MLPConfig = field(default_factory=MLPConfig)


class TriplaneField(nn.Module):
    """SDF, deformation and feature networks over a dual triplane cache."""

    def __init__(self, cfg: TriplaneFieldConfig):
        super().__init__()
        self.cfg = c = cfg
        geo_in = c.input_dim * (3 if c.geo_interpolate == "v2" else 1)
        tex_in = c.input_dim * (3 if c.tex_interpolate == "v2" else 1)
        self.sdf_network = get_mlp(geo_in, 1, c.mlp)
        if c.n_feature_dims > 0:
            self.feature_network = get_mlp(tex_in, c.n_feature_dims, c.mlp)
        if c.isosurface_deformable_grid:
            self.deformation_network = get_mlp(geo_in, 3, c.mlp)

    @property
    def bbox(self) -> torch.Tensor:
        r = self.cfg.radius
        return torch.tensor([[-r, -r, -r], [r, r, r]], dtype=torch.float32)

    def rescale_points(self, points: torch.Tensor) -> torch.Tensor:
        return contract_to_unisphere(points, _bbox_on(self.cfg.radius, points.device),
                                     unbounded=False)

    def shifted_sdf(self, points_unscaled: torch.Tensor, sdf: torch.Tensor) -> torch.Tensor:
        c = self.cfg
        # eps inside the max keeps the gradient of the norm finite at the origin
        if c.sdf_bias == "sphere":
            bias = torch.sqrt(torch.clamp((points_unscaled ** 2).sum(-1, keepdim=True),
                                          min=1e-24)) - float(c.sdf_bias_params)
        elif c.sdf_bias == "ellipsoid":
            size = torch.as_tensor(c.sdf_bias_params, dtype=sdf.dtype, device=sdf.device)
            bias = torch.sqrt(torch.clamp(((points_unscaled / size) ** 2).sum(-1, keepdim=True),
                                          min=1e-24)) - 1.0
        elif isinstance(c.sdf_bias, (int, float)):
            bias = float(c.sdf_bias)
        else:
            raise ValueError(f"Unknown sdf bias {c.sdf_bias}")
        return sdf + bias

    def interpolate(self, points: torch.Tensor, space_cache: torch.Tensor,
                    only_geo: bool = False):
        """points [B, N, 3] in [-1, 1]; space_cache [B, 6, H, W, C]."""
        c = self.cfg
        rotated = rotate_planes(space_cache, c.rotate_planes)
        geo = sample_from_planes(rotated[:, 0:3], points, c.geo_interpolate)
        if only_geo:
            return geo
        return geo, sample_from_planes(rotated[:, 3:6], points, c.tex_interpolate)

    def forward_field(self, points: torch.Tensor, space_cache: torch.Tensor
                      ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
        """SDF and deformation at points [B, N, 3]."""
        enc_geo = self.interpolate(self.rescale_points(points), space_cache, only_geo=True)
        sdf = self.shifted_sdf(points, self.sdf_network(enc_geo))
        deformation = None
        if self.cfg.isosurface_deformable_grid:
            deformation = self.deformation_network(enc_geo)
        return sdf, deformation

    def forward_sdf(self, points: torch.Tensor, space_cache: torch.Tensor) -> torch.Tensor:
        """SDF at points [B, N, 3]: the geometry planes only."""
        enc_geo = self.interpolate(self.rescale_points(points), space_cache, only_geo=True)
        return self.shifted_sdf(points, self.sdf_network(enc_geo))

    def forward(self, points: torch.Tensor, space_cache: torch.Tensor) -> Dict[str, torch.Tensor]:
        """SDF and texture features at points [B, N, 3] (the volume renderer's query)."""
        enc_geo, enc_tex = self.interpolate(self.rescale_points(points), space_cache)
        out = {"sdf": self.shifted_sdf(points, self.sdf_network(enc_geo))}
        if self.cfg.n_feature_dims > 0:
            out["features"] = self.feature_network(enc_tex)
        return out

    def forward_field_grid(self, space_cache: torch.Tensor, resolution: int
                           ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
        """SDF and deformation on the full regular grid of one item.

        space_cache [1, 6, H, W, C]. Returns (sdf [R³, 1], deformation [R³, 3]
        or None), grid order (x, y, z) -- the same values as ``forward_field``
        on the dense meshgrid.
        """
        c = self.cfg
        R = resolution
        rotated = rotate_planes(space_cache, c.rotate_planes)[0]  # [6, H, W, C]
        world = torch.linspace(-c.radius, c.radius, R, device=space_cache.device)
        coords = world / c.radius

        if self._can_fuse_grid(space_cache.device):
            m_xy, m_xz, m_zy = resample_triplane_axes(rotated[0:3].float(), coords)
            ps = [self.sdf_network.layer(i).weight.T for i in range(3)]
            pd = [self.deformation_network.layer(i).weight.T for i in range(3)]
            sdf, deform = fused_field_grid(
                m_xy, m_xz, m_zy, *ps, *pd, float(c.radius), float(c.sdf_bias_params),
                c.geo_interpolate == "v2")
            return sdf.reshape(-1, 1), deform.permute(1, 2, 3, 0).reshape(-1, 3)

        enc_geo = sample_triplane_on_grid(rotated[0:3], coords, c.geo_interpolate)
        enc_geo = enc_geo.reshape(R * R * R, -1)
        sdf = self.sdf_network(enc_geo)
        g = torch.stack(torch.meshgrid(world, world, world, indexing="ij"), dim=-1)
        sdf = self.shifted_sdf(g.reshape(-1, 3), sdf)
        deformation = None
        if c.isosurface_deformable_grid:
            deformation = self.deformation_network(enc_geo)
        return sdf, deformation

    def _can_fuse_grid(self, device: torch.device) -> bool:
        """The fused kernel covers the flagship configuration on CUDA tensors.

        The TPU-only conditions of the JAX package (backend, R % 8) do not
        apply; the kernel's fixed hidden width H = 128 adds ``n_neurons == 64``.
        """
        c = self.cfg
        m = c.mlp
        return (
            device.type == "cuda"
            and c.sdf_bias == "sphere"
            and c.isosurface_deformable_grid
            and c.geo_interpolate in ("v1", "v2")
            and m.otype == "VanillaMLP"
            and m.activation.lower() == "relu"
            and m.output_activation.lower() == "none"
            and m.n_hidden_layers == 2
            and m.n_neurons == 64
        )

    def export(self, points: torch.Tensor, space_cache: torch.Tensor) -> Dict[str, torch.Tensor]:
        """Texture features at mesh vertices."""
        if self.cfg.n_feature_dims == 0:
            return {}
        _, enc_tex = self.interpolate(self.rescale_points(points), space_cache)
        return {"features": self.feature_network(enc_tex)}


@functools.lru_cache(maxsize=None)
def _bbox_on(radius: float, device: torch.device) -> torch.Tensor:
    """``TriplaneField.bbox`` of ``radius`` on ``device``, copied there once: rescaling
    points after that uploads nothing from the host. Shared by every caller: never written."""
    return torch.tensor([[-radius] * 3, [radius] * 3], dtype=torch.float32).to(device)


def analytic_normal(field_apply: Callable[[torch.Tensor, torch.Tensor], torch.Tensor],
                    points: torch.Tensor, space_cache: torch.Tensor, normalize: bool = True,
                    eps: float = 1e-12) -> torch.Tensor:
    """dSDF/dpoints through autograd; ``field_apply`` (points [B, N, 3],
    space_cache) -> sdf [B, N, 1]. The graph is kept (``create_graph``) when the
    caller differentiates further, i.e. when grad mode is on."""
    outer = torch.is_grad_enabled()
    with torch.enable_grad():
        p = points if points.requires_grad else points.detach().requires_grad_()
        (n,) = torch.autograd.grad(field_apply(p, space_cache).sum(), p, create_graph=outer)
    if normalize:
        n = n / torch.sqrt(torch.clamp_min((n * n).sum(-1, keepdim=True), eps))
    return n


def decode_space_cache(triplane: torch.Tensor, split_channels: Optional[str] = "v1"
                       ) -> torch.Tensor:
    """[B, 6, H, W, C] -> [B, 6, H, W, C/2]: planes 0-2 keep the first half of
    the channels (geometry), planes 3-5 the second half (texture)."""
    if split_channels is None:
        return triplane
    if split_channels != "v1":
        raise ValueError(f"Unknown split_channels {split_channels}")
    C = triplane.shape[-1]
    return torch.cat([triplane[:, 0:3, ..., : C // 2], triplane[:, 3:6, ..., C // 2:]], dim=1)
