"""Bilinear and trilinear grid sampling as gathers and lerps.

Counterpart of ``triplaneturbo_tpu/ops/grid_sample.py``: ``grid_sample_2d`` (four
corner gathers), ``pack_2x2`` and ``grid_sample_2d_packed`` (one row gather per
point, what the triplane samplers use) and ``grid_sample_3d`` (eight corner
gathers of a voxel grid). Semantics match ``torch.nn.functional.grid_sample(
mode="bilinear", padding_mode="zeros", align_corners=False)`` on channels-last maps:
x indexes the width, y the height and z the depth, pixel centres sit at
``-1 + (2 i + 1) / size`` and a corner outside the map reads zero. Built from
gathers so that autograd can take them to any order (the training path needs
second derivatives, which ``F.grid_sample``'s backward does not give).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def pack_2x2(features: torch.Tensor) -> torch.Tensor:
    """[N, H, W, C] -> [N, H+1, W+1, 4C]: each row holds the four corner taps.

    packed[j, i] = (f[j-1, i-1], f[j-1, i], f[j, i-1], f[j, i]), zero outside.
    """
    P = F.pad(features, (0, 0, 1, 1, 1, 1))
    H1, W1 = features.shape[1] + 1, features.shape[2] + 1
    return torch.cat([P[:, :H1, :W1], P[:, :H1, 1:], P[:, 1:, :W1], P[:, 1:, 1:]], dim=-1)


def grid_sample_2d_packed(packed: torch.Tensor, grid: torch.Tensor) -> torch.Tensor:
    """Bilinear sample of a :func:`pack_2x2` map at ``grid`` [N, M, 2] (x, y) in [-1, 1].

    Returns [N, M, C]. Points whose whole 2x2 cell lies outside read zeros.
    """
    N, H1, W1, C4 = packed.shape
    H, W, C = H1 - 1, W1 - 1, C4 // 4
    x, y = grid[..., 0], grid[..., 1]
    ix = ((x + 1.0) * W - 1.0) * 0.5
    iy = ((y + 1.0) * H - 1.0) * 0.5
    ix0 = torch.floor(ix)
    iy0 = torch.floor(iy)
    wx1 = (ix - ix0)[..., None]
    wy1 = (iy - iy0)[..., None]
    j = iy0 + 1.0
    i = ix0 + 1.0
    valid = (i >= 0) & (i <= W) & (j >= 0) & (j <= H)
    ji = j.clamp(0, H).long() * W1 + i.clamp(0, W).long()  # [N, M]
    flat = packed.reshape(N, H1 * W1, C4)
    rows = torch.gather(flat, 1, ji[..., None].expand(-1, -1, C4))
    rows = rows * valid[..., None].to(packed.dtype)
    v00, v01, v10, v11 = rows.split(C, dim=-1)
    wx0 = 1.0 - wx1
    wy0 = 1.0 - wy1
    return v00 * (wy0 * wx0) + v01 * (wy0 * wx1) + v10 * (wy1 * wx0) + v11 * (wy1 * wx1)


def _unnormalize(x: torch.Tensor, size: int) -> torch.Tensor:
    """A normalized coordinate in [-1, 1] as a texel index (align_corners=False)."""
    return ((x + 1.0) * size - 1.0) * 0.5


def grid_sample_2d(features: torch.Tensor, grid: torch.Tensor) -> torch.Tensor:
    """Bilinear sample of ``features`` [N, H, W, C] at ``grid`` [N, M, 2] (x, y) in
    [-1, 1]; returns [N, M, C], zeros outside the map."""
    N, H, W, C = features.shape
    ix = _unnormalize(grid[..., 0], W)
    iy = _unnormalize(grid[..., 1], H)
    ix0, iy0 = torch.floor(ix), torch.floor(iy)
    wx1, wy1 = ix - ix0, iy - iy0
    flat = features.reshape(N, H * W, C)

    def gather(iy_, ix_):
        valid = (ix_ >= 0) & (ix_ <= W - 1) & (iy_ >= 0) & (iy_ <= H - 1)
        idx = iy_.clamp(0, H - 1).long() * W + ix_.clamp(0, W - 1).long()
        vals = torch.gather(flat, 1, idx[..., None].expand(-1, -1, C))
        return vals * valid[..., None].to(features.dtype)

    out = 0.0
    for dy, wy in ((iy0, 1.0 - wy1), (iy0 + 1.0, wy1)):
        for dx, wx in ((ix0, 1.0 - wx1), (ix0 + 1.0, wx1)):
            out = out + gather(dy, dx) * (wy * wx)[..., None]
    return out


def grid_sample_3d(features: torch.Tensor, grid: torch.Tensor) -> torch.Tensor:
    """Trilinear sample of a voxel grid ``features`` [N, D, H, W, C] at ``grid`` [N, M, 3]
    (x, y, z) in [-1, 1], x -> W, y -> H, z -> D; returns [N, M, C], zeros outside."""
    N, D, H, W, C = features.shape
    ix = _unnormalize(grid[..., 0], W)
    iy = _unnormalize(grid[..., 1], H)
    iz = _unnormalize(grid[..., 2], D)
    ix0, iy0, iz0 = torch.floor(ix), torch.floor(iy), torch.floor(iz)
    fx, fy, fz = ix - ix0, iy - iy0, iz - iz0
    flat = features.reshape(N, D * H * W, C)

    def gather(zi_, yi_, xi_):
        valid = ((xi_ >= 0) & (xi_ <= W - 1) & (yi_ >= 0) & (yi_ <= H - 1)
                 & (zi_ >= 0) & (zi_ <= D - 1))
        idx = ((zi_.clamp(0, D - 1).long() * H + yi_.clamp(0, H - 1).long()) * W
               + xi_.clamp(0, W - 1).long())
        vals = torch.gather(flat, 1, idx[..., None].expand(-1, -1, C))
        return vals * valid[..., None].to(features.dtype)

    out = 0.0
    for dz, wz in ((iz0, 1.0 - fz), (iz0 + 1.0, fz)):
        for dy, wy in ((iy0, 1.0 - fy), (iy0 + 1.0, fy)):
            for dx, wx in ((ix0, 1.0 - fx), (ix0 + 1.0, fx)):
                out = out + gather(dz, dy, dx) * (wz * wy * wx)[..., None]
    return out
