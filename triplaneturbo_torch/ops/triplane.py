"""Triplane feature fetch: plane rotation, projection and bilinear sampling.

Counterpart of ``triplaneturbo_tpu/ops/triplane.py``: the triplane sampler the
model uses, the gather-free grid path of the field grid, and the reference's
experimental samplers, which no shipped config uses (quaplanes, h-planes and the
voxel grid). Space caches are channels-last ``[B, P, H, W, C]``; within a group of
three planes index 0 is the XY plane, 1 the XZ plane, 2 the ZY plane.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from .grid_sample import grid_sample_2d_packed, grid_sample_3d, pack_2x2


def rotate_planes(space_cache: torch.Tensor, mode: Optional[str] = "v1") -> torch.Tensor:
    """Rotate plane feature maps to the generator's image convention.

    v1: xy transposed (H<->W), xz rotated 180°, zy rotated 90° clockwise;
    v2 flips the xy plane along W instead of transposing it.
    """
    if mode is None:
        return space_cache
    if mode not in ("v1", "v2"):
        raise ValueError(f"Unknown rotate_planes mode {mode}")
    B, P, H, W, C = space_cache.shape
    if P % 3:
        raise ValueError("plane axis must be a multiple of 3")
    xy = space_cache[:, 0::3]
    xz = space_cache[:, 1::3]
    zy = space_cache[:, 2::3]
    xy_r = xy.transpose(2, 3) if mode == "v1" else xy.flip(3)
    xz_r = xz.flip(2, 3)
    zy_r = zy.transpose(2, 3).flip(3)  # out[i, j] = in[H-1-j, i]
    out = torch.stack([xy_r, xz_r, zy_r], dim=2)  # [B, P//3, 3, H', W', C]
    return out.reshape(B, P, *xy_r.shape[2:])


def project_onto_planes(coordinates: torch.Tensor) -> torch.Tensor:
    """[..., 3] -> [..., 3, 2]: (x, y), (x, z), (z, y) per plane."""
    x, y, z = coordinates[..., 0], coordinates[..., 1], coordinates[..., 2]
    return torch.stack([torch.stack([x, y], -1), torch.stack([x, z], -1),
                        torch.stack([z, y], -1)], dim=-2)


def sample_from_planes(plane_features: torch.Tensor, coordinates: torch.Tensor,
                       interpolate_feat: Optional[str] = "v1",
                       box_warp: float = 2.0) -> torch.Tensor:
    """Per-point features from a 3-plane cache.

    plane_features [N, 3, H, W, C], coordinates [N, M, 3]; v1 sums the planes
    -> [N, M, C], v2 concatenates them -> [N, M, 3C].
    """
    N, n_planes, H, W, C = plane_features.shape
    if n_planes != 3:
        raise ValueError(f"expected 3 planes, got {n_planes}")
    M = coordinates.shape[1]
    proj = project_onto_planes((2.0 / box_warp) * coordinates).transpose(1, 2)  # [N, 3, M, 2]
    feats = grid_sample_2d_packed(
        pack_2x2(plane_features.reshape(N * 3, H, W, C)), proj.reshape(N * 3, M, 2),
    ).reshape(N, 3, M, C)
    if interpolate_feat in (None, "v1"):
        return feats.sum(dim=1)
    if interpolate_feat == "v2":
        return feats.transpose(1, 2).reshape(N, M, 3 * C)
    raise ValueError(f"Unknown interpolate_feat {interpolate_feat}")


def _sample_planes(plane_features: torch.Tensor, projs) -> torch.Tensor:
    """Each plane of ``plane_features`` [N, P, H, W, C] sampled at its own 2-D
    coordinates (``projs``, P tensors [N, M, 2]): [N, P, M, C]."""
    N, P, H, W, C = plane_features.shape
    M = projs[0].shape[1]
    proj = torch.stack(projs, dim=1)  # [N, P, M, 2]
    return grid_sample_2d_packed(pack_2x2(plane_features.reshape(N * P, H, W, C)),
                                 proj.reshape(N * P, M, 2)).reshape(N, P, M, C)


def sample_from_quaplanes(plane_features: torch.Tensor, coordinates: torch.Tensor,
                          interpolate_feat: Optional[str] = "v1",
                          box_warp: float = 2.0) -> torch.Tensor:
    """Quaplanes: xy, xz and a front and a back zy plane, [N, 4, H, W, C], at
    ``coordinates`` [N, M, 3] -> [N, M, 3C] (xy | xz | zy). The two zy planes are
    blended by x: None (or "none") takes the front plane where x > 0 and the back one
    elsewhere, "v1" weighs the front by 0.5 + 0.5 x."""
    if plane_features.shape[1] != 4:
        raise ValueError(f"expected 4 planes, got {plane_features.shape[1]}")
    c = (2.0 / box_warp) * coordinates
    x, y, z = c[..., 0], c[..., 1], c[..., 2]
    zy_proj = torch.stack([z, y], -1)
    feats = _sample_planes(plane_features, [torch.stack([x, y], -1), torch.stack([x, z], -1),
                                            zy_proj, zy_proj])
    xy, xz, zy_front, zy_back = feats.unbind(1)
    if interpolate_feat in (None, "none"):
        zy = torch.where((x > 0)[..., None], zy_front, zy_back)
    elif interpolate_feat == "v1":
        a_front = (0.5 + 0.5 * x)[..., None]
        zy = a_front * zy_front + (1.0 - a_front) * zy_back
    else:
        raise ValueError(f"Unknown quaplane interpolate_feat {interpolate_feat}")
    return torch.cat([xy, xz, zy], dim=-1)


def sample_from_hplanes(plane_features: torch.Tensor, coordinates: torch.Tensor,
                        interpolate_feat: Optional[str] = "v1",
                        box_warp: float = 2.0) -> torch.Tensor:
    """H-planes: a side (xz) plane and a front and a back zy plane, [N, 3, H, W, C], at
    ``coordinates`` [N, M, 3]. The variants weigh the front and back planes by x:
    None / "none" (hard select by x > 0) and "v1" (0.5 ± 0.5 x) -> [N, M, 2C]; "v2"
    (the side by 1 - |y| as well) and "v3" (trapezoids with thresholds ±0.5) -> 3C;
    "v4" (v3's weights) and "v5" (v1's) summed over the planes -> C; "v6" (a sigmoid of
    each plane's last channel) and "v7" (v6 plus v5's linear weights) summed -> C - 1."""
    if plane_features.shape[1] != 3:
        raise ValueError(f"expected 3 planes, got {plane_features.shape[1]}")
    c = (2.0 / box_warp) * coordinates
    x, y, z = c[..., 0], c[..., 1], c[..., 2]
    zy_proj = torch.stack([z, y], -1)
    feats = _sample_planes(plane_features, [torch.stack([x, z], -1), zy_proj, zy_proj])
    side, front, back = feats.unbind(1)
    xe = x[..., None]
    if interpolate_feat in (None, "none"):
        return torch.cat([side, torch.where(xe > 0, front, back)], dim=-1)
    if interpolate_feat == "v1":
        a = 0.5 + 0.5 * xe
        return torch.cat([side, a * front + (1.0 - a) * back], dim=-1)
    if interpolate_feat == "v2":
        a_side = 1.0 - torch.abs(y)[..., None]
        return torch.cat([side * a_side, front * (0.5 + 0.5 * xe), back * (0.5 - 0.5 * xe)],
                         dim=-1)

    def trapezoid(thres):
        return torch.where(xe > thres, 1.0 - (xe - thres) / (1.0 - thres),
                           (xe + 1.0) / (thres + 1.0))

    if interpolate_feat == "v3":
        return torch.cat([side, front * trapezoid(0.5), back * trapezoid(-0.5)], dim=-1)
    if interpolate_feat == "v4":
        return side + front * trapezoid(0.5) + back * trapezoid(-0.5)
    if interpolate_feat == "v5":
        return side + front * (0.5 + 0.5 * xe) + back * (0.5 - 0.5 * xe)
    if interpolate_feat in ("v6", "v7"):
        alpha = torch.sigmoid(feats[..., -1:])  # [N, 3, M, 1]
        if interpolate_feat == "v7":
            alpha = alpha + torch.stack([torch.zeros_like(xe), 0.5 + 0.5 * xe,
                                         0.5 - 0.5 * xe], dim=1)
        return (feats[..., :-1] * alpha).sum(dim=1)
    raise ValueError(f"Hplane interpolate_feat {interpolate_feat} not implemented")


def get_trilinear_feature(points: torch.Tensor, voxel: torch.Tensor) -> torch.Tensor:
    """Trilinear fetch from a dense voxel grid: points [N, M, 3] in [-1, 1], voxel
    [N, D, H, W, C] -> [N, M, C]."""
    return grid_sample_3d(voxel, points)


def bilinear_interp_matrix(out_coords: torch.Tensor, in_size: int) -> torch.Tensor:
    """Dense [n_out, in_size] bilinear interpolation matrix.

    Row r reproduces ``grid_sample`` (align_corners=False, zeros padding) at
    normalized coordinate ``out_coords[r]``: at most two taps.
    """
    ix = ((out_coords + 1.0) * in_size - 1.0) * 0.5
    i0 = torch.floor(ix)
    w1 = ix - i0
    w0 = 1.0 - w1
    cols = torch.arange(in_size, device=out_coords.device)[None, :]
    i0c = i0[:, None]
    i1c = i0c + 1
    m0 = (cols == i0c.long()) & (i0c >= 0) & (i0c <= in_size - 1)
    m1 = (cols == i1c.long()) & (i1c >= 0) & (i1c <= in_size - 1)
    return m0 * w0[:, None] + m1 * w1[:, None]


def resample_triplane_axes(planes: torch.Tensor, coords: torch.Tensor
                           ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Resample the rotated geo planes [3, H, W, C] onto the grid coordinates [R].

    Returns (m_xy [y, x, C], m_xz [z, x, C], m_zy [y, z, C]); the dense
    feature is m_xy[j, i] (+|) m_xz[k, i] (+|) m_zy[j, k].
    """
    H, W = planes.shape[1], planes.shape[2]
    Av = bilinear_interp_matrix(coords, H).to(planes.dtype)
    Au = bilinear_interp_matrix(coords, W).to(planes.dtype)

    def resample(p):
        return torch.einsum("vh,hwc,uw->vuc", Av, p, Au)

    return resample(planes[0]), resample(planes[1]), resample(planes[2])


def sample_triplane_on_grid(planes: torch.Tensor, coords: torch.Tensor,
                            interpolate_feat: str = "v1") -> torch.Tensor:
    """Triplane features on the full regular grid (axis order x, y, z), gather-free.

    Returns [R, R, R, C] (v1 sum) or [R, R, R, 3C] (v2 concat, order xy|xz|zy).
    """
    m_xy, m_xz, m_zy = resample_triplane_axes(planes, coords)
    xy = m_xy.transpose(0, 1)[:, :, None, :]  # [x, y, 1, C]
    xz = m_xz.transpose(0, 1)[:, None, :, :]  # [x, 1, z, C]
    zy = m_zy[None, :, :, :]  # [1, y, z, C]
    if interpolate_feat in (None, "v1"):
        return xy + xz + zy
    if interpolate_feat == "v2":
        R = coords.shape[0]
        C = planes.shape[-1]
        return torch.cat([t.expand(R, R, R, C) for t in (xy, xz, zy)], dim=-1)
    raise ValueError(f"Unknown interpolate_feat {interpolate_feat}")


def scale_tensor(dat, inp_scale, tgt_scale):
    """Affine rescale from ``inp_scale`` to ``tgt_scale`` (2-tuples or [2, D] tensors)."""
    if inp_scale is None:
        inp_scale = (0, 1)
    if tgt_scale is None:
        tgt_scale = (0, 1)
    dat = (dat - inp_scale[0]) / (inp_scale[1] - inp_scale[0])
    return dat * (tgt_scale[1] - tgt_scale[0]) + tgt_scale[0]


def contract_to_unisphere(x: torch.Tensor, bbox: torch.Tensor,
                          unbounded: bool = False) -> torch.Tensor:
    """Rescale points from ``bbox`` to [-1, 1]^3; the unbounded branch contracts the far field."""
    if not unbounded:
        return scale_tensor(x, bbox, (-1, 1))
    x = scale_tensor(x, bbox, (-1, 1))
    x = x * 2 - 1
    mag = torch.linalg.norm(x, dim=-1, keepdim=True)
    mask = mag > 1
    contracted = (2 - 1 / mag.clamp_min(1e-8)) * (x / mag.clamp_min(1e-8))
    x = torch.where(mask, contracted, x)
    return x / 4 + 0.5
