"""Camera math: ray generation, projection and MVP matrices, spherical rigs.

Counterpart of ``triplaneturbo_tpu/utils/camera.py``. OpenGL camera
convention (x right, y up, -z forward); world +z up, cameras placed by
elevation and azimuth. Two choices are kept from the JAX package: the inverse
of a camera-to-world matrix is the analytic rigid inverse (general LU is
fragile at axis-aligned azimuths, where the rotation holds 1e-7 residues), and
a constant rig is built on the host in float64 numpy (``camera_rig_np``).
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch


def get_ray_directions(H: int, W: int, fovy: torch.Tensor,
                       use_pixel_centers: bool = True) -> torch.Tensor:
    """Per-pixel camera-frame ray directions, [B, H, W, 3] (unnormalised,
    -z forward), for fovy [B] in radians."""
    center = 0.5 if use_pixel_centers else 0.0
    dev = fovy.device
    i, j = torch.meshgrid(torch.arange(W, dtype=torch.float32, device=dev) + center,
                          torch.arange(H, dtype=torch.float32, device=dev) + center,
                          indexing="xy")
    focal = 0.5 * H / torch.tan(0.5 * fovy)  # [B]
    cx, cy = W / 2.0, H / 2.0
    f = focal[:, None, None]
    return torch.stack([(i[None] - cx) / f, -(j[None] - cy) / f,
                        -torch.ones((1, H, W), device=dev) * torch.ones_like(f)], dim=-1)


def get_rays(directions: torch.Tensor, c2w: torch.Tensor, keepdim: bool = True,
             normalize: bool = True) -> Tuple[torch.Tensor, torch.Tensor]:
    """World-space ray origins and directions from camera-frame directions
    [B, H, W, 3] and c2w [B, 4, 4]."""
    rays_d = torch.einsum("bhwc,bkc->bhwk", directions, c2w[:, :3, :3])
    rays_o = c2w[:, None, None, :3, 3].expand(rays_d.shape)
    if normalize:
        rays_d = rays_d / torch.linalg.norm(rays_d, dim=-1, keepdim=True)
    if not keepdim:
        rays_o = rays_o.reshape(-1, 3)
        rays_d = rays_d.reshape(-1, 3)
    return rays_o, rays_d


def camera_to_world(elevation: torch.Tensor, azimuth: torch.Tensor, distance: torch.Tensor,
                    center: Optional[torch.Tensor] = None,
                    up_world: Tuple[float, float, float] = (0.0, 0.0, 1.0)) -> torch.Tensor:
    """Spherical cameras (radians) looking at ``center`` -> c2w [B, 4, 4];
    the columns are right, up, -forward and the position."""
    B = elevation.shape[0]
    pos = torch.stack([distance * torch.cos(elevation) * torch.cos(azimuth),
                       distance * torch.cos(elevation) * torch.sin(azimuth),
                       distance * torch.sin(elevation)], dim=-1)
    if center is None:
        center = torch.zeros((B, 3), dtype=pos.dtype, device=pos.device)
    up = torch.tensor(up_world, dtype=pos.dtype, device=pos.device).expand(B, 3)
    lookat = center - pos
    lookat = lookat / torch.linalg.norm(lookat, dim=-1, keepdim=True)
    right = torch.linalg.cross(lookat, up)
    right = right / torch.linalg.norm(right, dim=-1, keepdim=True)
    up2 = torch.linalg.cross(right, lookat)
    rot = torch.stack([right, up2, -lookat], dim=-1)  # [B, 3, 3]
    c2w = torch.cat([rot, pos[..., None]], dim=-1)
    bottom = torch.tensor([0.0, 0.0, 0.0, 1.0], dtype=pos.dtype, device=pos.device)
    return torch.cat([c2w, bottom.expand(B, 1, 4)], dim=1)


def get_projection_matrix(fovy: torch.Tensor, aspect: float, near: float, far: float
                          ) -> torch.Tensor:
    """OpenGL perspective projection [B, 4, 4] with row 1 negated, so that
    rasterized images come out y-down."""
    B = fovy.shape[0]
    f = 1.0 / torch.tan(fovy / 2.0)
    proj = torch.zeros((B, 4, 4), dtype=fovy.dtype, device=fovy.device)
    proj[:, 0, 0] = f / aspect
    proj[:, 1, 1] = -f
    proj[:, 2, 2] = -(far + near) / (far - near)
    proj[:, 2, 3] = -2.0 * far * near / (far - near)
    proj[:, 3, 2] = -1.0
    return proj


def camera_rig_np(elevation_deg, azimuth_deg, radius, fovy_deg, aspect: float = 1.0,
                  near: float = 0.01, far: float = 100.0, up_world=(0.0, 0.0, 1.0)
                  ) -> np.ndarray:
    """MVP matrices [B, 4, 4] float32 of a constant rig, computed on the host
    in float64: ``camera_to_world``, the rigid inverse and the projection in
    one numpy expression."""
    elev = np.deg2rad(np.asarray(elevation_deg, np.float64))
    azim = np.deg2rad(np.asarray(azimuth_deg, np.float64))
    dist = np.broadcast_to(np.asarray(radius, np.float64), elev.shape)
    B = elev.shape[0]
    pos = np.stack([dist * np.cos(elev) * np.cos(azim), dist * np.cos(elev) * np.sin(azim),
                    dist * np.sin(elev)], axis=-1)
    up = np.broadcast_to(np.asarray(up_world, np.float64), (B, 3))
    lookat = -pos / np.linalg.norm(pos, axis=-1, keepdims=True)
    right = np.cross(lookat, up)
    right = right / np.linalg.norm(right, axis=-1, keepdims=True)
    up2 = np.cross(right, lookat)
    R = np.stack([right, up2, -lookat], axis=-1)
    Rt = np.swapaxes(R, -1, -2)
    w2c = np.zeros((B, 4, 4))
    w2c[:, :3, :3] = Rt
    w2c[:, :3, 3] = -np.einsum("bij,bj->bi", Rt, pos)
    w2c[:, 3, 3] = 1.0
    f = np.broadcast_to(1.0 / np.tan(np.deg2rad(np.asarray(fovy_deg, np.float64)) / 2.0), (B,))
    proj = np.zeros((B, 4, 4))
    proj[:, 0, 0] = f / aspect
    proj[:, 1, 1] = -f
    proj[:, 2, 2] = -(far + near) / (far - near)
    proj[:, 2, 3] = -2.0 * far * near / (far - near)
    proj[:, 3, 2] = -1.0
    return np.einsum("bij,bjk->bik", proj, w2c).astype(np.float32)


def rigid_inverse(c2w: torch.Tensor) -> torch.Tensor:
    """Analytic inverse of a rigid transform [..., 4, 4]: (R, t)⁻¹ = (Rᵀ, -Rᵀt)."""
    Rt = c2w[..., :3, :3].transpose(-1, -2)
    top = torch.cat([Rt, -(Rt @ c2w[..., :3, 3:])], dim=-1)
    bottom = torch.tensor([0.0, 0.0, 0.0, 1.0], dtype=c2w.dtype, device=c2w.device)
    return torch.cat([top, bottom.expand(top.shape[:-2] + (1, 4))], dim=-2)


def get_mvp_matrix(c2w: torch.Tensor, proj: torch.Tensor) -> torch.Tensor:
    """[B, 4, 4] model-view-projection, proj @ rigid_inverse(c2w)."""
    return torch.einsum("bij,bjk->bik", proj, rigid_inverse(c2w))


def mvdream_normalize_camera(c2w: torch.Tensor) -> torch.Tensor:
    """Cameras moved onto the unit sphere and flattened to the 16-d
    conditioning MVDream takes."""
    pos = c2w[:, :3, 3]
    norm = torch.linalg.norm(pos, dim=-1, keepdim=True)
    out = c2w.clone()
    out[:, :3, 3] = pos / torch.clamp_min(norm, 1e-8)
    return out.reshape(out.shape[0], 16)
