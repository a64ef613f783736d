"""Evaluation views of a mesh: the kire rig, rendered with the port's rasterizer.

Counterpart of ``triplaneturbo_tpu/evaluation/mesh_render.py``: the mesh is
normalised as kiuikit's loader does it (centred, the largest extent scaled to
[-0.9, 0.9]), then rendered from the ``mesh_visualize`` rig (4 azimuths from +y,
elevation -15°, radius 3, fovy 50°; the MVPs built on the host in numpy), with a
headlight Lambertian on the interpolated vertex colors and the silhouette antialias
against a white background.

The JAX renderer drops the rasterizer's overflow counts inside its scan, so faces
past the 256-slot big-face list vanish from its images without a word. Here each
view's ``n_span_overflow`` and ``n_list_overflow`` come back with the images.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Sequence

import numpy as np
import torch

from ..ops.rasterize import antialias, interpolate, rasterize
from ..utils.camera import camera_rig_np
from ..utils.mesh import Mesh


class RenderedViews(NamedTuple):
    images: torch.Tensor  # [V, H, W, 3] in [0, 1]
    n_span_overflow: torch.Tensor  # [V] big faces past the 256-slot list, a view
    n_list_overflow: torch.Tensor  # [V] (tile, face) entries dropped at capacity, a view


def kire_normalize_mesh(v_pos: torch.Tensor, v_mask: Optional[torch.Tensor] = None,
                        bound: float = 0.9) -> torch.Tensor:
    """Centre the valid vertices and scale their largest axis extent to
    [-bound, bound] (kiuikit's ``Mesh.load(resize=True)``); invalid slots go to 0."""
    if v_mask is not None:
        vmax = torch.where(v_mask[:, None], v_pos, -torch.inf).amax(dim=0)
        vmin = torch.where(v_mask[:, None], v_pos, torch.inf).amin(dim=0)
    else:
        vmax, vmin = v_pos.amax(dim=0), v_pos.amin(dim=0)
    center = (vmax + vmin) / 2
    scale = 2.0 * bound / torch.clamp_min((vmax - vmin).max(), 1e-8)
    out = (v_pos - center) * scale
    return torch.where(v_mask[:, None], out, 0.0) if v_mask is not None else out


def kire_camera_rig(n_views: int = 4, elevation_deg: float = -15.0, radius: float = 3.0,
                    fovy_deg: float = 50.0) -> np.ndarray:
    """The ``mesh_visualize`` rig's MVPs [n_views, 4, 4] float32 (numpy): azimuths
    90° + k·360°/n (view 0 faces +y), near 0.01, far 100."""
    azim = np.linspace(0, 360, n_views, endpoint=False) + 90.0
    elev = np.full(n_views, elevation_deg)
    return camera_rig_np(elev, azim, radius, fovy_deg, 1.0, 0.01, 100.0)


class PreparedMesh(NamedTuple):
    """What every view of one mesh reads: its kire-normalised homogeneous vertices,
    colors and normals, and the background."""

    vh: torch.Tensor  # [V, 4]
    v_rgb: torch.Tensor  # [V, 3]
    v_nrm: torch.Tensor  # [V, 3]
    bg: torch.Tensor  # [H, W, 3]


@torch.no_grad()
def prepare_mesh(mesh: Mesh, height: int, width: int,
                 bg_color: Sequence[float] = (1.0, 1.0, 1.0)) -> PreparedMesh:
    """Normalise ``mesh`` (gray 0.7 without colors) on its device for its views."""
    dev = mesh.v_pos.device
    v_rgb = mesh.v_rgb if mesh.v_rgb is not None else torch.full_like(mesh.v_pos, 0.7)
    v_pos = kire_normalize_mesh(mesh.v_pos.float(), mesh.v_mask)
    bg = torch.ones((height, width, 3), device=dev) * torch.tensor(bg_color, device=dev,
                                                                   dtype=torch.float32)
    return PreparedMesh(torch.cat([v_pos, torch.ones_like(v_pos[:, :1])], dim=-1),
                        v_rgb.float(), mesh.vertex_normals(), bg)


@torch.no_grad()
def render_view(mesh: Mesh, prep: PreparedMesh, mvp: torch.Tensor, lambertian: bool = True,
                faces_per_tile: int = 2048):
    """One view from ``mvp`` [4, 4]: (image [H, W, 3], the rasterizer's output)."""
    H, W = prep.bg.shape[:2]
    rast = rasterize(prep.vh @ mvp.T, mesh.t_pos_idx, mesh.t_mask, H, W,
                     faces_per_tile=faces_per_tile, max_span=4, big_face_cap=256)
    rgb = interpolate(prep.v_rgb, rast, mesh.t_pos_idx)
    if lambertian:
        nrm = interpolate(prep.v_nrm, rast, mesh.t_pos_idx)
        # headlight along the camera ray: shade by |n·view|
        cam_dir = -mvp[2, :3] / torch.linalg.vector_norm(mvp[2, :3])
        lam = (nrm * cam_dir).sum(-1, keepdim=True).abs()
        rgb = rgb * (0.3 + 0.7 * lam)
    img = torch.where(rast.mask[..., None], rgb, prep.bg)
    return antialias(img, rast, prep.bg), rast


@torch.no_grad()
def render_mesh_views(mesh: Mesh, n_views: int = 4, height: int = 512, width: int = 512,
                      elevation_deg: float = -15.0, bg_color: Sequence[float] = (1.0, 1.0, 1.0),
                      lambertian: bool = True, faces_per_tile: int = 2048) -> RenderedViews:
    """Vertex-colored turntable views of ``mesh`` (gray 0.7 without colors), on its
    device: binning with ``max_span`` 4 and a 256-face big-face list, as the JAX
    renderer. Returns the images and each view's overflow counts."""
    prep = prepare_mesh(mesh, height, width, bg_color)
    rig = torch.from_numpy(kire_camera_rig(n_views, elevation_deg)).to(mesh.v_pos.device)
    frames, n_span, n_list = [], [], []
    for m in rig:
        img, rast = render_view(mesh, prep, m, lambertian, faces_per_tile)
        frames.append(img)
        n_span.append(rast.n_span_overflow)
        n_list.append(rast.n_list_overflow)
    return RenderedViews(torch.stack(frames).clamp(0.0, 1.0), torch.stack(n_span),
                         torch.stack(n_list))
