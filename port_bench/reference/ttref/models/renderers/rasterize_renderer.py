"""Generative-space mesh rasterize renderer, the first renderer of the pair.

Counterpart of ``triplaneturbo_tpu/models/renderers/rasterize_renderer.py``:
per space-cache item, the SDF and deformation on the dense grid, their
gradients damped (``sdf_grad_shrink`` / ``def_grad_shrink``), the empty-field
fallback and marching cubes; then per view rasterize, interpolate depth,
normals and positions, query the texture field at the pixels, compose with
the background and antialias.

As in the JAX package: depth is the interpolated clip w; the texture field
runs on every pixel (masked afterwards), in chunks of ``field_chunk`` points,
each chunk recomputed in the backward (``torch.utils.checkpoint``, where JAX
uses ``lax.map(jax.checkpoint(...))``). The output also carries the
rasterizer's overflow counts a view, ``n_span_overflow`` and
``n_list_overflow`` [B], which the JAX renderer drops.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable, Dict, List, Optional

import torch
from ...ops.sites import checkpoint

from ...ops.isosurface import extract_isosurface, force_field_crossing
from ...ops.rasterize import antialias, interpolate, rasterize
from ...utils.mesh import Mesh
from ...utils.ops import chunk_batch, safe_normalize


@dataclass
class RasterizeRendererConfig:
    radius: float = 1.0
    isosurface_resolution: int = 160
    sdf_grad_shrink: float = 0.001
    def_grad_shrink: float = 0.001
    enable_bg_rays: bool = True
    normal_direction: str = "camera"
    max_verts: int = 98304
    max_faces: int = 196608
    isosurface_method: str = "mc"
    field_chunk: int = 262144
    tile: int = 16
    faces_per_tile: int = 1024
    # marching-cubes faces are about one grid cell, so a face's box straddles at
    # most 2 tiles an axis; n_span_overflow counts any that does not
    max_span: int = 2
    isosurface_deformable_grid: bool = True


def _texture(points: torch.Tensor, export_fn: Callable, cache: torch.Tensor) -> torch.Tensor:
    return export_fn(points[None], cache)[0]


def _texture_chunk(points: torch.Tensor, export_fn: Callable, cache: torch.Tensor
                   ) -> torch.Tensor:
    """Texture features of one chunk of points, recomputed in the backward.
    The cache is an argument, not a closure's free variable: the recompute
    runs after the loop over items has moved on."""
    if torch.is_grad_enabled():
        return checkpoint(_texture, points, export_fn, cache, use_reentrant=False)
    return _texture(points, export_fn, cache)


class GenerativeSpaceMeshRasterizeRenderer:
    """Stateless renderer; the field and background closures carry the weights."""

    def __init__(self, cfg: Optional[RasterizeRendererConfig] = None):
        self.cfg = cfg or RasterizeRendererConfig()

    def isosurface(self, space_cache: torch.Tensor, forward_field: Callable,
                   sdf_grad_shrink: Optional[float] = None,
                   def_grad_shrink: Optional[float] = None,
                   forward_field_grid: Optional[Callable] = None) -> List[Mesh]:
        """One fixed-capacity mesh a space-cache item [Bsc, 6, H, W, C],
        differentiable in its vertex positions (world coordinates [-1, 1]):
        the field on the R³ grid, gradient damping, the empty-field fallback,
        extraction. ``forward_field_grid`` (cache [1, ...], R) -> (sdf, deform)
        is the grid path; ``forward_field`` (points [1, N, 3], cache) ->
        (sdf, deform) the fallback, evaluated in chunks of ``field_chunk``
        points."""
        cfg = self.cfg
        R = cfg.isosurface_resolution
        sgs = cfg.sdf_grad_shrink if sdf_grad_shrink is None else sdf_grad_shrink
        dgs = cfg.def_grad_shrink if def_grad_shrink is None else def_grad_shrink
        meshes = []
        for i in range(space_cache.shape[0]):
            cache_i = space_cache[i:i + 1]
            if forward_field_grid is not None:
                sdf, deform = forward_field_grid(cache_i, R)
            else:
                lin = torch.linspace(-1.0, 1.0, R, device=space_cache.device)
                grid = torch.stack(torch.meshgrid(lin, lin, lin, indexing="ij"), -1).reshape(-1, 3)

                def eval_chunk(pts):
                    sdf_, deform_ = forward_field(pts[None], cache_i)
                    if deform_ is None:
                        deform_ = torch.zeros_like(pts)[None]
                    return torch.cat([sdf_[0], deform_[0]], dim=-1)

                out = chunk_batch(eval_chunk, cfg.field_chunk, grid)
                sdf, deform = out[:, 0], out[:, 1:]
            sdf = sdf.reshape(-1)
            if deform is None:
                deform = torch.zeros((R ** 3, 3), dtype=sdf.dtype, device=sdf.device)
            # gradient damping: the value unchanged, the gradient scaled by the shrink
            sdf = sgs * sdf + (1.0 - sgs) * sdf.detach()
            deform = dgs * deform + (1.0 - dgs) * deform.detach()
            sdf = force_field_crossing(sdf, R)
            m = extract_isosurface(
                sdf.reshape(R, R, R),
                deform.reshape(R, R, R, 3) if cfg.isosurface_deformable_grid else None,
                method=cfg.isosurface_method, max_verts=cfg.max_verts, max_faces=cfg.max_faces)
            meshes.append(Mesh(v_pos=m.verts * 2.0 - 1.0, t_pos_idx=m.faces, v_mask=m.vert_mask,
                               t_mask=m.face_mask))
        return meshes

    def __call__(self, mvp_mtx: torch.Tensor, camera_positions: torch.Tensor,
                 space_cache: torch.Tensor, forward_field: Callable, export_fn: Callable,
                 material_fn: Callable, background_fn: Callable, height: int, width: int,
                 text_embed: Optional[torch.Tensor] = None,
                 rays_d_rasterize: Optional[torch.Tensor] = None,
                 camera_distances: Optional[torch.Tensor] = None,
                 c2w: Optional[torch.Tensor] = None, render_rgb: bool = True,
                 sdf_grad_shrink: Optional[float] = None,
                 def_grad_shrink: Optional[float] = None,
                 forward_field_grid: Optional[Callable] = None) -> Dict[str, Any]:
        """Render B = Bsc x views images; view v of item i is row i * views + v.

        ``export_fn`` (points [1, N, 3], cache) -> features [1, N, C];
        ``material_fn`` features -> rgb; ``background_fn`` (dirs [v, H, W, 3],
        pooled text [1, c]) -> rgb. Image outputs are [B, H, W, C]; ``mesh``
        is the list of the Bsc meshes."""
        cfg = self.cfg
        B = mvp_mtx.shape[0]
        Bsc = space_cache.shape[0]
        nv_per = B // Bsc
        meshes = self.isosurface(space_cache, forward_field, sdf_grad_shrink, def_grad_shrink,
                                 forward_field_grid=forward_field_grid)
        outs = []
        for i, mesh in enumerate(meshes):
            faces = mesh.t_pos_idx
            vn = mesh.vertex_normals()
            sl = slice(i * nv_per, (i + 1) * nv_per)
            vh = torch.cat([mesh.v_pos, torch.ones_like(mesh.v_pos[:, :1])], dim=-1)
            views = []
            for v in range(nv_per):
                v_clip = vh @ mvp_mtx[i * nv_per + v].T
                views.append((v_clip, rasterize(
                    v_clip, faces, mesh.t_mask, height, width, tile=cfg.tile,
                    faces_per_tile=cfg.faces_per_tile, max_span=cfg.max_span)))
            rasts = [r for _, r in views]
            mask = torch.stack([r.mask for r in rasts]).float()[..., None]
            depth = torch.stack([interpolate(vc[:, 3:4], r, faces) for vc, r in views])
            # non-hit pixels interpolate to exact zeros: safe_normalize keeps their backward finite
            gb_normal = safe_normalize(torch.stack([interpolate(vn, r, faces) for r in rasts]))
            gb_pos = torch.stack([interpolate(mesh.v_pos, r, faces) for r in rasts])

            out: Dict[str, Any] = {
                "opacity": torch.stack([antialias(mask[v], rasts[v], torch.zeros_like(mask[v]))
                                        for v in range(nv_per)]),
                "depth": depth,
                "n_span_overflow": torch.stack([r.n_span_overflow for r in rasts]),
                "n_list_overflow": torch.stack([r.n_list_overflow for r in rasts]),
            }
            if camera_distances is not None:
                cd = camera_distances[sl].reshape(-1, 1, 1, 1)
                far, near = cd + 3.0 ** 0.5, cd - 3.0 ** 0.5
                disparity = (far - torch.minimum(depth, far)) / (far - near)
                out["disparity"] = torch.clamp(disparity, 0.0, 1.0) * mask
            out["comp_normal"] = ((gb_normal + 1.0) / 2.0) * mask
            if cfg.normal_direction == "camera" and c2w is not None:
                w2c_rot = c2w[sl][:, :3, :3].transpose(-1, -2)  # rigid: inverse = transpose
                n_cam = torch.einsum("vhwc,vkc->vhwk", gb_normal, w2c_rot)
                n_cam = n_cam * torch.tensor([-1.0, 1.0, 1.0], device=n_cam.device)
                n_cam01 = (safe_normalize(n_cam) + 1.0) / 2.0
                bg_n = torch.tensor([0.5, 0.5, 1.0], device=n_cam.device)
                out["comp_normal_cam_vis"] = n_cam01 * mask + bg_n * (1 - mask)
                out["comp_normal_cam_vis_white"] = n_cam01 * mask + (1 - mask)

            if render_rgb:
                feats = chunk_batch(_texture_chunk, cfg.field_chunk, gb_pos.reshape(-1, 3),
                                    export_fn, space_cache[i:i + 1])
                rgb_fg = material_fn(feats.reshape(nv_per, height, width, -1))
                if rays_d_rasterize is not None and cfg.enable_bg_rays:
                    view_dirs = rays_d_rasterize[sl]
                else:
                    view_dirs = safe_normalize(gb_pos - camera_positions[sl][:, None, None, :])
                te = text_embed[i:i + 1] if text_embed is not None else None
                rgb_bg = background_fn(view_dirs, te)
                gb_rgb = rgb_bg * (1 - mask) + rgb_fg * mask
                out["comp_rgb"] = torch.stack([antialias(gb_rgb[v], rasts[v], rgb_bg[v])
                                               for v in range(nv_per)])
                out["comp_rgb_bg"] = rgb_bg
            out["mesh"] = mesh
            outs.append(out)

        merged: Dict[str, Any] = {}
        for k in outs[0]:
            merged[k] = ([o[k] for o in outs] if k == "mesh"
                         else torch.cat([o[k] for o in outs], dim=0))
        return merged
