"""Mesh exporter: space cache → vertex-colored OBJ.

Counterpart of ``triplaneturbo_tpu/models/exporters/mesh_exporter.py`` for
``fmt: "obj"``: the SDF and deformation on the R³ grid (the field-grid kernel on
the card, through ``forward_field_grid``), the empty-field fallback, marching
cubes into fixed-capacity buffers, the texture field's colours through the
material, and ``utils.saving.save_obj``. ``fmt: "obj-mtl"`` (a UV atlas and a
baked texture) waits for ROADMAP A18.
"""

from __future__ import annotations

import os
from dataclasses import dataclass
from typing import Callable, List, Optional

import torch

from ...ops.isosurface import extract_isosurface, force_field_crossing
from ...utils.mesh import Mesh
from ...utils.saving import save_obj


@dataclass
class MeshExporterConfig:
    fmt: str = "obj"  # "obj" (vertex colors) | "obj-mtl" (UV albedo, ROADMAP A18)
    save_name: str = "model"
    save_video: bool = False
    isosurface_resolution: int = 160
    # sized for "mc" output rates; double both for "mt"
    max_verts: int = 131072
    max_faces: int = 262144
    isosurface_method: str = "mc"


class MultipromptMeshExporter:
    def __init__(self, cfg: Optional[MeshExporterConfig] = None):
        self.cfg = cfg or MeshExporterConfig()
        if self.cfg.fmt != "obj":
            raise NotImplementedError(
                f"exporter fmt {self.cfg.fmt!r}: the UV-atlas OBJ+MTL export waits for "
                "ROADMAP A18")

    @torch.no_grad()
    def extract(self, space_cache: torch.Tensor, forward_field_grid: Callable,
                export_fn: Callable, material_fn: Callable) -> List[Mesh]:
        """One mesh per item of ``space_cache`` [Bsc, 6, H, W, C]:
        ``forward_field_grid(cache [1, ...], R)`` → (sdf, deformation or None),
        ``export_fn(points [1, N, 3], cache)`` → features, ``material_fn`` → rgb."""
        cfg = self.cfg
        R = cfg.isosurface_resolution
        meshes = []
        for i in range(space_cache.shape[0]):
            cache_i = space_cache[i:i + 1]
            sdf, deform = forward_field_grid(cache_i, R)
            sdf = force_field_crossing(sdf.reshape(-1), R)
            m = extract_isosurface(sdf.reshape(R, R, R),
                                   None if deform is None else deform.reshape(R, R, R, 3),
                                   method=cfg.isosurface_method, max_verts=cfg.max_verts,
                                   max_faces=cfg.max_faces)
            verts = m.verts * 2.0 - 1.0
            feats = export_fn(verts[None], cache_i)[0]
            meshes.append(Mesh(v_pos=verts, t_pos_idx=m.faces, v_mask=m.vert_mask,
                               t_mask=m.face_mask, v_rgb=material_fn(feats)))
        return meshes

    def __call__(self, meshes: List[Mesh], save_dir: str,
                 names: Optional[List[str]] = None) -> List[str]:
        """``<save_dir>/<name>/model.obj`` for each mesh; returns the paths."""
        return [save_obj(os.path.join(save_dir, names[i] if names else f"{self.cfg.save_name}_{i}",
                                      "model.obj"),
                         mesh.v_pos, mesh.t_pos_idx, v_rgb=mesh.v_rgb, v_mask=mesh.v_mask,
                         t_mask=mesh.t_mask)
                for i, mesh in enumerate(meshes)]
