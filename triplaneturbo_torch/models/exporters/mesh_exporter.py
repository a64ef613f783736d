"""Mesh exporter: space cache → vertex-colored OBJ, or OBJ + MTL + baked texture.

Counterpart of ``triplaneturbo_tpu/models/exporters/mesh_exporter.py``: the SDF
and deformation on the R³ grid (the field-grid kernel on the card, through
``forward_field_grid``), the empty-field fallback, marching cubes into
fixed-capacity buffers and the texture field's colours through the material;
then ``fmt: "obj"`` writes ``utils.saving.save_obj`` and ``fmt: "obj-mtl"`` the
compacted mesh through ``utils.uv_export.export_obj_mtl`` (a per-face UV atlas,
the texture baked from each mesh's color closure on the mesh's device).

Without a closure the JAX exporter bakes each texel from the nearest of only the
first 500 valid vertices, and its launcher never passes one; that fallback is not
carried over: ``obj-mtl`` without a closure raises ``ValueError``.
"""

from __future__ import annotations

import os
from dataclasses import dataclass
from typing import Callable, List, Optional

import torch

from ...ops.isosurface import extract_isosurface, force_field_crossing
from ...utils.mesh import Mesh
from ...utils.saving import save_obj
from ...utils.uv_export import export_obj_mtl


@dataclass
class MeshExporterConfig:
    fmt: str = "obj"  # "obj" (vertex colors) | "obj-mtl" (UV atlas, baked albedo)
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
        if self.cfg.fmt not in ("obj", "obj-mtl"):
            raise ValueError(f"exporter fmt {self.cfg.fmt!r}: 'obj' or 'obj-mtl'")

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

    @torch.no_grad()
    def __call__(self, meshes: List[Mesh], save_dir: str, names: Optional[List[str]] = None,
                 color_fns: Optional[List[Callable]] = None) -> List[str]:
        """``<save_dir>/<name>/model.obj`` for each mesh (with ``model.mtl`` and
        ``texture_kd.png`` for ``obj-mtl``, which needs ``color_fns``: one closure a
        mesh, points [N, 3] -> colors [N, 3]); returns the OBJ paths."""
        paths = []
        for i, mesh in enumerate(meshes):
            name = names[i] if names else f"{self.cfg.save_name}_{i}"
            if self.cfg.fmt == "obj-mtl":
                paths.append(self._export_obj_mtl(mesh, save_dir, name,
                                                  color_fns[i] if color_fns else None))
            else:
                paths.append(save_obj(os.path.join(save_dir, name, "model.obj"), mesh.v_pos,
                                      mesh.t_pos_idx, v_rgb=mesh.v_rgb, v_mask=mesh.v_mask,
                                      t_mask=mesh.t_mask))
        return paths

    def _export_obj_mtl(self, mesh: Mesh, save_dir: str, name: str,
                        color_fn: Optional[Callable]) -> str:
        """The valid vertices and faces, reindexed, through ``export_obj_mtl``."""
        if color_fn is None:
            raise ValueError("fmt 'obj-mtl' bakes the texture from each mesh's color "
                             "closure: pass color_fns")
        vm, fm = mesh.valid_vert_mask(), mesh.valid_face_mask()
        remap = torch.full((mesh.v_pos.shape[0],), -1, dtype=torch.long, device=vm.device)
        remap[vm] = torch.arange(int(vm.sum()), device=vm.device)
        faces = remap[mesh.t_pos_idx.long()[fm]]
        faces = faces[(faces >= 0).all(dim=1)]
        obj_path, _, _ = export_obj_mtl(os.path.join(save_dir, name), "model", mesh.v_pos[vm],
                                        faces, color_fn)
        return obj_path
