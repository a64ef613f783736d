"""Fixed-capacity triangle mesh with the quantities the renderers read.

Counterpart of ``triplaneturbo_tpu/utils/mesh.py``: ``v_mask`` / ``t_mask``
mark the valid entries of the fixed-capacity buffers, and invalid faces
reference vertex slot 0. Vertex normals are the area-weighted sum of face
normals, scattered with ``index_add``; ``normal_consistency`` and
``laplacian`` are the first renderer's mesh regularizers. Every norm keeps
its eps inside the sqrt, so zero rows (padded slots, masked faces) have
finite, zero gradients. ``vertex_tangents`` (from UVs, for tangent-space normal
maps) and ``remove_outliers`` (small components dropped on the host, by the masks)
follow the JAX package's.
"""

from __future__ import annotations

from dataclasses import dataclass, replace
from typing import Optional, Union

import numpy as np
import torch


def _rows(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """x[idx] through ``index_select``, whose backward is an ``index_add``."""
    return x.index_select(0, idx)


def _normalize(x: torch.Tensor, eps: float) -> torch.Tensor:
    return x / torch.sqrt(torch.clamp_min((x * x).sum(-1, keepdim=True), eps))


@dataclass(frozen=True)
class Mesh:
    v_pos: torch.Tensor  # [V, 3]
    t_pos_idx: torch.Tensor  # [F, 3] integer
    v_mask: Optional[torch.Tensor] = None  # [V] bool
    t_mask: Optional[torch.Tensor] = None  # [F] bool
    v_rgb: Optional[torch.Tensor] = None  # [V, 3]
    v_nrm: Optional[torch.Tensor] = None  # [V, 3]
    v_tex: Optional[torch.Tensor] = None  # [V, 2]

    @property
    def num_capacity_verts(self) -> int:
        return self.v_pos.shape[0]

    @property
    def num_capacity_faces(self) -> int:
        return self.t_pos_idx.shape[0]

    def with_(self, **kw) -> "Mesh":
        """A copy with the fields ``kw`` replaced."""
        return replace(self, **kw)

    def valid_vert_mask(self) -> torch.Tensor:
        if self.v_mask is None:
            return torch.ones(self.v_pos.shape[0], dtype=torch.bool, device=self.v_pos.device)
        return self.v_mask

    def valid_face_mask(self) -> torch.Tensor:
        if self.t_mask is None:
            return torch.ones(self.t_pos_idx.shape[0], dtype=torch.bool,
                              device=self.t_pos_idx.device)
        return self.t_mask

    def face_normals(self, normalize: bool = True, eps: float = 1e-20) -> torch.Tensor:
        """Per-face normals [F, 3]; invalid faces give zero vectors."""
        p0, p1, p2 = (_rows(self.v_pos, self.t_pos_idx[:, k]) for k in range(3))
        n = torch.linalg.cross(p1 - p0, p2 - p0)
        if normalize:
            n = _normalize(n, eps)
        return n * self.valid_face_mask()[:, None]

    def vertex_normals(self, eps: float = 1e-20) -> torch.Tensor:
        """Area-weighted vertex normals [V, 3]: the unnormalised face normals
        scattered onto their three vertices, then normalised."""
        fn = self.face_normals(normalize=False)
        vn = torch.zeros_like(self.v_pos)
        for k in range(3):
            vn = vn.index_add(0, self.t_pos_idx[:, k], fn)
        return _normalize(vn, eps) * self.valid_vert_mask()[:, None]

    def vertex_tangents(self, t_tex_idx: Optional[torch.Tensor] = None,
                        eps: float = 1e-20) -> torch.Tensor:
        """Per-vertex tangents [V, 3] from the UVs ``v_tex`` (``t_tex_idx`` [F, 3], the
        faces' UV indices, defaults to ``t_pos_idx``): each face's tangent from its UV
        Jacobian, with the determinant clamped away from 0 with its sign (|d| >= 1e-6;
        0 counts as negative), averaged over the vertex's valid faces, normalised, then
        made orthogonal to the vertex normal (``v_nrm``, or :meth:`vertex_normals`)."""
        if self.v_tex is None:
            raise ValueError("vertex_tangents requires v_tex UV coordinates")
        tex_idx = self.t_pos_idx if t_tex_idx is None else t_tex_idx
        p0, p1, p2 = (_rows(self.v_pos, self.t_pos_idx[:, k]) for k in range(3))
        t0, t1, t2 = (_rows(self.v_tex, tex_idx[:, k]) for k in range(3))
        uve1, uve2 = t1 - t0, t2 - t0
        pe1, pe2 = p1 - p0, p2 - p0
        nom = pe1 * uve2[:, 1:2] - pe2 * uve1[:, 1:2]
        denom = uve1[:, 0:1] * uve2[:, 1:2] - uve1[:, 1:2] * uve2[:, 0:1]
        denom = torch.where(denom > 0.0, torch.clamp_min(denom, 1e-6),
                            torch.clamp_max(denom, -1e-6))
        fm = self.valid_face_mask().to(self.v_pos.dtype)[:, None]
        tang = (nom / denom) * fm
        tangents = torch.zeros_like(self.v_pos)
        tansum = torch.zeros_like(self.v_pos)
        for k in range(3):
            tangents = tangents.index_add(0, self.t_pos_idx[:, k], tang)
            tansum = tansum.index_add(0, self.t_pos_idx[:, k], fm.expand_as(tang))
        tangents = _normalize(tangents / torch.clamp_min(tansum, 1.0), eps)
        vn = self.v_nrm if self.v_nrm is not None else self.vertex_normals()
        tangents = _normalize(tangents - (tangents * vn).sum(-1, keepdim=True) * vn, eps)
        return tangents * self.valid_vert_mask()[:, None]

    def remove_outliers(self, outlier_n_faces_threshold: Union[int, float] = 0.01) -> "Mesh":
        """The mesh without its small connected components, by the masks (the
        capacities stay): a component of valid faces is kept when it has at least
        ``outlier_n_faces_threshold`` faces (an int) or that share of the largest
        component's (a float). Vertices are kept where a kept face uses them. Runs on
        the host (union-find over the valid faces)."""
        faces = self.t_pos_idx.detach().cpu().numpy()
        fmask = self.valid_face_mask().detach().cpu().numpy()
        idx = np.nonzero(fmask)[0]
        if len(idx) == 0:
            return self
        parent = np.arange(self.num_capacity_verts)

        def find(a):
            root = a
            while parent[root] != root:
                root = parent[root]
            while parent[a] != root:
                parent[a], a = root, parent[a]
            return root

        f = faces[idx]
        for tri in f:
            r0 = find(tri[0])
            for v in tri[1:]:
                rv = find(v)
                if rv != r0:
                    parent[rv] = r0
        comp = np.array([find(v) for v in f[:, 0]])
        labels, counts = np.unique(comp, return_counts=True)
        if isinstance(outlier_n_faces_threshold, float):
            keep_min = counts.max() * outlier_n_faces_threshold
        else:
            keep_min = outlier_n_faces_threshold
        keep_face = np.isin(comp, labels[counts >= keep_min])
        new_fmask = fmask.copy()
        new_fmask[idx[~keep_face]] = False
        new_vmask = np.zeros(self.num_capacity_verts, bool)
        new_vmask[faces[new_fmask].reshape(-1)] = True
        dev = self.v_pos.device
        return self.with_(t_mask=torch.from_numpy(new_fmask).to(dev),
                          v_mask=torch.from_numpy(new_vmask).to(dev))

    def normal_consistency(self) -> torch.Tensor:
        """Mean of 1 - cos between the vertex normals at the two ends of
        every edge of every valid face."""
        vn = self.vertex_normals()
        fm = self.valid_face_mask().to(self.v_pos.dtype)
        total = self.v_pos.new_zeros(())
        for a, b in ((0, 1), (1, 2), (2, 0)):
            cos = (_rows(vn, self.t_pos_idx[:, a]) * _rows(vn, self.t_pos_idx[:, b])).sum(-1)
            total = total + ((1.0 - cos) * fm).sum()
        return total / torch.clamp_min(fm.sum() * 3.0, 1.0)

    def laplacian(self) -> torch.Tensor:
        """Uniform-Laplacian smoothness: the mean distance of every valid
        vertex from the mean of its neighbours along valid faces."""
        V = self.v_pos.shape[0]
        fm = self.valid_face_mask().to(self.v_pos.dtype)
        nbr_sum = torch.zeros_like(self.v_pos)
        nbr_cnt = self.v_pos.new_zeros((V,))
        for a, b in ((0, 1), (1, 2), (2, 0)):
            ia, ib = self.t_pos_idx[:, a], self.t_pos_idx[:, b]
            nbr_sum = nbr_sum.index_add(0, ia, _rows(self.v_pos, ib) * fm[:, None])
            nbr_sum = nbr_sum.index_add(0, ib, _rows(self.v_pos, ia) * fm[:, None])
            nbr_cnt = nbr_cnt.index_add(0, ia, fm).index_add(0, ib, fm)
        valid = (nbr_cnt > 0) & self.valid_vert_mask()
        mean_nbr = nbr_sum / torch.clamp_min(nbr_cnt, 1.0)[:, None]
        # eps inside the sqrt: padded slots have v_pos == mean_nbr == 0 exactly
        lap = torch.sqrt(torch.clamp_min(((self.v_pos - mean_nbr) ** 2).sum(-1), 1e-20))
        return (lap * valid).sum() / torch.clamp_min(valid.sum(), 1)
