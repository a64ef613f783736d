"""Fixed-capacity triangle mesh with the quantities the renderers read.

Counterpart of ``triplaneturbo_tpu/utils/mesh.py``: ``v_mask`` / ``t_mask``
mark the valid entries of the fixed-capacity buffers, and invalid faces
reference vertex slot 0. Vertex normals are the area-weighted sum of face
normals, scattered with ``index_add``; ``normal_consistency`` and
``laplacian`` are the first renderer's mesh regularizers. Every norm keeps
its eps inside the sqrt, so zero rows (padded slots, masked faces) have
finite, zero gradients.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

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
