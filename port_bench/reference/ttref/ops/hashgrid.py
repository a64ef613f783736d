"""Multiresolution hash-grid encoding (the tiny-cuda-nn grid the background uses).

Counterpart of ``triplaneturbo_tpu/ops/hashgrid.py``: L levels of
geometrically growing resolution, each a table of T rows of F features,
trilinearly interpolated and concatenated. A level whose dense grid fits the
table, (res + 1)³ <= T, indexes its rows without a hash, as tcnn does; the
finer levels hash the corner with the primes (1, 2654435761, 805459861) in
uint32 arithmetic. Torch has no uint32 multiply on CUDA, so the hash runs in
int64 with ``& 0xFFFFFFFF`` after each product, then XOR, then ``% T``.

The JAX package samples its dense levels through a packed cell table and its
hashed levels through a custom VJP: both are TPU layouts of this same
function. Here each level is one gather of its eight corner rows
(``index_select``), and autograd gives the same values and the same
gradients, for the table (a scatter-add, ``index_add``, in the gather's
backward) and for x (through the trilinear weights).
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import torch
from torch import nn

_PRIMES = (1, 2654435761, 805459861)
_MASK32 = 0xFFFFFFFF

# corner offsets, x fastest (8, 3)
_OFFSETS = tuple((dx, dy, dz) for dz in (0, 1) for dy in (0, 1) for dx in (0, 1))


@dataclass(frozen=True)
class HashGridConfig:
    n_levels: int = 8
    n_features_per_level: int = 2
    log2_hashmap_size: int = 19
    base_resolution: int = 4
    per_level_scale: float = 1.8114473285278132

    @property
    def n_output_dims(self) -> int:
        return self.n_levels * self.n_features_per_level

    @property
    def resolutions(self) -> tuple:
        return tuple(max(int(math.floor(self.base_resolution * self.per_level_scale ** lvl)), 1)
                     for lvl in range(self.n_levels))

    def is_dense(self, res: int) -> bool:
        return (res + 1) ** 3 <= (1 << self.log2_hashmap_size)


def _corner_weights(x: torch.Tensor, res: int) -> torch.Tensor:
    """Trilinear corner weights (N, 8), corner order ``_OFFSETS``."""
    pos = x * res
    frac = (pos - torch.floor(pos)).float()
    off = torch.tensor(_OFFSETS, dtype=torch.float32, device=x.device)
    return torch.prod(off[None] * frac[:, None, :] + (1.0 - off[None]) * (1.0 - frac[:, None, :]),
                      dim=-1)


def _level_indices_weights(x: torch.Tensor, res: int, T: int, dense: bool):
    """Rows (N, 8) int64 in [0, T) of one level's corners, and their weights."""
    with torch.no_grad():
        p0 = torch.floor(x * res).long()
        off = torch.tensor(_OFFSETS, dtype=torch.long, device=x.device)
        corner = (p0[:, None, :] + off[None]).clamp(0, res)  # (N, 8, 3)
        c0, c1, c2 = corner.unbind(-1)
        if dense:
            stride = res + 1
            idx = c0 + stride * (c1 + stride * c2)
        else:
            h = (((c0 * _PRIMES[0]) & _MASK32) ^ ((c1 * _PRIMES[1]) & _MASK32)
                 ^ ((c2 * _PRIMES[2]) & _MASK32))
            idx = h % T
    return idx, _corner_weights(x, res)


def hashgrid_encode(table: torch.Tensor, x: torch.Tensor, cfg: HashGridConfig) -> torch.Tensor:
    """table (L, T, F), x (N, 3) in [0, 1] -> (N, L * F)."""
    L, T, F = table.shape
    flat = table.reshape(L * T, F)
    feats = []
    for lvl, res in enumerate(cfg.resolutions):
        idx, w = _level_indices_weights(x, res, T, cfg.is_dense(res))
        # index_select: its backward is an index_add (atomic adds). The backward of
        # flat[idx] sorts the indices and walks each run of duplicates serially, and
        # a coarse level reads its few rows millions of times
        rows = flat.index_select(0, (idx + lvl * T).reshape(-1)).reshape(*idx.shape, F)
        feats.append((rows * w[..., None]).sum(1))
    return torch.cat(feats, dim=-1)


class HashGridEncoding(nn.Module):
    """x in [0, 1]³ -> [N, L * F] features; the table starts uniform in ±1e-4."""

    def __init__(self, cfg: HashGridConfig = HashGridConfig()):
        super().__init__()
        self.cfg = cfg
        self.table = nn.Parameter(torch.empty(
            cfg.n_levels, 1 << cfg.log2_hashmap_size, cfg.n_features_per_level))
        self.reset_parameters()

    @torch.no_grad()
    def reset_parameters(self, generator: torch.Generator = None) -> None:
        if self.table.device.type == "meta":
            return
        self.table.copy_(torch.rand(self.table.shape, generator=generator,
                                    device=self.table.device) * 2e-4 - 1e-4)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return hashgrid_encode(self.table, x, self.cfg)
