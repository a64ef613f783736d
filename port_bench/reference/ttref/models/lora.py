"""LoRA and LoCon adapters, with per-plane ("hexa") LoRA routing.

Counterpart of ``triplaneturbo_tpu/models/lora.py``. Every adapter computes in
float32 and casts back to its input's dtype, whatever the model's dtype, and
its parameters stay float32. ``up`` starts at zero, so a fresh adapter adds
nothing. ``PlaneLoConAdapter`` (hexa LoCon) is the JAX package's ``nn.vmap`` of
``LoConAdapter`` over the planes as two grouped convolutions: the planes are
folded into channel groups, one group a plane.
"""

from __future__ import annotations

import torch
from torch import nn


class LoRAAdapter(nn.Module):
    """Vanilla LoRA delta for a linear layer: x @ down @ up (+ bias)."""

    def __init__(self, in_features: int, out_features: int, rank: int = 16,
                 with_bias: bool = False):
        super().__init__()
        self.rank = rank
        self.down = nn.Parameter(torch.empty(in_features, rank, dtype=torch.float32))
        self.up = nn.Parameter(torch.zeros(rank, out_features, dtype=torch.float32))
        self.bias = (nn.Parameter(torch.zeros(out_features, dtype=torch.float32))
                     if with_bias else None)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = (x.float() @ self.down) @ self.up
        if self.bias is not None:
            h = h + self.bias
        return h.to(x.dtype)


class PlaneLoRAAdapter(nn.Module):
    """Per-plane LoRA over ``[B, P, L, C]``: plane p uses its own (down_p, up_p)."""

    def __init__(self, in_features: int, out_features: int, n_planes: int = 6,
                 rank: int = 16, with_bias: bool = False):
        super().__init__()
        self.n_planes = n_planes
        self.rank = rank
        self.down = nn.Parameter(torch.empty(n_planes, in_features, rank, dtype=torch.float32))
        self.up = nn.Parameter(torch.zeros(n_planes, rank, out_features, dtype=torch.float32))
        self.bias = (nn.Parameter(torch.zeros(n_planes, out_features, dtype=torch.float32))
                     if with_bias else None)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if x.ndim != 4 or x.shape[1] != self.n_planes:
            raise ValueError(f"expected [B, {self.n_planes}, L, C], got {tuple(x.shape)}")
        h = torch.einsum("bplc,pcr->bplr", x.float(), self.down)
        h = torch.einsum("bplr,pro->bplo", h, self.up)
        if self.bias is not None:
            h = h + self.bias[None, :, None, :]
        return h.to(x.dtype)


class LoConAdapter(nn.Module):
    """Low-rank conv delta on NCHW input: kxk ``down`` conv to rank channels, 1x1 ``up``."""

    def __init__(self, in_channels: int, out_features: int, rank: int = 16,
                 kernel_size: int = 3, stride: int = 1, padding: int = 1,
                 with_bias: bool = False):
        super().__init__()
        self.down = nn.Conv2d(in_channels, rank, kernel_size, stride=stride, padding=padding,
                              bias=False, dtype=torch.float32)
        self.up = nn.Conv2d(rank, out_features, 1, bias=with_bias, dtype=torch.float32)
        nn.init.zeros_(self.up.weight)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.up(self.down(x.float())).to(x.dtype)


class PlaneLoConAdapter(nn.Module):
    """Per-plane LoCon over NCHW input ``[B * P, C, H, W]`` (plane-major within each
    item): plane p uses its own k x k ``down`` to rank channels and 1x1 ``up``.

    The planes are folded into the channels, ``[B, P * C, H, W]``, and each conv has
    ``groups=P``, so ``planes.down.weight`` is ``[P * rank, C, k, k]`` and
    ``planes.up.weight`` ``[P * out, rank, 1, 1]``: group p holds the JAX package's
    stacked kernel p (``locon/planes/{down,up}/kernel``, ``[P, k, k, C, rank]`` and
    ``[P, 1, 1, rank, out]``)."""

    def __init__(self, in_channels: int, out_features: int, n_planes: int = 6, rank: int = 16,
                 kernel_size: int = 3, stride: int = 1, padding: int = 1,
                 with_bias: bool = False):
        super().__init__()
        P = n_planes
        self.n_planes = P
        self.planes = nn.ModuleDict({
            "down": nn.Conv2d(P * in_channels, P * rank, kernel_size, stride=stride,
                              padding=padding, groups=P, bias=False, dtype=torch.float32),
            "up": nn.Conv2d(P * rank, P * out_features, 1, groups=P, bias=with_bias,
                            dtype=torch.float32)})
        nn.init.zeros_(self.planes["up"].weight)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        N, C, H, W = x.shape
        P = self.n_planes
        if N % P:
            raise ValueError(f"{N} items are not a whole number of {P}-plane groups")
        h = self.planes["up"](self.planes["down"](x.float().reshape(N // P, P * C, H, W)))
        return h.reshape(N, -1, *h.shape[-2:]).to(x.dtype)
