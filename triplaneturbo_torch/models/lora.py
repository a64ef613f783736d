"""LoRA and LoCon adapters, with per-plane ("hexa") LoRA routing.

Counterpart of ``triplaneturbo_tpu/models/lora.py``. Every adapter computes in
float32 and casts back to its input's dtype, whatever the model's dtype, and
its parameters stay float32. ``up`` starts at zero, so a fresh adapter adds
nothing. ``PlaneLoConAdapter`` (hexa LoCon) is the JAX package's ``nn.vmap`` of
``LoConAdapter`` over the planes as two grouped convolutions: the planes are
folded into channel groups, one group a plane.

Serving folds the frozen adapters into their base layers (:class:`Fold`):
``conv(x, W) + up(down(x))`` is ``conv(x, W + up∘down)`` where ``down`` is a k x k
conv with the base conv's stride and padding and ``up`` is 1 x 1, and
``x W + x D U`` is ``x (W + D U)``, plane by plane for the hexa LoRA.
"""

from __future__ import annotations

import contextlib
from typing import Iterator, List, Optional, Tuple

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


# -- folding the frozen adapters into their base layers (serving) ------------------------


def bias_sum(*biases: Optional[torch.Tensor]) -> Optional[torch.Tensor]:
    """The f32 sum of the biases given (broadcast), or None when none is."""
    terms = [b.float() for b in biases if b is not None]
    return None if not terms else sum(terms[1:], terms[0])


def _rounded(t: Optional[torch.Tensor], dtype: torch.dtype) -> Optional[torch.Tensor]:
    """A new tensor of ``t``'s values in ``dtype`` (never a parameter itself):
    channels-last for a conv weight, contiguous otherwise."""
    if t is None:
        return None
    fmt = torch.channels_last if t.ndim == 4 else torch.contiguous_format
    return t.to(dtype, memory_format=fmt, copy=True)


def fold_locon(conv: nn.Conv2d, locon: Optional[LoConAdapter], dtype: torch.dtype
               ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """``conv``'s weight with the shared LoCon (if any) added, ``W + up·down``, summed in
    f32 and rounded once to ``dtype``, channels-last (so that cuDNN runs the conv on NHWC
    activations as they are); and its bias ``b + up.bias`` in f32, which the caller adds
    after the conv (``ops/nhwc.py``)."""
    w, up_bias = conv.weight.float(), None
    if locon is not None:
        up = locon.up.weight[:, :, 0, 0].float()  # [out, rank]
        w = w + torch.einsum("or,rikl->oikl", up, locon.down.weight.float())
        up_bias = locon.up.bias
    return _rounded(w, dtype), _rounded(bias_sum(conv.bias, up_bias), torch.float32)


def fold_lora(linear: nn.Linear, lora: LoRAAdapter
              ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """``linear``'s ``[out, in]`` weight and bias with a vanilla LoRA on its input
    added: ``W + (D U)ᵀ``, ``b + lora.bias``."""
    w = linear.weight.float() + (lora.down.float() @ lora.up.float()).T
    return _rounded(w, linear.weight.dtype), _rounded(bias_sum(linear.bias, lora.bias),
                                                      linear.weight.dtype)


def fold_plane_lora(linear: nn.Linear, lora: PlaneLoRAAdapter, on_output: bool = False
                    ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """Per-plane weights ``[P, in, out]`` and biases ``[P, 1, out]`` (or None) of
    ``linear`` with a hexa LoRA: on its input, ``W_p = Wᵀ + D_p U_p`` and
    ``b_p = b + c_p``; on its output (``on_output``, the attention's ``lora_out``),
    ``y + (y D_p U_p + c_p)`` with ``y = x Wᵀ + b``, so ``W_p = Wᵀ (I + D_p U_p)`` and
    ``b_p = b (I + D_p U_p) + c_p``."""
    wt = linear.weight.float().T  # [in, out]
    down, up = lora.down.float(), lora.up.float()  # [P, *, rank], [P, rank, out]
    b = None if linear.bias is None else linear.bias.float()
    if on_output:
        w = wt + (wt @ down) @ up
        if b is not None:
            b = b + torch.einsum("i,pir,pro->po", b, down, up)
    else:
        w = wt + down @ up
    bias = bias_sum(b, lora.bias)
    if bias is not None:
        bias = bias.expand(lora.n_planes, -1)[:, None, :]
    return _rounded(w, linear.weight.dtype), _rounded(bias, linear.weight.dtype)


def plane_linear(x: torch.Tensor, w: torch.Tensor, b: Optional[torch.Tensor]) -> torch.Tensor:
    """``[N, L, in]`` tokens, ``N / P`` items of ``P`` planes (plane-major), through
    plane p's ``w[p]`` ``[in, out]`` and ``b[p]`` ``[1, out]``: one batched matmul over
    the planes (a view of ``x`` for one item)."""
    P = w.shape[0]
    N, L, C = x.shape
    xp = x.reshape(N // P, P, L, C).transpose(0, 1).reshape(P, -1, C)
    y = torch.bmm(xp, w) if b is None else torch.baddbmm(b, xp, w)
    return y.reshape(P, N // P, L, -1).transpose(0, 1).reshape(N, L, -1)


class FoldSite:
    """A layer that :class:`Fold` folds (unless its ``foldable`` is false): it computes
    its folded weights (``fold_weights``) and runs on them while :meth:`folded_now`
    gives them."""

    foldable = True
    fold: Optional["Fold"] = None
    folded: Optional[Tuple[Optional[torch.Tensor], ...]] = None

    def fold_weights(self) -> Tuple[Optional[torch.Tensor], ...]:
        raise NotImplementedError

    def folded_now(self) -> Optional[Tuple[Optional[torch.Tensor], ...]]:
        """The folded weights while the fold is engaged and no gradient is recorded,
        else None (the adapters run as they are)."""
        fold = self.fold
        if fold is not None and fold.on and not torch.is_grad_enabled():
            return self.folded
        return None


class Fold:
    """The frozen adapters of ``root``'s layers folded into their base weights, and the
    trunk run channels-last on them.

    Each site (:class:`FoldSite`) keeps its folded weights outside ``state_dict``: a
    conv's (its shared LoCon added) in the model's dtype and channels-last, with its bias
    in f32; a linear layer's (its LoRA added; per plane for a hexa LoRA); a GroupNorm's
    are its own parameters. :meth:`engaged` brings them up to date with the parameters,
    then lets the sites run on them until it exits: one conv or linear layer (a batched
    matmul over the planes for a hexa LoRA) in place of the base layer, the adapter's
    f32 pass and the add, and the channels-last GroupNorm and bias kernels of
    ``ops/nhwc.py``. The weights are refolded in place whenever a parameter of a site
    was written (its version counter moved) or moved (its storage changed), so a CUDA
    graph captured on them stays valid.
    """

    def __init__(self, root: nn.Module):
        self.on = False
        self.sites: List[FoldSite] = [m for m in root.modules()
                                      if isinstance(m, FoldSite) and m.foldable]
        self._params = [p for m in self.sites for p in m.parameters()]
        self._stamp: Optional[List[Tuple[int, int]]] = None
        for m in self.sites:
            m.fold = self

    @torch.no_grad()
    def refresh(self) -> bool:
        """Refold every site if a parameter changed since the last fold; whether it
        did."""
        stamp = [(p._version, p.data_ptr()) for p in self._params]
        if stamp == self._stamp:
            return False
        for m in self.sites:
            new = m.fold_weights()
            old = m.folded
            if old is None or old[0].device != new[0].device:
                m.folded = new
            else:
                for dst, src in zip(old, new):
                    if dst is not None and dst is not src:
                        dst.copy_(src)
        self._stamp = stamp
        return True

    @contextlib.contextmanager
    def engaged(self) -> Iterator[None]:
        """Refold (:meth:`refresh`) and run the sites folded until the exit. Entries nest:
        an inner one does nothing, and the fold stays on until the outermost exits."""
        if self.on:
            yield
            return
        self.refresh()
        self.on = True
        try:
            yield
        finally:
            self.on = False
