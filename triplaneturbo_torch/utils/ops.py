"""Tensor helpers on the render path, and the reference's small loss helpers.

Counterpart of ``triplaneturbo_tpu/utils/ops.py``: ``safe_normalize``, the
normalisation whose backward stays finite on zero rows; ``chunk_batch``, which
bounds the memory of a per-point function by running it over fixed-size chunks;
``specify_gradient``, which injects a precomputed gradient (the reference's
``SpecifyGradient``); ``binary_cross_entropy``, ``perpendicular_component`` and
``dot``.
"""

from __future__ import annotations

from typing import Callable

import torch
import torch.nn.functional as F


def safe_normalize(x: torch.Tensor, eps: float = 1e-8) -> torch.Tensor:
    """x / ||x|| over the last axis, with eps INSIDE the sqrt.

    ``x / max(||x||, eps)`` has a NaN backward at an exactly zero row
    (d||x||/dx = x/||x|| is 0/0 there, and a zero cotangent times a NaN
    partial is NaN). Non-hit rasterizer pixels interpolate to exact zeros and
    padded mesh slots are exact zeros, so ``sqrt(max(s, eps²))``, whose
    derivative in s is 0 at s = 0, gives them clean zero gradients.
    """
    s = (x * x).sum(-1, keepdim=True)
    return x / torch.sqrt(torch.clamp_min(s, eps * eps))


def chunk_batch(fn: Callable, chunk_size: int, x: torch.Tensor, *args, **kwargs):
    """``fn(x, *args, **kwargs)`` computed over chunks of ``x`` along dim 0.

    The tail is padded with zeros to a whole chunk, as the JAX package pads it
    for ``lax.map``, so every call sees the same shape; the results are
    concatenated and cut back to ``x``'s length. ``chunk_size <= 0``, or a
    ``x`` no longer than one chunk, calls ``fn`` once.
    """
    n = x.shape[0]
    if chunk_size <= 0 or n <= chunk_size:
        return fn(x, *args, **kwargs)
    pad = -(-n // chunk_size) * chunk_size - n
    xp = F.pad(x, (0, 0) * (x.ndim - 1) + (0, pad))
    return torch.cat([fn(xc, *args, **kwargs) for xc in xp.split(chunk_size)])[:n]


class _SpecifyGradient(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, grad):
        ctx.save_for_backward(grad)
        return x.new_zeros(())

    @staticmethod
    def backward(ctx, g):
        (grad,) = ctx.saved_tensors
        return g * grad, torch.zeros_like(grad)


def specify_gradient(x: torch.Tensor, grad: torch.Tensor) -> torch.Tensor:
    """A zero scalar in ``x``'s dtype, connected to ``x``: its backward gives ``x`` the
    gradient ``grad`` (times the scalar's cotangent) and ``grad`` a zero one."""
    return _SpecifyGradient.apply(x, grad)


def binary_cross_entropy(inputs: torch.Tensor, targets: torch.Tensor,
                         eps: float = 0.0) -> torch.Tensor:
    """The mean binary cross-entropy, the inputs clamped to [1e-7, 1 - 1e-7] (``eps``
    is unused, as in the JAX package)."""
    x = torch.clamp(inputs, 1e-7, 1 - 1e-7)
    return -(targets * torch.log(x) + (1 - targets) * torch.log(1 - x)).mean()


def perpendicular_component(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """The component of ``x`` orthogonal to ``y``, item by item along dim 0."""
    dims = tuple(range(1, x.ndim))
    proj, norm = x * y, y * y
    if dims:  # torch reads an empty dim tuple as every dim
        proj, norm = proj.sum(dim=dims, keepdim=True), norm.sum(dim=dims, keepdim=True)
    return x - proj / torch.clamp_min(norm, 1e-8) * y


def dot(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """The dot product over the last axis, kept as a size-1 axis."""
    return (a * b).sum(-1, keepdim=True)
