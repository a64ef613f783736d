"""Tensor helpers on the render path.

Counterpart of ``triplaneturbo_tpu/utils/ops.py``: ``safe_normalize``, the
normalisation whose backward stays finite on zero rows, and ``chunk_batch``,
which bounds the memory of a per-point function by running it over fixed-size
chunks.
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
