"""Plain softmax attention: the reference's stand-in for the port's flash kernels.

Every call computes softmax(q kᵀ/√D) v in the inputs' type with the softmax in f32
(autograd differentiates it), in blocks of batch-heads so that the score matrix of
one block stays under ``_BLOCK_BYTES``, and reports its shapes to ``sites``.
"""

from __future__ import annotations

import math

import torch

from . import sites

_BLOCK_BYTES = 1 << 30


def _plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """[BH, L, D] attention."""
    scale = 1.0 / math.sqrt(q.shape[-1])
    s = torch.einsum("bld,bkd->blk", q, k).float() * scale
    p = torch.softmax(s, dim=-1).to(q.dtype)
    return torch.einsum("blk,bkd->bld", p, v)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    BH, L, D = q.shape
    Lk = k.shape[1]
    grad = torch.is_grad_enabled() and (q.requires_grad or k.requires_grad or v.requires_grad)
    sites.record("attention", BH=BH, L=L, Lk=Lk, D=D, dtype=str(q.dtype).replace("torch.", ""),
                 grad=grad, needs=(q.requires_grad, k.requires_grad, v.requires_grad))
    step = max(1, _BLOCK_BYTES // max(1, L * Lk * 4))
    if step >= BH:
        return _plain(q, k, v)
    return torch.cat([_plain(q[i:i + step], k[i:i + step], v[i:i + step])
                      for i in range(0, BH, step)])


def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """``[B, L, H, D]`` attention: the program's kernel sites (D in (64, 512) and
    L >= 128) through :func:`flash_attention`, the rest as the program's einsum path."""
    B, L, H, D = q.shape
    Lk = k.shape[1]
    if D in (64, 512) and L >= 128:
        qf = q.transpose(1, 2).reshape(B * H, L, D)
        kf = k.transpose(1, 2).reshape(B * H, Lk, D)
        vf = v.transpose(1, 2).reshape(B * H, Lk, D)
        return flash_attention(qf, kf, vf).reshape(B, H, L, D).transpose(1, 2)
    scale = 1.0 / math.sqrt(D)
    scores = torch.einsum("bqhd,bkhd->bhqk", q, k) * scale
    probs = torch.softmax(scores.float(), dim=-1).to(q.dtype)
    return torch.einsum("bhqk,bkhd->bqhd", probs, v)
