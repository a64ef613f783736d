"""Flash attention, forward and backward: the hand-written CUDA kernels, their
plain versions and the dispatcher the attention layers call.

Counterpart of ``triplaneturbo_tpu/ops/attention_pallas.py``. Four kernels in
two sources, none of which materialises the ``[L, Lk]`` score matrix:

* ``csrc/flash_attn_fwd.cu``: the forward (``_flash_kernel``), and the forward
  that also writes the per-row logsumexp (``_flash_kernel_stats``);
* ``csrc/flash_attn_bwd.cu``: dq (``_flash_bwd_dq_kernel``) and dk/dv
  (``_flash_bwd_dkdv_kernel``), which recompute the probabilities from the
  saved logsumexp.

On a CPU tensor ``flash_attention`` computes the plain version and autograd
differentiates it. On a CUDA tensor it launches the kernels or raises: the
plain forward without grad, and a ``torch.autograd.Function`` (forward with
stats, both backward kernels) when an input requires grad.
"""

from __future__ import annotations

import ctypes
import math
from typing import Tuple

import torch

from . import _build

# Kernel launches since each count was last reset (a wrapper adds one per launch).
LAUNCHES = 0  # forward without stats
LAUNCHES_STATS = 0  # forward that also writes the logsumexp
LAUNCHES_BWD_DQ = 0
LAUNCHES_BWD_DKDV = 0

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_HEAD_DIMS = (64, 512)


def flash_attention_reference(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                              return_stats: bool = False):
    """Plain softmax(q kᵀ/√D) v over ``[BH, L, D]``, in f32, cast to q's type.

    With ``return_stats`` also the per-row logsumexp of the scaled scores,
    ``[BH, L]`` f32, which the backward reads.
    """
    scale = 1.0 / math.sqrt(q.shape[-1])
    s = torch.einsum("bld,bkd->blk", q.float(), k.float()) * scale
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("blk,bkd->bld", p, v.float()).to(q.dtype)
    if return_stats:
        return out, torch.logsumexp(s, dim=-1)
    return out


def flash_attention_bwd_reference(q, k, v, o, lse, g) -> Tuple[torch.Tensor, ...]:
    """Plain flash backward, step by step in f32: (dq, dk, dv) in the inputs' types.

    ``o`` and ``lse`` are the forward's output and logsumexp, ``g`` the
    cotangent of ``o``.
    """
    scale = 1.0 / math.sqrt(q.shape[-1])
    qf, kf, vf, gf = q.float(), k.float(), v.float(), g.float()
    delta = flash_delta(o, g)  # [BH, L]
    s = torch.einsum("bld,bkd->blk", qf, kf) * scale
    p = torch.exp(s - lse[..., None])
    dp = torch.einsum("bld,bkd->blk", gf, vf)
    ds = p * (dp - delta[..., None])
    dq = torch.einsum("blk,bkd->bld", ds, kf) * scale
    dk = torch.einsum("blk,bld->bkd", ds, qf) * scale
    dv = torch.einsum("blk,bld->bkd", p, gf)
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


def _check(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> None:
    BH, L, D = q.shape
    Lk = k.shape[1]
    if q.dtype not in _DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"flash_attention takes float32 or bfloat16, got {q.dtype}/{k.dtype}/{v.dtype}")
    if D not in _HEAD_DIMS:
        raise ValueError(f"flash_attention kernel is built for D in {_HEAD_DIMS}, got {D}")
    if k.shape != (BH, Lk, D) or v.shape != k.shape:
        raise ValueError(f"shape mismatch: q {tuple(q.shape)}, k {tuple(k.shape)}, v {tuple(v.shape)}")
    if not (k.device == q.device and v.device == q.device):
        raise ValueError("q, k and v must be on one device")
    if not (q.is_contiguous() and k.is_contiguous() and v.is_contiguous()):
        raise ValueError("flash_attention needs contiguous q, k and v")
    if BH > 65535:
        raise ValueError(f"flash_attention takes at most 65535 batch-heads, got {BH}")


def _call(source: str, name: str, pointers, ints, device) -> None:
    """Call the C entry point ``name`` of ``csrc/<source>.cu`` (pointers, then ints,
    then the stream) and raise on a CUDA error."""
    fn = getattr(_build.load(source), name)
    fn.argtypes = [ctypes.c_void_p] * len(pointers) + [ctypes.c_int] * len(ints) + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        err = fn(*pointers, *ints, stream)
    if err != 0:
        raise RuntimeError(f"{name} launch failed with CUDA error {err}")


def _launch(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, return_stats: bool = False):
    global LAUNCHES, LAUNCHES_STATS
    _check(q, k, v)
    BH, L, D = q.shape
    ints = (BH, L, k.shape[1], D, _DTYPES[q.dtype])
    out = torch.empty_like(q)
    if not return_stats:
        _call("flash_attn_fwd", "flash_attn_fwd",
              (q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr()), ints, q.device)
        LAUNCHES += 1
        return out
    lse = torch.empty((BH, L), device=q.device, dtype=torch.float32)
    _call("flash_attn_fwd", "flash_attn_fwd_stats",
          (q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), lse.data_ptr()), ints,
          q.device)
    LAUNCHES_STATS += 1
    return out, lse


def _bwd_args(q, k, v, g, lse, delta):
    """Check the backward kernels' inputs; return their pointers and ints."""
    _check(q, k, v)
    BH, L, D = q.shape
    for name, t, shape, dtype in (("g", g, q.shape, q.dtype), ("lse", lse, (BH, L), torch.float32),
                                  ("delta", delta, (BH, L), torch.float32)):
        if tuple(t.shape) != tuple(shape) or t.dtype != dtype or t.device != q.device:
            raise ValueError(f"flash backward: {name} must be {tuple(shape)} {dtype} on {q.device}, "
                             f"got {tuple(t.shape)} {t.dtype} on {t.device}")
        if not t.is_contiguous():
            raise ValueError(f"flash backward needs a contiguous {name}")
    pointers = tuple(t.data_ptr() for t in (q, k, v, g, lse, delta))
    return pointers, (BH, L, k.shape[1], D, _DTYPES[q.dtype])


def _launch_dq(q, k, v, g, lse, delta) -> torch.Tensor:
    global LAUNCHES_BWD_DQ
    pointers, ints = _bwd_args(q, k, v, g, lse, delta)
    dq = torch.empty_like(q)
    _call("flash_attn_bwd", "flash_attn_bwd_dq", pointers + (dq.data_ptr(),), ints, q.device)
    LAUNCHES_BWD_DQ += 1
    return dq


def _launch_dkdv(q, k, v, g, lse, delta) -> Tuple[torch.Tensor, torch.Tensor]:
    global LAUNCHES_BWD_DKDV
    pointers, ints = _bwd_args(q, k, v, g, lse, delta)
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    _call("flash_attn_bwd", "flash_attn_bwd_dkdv", pointers + (dk.data_ptr(), dv.data_ptr()),
          ints, q.device)
    LAUNCHES_BWD_DKDV += 1
    return dk, dv


def flash_delta(o: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    """δ = rowsum(dO ∘ O) in f32, ``[BH, L]``: the softmax-Jacobian row term."""
    return (g.float() * o.float()).sum(-1)


class _FlashAttention(torch.autograd.Function):
    """Forward with stats; backward through the dq and dk/dv kernels."""

    @staticmethod
    def forward(ctx, q, k, v):
        out, lse = _launch(q, k, v, return_stats=True)
        ctx.save_for_backward(q, k, v, out, lse)
        return out

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, g):
        q, k, v, out, lse = ctx.saved_tensors
        # the cotangent usually arrives through a transpose: the kernels take it contiguous
        g = g.contiguous()
        delta = flash_delta(out, g)
        return (_launch_dq(q, k, v, g, lse, delta), *_launch_dkdv(q, k, v, g, lse, delta))


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Fused softmax attention over ``[BH, L, D]`` (no causal mask), differentiable."""
    if q.device.type == "cpu":
        return flash_attention_reference(q, k, v)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention runs on cuda or cpu, got {q.device}")
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad or v.requires_grad):
        return _FlashAttention.apply(q, k, v)
    return _launch(q, k, v)


def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Dispatch ``[B, L, H, D]`` attention with the JAX package's gate.

    The kernel takes ``D % 64 == 0 and L >= 128``; the rest runs the einsum
    path, whose softmax is taken in f32 and cast to q's type before the product
    with v (``attention_pallas.py:309-319``), and which autograd differentiates.
    """
    B, L, H, D = q.shape
    Lk = k.shape[1]
    if D % 64 == 0 and L >= 128:
        qf = q.transpose(1, 2).reshape(B * H, L, D).contiguous()
        kf = k.transpose(1, 2).reshape(B * H, Lk, D).contiguous()
        vf = v.transpose(1, 2).reshape(B * H, Lk, D).contiguous()
        return flash_attention(qf, kf, vf).reshape(B, H, L, D).transpose(1, 2)
    scale = 1.0 / math.sqrt(D)
    scores = torch.einsum("bqhd,bkhd->bhqk", q, k) * scale
    probs = torch.softmax(scores.float(), dim=-1).to(q.dtype)
    return torch.einsum("bhqk,bkhd->bqhd", probs, v)
