"""Flash attention, forward and backward: the hand-written CUDA kernels, their
plain versions and the dispatcher the attention layers call.

Counterpart of ``triplaneturbo_tpu/ops/attention_pallas.py``. Four kernels in
two sources, none of which materialises the ``[L, Lk]`` score matrix:

* ``csrc/flash_attn_fwd.cu``: the forward (``_flash_kernel``), and the forward
  that also writes the per-row logsumexp (``_flash_kernel_stats``);
* ``csrc/flash_attn_bwd.cu``: dq (``_flash_bwd_dq_kernel``) and dk/dv
  (``_flash_bwd_dkdv_kernel``), which recompute the probabilities from the
  saved logsumexp.

For bf16 inputs every kernel runs its products on the tensor cores
(``wgmma``), keeps the score tiles (S and P; in the backward also dP and dS)
in registers, takes the exponentials in base 2 and rounds P (and dS) to bf16
before the products that read them; f32 inputs keep FMA bodies.
``flash_attention_tiled_reference`` and ``flash_attention_bwd_tiled_reference``
emulate that arithmetic tile by tile in plain PyTorch, so that its numerics are
held against the JAX package on the CPU; nothing on the main path calls them.

On a CPU tensor ``flash_attention`` computes the plain version and autograd
differentiates it. On a CUDA tensor it launches the kernels or raises: the
plain forward without grad, and a ``torch.autograd.Function`` (forward with
stats, both backward kernels) when an input requires grad. Each launch reports to
``utils/flops.py`` what the plain version counts at its shapes (the kernels' own
recompute of the scores in the backward does not count): 4·BH·L·Lk·D a forward, with
or without stats, and for the backward what autograd through
``flash_attention_reference`` runs for the inputs that need a gradient, 8·BH·L·Lk·D
when all three do (dP and dq reported by the dq kernel, dk and dv by dk/dv).
"""

from __future__ import annotations

import ctypes
import math
from typing import Optional, Tuple

import torch

from ..utils import cuda_graphs as _cuda_graphs
from ..utils import flops as _flops
from ..utils.profiling import span
from . import _build

# Kernel launches since each count was last reset (a wrapper adds one per launch).
LAUNCHES = 0  # forward without stats
LAUNCHES_STATS = 0  # forward that also writes the logsumexp
LAUNCHES_BWD_DQ = 0
LAUNCHES_BWD_DKDV = 0

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_HEAD_DIMS = (64, 512)
_NEG_INF = -1e30  # the score of a key past Lk, as in the kernels


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


def flash_attention_tiled_reference(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                                    return_stats: bool = False, kv_tile: Optional[int] = None):
    """The tensor-core forward kernel's arithmetic, tile by tile in plain PyTorch.

    What ``csrc/flash_attn_fwd.cu`` does for bf16 inputs: an online softmax over
    key tiles of ``kv_tile`` (the kernels' 128 at D = 64 and 64 at D = 512 when
    not given) in base 2 with ``scale * log2(e)`` folded into one multiply-add,
    keys at or past ``Lk`` (the zero-filled rest of the last tile) set to -1e30
    before the row max, the normalizer summed from the f32 exponentials, P
    rounded to the inputs' type before P·V (no rounding for f32 inputs, which
    take the FMA kernel on the card), ``o = acc / max(l, 1e-30)`` and the
    logsumexp converted back to natural log, ``m * ln2 + log(l)``.
    """
    BH, L, D = q.shape
    Lk = k.shape[1]
    if kv_tile is None:
        kv_tile = 128 if D <= 64 else 64
    c = torch.tensor(math.log2(math.e) / math.sqrt(D), dtype=torch.float32)
    qf, kf, vf = q.float(), k.float(), v.float()
    m = torch.full((BH, L), _NEG_INF, dtype=torch.float32, device=q.device)
    l = torch.zeros((BH, L), dtype=torch.float32, device=q.device)
    acc = torch.zeros((BH, L, D), dtype=torch.float32, device=q.device)
    for k0 in range(0, Lk, kv_tile):
        kt, vt = kf[:, k0:k0 + kv_tile], vf[:, k0:k0 + kv_tile]
        pad = kv_tile - kt.shape[1]
        if pad:  # the loads fill rows past Lk with zeros
            kt = torch.nn.functional.pad(kt, (0, 0, 0, pad))
            vt = torch.nn.functional.pad(vt, (0, 0, 0, pad))
        s = torch.einsum("bld,bkd->blk", qf, kt)
        valid = torch.arange(k0, k0 + kv_tile, device=q.device) < Lk
        s = torch.where(valid, s, torch.full_like(s, _NEG_INF))
        m_new = torch.maximum(m, s.amax(-1) * c)
        alpha = torch.exp2(m - m_new)
        e = torch.exp2(s * c - m_new[..., None])
        l = l * alpha + e.sum(-1)
        p = e.to(q.dtype).float()
        acc = acc * alpha[..., None] + torch.einsum("blk,bkd->bld", p, vt)
        m = m_new
    l = l.clamp_min(1e-30)
    out = (acc / l[..., None]).to(q.dtype)
    if return_stats:
        return out, m * math.log(2.0) + torch.log(l)
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


def flash_attention_bwd_tiled_reference(q, k, v, o, lse, g, q_tile: Optional[int] = None,
                                        kv_tile: Optional[int] = None) -> Tuple[torch.Tensor, ...]:
    """The tensor-core backward kernels' arithmetic, tile by tile in plain PyTorch.

    What ``csrc/flash_attn_bwd.cu`` does for bf16 inputs, on tiles of
    ``q_tile`` queries and ``kv_tile`` keys (64 at D = 64 and 32 at D = 512
    when not given) zero-filled past L and Lk as the kernels' loads are:
    P = 2^(S · scale·log2(e) − lse·log2(e)) from the natural-log ``lse``, set
    to 0 at keys past Lk and at queries past L; dS = P ∘ (dP − δ) from the f32
    P; P and dS rounded to the inputs' type before Pᵀ·dO, dS·K and dSᵀ·Q (no
    rounding for f32 inputs, which take the FMA kernels on the card), f32 sums,
    and ``scale`` applied to dq and dk at the store. dq runs over key tiles
    for each query tile; dk and dv over query tiles for each key tile, from
    the transposes Sᵀ = K·Qᵀ and dPᵀ = V·dOᵀ, so that lse and δ are read by
    column there as in the kernel. Returns (dq, dk, dv) in the inputs' types.
    """
    BH, L, D = q.shape
    Lk = k.shape[1]
    tile = 64 if D <= 64 else 32
    q_tile, kv_tile = q_tile or tile, kv_tile or tile
    scale = 1.0 / math.sqrt(D)
    log2e = torch.tensor(math.log2(math.e), dtype=torch.float32)
    c = log2e * torch.tensor(scale, dtype=torch.float32)
    nq, nk = -(-L // q_tile) * q_tile, -(-Lk // kv_tile) * kv_tile

    def pad(t, n):  # zero rows past the end, as the kernels' loads fill them
        return torch.nn.functional.pad(t.float(), (0, 0, 0, n - t.shape[1]))

    qf, gf, kf, vf = pad(q, nq), pad(g, nq), pad(k, nk), pad(v, nk)
    # lse · log2(e) and δ of every query, zero past L
    lse2 = torch.nn.functional.pad(lse.float() * log2e, (0, nq - L))
    delta = torch.nn.functional.pad(flash_delta(o, g), (0, nq - L))
    q_ok = torch.arange(nq, device=q.device) < L
    k_ok = torch.arange(nk, device=q.device) < Lk

    def rnd(x):  # the operand of a tensor-core product: rounded to the inputs' type
        return x.to(q.dtype).float()

    dq = torch.zeros((BH, nq, D), dtype=torch.float32, device=q.device)
    for q0 in range(0, nq, q_tile):
        qs = slice(q0, q0 + q_tile)
        for k0 in range(0, nk, kv_tile):
            ks = slice(k0, k0 + kv_tile)
            s = torch.einsum("bld,bkd->blk", qf[:, qs], kf[:, ks])
            p = torch.exp2(s * c - lse2[:, qs, None])
            p = torch.where(q_ok[qs, None] & k_ok[None, ks], p, torch.zeros_like(p))
            dp = torch.einsum("bld,bkd->blk", gf[:, qs], vf[:, ks])
            ds = p * (dp - delta[:, qs, None])
            dq[:, qs] += torch.einsum("blk,bkd->bld", rnd(ds), kf[:, ks])
    dk = torch.zeros((BH, nk, D), dtype=torch.float32, device=q.device)
    dv = torch.zeros_like(dk)
    for k0 in range(0, nk, kv_tile):
        ks = slice(k0, k0 + kv_tile)
        for q0 in range(0, nq, q_tile):
            qs = slice(q0, q0 + q_tile)
            st = torch.einsum("bkd,bld->bkl", kf[:, ks], qf[:, qs])
            pt = torch.exp2(st * c - lse2[:, None, qs])
            pt = torch.where(k_ok[ks, None] & q_ok[None, qs], pt, torch.zeros_like(pt))
            dpt = torch.einsum("bkd,bld->bkl", vf[:, ks], gf[:, qs])
            dst = pt * (dpt - delta[:, None, qs])
            dv[:, ks] += torch.einsum("bkl,bld->bkd", rnd(pt), gf[:, qs])
            dk[:, ks] += torch.einsum("bkl,bld->bkd", rnd(dst), qf[:, qs])
    scale_t = torch.tensor(scale, dtype=torch.float32)
    return ((dq[:, :L] * scale_t).to(q.dtype), (dk[:, :Lk] * scale_t).to(k.dtype),
            dv[:, :Lk].to(v.dtype))


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
    if q.data_ptr() % 16 or k.data_ptr() % 16 or v.data_ptr() % 16:
        raise ValueError("flash_attention needs 16-byte aligned q, k and v")


_FUNCTIONS = {}  # (source, entry point) -> the ctypes function with its argument types set


def _call(source: str, name: str, pointers, ints, device) -> None:
    """Call the C entry point ``name`` of ``csrc/<source>.cu`` (pointers, then ints,
    then the stream) and raise on a CUDA error."""
    key = (source, name)
    fn = _FUNCTIONS.get(key)
    if fn is None:
        fn = getattr(_build.load(source), name)
        fn.argtypes = ([ctypes.c_void_p] * len(pointers) + [ctypes.c_int] * len(ints)
                       + [ctypes.c_void_p])
        fn.restype = ctypes.c_int
        _FUNCTIONS[key] = fn
    # the launch goes to the current device: switch only for a tensor that lies elsewhere
    if device.index is None or device.index == torch.cuda.current_device():
        err = fn(*pointers, *ints, torch.cuda.current_stream().cuda_stream)
    else:
        with torch.cuda.device(device):
            err = fn(*pointers, *ints, torch.cuda.current_stream(device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"{name} launch failed with CUDA error {err}")


def _products(q: torch.Tensor, k: torch.Tensor) -> int:
    """The FLOPs of one of attention's two products, 2·BH·L·Lk·D."""
    BH, L, D = q.shape
    return _flops.attention_flops(BH, L, k.shape[1], D)


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
        _flops.report("flash_attn_fwd", 2 * _products(q, k))
        return out
    lse = torch.empty((BH, L), device=q.device, dtype=torch.float32)
    _call("flash_attn_fwd", "flash_attn_fwd_stats",
          (q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), lse.data_ptr()), ints,
          q.device)
    LAUNCHES_STATS += 1
    _flops.report("flash_attn_fwd_stats", 2 * _products(q, k))
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
    if g.data_ptr() % 16:
        raise ValueError("flash backward needs a 16-byte aligned g")
    pointers = tuple(t.data_ptr() for t in (q, k, v, g, lse, delta))
    return pointers, (BH, L, k.shape[1], D, _DTYPES[q.dtype])


def _backward_products(needs: Tuple[bool, bool, bool]) -> Tuple[int, int]:
    """How many of attention's products autograd through the plain version runs in the
    backward, given which of (q, k, v) need a gradient: (dP = g·vᵀ when q or k does,
    plus dq; dk plus dv), the dq kernel's and the dk/dv kernel's shares."""
    nq, nk, nv = needs
    return int(nq or nk) + int(nq), int(nk) + int(nv)


def _launch_dq(q, k, v, g, lse, delta, products: int = 2) -> torch.Tensor:
    """The dq kernel; it reports ``products`` of attention's products (dP and dq)."""
    global LAUNCHES_BWD_DQ
    pointers, ints = _bwd_args(q, k, v, g, lse, delta)
    dq = torch.empty_like(q)
    _call("flash_attn_bwd", "flash_attn_bwd_dq", pointers + (dq.data_ptr(),), ints, q.device)
    LAUNCHES_BWD_DQ += 1
    _flops.report("flash_attn_bwd_dq", products * _products(q, k))
    return dq


def _launch_dkdv(q, k, v, g, lse, delta, products: int = 2) -> Tuple[torch.Tensor, torch.Tensor]:
    """The dk/dv kernel; it reports ``products`` of attention's products (dk and dv)."""
    global LAUNCHES_BWD_DKDV
    pointers, ints = _bwd_args(q, k, v, g, lse, delta)
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    _call("flash_attn_bwd", "flash_attn_bwd_dkdv", pointers + (dk.data_ptr(), dv.data_ptr()),
          ints, q.device)
    LAUNCHES_BWD_DKDV += 1
    _flops.report("flash_attn_bwd_dkdv", products * _products(q, k))
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
        n_dq, n_dkdv = _backward_products(ctx.needs_input_grad)
        return (_launch_dq(q, k, v, g, lse, delta, n_dq),
                *_launch_dkdv(q, k, v, g, lse, delta, n_dkdv))


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
    """Dispatch ``[B, L, H, D]`` attention to the kernels or the einsum path.

    The kernels take ``D in _HEAD_DIMS and L >= 128``. The JAX package's gate
    is ``D % 64 == 0 and L >= 128``, but the kernels here are built for the
    head sizes the shipped configs use and ``_check`` refuses any other D, so a
    D = 128 or 256 (a VAE whose last block has that many channels, its
    attention being single-head) takes the einsum path, the JAX package's own
    non-kernel route. That path takes its softmax in f32 and casts it to q's
    type before the product with v (``attention_pallas.py:309-319``), and
    autograd differentiates it.

    The span ``flash_attention`` holds the whole op, either route and the copies
    to the kernels' layout included (its forward: a backward runs in autograd).

    While a piecewise CUDA graph is captured (``utils/cuda_graphs.py``), the op is
    where the graph breaks: the piece captured so far ends, the op runs eagerly in
    its span, and the next piece reads its result from a contiguous ``[B, L, H, D]``
    buffer, copied outside the span (the copy the caller's ``reshape`` of the
    transposed result would make). Each replay runs the op so again.
    """
    if _cuda_graphs.active is not None:
        return _cuda_graphs.active.split(_attention, q, k, v)
    return _attention(q, k, v)


def _attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    with span("flash_attention"):
        B, L, H, D = q.shape
        Lk = k.shape[1]
        if D in _HEAD_DIMS and L >= 128:
            qf = q.transpose(1, 2).reshape(B * H, L, D).contiguous()
            kf = k.transpose(1, 2).reshape(B * H, Lk, D).contiguous()
            vf = v.transpose(1, 2).reshape(B * H, Lk, D).contiguous()
            return flash_attention(qf, kf, vf).reshape(B, H, L, D).transpose(1, 2)
        scale = 1.0 / math.sqrt(D)
        scores = torch.einsum("bqhd,bkhd->bhqk", q, k) * scale
        probs = torch.softmax(scores.float(), dim=-1).to(q.dtype)
        return torch.einsum("bhqk,bkhd->bqhd", probs, v)
