"""The serving trunk's channels-last (NHWC) epilogues: GroupNorm, optionally with a
per-channel shift before it and SiLU after it, and a conv's bias added with an
optional residual. Hand-written Triton kernels and their plain versions.

No TPU kernel is replaced: the JAX package leaves both to XLA, which fuses them into
their neighbours. On the card the folded serving trunk (``models/lora.py`` ``Fold``)
runs NHWC, where PyTorch's own GroupNorm turns its input back into NCHW and runs the
SiLU as a pass of its own, and a convolution adds its bias in a broadcasting pass that
does not vectorise. Both ops are bound by bytes.

GroupNorm (:func:`group_norm_act`) reads its input twice and writes it once, with f32
statistics, in three launches:

* ``group_norm_partial``: a program a (sample, block of 64 rows, block of 64
  channels) loads its tile once and writes each channel's mean and sum of squared
  deviations over its rows;
* ``group_norm_finalize``: a program a (sample, group) combines those (Chan's parallel
  rule, so no ``E[x²] - E[x]²`` cancellation) into the group's mean and 1/std. A
  per-channel ``shift`` (a conv's bias and the time embedding, which the caller then
  leaves out of the conv) moves each channel's means and leaves its deviations as they
  are;
* ``group_norm_apply``: the same tiles again, shifted, normalised, scaled and, with
  ``silu``, through SiLU, rounded once to the input's dtype.

The bias add (:func:`bias_add`) reads the conv's output (and the residual) once and
writes the sum in place, in f32, rounded once.

On CPU tensors both compute their plain versions; on CUDA tensors they launch the
kernels or raise.
"""

# no ``from __future__ import annotations``: the kernels' ``tl.constexpr`` annotations
# are read when ``_kernels`` defines them

from typing import Optional

import torch
import torch.nn.functional as F

# Launches since each count was last reset (a GroupNorm launch is three kernels).
LAUNCHES = 0  # group_norm_act
LAUNCHES_BIAS = 0  # bias_add

_BLOCK_R = 64  # rows (pixels) a tile
_BLOCK_C = 64  # channels a tile (every width of the full-size trunk is a multiple of it)
_BLOCK_K = 64  # partial rows a step of the finalize loop

tl = None  # triton.language, set at the first launch (this module imports no triton)
_KERNELS = None


def _per_sample(shift: torch.Tensor, N: int, C: int) -> torch.Tensor:
    """``shift`` [C] or [N, C] as an f32 [N, C] view (stride 0 over the samples for [C])."""
    if shift.dtype != torch.float32 or shift.shape[-1] != C or shift.ndim > 2:
        raise ValueError(f"shift must be float32 [{C}] or [{N}, {C}], got {shift.dtype} "
                         f"{tuple(shift.shape)}")
    return shift.contiguous().reshape(-1, C).expand(N, C)


def group_norm_act_reference(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
                             groups: int, eps: float, silu: bool,
                             shift: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Plain GroupNorm of ``x`` (plus ``shift``) in f32, then SiLU when ``silu``,
    rounded once to ``x``'s dtype."""
    xf = x.float()
    if shift is not None:
        xf = xf + _per_sample(shift, x.shape[0], x.shape[1])[:, :, None, None]
    y = F.group_norm(xf, groups, weight.float(), bias.float(), eps)
    if silu:
        y = F.silu(y)
    return y.to(x.dtype)


def group_norm_act(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor, groups: int,
                   eps: float, silu: bool, shift: Optional[torch.Tensor] = None
                   ) -> torch.Tensor:
    """GroupNorm of ``x`` [N, C, H, W] plus the f32 ``shift`` [C] or [N, C] when given,
    with ``weight`` and ``bias`` [C] (read in their own dtype, applied in f32), then SiLU
    when ``silu``; channels-last out. The kernels on a CUDA tensor, the plain version on
    a CPU one."""
    if x.device.type == "cpu":
        return group_norm_act_reference(x, weight, bias, groups, eps, silu, shift)
    if x.device.type != "cuda":
        raise ValueError(f"group_norm_act runs on cuda or cpu, got {x.device}")
    N, C, H, W = x.shape
    if C % groups:
        raise ValueError(f"{C} channels do not split into {groups} groups")
    x = x.contiguous(memory_format=torch.channels_last)
    y = torch.empty_like(x)
    shift = _per_sample(shift, N, C) if shift is not None else None
    _launch_group_norm(x, weight.contiguous(), bias.contiguous(), shift, y, groups, eps, silu)
    return y


def bias_add_reference(y: torch.Tensor, bias: Optional[torch.Tensor],
                       residual: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Plain ``y + bias`` (per channel, f32) ``+ residual``, in f32, rounded once to
    ``y``'s dtype."""
    out = y.float()
    if bias is not None:
        out = out + bias.float()[None, :, None, None]
    if residual is not None:
        out = out + residual.float()
    return out.to(y.dtype)


def bias_add(y: torch.Tensor, bias: Optional[torch.Tensor],
             residual: Optional[torch.Tensor] = None) -> torch.Tensor:
    """``y`` [N, C, H, W] (a conv's output without its bias) plus the f32 ``bias`` [C]
    and ``residual``; on a CUDA tensor written into ``y`` (made channels-last first if it
    is not), on a CPU one the plain version."""
    if bias is None and residual is None:
        return y
    if y.device.type == "cpu":
        return bias_add_reference(y, bias, residual)
    if y.device.type != "cuda":
        raise ValueError(f"bias_add runs on cuda or cpu, got {y.device}")
    N, C, H, W = y.shape
    if bias is not None and (bias.dtype != torch.float32 or tuple(bias.shape) != (C,)):
        raise ValueError(f"bias must be float32 [{C}], got {bias.dtype} {tuple(bias.shape)}")
    if residual is not None and residual.shape != y.shape:
        raise ValueError(f"residual {tuple(residual.shape)} is not {tuple(y.shape)}")
    y = y.contiguous(memory_format=torch.channels_last)
    if residual is not None:
        residual = residual.contiguous(memory_format=torch.channels_last)
    _launch_bias_add(y, bias, residual)
    return y


def _launch_group_norm(x, weight, bias, shift, y, groups, eps, silu) -> None:
    global LAUNCHES
    k = _kernels()
    N, C, H, W = x.shape
    HW = H * W
    K = -(-HW // _BLOCK_R)  # row blocks a sample
    mean = torch.empty((N, K, C), dtype=torch.float32, device=x.device)
    m2 = torch.empty_like(mean)
    stats = torch.empty((N, groups, 2), dtype=torch.float32, device=x.device)
    has_shift = shift is not None
    shift_arg, shift_sn = (shift, shift.stride(0)) if has_shift else (stats, 0)
    grid = (N, K, -(-C // _BLOCK_C))
    k["partial"][grid](x, mean, m2, HW, C, K, BLOCK_R=_BLOCK_R, BLOCK_C=_BLOCK_C, num_warps=4)
    cpg = C // groups
    k["finalize"][(N, groups)](mean, m2, shift_arg, shift_sn, stats, HW, C, K, cpg, groups,
                               eps, HAS_SHIFT=has_shift, BLOCK_K=_BLOCK_K,
                               BLOCK_J=max(16, 1 << (cpg - 1).bit_length()),
                               BLOCK_R=_BLOCK_R, num_warps=4)
    k["apply"][grid](x, y, weight, bias, shift_arg, shift_sn, stats, HW, C, cpg, groups,
                     HAS_SHIFT=has_shift, SILU=silu, BLOCK_R=_BLOCK_R, BLOCK_C=_BLOCK_C,
                     num_warps=4)
    LAUNCHES += 1


def _launch_bias_add(y, bias, residual) -> None:
    global LAUNCHES_BIAS
    k = _kernels()
    N, C, H, W = y.shape
    M = N * H * W
    grid = (-(-M // _BLOCK_R), -(-C // _BLOCK_C))
    k["bias_add"][grid](y, bias if bias is not None else y, residual if residual is not None
                        else y, M, C, HAS_BIAS=bias is not None,
                        HAS_RESIDUAL=residual is not None, BLOCK_R=_BLOCK_R,
                        BLOCK_C=_BLOCK_C, num_warps=4)
    LAUNCHES_BIAS += 1


def _kernels():
    global tl, _KERNELS
    if _KERNELS is not None:
        return _KERNELS
    import triton
    import triton.language

    tl = triton.language

    @triton.jit
    def group_norm_partial(x_ptr, mean_ptr, m2_ptr, HW, C, K,
                           BLOCK_R: tl.constexpr, BLOCK_C: tl.constexpr):
        n = tl.program_id(0)
        k = tl.program_id(1)
        cb = tl.program_id(2)
        rows = k * BLOCK_R + tl.arange(0, BLOCK_R)
        cols = cb * BLOCK_C + tl.arange(0, BLOCK_C)
        ok = (rows[:, None] < HW) & (cols[None, :] < C)
        offs = (n * HW + rows[:, None]).to(tl.int64) * C + cols[None, :]
        v = tl.load(x_ptr + offs, mask=ok, other=0.0).to(tl.float32)
        cnt = tl.minimum(HW - k * BLOCK_R, BLOCK_R).to(tl.float32)
        mu = tl.sum(v, axis=0) / cnt
        d = tl.where(ok, v - mu[None, :], 0.0)
        out = (n * K + k) * C + cols
        tl.store(mean_ptr + out, mu, mask=cols < C)
        tl.store(m2_ptr + out, tl.sum(d * d, axis=0), mask=cols < C)

    @triton.jit
    def group_norm_finalize(mean_ptr, m2_ptr, shift_ptr, shift_sn, stats_ptr, HW, C, K, CPG,
                            G, eps, HAS_SHIFT: tl.constexpr, BLOCK_K: tl.constexpr,
                            BLOCK_J: tl.constexpr, BLOCK_R: tl.constexpr):
        n = tl.program_id(0)
        g = tl.program_id(1)
        j = tl.arange(0, BLOCK_J)
        total = (HW * CPG).to(tl.float32)
        if HAS_SHIFT:
            sh = tl.load(shift_ptr + n * shift_sn + g * CPG + j, mask=j < CPG, other=0.0)
        acc = tl.zeros((BLOCK_K, BLOCK_J), dtype=tl.float32)
        for k0 in range(0, K, BLOCK_K):
            ks = k0 + tl.arange(0, BLOCK_K)
            ok = (ks[:, None] < K) & (j[None, :] < CPG)
            cnt = tl.minimum(HW - ks * BLOCK_R, BLOCK_R).to(tl.float32)
            offs = (n * K + ks[:, None]) * C + g * CPG + j[None, :]
            mu = tl.load(mean_ptr + offs, mask=ok, other=0.0)
            if HAS_SHIFT:
                mu += sh[None, :]
            acc += tl.where(ok, cnt[:, None] * mu, 0.0)
        mean = tl.sum(tl.sum(acc, axis=1), axis=0) / total
        acc = tl.zeros((BLOCK_K, BLOCK_J), dtype=tl.float32)
        for k0 in range(0, K, BLOCK_K):
            ks = k0 + tl.arange(0, BLOCK_K)
            ok = (ks[:, None] < K) & (j[None, :] < CPG)
            cnt = tl.minimum(HW - ks * BLOCK_R, BLOCK_R).to(tl.float32)
            offs = (n * K + ks[:, None]) * C + g * CPG + j[None, :]
            mu = tl.load(mean_ptr + offs, mask=ok, other=0.0)
            if HAS_SHIFT:
                mu += sh[None, :]
            m2 = tl.load(m2_ptr + offs, mask=ok, other=0.0)
            dev = mu - mean
            acc += tl.where(ok, m2 + cnt[:, None] * dev * dev, 0.0)
        var = tl.sum(tl.sum(acc, axis=1), axis=0) / total
        tl.store(stats_ptr + (n * G + g) * 2, mean)
        tl.store(stats_ptr + (n * G + g) * 2 + 1, 1.0 / tl.sqrt(var + eps))

    @triton.jit
    def group_norm_apply(x_ptr, y_ptr, w_ptr, b_ptr, shift_ptr, shift_sn, stats_ptr, HW, C,
                         CPG, G, HAS_SHIFT: tl.constexpr, SILU: tl.constexpr,
                         BLOCK_R: tl.constexpr, BLOCK_C: tl.constexpr):
        n = tl.program_id(0)
        k = tl.program_id(1)
        cb = tl.program_id(2)
        rows = k * BLOCK_R + tl.arange(0, BLOCK_R)
        cols = cb * BLOCK_C + tl.arange(0, BLOCK_C)
        c_ok = cols < C
        ok = (rows[:, None] < HW) & c_ok[None, :]
        offs = (n * HW + rows[:, None]).to(tl.int64) * C + cols[None, :]
        v = tl.load(x_ptr + offs, mask=ok, other=0.0).to(tl.float32)
        g = cols // CPG
        mu = tl.load(stats_ptr + (n * G + g) * 2, mask=c_ok, other=0.0)
        rstd = tl.load(stats_ptr + (n * G + g) * 2 + 1, mask=c_ok, other=0.0)
        scale = tl.load(w_ptr + cols, mask=c_ok, other=0.0).to(tl.float32) * rstd
        offset = tl.load(b_ptr + cols, mask=c_ok, other=0.0).to(tl.float32) - mu * scale
        if HAS_SHIFT:  # (x + s - mu) * scale + b
            offset += tl.load(shift_ptr + n * shift_sn + cols, mask=c_ok, other=0.0) * scale
        out = v * scale[None, :] + offset[None, :]
        if SILU:
            out = out * tl.sigmoid(out)
        tl.store(y_ptr + offs, out.to(y_ptr.dtype.element_ty), mask=ok)

    @triton.jit
    def bias_add_kernel(y_ptr, b_ptr, r_ptr, M, C, HAS_BIAS: tl.constexpr,
                        HAS_RESIDUAL: tl.constexpr, BLOCK_R: tl.constexpr,
                        BLOCK_C: tl.constexpr):
        rows = tl.program_id(0) * BLOCK_R + tl.arange(0, BLOCK_R)
        cols = tl.program_id(1) * BLOCK_C + tl.arange(0, BLOCK_C)
        c_ok = cols < C
        ok = (rows[:, None] < M) & c_ok[None, :]
        offs = rows[:, None].to(tl.int64) * C + cols[None, :]
        v = tl.load(y_ptr + offs, mask=ok, other=0.0).to(tl.float32)
        if HAS_BIAS:
            v += tl.load(b_ptr + cols, mask=c_ok, other=0.0)[None, :]
        if HAS_RESIDUAL:
            v += tl.load(r_ptr + offs, mask=ok, other=0.0).to(tl.float32)
        tl.store(y_ptr + offs, v.to(y_ptr.dtype.element_ty), mask=ok)

    _KERNELS = {"partial": group_norm_partial, "finalize": group_norm_finalize,
                "apply": group_norm_apply, "bias_add": bias_add_kernel}
    return _KERNELS
