"""Fused triplane-grid field evaluation: SDF and deformation on the dense
marching-cubes grid in one CUDA kernel.

Counterpart of ``triplaneturbo_tpu/ops/field_grid_pallas.py``. The
bias-free MLPs let the first layer distribute over the triplane sum, so
``_prep`` folds it into three per-plane ``[R², C] x [C, 128]`` products (plain
PyTorch matmuls) and the kernel (``csrc/field_grid.cu``) does the rest per grid
point without materialising the ``[R³, C]`` feature grid.
``field_grid_reference`` is the unfused expression, the counterpart of
``_reference_field_grid``: on a CPU tensor ``fused_field_grid`` computes it
(and autograd differentiates it), on a CUDA tensor it launches the kernel or
raises. The kernel runs the second layer on the tensor cores as three TF32
products of split operands; ``field_grid_split_tf32_reference`` repeats that
arithmetic in plain PyTorch for the tests and ``chip_smoke.py``, and no main
path calls it. When a CUDA input requires grad the call goes through a
``torch.autograd.Function`` whose backward, like the JAX package's, is no
kernel: :func:`field_grid_slab_backward` recomputes the unfused expression on
x-slabs of the grid, which bounds the ``[R³, 128]`` temporaries of a whole-grid
recompute to one slab's.
"""

from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from . import _build

# Kernel launches since the count was last reset (the wrapper adds one per launch).
LAUNCHES = 0

_H = 128

# x-slabs of the backward recompute (1 when it does not divide R): any count
# gives the same gradients, since the slabs partition the grid and every
# parameter gradient is a sum over grid points.
BWD_SLABS = 8


def _world(R: int, radius: float, device, dtype=torch.float32) -> torch.Tensor:
    return torch.linspace(-radius, radius, R, device=device, dtype=dtype)


def _sphere_bias(world_x: torch.Tensor, world: torch.Tensor, bias_r: float) -> torch.Tensor:
    g = torch.stack(torch.meshgrid(world_x, world, world, indexing="ij"), dim=-1)
    return torch.linalg.norm(g, dim=-1) - bias_r


def _reference_slab(m_xy_s, m_xz_s, m_zy, w1s, w2s, w3s, w1d, w2d, w3d,
                    radius: float, bias_r: float, concat: bool, world_x: torch.Tensor):
    """The unfused expression on an x-slab of the grid.

    m_xy_s / m_xz_s ``[R, S, C]`` (x restricted to the slab), m_zy ``[R, R, C]``,
    world_x ``[S]`` the slab's world x-coordinates. Returns (sdf [S, R, R],
    deform [3, S, R, R]).
    """
    R = m_zy.shape[0]
    S = m_xy_s.shape[1]
    xy = m_xy_s.transpose(0, 1)[:, :, None, :]  # [S, y, 1, C]
    xz = m_xz_s.transpose(0, 1)[:, None, :, :]  # [S, 1, z, C]
    zy = m_zy[None, :, :, :]  # [1, y, z, C]
    if concat:
        C = m_zy.shape[-1]
        feat = torch.cat([t.expand(S, R, R, C) for t in (xy, xz, zy)], dim=-1)
    else:
        feat = xy + xz + zy
    f = feat.reshape(-1, feat.shape[-1])

    def mlp(x, w1, w2, w3):
        h = torch.relu(x @ w1)
        h = torch.relu(h @ w2)
        return h @ w3

    sdf = mlp(f, w1s, w2s, w3s)[:, 0].reshape(S, R, R)
    deform = mlp(f, w1d, w2d, w3d).reshape(S, R, R, 3)
    world = _world(R, radius, m_zy.device, m_zy.dtype)
    sdf = sdf + _sphere_bias(world_x, world, bias_r)
    return sdf, deform.permute(3, 0, 1, 2)


def field_grid_reference(m_xy, m_xz, m_zy, w1s, w2s, w3s, w1d, w2d, w3d,
                         radius: float, bias_r: float, concat: bool):
    """The unfused expression: the grid features, both MLPs and the sphere bias.

    m_xy [y, x, C], m_xz [z, x, C], m_zy [y, z, C]; weights are ``[in, out]``.
    Returns (sdf [R, R, R], deform [3, R, R, R]) in axis order (x, y, z).
    """
    world = _world(m_zy.shape[0], radius, m_zy.device, m_zy.dtype)
    return _reference_slab(m_xy, m_xz, m_zy, w1s, w2s, w3s, w1d, w2d, w3d,
                           radius, bias_r, concat, world)


def field_grid_slab_backward(inputs, g_sdf: torch.Tensor, g_def: torch.Tensor,
                             radius: float, bias_r: float, concat: bool):
    """Gradients of :func:`field_grid_reference` wrt its nine tensor inputs.

    ``inputs`` are (m_xy, m_xz, m_zy, w1s, w2s, w3s, w1d, w2d, w3d); ``g_sdf``
    ``[R, R, R]`` and ``g_def`` ``[3, R, R, R]`` the cotangents. The unfused
    expression is recomputed and differentiated one x-slab at a time: the
    weight and ``m_zy`` gradients are summed over slabs, the ``m_xy`` / ``m_xz``
    gradients of a slab land in its own columns.
    """
    m_xy, m_xz = inputs[0], inputs[1]
    R = m_xy.shape[0]
    n_slabs = BWD_SLABS if R % BWD_SLABS == 0 else 1
    S = R // n_slabs
    world = _world(R, radius, m_xy.device, m_xy.dtype)
    grads = [torch.zeros_like(m_xy), torch.zeros_like(m_xz)] + [None] * 7
    for s in range(n_slabs):
        sl = slice(s * S, (s + 1) * S)
        leaves = [m_xy[:, sl], m_xz[:, sl], *inputs[2:]]
        leaves = [t.detach().requires_grad_(True) for t in leaves]
        with torch.enable_grad():
            out = _reference_slab(*leaves, radius, bias_r, concat, world[sl])
        d = torch.autograd.grad(out, leaves, (g_sdf[sl], g_def[:, sl]))
        grads[0][:, sl] = d[0]
        grads[1][:, sl] = d[1]
        for i in range(2, 9):
            grads[i] = d[i] if grads[i] is None else grads[i] + d[i]
    return tuple(grads)


def _prep(m_xy, m_xz, m_zy, w1s, w1d, w2s, w2d, w3s, w3d, concat: bool):
    """Fold layer 1 into the plane resamples; build block-diagonal W2 and W3."""
    if concat:
        C = m_xy.shape[-1]
        w1s_p = (w1s[:C], w1s[C:2 * C], w1s[2 * C:])
        w1d_p = (w1d[:C], w1d[C:2 * C], w1d[2 * C:])
    else:
        w1s_p = (w1s, w1s, w1s)
        w1d_p = (w1d, w1d, w1d)
    a_xy = torch.einsum("yxc,ch->xyh", m_xy, torch.cat([w1s_p[0], w1d_p[0]], dim=1))
    a_xz = torch.einsum("zxc,ch->xzh", m_xz, torch.cat([w1s_p[1], w1d_p[1]], dim=1))
    a_zy = torch.einsum("yzc,ch->yzh", m_zy, torch.cat([w1s_p[2], w1d_p[2]], dim=1))
    w2blk = torch.block_diag(w2s, w2d)  # [H, H]
    w3 = torch.block_diag(w3s, w3d)  # [H, 4]
    w3t = torch.cat([w3.T, w3.new_zeros(4, w3.shape[0])], dim=0)  # [8, H]
    return (a_xy.contiguous(), a_xz.contiguous(), a_zy.contiguous(),
            w2blk.contiguous(), w3t.contiguous())


def _tf32_rna(x: torch.Tensor) -> torch.Tensor:
    """Round float32 to TF32 (10 mantissa bits), to nearest with ties away from
    zero, as ``cvt.rna.tf32.f32`` does: add half a TF32 step to the magnitude
    bits of the int32 view and clear the 13 bits that TF32 drops."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & -0x2000).view(torch.float32)


def _tf32_split(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """hi = rna_tf32(x) and lo = rna_tf32(x - hi); hi + lo keeps about 21 bits of x."""
    hi = _tf32_rna(x)
    return hi, _tf32_rna(x - hi)


def field_grid_split_tf32_reference(a_xy, a_xz, a_zy, w2blk, w3t, radius: float,
                                    bias_r: float):
    """The kernel's arithmetic in plain PyTorch, on ``_prep``'s outputs.

    What ``csrc/field_grid.cu`` computes per grid point: h1 = relu((a_xy + a_xz)
    + a_zy) in f32; for each net's 64 columns, h1 and its diagonal block of W2
    split into TF32 hi and lo, and h2 = relu((h1_lo W2_hi + h1_hi W2_lo) +
    h1_hi W2_hi) with f32 sums; the heads and the sphere bias in f32, the world
    coordinates as -radius + i * step. Only the order of the f32 sums differs
    from the kernel's. No main path calls it: it holds the split-TF32 numerics
    against the JAX package on the CPU and the kernel against them on the card.
    Returns (sdf [R, R, R], deform [3, R, R, R]).
    """
    R = a_xy.shape[0]
    dev = a_xy.device
    f32 = torch.float32
    step = torch.tensor(2.0 * radius / (R - 1) if R > 1 else 0.0, dtype=f32, device=dev)
    world = torch.tensor(-radius, dtype=f32, device=dev) + torch.arange(R, device=dev,
                                                                        dtype=f32) * step
    w2 = [_tf32_split(w2blk[b * 64:(b + 1) * 64, b * 64:(b + 1) * 64]) for b in range(2)]
    sdf = torch.empty((R, R, R), device=dev, dtype=f32)
    deform = torch.empty((3, R, R, R), device=dev, dtype=f32)
    slab = max(1, (1 << 28) // (R * R * _H * 4))  # x-values a pass: ~256 MB of h1
    for x0 in range(0, R, slab):
        xs = slice(x0, x0 + slab)
        h1 = torch.relu((a_xy[xs, :, None] + a_xz[xs, None, :]) + a_zy[None])  # [S, y, z, H]
        S = h1.shape[0]
        h2 = []
        for b, (w_hi, w_lo) in enumerate(w2):
            a_hi, a_lo = _tf32_split(h1[..., b * 64:(b + 1) * 64].reshape(-1, 64))
            h2.append(torch.relu((a_lo @ w_hi + a_hi @ w_lo) + a_hi @ w_hi))
        wx = world[xs].view(S, 1, 1)
        sphere = torch.sqrt(wx * wx + world.view(1, R, 1) ** 2 + world.view(1, 1, R) ** 2)
        sdf[xs] = (h2[0] @ w3t[0, :64]).view(S, R, R) + sphere - bias_r
        deform[:, xs] = (h2[1] @ w3t[1:4, 64:].T).T.reshape(3, S, R, R)
    return sdf, deform


def _launch(a_xy, a_xz, a_zy, w2blk, w3t, radius: float, bias_r: float):
    """The kernel on ``_prep``'s outputs. It reads only the two diagonal 64 x 64
    blocks of ``w2blk`` and the nonzero blocks of ``w3t``, as ``_prep`` builds them."""
    global LAUNCHES
    R = a_xy.shape[0]
    tensors = (a_xy, a_xz, a_zy, w2blk, w3t)
    for t in tensors:
        if t.dtype != torch.float32 or t.device != a_xy.device or not t.is_contiguous():
            raise ValueError("field_grid takes contiguous float32 tensors on one device")
    for name, t in (("a_xy", a_xy), ("a_xz", a_xz), ("a_zy", a_zy)):
        if tuple(t.shape) != (R, R, _H):
            raise ValueError(f"{name} must be [R, R, {_H}], got {tuple(t.shape)}")
    if tuple(w2blk.shape) != (_H, _H) or tuple(w3t.shape) != (8, _H):
        raise ValueError(f"w2blk must be [{_H}, {_H}] and w3t [8, {_H}]")
    fn = _build.load("field_grid").field_grid_fwd
    fn.argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_int, ctypes.c_float, ctypes.c_float,
                                           ctypes.c_void_p]
    fn.restype = ctypes.c_int
    sdf = torch.empty((R, R, R), device=a_xy.device, dtype=torch.float32)
    deform = torch.empty((3, R, R, R), device=a_xy.device, dtype=torch.float32)
    with torch.cuda.device(a_xy.device):
        stream = torch.cuda.current_stream(a_xy.device).cuda_stream
        err = fn(*(t.data_ptr() for t in tensors), sdf.data_ptr(), deform.data_ptr(),
                 R, float(radius), float(bias_r), stream)
    if err != 0:
        raise RuntimeError(f"field_grid_fwd launch failed with CUDA error {err}")
    LAUNCHES += 1
    return sdf, deform


class _FusedFieldGrid(torch.autograd.Function):
    """Forward: the kernel. Backward: the slab recompute of the unfused expression."""

    @staticmethod
    def forward(ctx, radius, bias_r, concat, *inputs):
        m_xy, m_xz, m_zy, w1s, w2s, w3s, w1d, w2d, w3d = inputs
        ctx.save_for_backward(*inputs)
        ctx.consts = (radius, bias_r, concat)
        prepped = _prep(m_xy, m_xz, m_zy, w1s, w1d, w2s, w2d, w3s, w3d, concat)
        return _launch(*prepped, radius, bias_r)

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, g_sdf, g_def):
        grads = field_grid_slab_backward(ctx.saved_tensors, g_sdf, g_def, *ctx.consts)
        return (None, None, None, *grads)


def fused_field_grid(m_xy, m_xz, m_zy, w1s, w2s, w3s, w1d, w2d, w3d,
                     radius: float, bias_r: float, concat: bool
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """SDF + deformation on the dense grid, fused, differentiable.

    Same arguments and results as :func:`field_grid_reference`; all float32.
    The hidden width of both MLPs must be 64 (the kernel's H = 128).
    """
    inputs = (m_xy, m_xz, m_zy, w1s, w2s, w3s, w1d, w2d, w3d)
    if m_xy.device.type == "cpu":
        return field_grid_reference(*inputs, radius, bias_r, concat)
    if m_xy.device.type != "cuda":
        raise ValueError(f"fused_field_grid runs on cuda or cpu, got {m_xy.device}")
    if torch.is_grad_enabled() and any(t.requires_grad for t in inputs):
        return _FusedFieldGrid.apply(float(radius), float(bias_r), bool(concat), *inputs)
    prepped = _prep(m_xy, m_xz, m_zy, w1s, w1d, w2s, w2d, w3s, w3d, concat)
    return _launch(*prepped, radius, bias_r)
