"""Plain triplane-grid field: the reference's stand-in for the port's field-grid kernel.

The unfused expression (grid features, both MLPs, the sphere bias) in the inputs'
type, forward in x-slabs without grad and, with grad, through an autograd function
whose backward recomputes the slabs (:func:`field_grid_slab_backward`); each call
reports its shapes to ``sites``.
"""

from __future__ import annotations

from typing import Tuple

import torch

from . import sites

BWD_SLABS = 8
_FWD_SLAB_POINTS = 1 << 21


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
                             radius: float, bias_r: float, concat: bool, needs=None):
    """Gradients of :func:`field_grid_reference` wrt its nine tensor inputs.

    ``inputs`` are (m_xy, m_xz, m_zy, w1s, w2s, w3s, w1d, w2d, w3d); ``g_sdf``
    ``[R, R, R]`` and ``g_def`` ``[3, R, R, R]`` the cotangents; ``needs`` says
    which inputs need a gradient (all when not given; the others get None). The
    unfused expression is recomputed and differentiated one x-slab at a time: the
    weight and ``m_zy`` gradients are summed over slabs, the ``m_xy`` / ``m_xz``
    gradients of a slab land in its own columns.
    """
    m_xy, m_xz = inputs[0], inputs[1]
    needs = tuple(needs) if needs is not None else (True,) * 9
    R = m_xy.shape[0]
    n_slabs = BWD_SLABS if R % BWD_SLABS == 0 else 1
    S = R // n_slabs
    world = _world(R, radius, m_xy.device, m_xy.dtype)
    grads = [torch.zeros_like(m_xy) if needs[0] else None,
             torch.zeros_like(m_xz) if needs[1] else None] + [None] * 7
    wanted = [i for i in range(9) if needs[i]]
    for s in range(n_slabs):
        sl = slice(s * S, (s + 1) * S)
        leaves = [m_xy[:, sl], m_xz[:, sl], *inputs[2:]]
        leaves = [t.detach().requires_grad_(need) for t, need in zip(leaves, needs)]
        with torch.enable_grad(), sites.recompute():  # the forward again: not counted
            out = _reference_slab(*leaves, radius, bias_r, concat, world[sl])
        d = dict(zip(wanted, torch.autograd.grad(out, [leaves[i] for i in wanted],
                                                 (g_sdf[sl], g_def[:, sl]))))
        for i in (0, 1):
            if i in d:
                grads[i][:, sl] = d[i]
        for i in range(2, 9):
            if i in d:
                grads[i] = d[i] if grads[i] is None else grads[i] + d[i]
    return tuple(grads)


def _slabbed(inputs, radius: float, bias_r: float, concat: bool):
    m_xy, m_xz, m_zy = inputs[:3]
    R = m_zy.shape[0]
    S = max(1, min(R, _FWD_SLAB_POINTS // (R * R)))
    world = _world(R, radius, m_zy.device, m_zy.dtype)
    sdfs, defs = [], []
    for x0 in range(0, R, S):
        sl = slice(x0, x0 + S)
        s, d = _reference_slab(m_xy[:, sl], m_xz[:, sl], *inputs[2:], radius, bias_r, concat,
                               world[sl])
        sdfs.append(s)
        defs.append(d)
    return torch.cat(sdfs, 0), torch.cat(defs, 1)


class _PlainFieldGrid(torch.autograd.Function):
    @staticmethod
    def forward(ctx, radius, bias_r, concat, *inputs):
        ctx.save_for_backward(*inputs)
        ctx.consts = (radius, bias_r, concat)
        with torch.no_grad():
            return _slabbed(inputs, radius, bias_r, concat)

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, g_sdf, g_def):
        grads = field_grid_slab_backward(ctx.saved_tensors, g_sdf, g_def, *ctx.consts,
                                         needs=ctx.needs_input_grad[3:])
        return (None, None, None, *grads)


def fused_field_grid(m_xy, m_xz, m_zy, w1s, w2s, w3s, w1d, w2d, w3d,
                     radius: float, bias_r: float, concat: bool
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """SDF [R, R, R] and deformation [3, R, R, R] on the dense grid, differentiable."""
    inputs = (m_xy, m_xz, m_zy, w1s, w2s, w3s, w1d, w2d, w3d)
    grad = torch.is_grad_enabled() and any(t.requires_grad for t in inputs)
    sites.record("field_grid", R=int(m_zy.shape[0]), C=int(m_zy.shape[-1]),
                 widths=[tuple(int(s) for s in w.shape) for w in inputs[3:]],
                 concat=bool(concat), grad=grad)
    if grad:
        return _PlainFieldGrid.apply(float(radius), float(bias_r), bool(concat), *inputs)
    return _slabbed(inputs, radius, bias_r, concat)
