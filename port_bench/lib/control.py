"""The control of the correctness check: the reference computed one precision below
what the configuration states.

Both configurations state bf16, so the control rounds every floating operand of every
product (matrix products, convolutions, their backward) to fp8 (e4m3, scaled by its
largest magnitude over 448, the format's largest value) before the product, which then
runs as the reference's does. The check has to find it not correct.
"""

from __future__ import annotations

import torch
from torch.utils._python_dispatch import TorchDispatchMode

_aten = torch.ops.aten
_PRODUCTS = {_aten.mm, _aten.addmm, _aten.bmm, _aten.baddbmm, _aten.convolution,
             _aten.convolution_backward, _aten._convolution, _aten.matmul, _aten.linear}
_E4M3_MAX = 448.0


def fp8_round(x: torch.Tensor) -> torch.Tensor:
    if not x.is_floating_point() or x.numel() == 0:
        return x
    amax = x.detach().abs().amax().float().clamp_min(1e-30)
    scale = amax / _E4M3_MAX
    return ((x.float() / scale).to(torch.float8_e4m3fn).float() * scale).to(x.dtype)


class Fp8Products(TorchDispatchMode):
    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if func._overloadpacket in _PRODUCTS:
            args = tuple(fp8_round(a) if isinstance(a, torch.Tensor) else a for a in args)
        return func(*args, **kwargs)
