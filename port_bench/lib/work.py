"""The benchmark's own count of the work a configuration requires, taken from the plain
reference at the cell's shapes.

:class:`WorkCounter` counts the products of the aten operators by their shapes
(``torch.utils.flop_counter``'s formulas), forward and backward, leaving out a
checkpointed region's recompute (``ttref.ops.sites``); it also keeps every call of
the reference's plain attention and plain field grid with its shapes, the sites of the
program's hand-written kernels. :func:`attention_bound_s` and
:func:`field_grid_bound_s` give the least time of one site on the card.
"""

from __future__ import annotations

from typing import Any, Dict, List

from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.flop_counter import flop_registry

from ..reference.ttref.ops import sites
from .peaks import PEAK_FLOPS, bound_s

_ESIZE = {"bfloat16": 2, "float16": 2, "float32": 4}


class WorkCounter(TorchDispatchMode):
    """``with WorkCounter() as w:`` ... ``w.flops``, ``w.sites``."""

    def __init__(self):
        super().__init__()
        self.flops = 0
        self.sites: List[Dict[str, Any]] = []
        self._prev = None

    def _record(self, kind: str, **shape: Any) -> None:
        self.sites.append({"kind": kind, **shape})

    def __enter__(self):
        self._prev = sites.RECORDER
        sites.RECORDER = self._record
        return super().__enter__()

    def __exit__(self, *exc):
        sites.RECORDER = self._prev
        return super().__exit__(*exc)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        fn = flop_registry.get(func._overloadpacket)
        if fn is not None and not sites.in_recompute():
            self.flops += int(fn(*args, **kwargs, out_val=out))
        return out


def attention_bound_s(site: Dict[str, Any]) -> float:
    """The least time of one attention call on the card: the forward (with the
    logsumexp when it is differentiated) and, when it is, the backward (dq, dk, dv).
    Operations as the plain version counts them (2·BH·L·Lk·D a product: two forward,
    up to four backward); bytes of each input read once and each output written once."""
    BH, L, Lk, D, dtype = site["BH"], site["L"], site["Lk"], site["D"], site["dtype"]
    e = _ESIZE[dtype]
    peak = dtype if dtype in PEAK_FLOPS else "bfloat16"
    product = 2 * BH * L * Lk * D
    fwd_bytes = e * BH * D * (2 * L + 2 * Lk) + (4 * BH * L if site["grad"] else 0)
    t = bound_s(2 * product, fwd_bytes, peak)
    if site["grad"]:
        nq, nk, nv = site["needs"]
        products = int(nq or nk) + int(nq) + int(nk) + int(nv)
        # q, k, v, o, dO and the two f32 row vectors in; dq, dk, dv out
        bwd_bytes = e * BH * D * (3 * L + 2 * Lk) + 8 * BH * L + e * BH * D * (L + 2 * Lk)
        t += bound_s(products * product, bwd_bytes, peak)
    return t


def field_grid_bound_s(site: Dict[str, Any]) -> float:
    """The least time of one field-grid forward at f32 accuracy on the card: the second
    layer's products as three TF32 products of split operands on the tensor cores, the
    first layer's fold into the planes, the plane sum and the heads in f32 beside them
    (``chip_smoke.py``'s K2 bound); bytes of the three planes, the weights and the
    four output grids."""
    R, C = site["R"], site["C"]
    w1s, w2s, w3s, w1d, w2d, w3d = site["widths"]
    H = w1s[1] + w1d[1]
    products = R ** 3 * 2 * (w2s[0] * w2s[1] + w2d[0] * w2d[1])
    rest = 3 * R * R * C * H * 2 + R ** 3 * (2 * H + 2 * (w3s[0] * w3s[1] + w3d[0] * w3d[1]))
    nbytes = (3 * R * R * C + sum(a * b for a, b in site["widths"]) + 4 * R ** 3) * 4
    t_ops = max(3 * products / PEAK_FLOPS["tfloat32"], rest / PEAK_FLOPS["float32"])
    return max(t_ops, bound_s(0, nbytes, "float32"))
