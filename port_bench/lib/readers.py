"""What the per-layer metric files share. A reader's ``ctx`` holds ``trace`` (a
:class:`~lib.trace.TraceSummary` of the traced window), ``calls`` (whole calls or steps
in it), ``units_per_call`` (prompts a call; 1 for a step), ``work_flops`` and
``work_sites`` (the reference's count of one call) and, for training,
``peak_window_bytes``. A reader returns None where it finds nothing to read."""

from __future__ import annotations

from typing import Iterable, Optional

from .peaks import MFU_PEAK
from .work import attention_bound_s, field_grid_bound_s

# the port's own kernels (csrc/flash_attn_fwd.cu, flash_attn_bwd.cu, field_grid.cu), by
# whole symbol (lib/trace.py kernel_symbol)
FLASH_KERNELS = tuple(f"flash_{p}_kernel_{v}" for p in ("fwd", "bwd_dq", "bwd_dkdv")
                      for v in ("wgmma_d64", "wgmma_d512", "f32"))
FIELD_GRID_KERNELS = ("field_grid_kernel",)


def range_ms(ctx, ranges: Iterable[str]) -> Optional[float]:
    """Device-busy ms a prompt (or a step) inside the program's ``ranges``."""
    s = ctx["trace"].busy_in(ranges)
    if s <= 0:
        return None
    return s * 1e3 / (ctx["calls"] * ctx["units_per_call"])


def idle_share(ctx) -> Optional[float]:
    tr = ctx["trace"]
    if tr.window_s <= 0:
        return None
    return 100.0 * (1.0 - tr.busy_s / tr.window_s)


def mfu(ctx) -> Optional[float]:
    tr = ctx["trace"]
    if not ctx.get("work_flops") or tr.window_s <= 0:
        return None
    return 100.0 * ctx["work_flops"] * ctx["calls"] / (tr.window_s * MFU_PEAK)


def roofline(ctx, kind: str, kernels: Iterable[str]) -> Optional[float]:
    """Σ least time of the reference's ``kind`` sites over Σ device time of the program's
    ``kernels`` in the window, in %."""
    t = ctx["trace"].kernels_matching(kernels)
    bound = {"attention": attention_bound_s, "field_grid": field_grid_bound_s}[kind]
    b = sum(bound(s) for s in ctx["work_sites"] if s["kind"] == kind) * ctx["calls"]
    if t <= 0 or b <= 0:
        return None
    return 100.0 * b / t
