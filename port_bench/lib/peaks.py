"""Published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet; dense rates, without
sparsity, at the full 700 W), and the least time of a piece of work on them."""

from __future__ import annotations

PEAK_FLOPS = {"bfloat16": 989e12, "tfloat32": 495e12, "float32": 67e12}
PEAK_BYTES = 3.35e12
MFU_PEAK = PEAK_FLOPS["bfloat16"]


def bound_s(flops: float, nbytes: float, dtype: str) -> float:
    """The larger of operations over the peak rate of ``dtype`` and bytes over the
    memory bandwidth, in seconds."""
    return max(flops / PEAK_FLOPS[dtype], nbytes / PEAK_BYTES)
