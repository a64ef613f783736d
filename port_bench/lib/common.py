"""What both runners share: phase times, the device record, the reference's precision,
freeing the program, and the per-layer metrics of a traced run."""

from __future__ import annotations

import contextlib
import gc
import subprocess
import sys
import time
from typing import Any, Dict, Optional

import torch


def log(what: str, t0: float) -> None:
    """A phase's time on standard error (before the check's lines, which come last)."""
    print(f"port_bench: {what} at {time.perf_counter() - t0:.3f} s", file=sys.stderr, flush=True)


def device_record(device: torch.device, peak_bytes: int) -> Dict[str, Any]:
    if device.type == "cuda":
        return {"platform": "gpu", "kind": torch.cuda.get_device_name(device), "count": 1,
                "memory_peak_bytes": int(peak_bytes)}
    return {"platform": "cpu", "kind": "cpu", "count": 1, "memory_peak_bytes": int(peak_bytes)}


def power_limit() -> Optional[str]:
    """The card's name and power limit as ``nvidia-smi`` reads them, or None."""
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=30)
    except (OSError, subprocess.SubprocessError):
        return None
    return out.stdout.strip().splitlines()[0] if out.returncode == 0 and out.stdout.strip() else None


def sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


@contextlib.contextmanager
def reference_precision():
    """f32 products in f32: no TF32 in matrix products or convolutions."""
    old = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = old


def free(device: torch.device) -> None:
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()


def per_layer(cell, ctx: Dict[str, Any]) -> Dict[str, Dict[str, Any]]:
    """Each of the cell's per-layer metrics its reader finds something to read for."""
    out = {}
    for m in cell.per_layer:
        v = cell.readers[m["name"]].read(ctx)
        if v is not None:
            out[m["name"]] = {"value": float(v), "unit": m["unit"]}
    return out
