"""Small host-side utilities: rank discovery, dtype names, path helpers.

Counterpart of ``triplaneturbo_tpu/utils/misc.py``: rank and world size come
from ``torch.distributed`` when a process group is up, else 0 and 1.
"""

from __future__ import annotations

import gc
import os
from typing import Optional, Union

import torch


def _distributed() -> bool:
    return torch.distributed.is_available() and torch.distributed.is_initialized()


def get_rank() -> int:
    return torch.distributed.get_rank() if _distributed() else 0


def get_world_size() -> int:
    return torch.distributed.get_world_size() if _distributed() else 1


_DTYPE_ALIASES = {
    "float32": torch.float32,
    "fp32": torch.float32,
    "bfloat16": torch.bfloat16,
    "bf16": torch.bfloat16,
    "float16": torch.float16,
    "fp16": torch.float16,
}


def parse_dtype(d: Union[str, torch.dtype]) -> torch.dtype:
    return _DTYPE_ALIASES[d] if isinstance(d, str) else d


def find_last_path(path: Optional[str]) -> Optional[str]:
    """Resolve a literal ``LAST`` in ``path`` to the newest (by name) existing match."""
    if path is None or "LAST" not in path:
        return path
    path = path.replace(" ", "_")
    base_dir_prefix, suffix = path.split("LAST", 1)
    base_dir = os.path.dirname(base_dir_prefix)
    prefix = os.path.split(base_dir_prefix)[-1]
    base_dir_prefix = os.path.join(base_dir, prefix)
    candidates = sorted((os.path.join(base_dir, d) for d in os.listdir(base_dir)), reverse=True)
    for c in candidates:
        if c.startswith(base_dir_prefix) and os.path.exists(c + suffix):
            return c + suffix
    raise FileNotFoundError(path)


def cleanup() -> None:
    """Collect garbage and return the CUDA caching allocator's free blocks."""
    gc.collect()
    if torch.cuda.is_available() and torch.cuda.is_initialized():
        torch.cuda.empty_cache()
