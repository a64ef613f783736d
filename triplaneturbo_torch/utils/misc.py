"""Small host-side utilities: rank discovery, dtype names, path helpers.

Counterpart of ``triplaneturbo_tpu/utils/misc.py``: rank and world size come
from ``torch.distributed`` when a process group is up, else 0 and 1;
:func:`barrier` and :func:`broadcast_host` do nothing without one.
"""

from __future__ import annotations

import gc
import os
from typing import Any, Optional, Union

import torch


def _distributed() -> bool:
    return torch.distributed.is_available() and torch.distributed.is_initialized()


def get_rank() -> int:
    return torch.distributed.get_rank() if _distributed() else 0


def get_world_size() -> int:
    return torch.distributed.get_world_size() if _distributed() else 1


def fold_seed(seed: int, i: int) -> int:
    """A seed made from (``seed``, ``i``) alone, the JAX package's
    ``fold_in(PRNGKey(seed), i)``: a step's generator, a prompt's latents."""
    import numpy as np

    return int(np.random.SeedSequence([seed, i]).generate_state(1)[0])


def get_device_count() -> int:
    """The GPUs this process sees (0 without CUDA)."""
    return torch.cuda.device_count() if torch.cuda.is_available() else 0


def barrier(name: str = "barrier") -> None:
    """Wait until every rank gets here (``name`` is for the reader)."""
    if _distributed():
        torch.distributed.barrier()


def broadcast_host(x: Any, src: int = 0) -> Any:
    """Rank ``src``'s value of a picklable host object, on every rank."""
    if not _distributed():
        return x
    box = [x]
    torch.distributed.broadcast_object_list(box, src)
    return box[0]


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
