"""Data parallelism with ``torch.distributed``: one process a GPU.

Counterpart of ``triplaneturbo_tpu/parallel/mesh.py``. There one process shards the
view batch over a device mesh, the parameters are replicated and XLA's psum reduces
the gradients, so the step keeps the whole batch's semantics whatever the sharding.
Here each rank holds the same parameters (:func:`replicate`, or the same seed), every
rank sees the step's whole batch and keeps its own prompts (:func:`shard_batch`), and
the gradients are averaged across ranks once before the update
(:func:`all_reduce_mean`).

A step couples the views of one prompt (MVDream's 4-view joint attention, the
teachers' per-prompt timesteps), so the batch is sharded by whole prompts, never
splitting a prompt's views: rank r of w takes prompts ``[r * B/w, (r + 1) * B/w)``
of a batch of B, with every view and draw that belongs to them.
"""

from __future__ import annotations

import os
from dataclasses import fields, is_dataclass, replace
from typing import Any, Dict, List, Mapping, Sequence, Tuple, Union

import torch
import torch.distributed as dist

_ENV = ("RANK", "WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT")


def is_initialized() -> bool:
    return dist.is_available() and dist.is_initialized()


def init_data_parallel(device_type: str = "cuda") -> Tuple[int, int, torch.device]:
    """Join the process group that the ``torchrun`` environment describes (``RANK``,
    ``WORLD_SIZE``, ``MASTER_ADDR``, ``MASTER_PORT``; ``LOCAL_RANK`` picks the card):
    NCCL on ``cuda:LOCAL_RANK``, gloo on the CPU. Returns (rank, world size, this
    rank's device). A group already up is kept."""
    if device_type not in ("cuda", "cpu"):
        raise ValueError(f"device type {device_type!r}: cuda or cpu")
    if not is_initialized():
        missing = [k for k in _ENV if k not in os.environ]
        if missing:
            raise RuntimeError(
                f"WORLD_SIZE={os.environ.get('WORLD_SIZE', '1')} asks for several processes, "
                f"but {', '.join(missing)} {'is' if len(missing) == 1 else 'are'} not set: "
                "start them with torchrun (torchrun --nproc_per_node=N -m "
                "triplaneturbo_torch.launch ...)")
        if device_type == "cuda":
            if not torch.cuda.is_available():
                raise RuntimeError("no CUDA device: pass --device cpu to run on the CPU")
            torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", "0")))
        dist.init_process_group("nccl" if device_type == "cuda" else "gloo")
    rank, world = dist.get_rank(), dist.get_world_size()
    device = (torch.device("cuda", torch.cuda.current_device()) if device_type == "cuda"
              else torch.device("cpu"))
    return rank, world, device


@torch.no_grad()
def replicate(obj: Union[torch.nn.Module, Sequence[torch.Tensor], Mapping[str, torch.Tensor]]):
    """Broadcast a module's parameters and buffers, or a list or dict of tensors, from
    rank 0 to every rank, in place; returns ``obj``. Without a process group,
    nothing."""
    if not is_initialized():
        return obj
    if isinstance(obj, torch.nn.Module):
        tensors = [*obj.parameters(), *obj.buffers()]
    elif isinstance(obj, Mapping):
        tensors = list(obj.values())
    else:
        tensors = list(obj)
    for t in tensors:
        dist.broadcast(t.data, 0)
    return obj


@torch.no_grad()
def all_reduce_mean(grads: Union[Dict[str, torch.Tensor], List[torch.Tensor]]):
    """Average ``grads`` (a dict or list of tensors) across the ranks, in place, as one
    flat buffer a dtype and device; returns ``grads``. Without a process group,
    nothing."""
    if not is_initialized():
        return grads
    world = dist.get_world_size()
    tensors = list(grads.values()) if isinstance(grads, Mapping) else list(grads)
    groups: Dict[Tuple[torch.dtype, torch.device], List[torch.Tensor]] = {}
    for t in tensors:
        groups.setdefault((t.dtype, t.device), []).append(t)
    for group in groups.values():
        flat = torch.cat([t.reshape(-1) for t in group])
        dist.all_reduce(flat)
        if world > 1:
            flat.div_(world)
        offset = 0
        for t in group:
            n = t.numel()
            t.copy_(flat[offset:offset + n].view_as(t))
            offset += n
    return grads


def all_reduce_sum(t: torch.Tensor) -> torch.Tensor:
    """``t`` summed over the ranks, as a new tensor; ``t`` itself without a process
    group."""
    if not is_initialized():
        return t
    t = t.detach().clone()
    dist.all_reduce(t)
    return t


def prompt_block(n_prompts: int, rank: int, world: int) -> slice:
    """Rank ``rank``'s prompts of a batch of ``n_prompts``: a contiguous block."""
    if n_prompts % world:
        raise ValueError(f"{n_prompts} prompts do not split over {world} ranks")
    per = n_prompts // world
    return slice(rank * per, (rank + 1) * per)


def shard_rows(x: torch.Tensor, rank: int, world: int, n_prompts: int,
               halves: int = 1) -> torch.Tensor:
    """Rank ``rank``'s rows of ``x``, whose dim 0 is ``halves`` blocks (one a renderer,
    when two renders are stacked) of ``n_prompts`` groups of equal size, a group a
    prompt; a tensor whose dim 0 is no multiple of ``halves * n_prompts`` is shared
    by the prompts and comes back whole."""
    if x.ndim == 0 or x.shape[0] % (halves * n_prompts):
        return x
    sl = prompt_block(n_prompts, rank, world)
    g = x.reshape(halves, n_prompts, -1, *x.shape[1:])[:, sl]
    return g.reshape(-1, *x.shape[1:])


def shard_batch(batch: Any, rank: int, world: int, n_prompts: int) -> Any:
    """Rank ``rank``'s share of a step-batch (or any tree of dicts, lists, tuples and
    dataclasses of tensors): every tensor through :func:`shard_rows`, a list of
    ``n_prompts`` items (the prompts) cut to the rank's, anything else as it is."""
    prompt_block(n_prompts, rank, world)  # raises unless the prompts split evenly

    def go(x):
        if isinstance(x, torch.Tensor):
            return shard_rows(x, rank, world, n_prompts)
        if isinstance(x, Mapping):
            return {k: go(v) for k, v in x.items()}
        if isinstance(x, list):
            if len(x) == n_prompts and all(isinstance(v, str) for v in x):
                return x[prompt_block(n_prompts, rank, world)]
            return [go(v) for v in x]
        if isinstance(x, tuple):
            return tuple(go(v) for v in x)
        if is_dataclass(x) and not isinstance(x, type):
            return replace(x, **{f.name: go(getattr(x, f.name)) for f in fields(x)})
        return x

    return go(batch)
