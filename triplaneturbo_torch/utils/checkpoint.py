"""Checkpoint I/O as ``torch.save`` files of tensors, read back with ``weights_only``.

Counterpart of ``triplaneturbo_tpu/utils/checkpoint.py`` without flax or orbax:
:func:`save_params` / :func:`load_params` hold a module's ``state_dict`` (the
geometry's, in the launcher); :func:`save_train_state` / :func:`load_train_state`
hold what a resumed run needs: the trainer's trainable partition by name, the
guarded Adan state (Adan's step count and moments, the accumulation cycle and the
finiteness gate's counters), ``global_step`` and the states of the host generators
that draw a step's timesteps and batch, so that a resumed run takes the steps an
uninterrupted one would. :func:`load_weights` reads ``system.weights`` in the
port's format (a ``geometry.pt``).

The readers of the reference's formats (the adapter ``.pth`` through the name
conversion, flax ``msgpack`` files, pipeline directories, teacher checkpoints) wait
for ROADMAP A20.
"""

from __future__ import annotations

import os
from typing import Any, Dict, Optional

import numpy as np
import torch

TRAIN_STATE_FILE = "train_state.pt"


def save_params(path: str, module: torch.nn.Module) -> str:
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    torch.save({k: v.detach().cpu() for k, v in module.state_dict().items()}, path)
    return path


def load_params(path: str, module: torch.nn.Module) -> torch.nn.Module:
    module.load_state_dict(torch.load(path, map_location="cpu", weights_only=True))
    return module


def _optimizer_state(optimizer) -> Dict[str, Any]:
    adan = optimizer.adan
    moments = {}
    for i, p in enumerate(optimizer.params):
        st = adan.state.get(p)
        if st:
            moments[i] = {k: v.detach().cpu() for k, v in st.items()}
    return {"count": adan.count, "moments": moments, "mini_step": optimizer.mini_step,
            "acc_grads": None if optimizer.acc_grads is None
            else [g.detach().cpu() for g in optimizer.acc_grads],
            "notfinite_count": optimizer.notfinite_count,
            "total_notfinite": optimizer.total_notfinite}


@torch.no_grad()
def _load_optimizer_state(optimizer, state: Dict[str, Any]) -> None:
    adan = optimizer.adan
    adan.count = int(state["count"])
    adan.state.clear()
    for i, st in state["moments"].items():
        p = optimizer.params[int(i)]
        adan.state[p] = {k: v.to(device=p.device, dtype=p.dtype) for k, v in st.items()}
    optimizer.mini_step = int(state["mini_step"])
    optimizer.acc_grads = (None if state["acc_grads"] is None else
                           [g.to(p.device) for g, p in zip(state["acc_grads"], optimizer.params)])
    optimizer.notfinite_count = int(state["notfinite_count"])
    optimizer.total_notfinite = int(state["total_notfinite"])


def _rng_state(rng: np.random.RandomState) -> Dict[str, Any]:
    _, keys, pos, has_gauss, cached = rng.get_state()
    return {"keys": torch.from_numpy(keys.astype(np.int64)), "pos": int(pos),
            "has_gauss": int(has_gauss), "cached_gaussian": float(cached)}


def _set_rng_state(rng: np.random.RandomState, state: Dict[str, Any]) -> None:
    rng.set_state(("MT19937", state["keys"].numpy().astype(np.uint32), state["pos"],
                   state["has_gauss"], state["cached_gaussian"]))


def save_train_state(path: str, trainer, global_step: Optional[int] = None,
                     data_rng: Optional[np.random.RandomState] = None) -> str:
    """The trainable partition, the optimizer state, the step and the host generators
    (the trainer's timestep strata and, when given, the data module's ``data_rng``)
    into ``path`` (a file, or ``path/train_state.pt`` where ``path`` is a directory or
    has no suffix)."""
    if os.path.isdir(path) or not os.path.splitext(path)[1]:
        path = os.path.join(path, TRAIN_STATE_FILE)
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    rngs = {"trainer": _rng_state(trainer.rng)}
    if data_rng is not None:
        rngs["data"] = _rng_state(data_rng)
    torch.save({"params_train": {n: p.detach().cpu() for n, p in trainer.params_train.items()},
                "optimizer": _optimizer_state(trainer.optimizer),
                "global_step": int(trainer.global_step if global_step is None else global_step),
                "rngs": rngs}, path)
    return path


@torch.no_grad()
def load_train_state(path: str, trainer,
                     data_rng: Optional[np.random.RandomState] = None) -> int:
    """Restore what :func:`save_train_state` wrote into ``trainer`` (in place; the
    names must be the trainer's trainable partition) and, when given, ``data_rng``;
    returns ``global_step``, which is also set on the trainer."""
    if os.path.isdir(path):
        path = os.path.join(path, TRAIN_STATE_FILE)
    state = torch.load(path, map_location="cpu", weights_only=True)
    saved = state["params_train"]
    if set(saved) != set(trainer.params_train):
        missing = sorted(set(trainer.params_train) - set(saved))
        extra = sorted(set(saved) - set(trainer.params_train))
        raise ValueError(f"train state does not match the trainer: missing {missing[:5]}, "
                         f"extra {extra[:5]}")
    for n, p in trainer.params_train.items():
        p.copy_(saved[n])
    _load_optimizer_state(trainer.optimizer, state["optimizer"])
    _set_rng_state(trainer.rng, state["rngs"]["trainer"])
    if data_rng is not None:
        _set_rng_state(data_rng, state["rngs"]["data"])
    trainer.global_step = int(state["global_step"])
    return trainer.global_step


def check_weights_format(path: str) -> None:
    """Raise unless ``path`` is a ``system.weights`` file :func:`load_weights` reads."""
    if not str(path).endswith(".pt"):
        _a20(f"the weights {path} (the port reads its own geometry.pt)")


def load_weights(path: str, trainer) -> None:
    """``system.weights``: the geometry's ``state_dict`` from a ``geometry.pt`` that
    :func:`save_params` wrote (module weights without optimizer state, as the
    reference's ``system.weights``)."""
    check_weights_format(path)
    load_params(path, trainer.geometry)


def _a20(what: str):
    raise NotImplementedError(f"reading {what} waits for ROADMAP A20")


def load_torch_adapter(path: str, geometry: torch.nn.Module, strict: bool = False):
    _a20(f"the reference's adapter checkpoint {path}")


def maybe_load_pipeline_params(path: str, geometry: torch.nn.Module, text_encoder):
    _a20(f"pipeline weights from {path}")


def load_teacher_params(path: str, unet, vae=None, **kwargs):
    _a20(f"the teacher checkpoint {path}")
