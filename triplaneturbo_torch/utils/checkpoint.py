"""Checkpoint I/O: the port's ``torch.save`` files, the JAX package's flax ``msgpack``
files and the reference's checkpoints.

Counterpart of ``triplaneturbo_tpu/utils/checkpoint.py`` without flax or orbax:
:func:`save_params` / :func:`load_params` hold a module's weights (the geometry's, in
the launcher), chosen by the extension: a ``.pt`` of its ``state_dict`` (the port's
default), or a ``.msgpack`` of its flax tree ``{"params": ...}`` as the JAX package's
``save_params`` writes it (``utils/msgpack_io.py``, ``utils/weights.py``
``module_to_flax_tree``), which the JAX package reads back and which holds what the
JAX package writes. :func:`save_train_state` / :func:`load_train_state` hold what a
resumed run needs: the trainer's trainable partition by name, the guarded Adan state
(Adan's step count and moments, the accumulation cycle and the finiteness gate's
counters), ``global_step`` and the states of the host generators that draw a step's
timesteps and batch, so that a resumed run takes the steps an uninterrupted one would;
the JAX launcher's orbax train state is not read. :func:`load_weights` reads
``system.weights``: a ``geometry.pt``, a ``geometry.msgpack`` (the JAX launcher's
``ckpt_*/`` and ``last/`` files) or the reference's adapter ``.pth``.

The readers of the other formats, after the JAX module: the adapter ``.pth``
(:func:`load_torch_adapter`), teacher checkpoints in the diffusers and LDM layouts and
the ``{kind}_teacher.msgpack`` / ``.pt`` files (:func:`load_teacher_params`), and
pipeline directories of ``geometry`` and ``text_encoder`` files
(:func:`maybe_load_pipeline_params`), through ``utils/convert_torch.py``. A reader
of the reference's layouts that leaves a parameter at its random initialisation warns
of it, and with ``strict`` raises; the port's ``.pt`` and the flax ``.msgpack`` files
must fit their modules exactly.
"""

from __future__ import annotations

import logging
import os
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from . import msgpack_io
from .convert_torch import (
    apply_flat_to_module,
    convert_adapters,
    convert_ldm_teacher,
    convert_unet,
    convert_vae,
)
from .weights import _flatten, module_to_flax_tree

TRAIN_STATE_FILE = "train_state.pt"
_LOG = logging.getLogger("triplaneturbo_torch")


def _is_msgpack(path) -> bool:
    return str(path).endswith(".msgpack")


def save_msgpack(path: str, tree: Any) -> str:
    """``tree`` (nested dicts of arrays and tensors) into ``path`` in the flax
    ``msgpack`` format, as ``flax.serialization.to_bytes`` writes it."""
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with open(path, "wb") as f:
        msgpack_io.dump(tree, f)
    return path


def load_msgpack(path: str) -> Any:
    """The tree of a flax ``msgpack`` file (``utils/msgpack_io.py`` ``load``)."""
    with open(path, "rb") as f:
        return msgpack_io.load(f)


def flax_params(module: torch.nn.Module) -> Dict[str, Any]:
    """``{"params": tree}``: what the JAX package saves for ``module``'s counterpart."""
    return {"params": module_to_flax_tree(module)}


def save_params(path: str, module: torch.nn.Module) -> str:
    """``module``'s weights into ``path``: its ``state_dict`` with ``torch.save``, or
    for a ``.msgpack`` path its flax tree ``{"params": ...}`` (:func:`flax_params`)."""
    if _is_msgpack(path):
        return save_msgpack(path, flax_params(module))
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    torch.save({k: v.detach().cpu() for k, v in module.state_dict().items()}, path)
    return path


def load_params(path: str, module: torch.nn.Module) -> torch.nn.Module:
    """``module``'s weights from ``path``, in place: a ``.pt`` of its ``state_dict`` or
    a flax ``.msgpack`` (:func:`load_flax_tree`). Either raises on a parameter the file
    leaves random, a leaf with no place or a leaf of another shape."""
    if _is_msgpack(path):
        load_flax_tree(load_msgpack(path), module, f"params of {path}")
        return module
    module.load_state_dict(torch.load(path, map_location="cpu", weights_only=True))
    return module


def load_flax_tree(tree: Any, module: torch.nn.Module, what: str) -> List[str]:
    """A flax parameter tree (``{"params": ...}`` or the tree under it, as a msgpack
    file holds it) onto ``module``, in place, each leaf cast to its parameter's dtype.
    Raises, as ``load_state_dict`` does, on a leaf with no place or of another shape
    and on a parameter left at its random initialisation. Returns the names loaded."""
    loaded, _ = _apply(_flatten(_params_tree(tree, what)), module, what, strict=True)
    _unloaded(what, module, loaded, strict=True)
    return loaded


def _params_tree(tree: Any, what: str) -> Dict[str, Any]:
    """The parameter tree of a flax file's ``{"params": ...}`` (or the tree itself)."""
    if not isinstance(tree, dict):
        raise ValueError(f"{what}: a flax parameter tree, got {type(tree).__name__}")
    return tree["params"] if set(tree) == {"params"} else tree


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
    """Raise unless ``path`` is a ``system.weights`` file :func:`load_weights` reads:
    a ``geometry.pt`` of the port, a ``geometry.msgpack`` of either package or the
    reference's adapter ``.pth``; a missing file raises before the system is built."""
    path = str(path)
    if not path.endswith((".pt", ".pth", ".msgpack")):
        raise ValueError(f"system.weights {path}: a geometry.pt or geometry.msgpack, or an "
                         "adapter .pth")
    if not os.path.exists(path):
        raise FileNotFoundError(path)


def load_weights(path: str, trainer) -> None:
    """``system.weights``: module weights without optimizer state, as the reference's:
    the geometry's from a ``geometry.pt`` or ``geometry.msgpack`` that
    :func:`save_params` (or the JAX package's) wrote, or the reference's adapter
    ``.pth`` through :func:`load_torch_adapter` (as the JAX builder reads them)."""
    check_weights_format(path)
    if str(path).endswith(".pth"):
        load_torch_adapter(str(path), trainer.geometry)
    else:
        load_params(path, trainer.geometry)


# -- the reference's formats ---------------------------------------------------
#
# Lightning, LDM and diffusers checkpoints are pickles that carry non-tensor
# entries (epoch, global_step, EMA bookkeeping), so they are read with
# ``torch.load(..., weights_only=False)``, as the JAX package reads them: that
# unpickles, and runs whatever code the file names. Read only checkpoints you trust.


def _torch_load(path: str) -> Any:
    return torch.load(path, map_location="cpu", weights_only=False)


def _state_numpy(state: Dict[str, Any]) -> Dict[str, np.ndarray]:
    return {k: v.detach().cpu().float().numpy() if hasattr(v, "detach") else np.asarray(v)
            for k, v in state.items()}


def _torch_state_numpy(path: str) -> Dict[str, np.ndarray]:
    """A torch checkpoint's state dict (its ``state_dict`` entry, or the whole file)
    as float32 numpy arrays. Unpickles ``path``."""
    ckpt = _torch_load(path)
    return _state_numpy(ckpt.get("state_dict", ckpt))


def _without(flat: Dict[str, np.ndarray], lacks: Tuple[str, ...]) -> Dict[str, np.ndarray]:
    """The entries of ``flat`` under none of the path prefixes ``lacks``: the parts of
    a reference checkpoint that the port's module has no place for by design."""
    return {k: v for k, v in flat.items() if not k.startswith(lacks)}


def _apply(flat: Dict[str, np.ndarray], module: torch.nn.Module, what: str,
           strict: bool, prefix: str = "") -> Tuple[List[str], List[str]]:
    """Write ``flat`` onto ``module`` (under ``prefix``); log the counts, warn of (or,
    with ``strict``, raise on) every key that did not load. Returns (names loaded,
    keys not)."""
    loaded, mismatched = apply_flat_to_module(flat, module, prefix)
    _LOG.info("%s: %d tensors loaded, %d unmatched", what, len(loaded), len(mismatched))
    for m in mismatched[:20]:
        _LOG.warning("  %s mismatch: %s", what, m)
    if mismatched and strict:
        raise ValueError(f"strict {what} load failed: {len(mismatched)} mismatches: "
                         f"{mismatched[:10]}")
    return loaded, mismatched


def _unloaded(what: str, module: torch.nn.Module, loaded: List[str], strict: bool) -> List[str]:
    """The parameters of ``module`` that ``loaded`` does not name, which keep their
    random initialisation: warned of, or with ``strict`` raised on."""
    missing = sorted({n for n, _ in module.named_parameters()} - set(loaded))
    if missing:
        msg = (f"{what}: {len(missing)} parameters not loaded, left at their random "
               f"initialisation: {missing[:5]}")
        if strict:
            raise ValueError(f"strict {msg}")
        _LOG.warning(msg)
    return missing


def load_torch_adapter(path: str, geometry: torch.nn.Module,
                       strict: bool = False) -> Tuple[List[str], List[str]]:
    """The released adapter checkpoint (``triplane_turbo_sd_v1.pth``:
    ``{state_dict, epoch, global_step}`` with ``geometry.*`` keys) onto a
    ``TriplaneGeometry``, in place, through ``convert_adapters`` (hexa-LoRA,
    vanilla LoRA, LoCon, the ``conv_out`` retrofit, the field MLPs). With ``strict``
    every converted tensor must land; otherwise mismatches are logged. Returns (the
    names loaded, the keys that did not load). Unpickles ``path``."""
    state = {k.replace("geometry.", "", 1): v for k, v in _torch_state_numpy(path).items()}
    return _apply(convert_adapters(state), geometry, "adapter", strict)


def maybe_load_pipeline_params(path: str, geometry: torch.nn.Module,
                               text_encoder: torch.nn.Module):
    """The pipeline's weights, in place: from a directory of ``geometry`` and
    ``text_encoder`` files, each the port's ``.pt`` or a flax ``.msgpack`` (what
    either package's ``tools/convert_checkpoints.py`` writes, as the JAX reader reads
    its own), or from an adapter ``.pth`` over the backbone the modules hold. Unlike
    the JAX reader, a directory without one of the two files, or a path that is
    neither, raises ``FileNotFoundError`` rather than leaving weights random; a
    file that leaves a parameter random raises."""
    path = str(path)
    if os.path.isdir(path):
        for name, module in (("geometry", geometry), ("text_encoder", text_encoder)):
            files = [os.path.join(path, f"{name}{ext}") for ext in (".pt", ".msgpack")]
            found = [f for f in files if os.path.exists(f)]
            if not found:
                raise FileNotFoundError(f"{path} holds no {name}.pt or {name}.msgpack")
            load_params(found[0], module)
            _LOG.info("loaded %s from %s", name, found[0])
    elif path.endswith(".pth") and os.path.exists(path):
        load_torch_adapter(path, geometry)
    else:
        raise FileNotFoundError(f"{path}: a pipeline directory or an adapter .pth")
    return geometry, text_encoder


# what a whole VAE's checkpoint holds and a teacher's encoder-only VAE has no place for
_TEACHER_VAE_LACKS = ("decoder/", "post_quant_conv/")


def save_teacher(path: str, unet: torch.nn.Module, vae: Optional[torch.nn.Module]) -> str:
    """A teacher's ``{"unet", "vae"}`` (``vae`` ``{}`` when there is none) into ``path``,
    as :func:`load_teacher_params` reads it: state dicts in a ``.pt``, flax trees in a
    ``.msgpack``."""
    if _is_msgpack(path):
        return save_msgpack(path, {"unet": flax_params(unet),
                                   "vae": flax_params(vae) if vae is not None else {}})
    state = {"unet": {k: v.detach().cpu() for k, v in unet.state_dict().items()}, "vae": {}}
    if vae is not None:
        state["vae"] = {k: v.detach().cpu() for k, v in vae.state_dict().items()}
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    torch.save(state, path)
    return path


def _is_port_teacher(ckpt: Any) -> bool:
    return (isinstance(ckpt, dict) and set(ckpt) == {"unet", "vae"}
            and isinstance(ckpt["unet"], dict))


def load_teacher_params(path: str, unet: torch.nn.Module, vae: Optional[torch.nn.Module] = None,
                        n_blocks: int = 4, layers_per_block: int = 2, strict: bool = False
                        ) -> Dict[str, Tuple[List[str], List[str]]]:
    """A teacher's weights, in place, from any of the reference's layouts:

    * a diffusers directory (``unet/`` and ``vae/`` ``diffusion_pytorch_model.bin``):
      the SD-2.1 teacher;
    * ``*.pt`` / ``*.ckpt`` with ``model.diffusion_model.*`` keys: the LDM layout
      (MVDream ``sd-v2.1-base-4view.pt``, RichDreamer ``nd_mv_ema.ckpt``), whose
      ``model_ema`` shadows win;
    * a bare diffusers UNet state dict;
    * the port's own ``{kind}_teacher.pt`` (``{"unet": state_dict, "vae":
      state_dict or {}}``, what ``tools/convert_checkpoints.py`` writes);
    * a ``{kind}_teacher.msgpack`` (``{"unet": flax tree, "vae": flax tree or {}}``,
      what the JAX package's ``tools/convert_checkpoints.py`` and the port's with
      ``--format msgpack`` write; :func:`save_teacher`).

    The port's two files must fit the modules exactly, as ``load_state_dict`` holds
    them. Of the reference's layouts, a whole VAE's decoder half is left out for the
    teacher's encoder; a path that gives the UNet no tensor raises ``ValueError``; a
    parameter left at its random initialisation is warned of. With ``strict`` every
    converted tensor must land and every parameter of ``unet`` and ``vae`` must be
    loaded. Returns ``{"unet": (names
    loaded, keys not), "vae": ...}``. Unpickles a torch ``path``."""
    out: Dict[str, Tuple[List[str], List[str]]] = {}

    def apply(flat, module, what, lacks=()):
        if module is not None:
            out[what] = _apply(_without(flat, lacks), module, f"teacher {what}", strict)

    path = str(path)
    if _is_msgpack(path):
        tree = load_msgpack(path)
        if not (isinstance(tree, dict) and set(tree) == {"unet", "vae"}):
            raise ValueError(f"{path}: a teacher msgpack holds {{'unet', 'vae'}}")
        for what, module in (("unet", unet), ("vae", vae)):
            if module is not None:
                out[what] = (load_flax_tree(tree[what], module, f"teacher {what}"), [])
    elif os.path.isdir(path):
        unet_bin = os.path.join(path, "unet", "diffusion_pytorch_model.bin")
        vae_bin = os.path.join(path, "vae", "diffusion_pytorch_model.bin")
        if os.path.exists(unet_bin):
            apply(convert_unet(_torch_state_numpy(unet_bin), n_blocks, layers_per_block),
                  unet, "unet")
        if vae is not None and os.path.exists(vae_bin):
            apply(convert_vae(_torch_state_numpy(vae_bin), n_blocks, layers_per_block),
                  vae, "vae", _TEACHER_VAE_LACKS)
    else:
        ckpt = _torch_load(path)
        if _is_port_teacher(ckpt):
            unet.load_state_dict(ckpt["unet"])
            out["unet"] = (list(ckpt["unet"]), [])
            if vae is not None:
                vae.load_state_dict(ckpt["vae"])
                out["vae"] = (list(ckpt["vae"]), [])
        else:
            state = _state_numpy(ckpt.get("state_dict", ckpt))
            del ckpt
            if any(k.startswith("model.diffusion_model.") for k in state):
                conv = convert_ldm_teacher(state, n_blocks, layers_per_block)
                apply(conv["unet"], unet, "unet")
                apply(conv["vae"], vae, "vae", _TEACHER_VAE_LACKS)
            else:
                apply(convert_unet(state, n_blocks, layers_per_block), unet, "unet")
    if not out.get("unet", ([], []))[0]:
        raise ValueError(f"{path} gave the teacher's UNet no tensor: a diffusers directory "
                         "with unet/, an LDM or diffusers UNet checkpoint, or a teacher .pt")
    for what, module in (("unet", unet), ("vae", vae)):
        if module is not None:
            _unloaded(f"teacher {what}", module, out.get(what, ([], []))[0], strict)
    return out
