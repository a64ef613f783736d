"""Parameters of the port's modules: the bridge from a flax tree, and random init.

The port's modules carry the flax modules' names (``down_0_res_0``,
``conv1.conv``, ``Dense_0``, ``lora_q`` ...), so a flax parameter path maps to
one torch parameter by its last name alone:

* ``kernel`` of a Dense ``[in, out]`` -> Linear ``weight`` transposed;
* ``kernel`` of a Conv, HWIO -> Conv2d ``weight``, OIHW;
* norm ``scale`` -> ``weight``; ``Embed.embedding`` -> ``weight``;
* everything else (``bias``, the LoRA ``down`` / ``up``, plane-stacked or
  not, ``position_embedding``) keeps its name and layout.

The same mapping carries any tree shaped like the parameters (gradients,
optimizer moments) across, in either direction: :func:`flax_tree_to_named`,
:func:`named_to_flax_tree`, :func:`load_adan_state`. It covers the geometry
the hash-grid background (``hypernet/fc_in``, ``ln_in``, ``fc_out``,
``encoding/table``) and the volume renderer (``variance_inv_std``) alike.
"""

from __future__ import annotations

import math
from typing import Any, Dict, Mapping

import numpy as np
import torch
from torch import nn

from ..models.background.hashgrid_env_map import LinearHyperNetwork
from ..models.lora import LoConAdapter, LoRAAdapter, PlaneLoRAAdapter
from ..models.renderers.volume_renderer import GenerativeSpaceSDFVolumeRenderer
from ..ops.hashgrid import HashGridEncoding


def _flatten(tree: Mapping[str, Any], prefix: str = "") -> Dict[str, np.ndarray]:
    out: Dict[str, np.ndarray] = {}
    for k, v in tree.items():
        path = f"{prefix}/{k}" if prefix else str(k)
        if isinstance(v, Mapping):
            out.update(_flatten(v, path))
        else:
            out[path] = np.asarray(v)
    return out


def _contiguous(arr: np.ndarray) -> np.ndarray:
    """A C-contiguous copy that keeps a scalar a scalar (``np.ascontiguousarray``
    makes it 1-d)."""
    return np.ascontiguousarray(arr).reshape(arr.shape)


def _torch_leaf(path: str, arr: np.ndarray):
    """(torch parameter name, array in torch layout) for one flax leaf."""
    *mods, leaf = path.split("/")
    name = {"kernel": "weight", "scale": "weight", "embedding": "weight"}.get(leaf, leaf)
    if leaf == "kernel":
        if arr.ndim == 2:
            arr = arr.T
        elif arr.ndim == 4:
            arr = arr.transpose(3, 2, 0, 1)
        else:
            raise ValueError(f"{path}: kernel of rank {arr.ndim}")
    return ".".join(mods + [name]), _contiguous(arr)


def flax_tree_to_named(tree: Mapping[str, Any]) -> Dict[str, np.ndarray]:
    """A flax-shaped tree (parameters, gradients, moments) as a dict from the
    port's parameter names to arrays in the port's layout."""
    return dict(_torch_leaf(p, a) for p, a in _flatten(tree).items())


def named_to_flax_tree(named: Mapping[str, Any], like: Mapping[str, Any]) -> Dict[str, Any]:
    """The reverse: arrays keyed by the port's parameter names, laid out as the
    flax tree ``like`` (whose leaves give the paths; their values are not read).
    Names that ``like`` does not hold are left out; a missing one raises."""
    out: Dict[str, Any] = {}
    for path, leaf in _flatten(like).items():
        name, _ = _torch_leaf(path, np.empty((0,) * leaf.ndim))
        arr = named[name]
        arr = arr.detach().cpu().numpy() if isinstance(arr, torch.Tensor) else np.asarray(arr)
        if path.rsplit("/", 1)[-1] == "kernel":
            arr = arr.T if arr.ndim == 2 else arr.transpose(2, 3, 1, 0)
        node = out
        *mods, last = path.split("/")
        for m in mods:
            node = node.setdefault(m, {})
        node[last] = _contiguous(arr)
    return out


@torch.no_grad()
def load_adan_state(optimizer, names, count: int, m: Mapping[str, Any], v: Mapping[str, Any],
                    n: Mapping[str, Any], prev_grad: Mapping[str, Any]) -> None:
    """Carry an Adan state of the JAX package into the port's optimizer.

    ``optimizer`` is an ``Adan`` or a ``GuardedAdan`` whose parameters are, in
    order, the ones called ``names``; ``m``, ``v``, ``n`` and ``prev_grad`` are
    flax-shaped trees of numpy arrays over (at least) those parameters, and
    ``count`` the number of steps taken.
    """
    adan = getattr(optimizer, "adan", optimizer)
    params = [p for group in adan.param_groups for p in group["params"]]
    names = list(names)
    if len(names) != len(params):
        raise ValueError(f"{len(names)} names for {len(params)} parameters")
    moments = {key: flax_tree_to_named(tree)
               for key, tree in (("m", m), ("v", v), ("n", n), ("prev_grad", prev_grad))}
    adan.count = int(count)
    for name, p in zip(names, params):
        for key, named in moments.items():
            arr = named[name]
            if tuple(p.shape) != arr.shape:
                raise ValueError(f"{key} of {name}: parameter {tuple(p.shape)} vs state {arr.shape}")
            adan.state[p][key] = torch.tensor(arr, device=p.device, dtype=p.dtype)


@torch.no_grad()
def load_flax_params(module: nn.Module, tree: Mapping[str, Any]) -> None:
    """Fill ``module``'s parameters from a flax parameter tree of numpy arrays.

    ``tree`` is the nested dict under ``"params"``. Raises on a missing
    parameter, an unused leaf or a shape mismatch.
    """
    params = dict(module.named_parameters())
    mapped = flax_tree_to_named(tree)
    missing = sorted(set(params) - set(mapped))
    unused = sorted(set(mapped) - set(params))
    if missing or unused:
        raise ValueError(f"flax tree does not match the module: missing {missing[:10]} "
                         f"({len(missing)}), unused {unused[:10]} ({len(unused)})")
    for name, arr in mapped.items():
        p = params[name]
        if tuple(p.shape) != arr.shape:
            raise ValueError(f"{name}: module {tuple(p.shape)} vs tree {arr.shape}")
        p.copy_(torch.tensor(arr, device=p.device, dtype=p.dtype))


def _normal_(t: torch.Tensor, std: float, gen: torch.Generator) -> None:
    t.copy_(torch.randn(t.shape, generator=gen, device=t.device, dtype=torch.float32) * std)


@torch.no_grad()
def init_random_(module: nn.Module, generator: torch.Generator) -> None:
    """Random weights from ``generator``, after the flax initializers.

    Linear / conv kernels N(0, 1/fan_in) (flax's lecun normal, untruncated),
    biases 0, norms 1 and 0, embeddings N(0, 1), the position embedding
    N(0, 0.01²); LoRA ``down`` N(0, 1)/rank, LoCon ``down`` kaiming uniform,
    and every adapter ``up`` 0, so fresh adapters add nothing; the
    hypernetwork's kernels xavier normal, the hash-grid table uniform in
    ±1e-4, the volume renderer's ``variance_inv_std`` its configured start.
    """
    done = set()
    for m in module.modules():
        own = dict(m.named_parameters(recurse=False))
        if isinstance(m, LinearHyperNetwork):
            for lin in m.children():
                if isinstance(lin, nn.Linear):
                    fan_out, fan_in = lin.weight.shape
                    _normal_(lin.weight, math.sqrt(2.0 / (fan_in + fan_out)), generator)
                    done.add(id(lin.weight))
        elif isinstance(m, HashGridEncoding):
            m.reset_parameters(generator)
        elif isinstance(m, GenerativeSpaceSDFVolumeRenderer):
            m.variance_inv_std.fill_(m.cfg.learned_variance_init)
        elif isinstance(m, (LoRAAdapter, PlaneLoRAAdapter)):
            _normal_(m.down, 1.0 / m.rank, generator)
            m.up.zero_()
        elif isinstance(m, LoConAdapter):
            fan_in = m.down.weight[0].numel()
            bound = math.sqrt(6.0 / fan_in)
            u = torch.rand(m.down.weight.shape, generator=generator, device=m.down.weight.device)
            m.down.weight.copy_(u * 2 * bound - bound)
            m.up.weight.zero_()
            done.update(id(p) for p in m.parameters())
        elif isinstance(m, (nn.Linear, nn.Conv2d)) and id(m.weight) not in done:
            _normal_(m.weight, 1.0 / math.sqrt(m.weight[0].numel()), generator)
        elif isinstance(m, (nn.GroupNorm, nn.LayerNorm)):
            m.weight.fill_(1.0)
        elif isinstance(m, nn.Embedding):
            _normal_(m.weight, 1.0, generator)
        elif "position_embedding" in own:
            _normal_(own["position_embedding"], 0.01, generator)
        for name, p in own.items():
            if name == "bias":
                p.zero_()
