"""Parameters of the port's modules: the bridge from a flax tree, and random init.

The port's modules carry the flax modules' names (``down_0_res_0``,
``conv1.conv``, ``Dense_0``, ``lora_q`` ...), so a flax parameter path maps to
one torch parameter by its last name alone:

* ``kernel`` of a Dense ``[in, out]`` -> Linear ``weight`` transposed;
* ``kernel`` of a Conv, HWIO -> Conv2d ``weight``, OIHW; a plane-stacked one
  (``PlaneLoConAdapter``, ``[P, kh, kw, I, O]``) -> the grouped Conv2d's
  ``[P * O, I, kh, kw]``, and its stacked bias ``[P, O]`` -> ``[P * O]``;
* norm ``scale`` -> ``weight``; ``Embed.embedding`` -> ``weight``;
* everything else (``bias``, the LoRA ``down`` / ``up``, plane-stacked or
  not, ``position_embedding``) keeps its name and layout.

The same mapping carries any tree shaped like the parameters (gradients,
optimizer moments) across, in either direction: :func:`flax_tree_to_named`,
:func:`named_to_flax_tree`, :func:`load_adan_state`. :func:`module_to_flax_tree`
inverts it from the module alone, deciding ``kernel``, ``scale`` or ``embedding``
by each parameter's module type: the tree the JAX package saves for that module. It covers the geometry
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
from ..models.lora import LoConAdapter, LoRAAdapter, PlaneLoConAdapter, PlaneLoRAAdapter
from ..models.renderers.volume_renderer import GenerativeSpaceSDFVolumeRenderer
from ..ops.hashgrid import HashGridEncoding


def _numpy(v) -> np.ndarray:
    """A leaf as a numpy array; a torch tensor on the host, bfloat16 (which numpy
    lacks) widened to float32, which holds it exactly."""
    if isinstance(v, torch.Tensor):
        v = v.detach().cpu()
        return (v.float() if v.dtype == torch.bfloat16 else v).numpy()
    return np.asarray(v)


def _flatten(tree: Mapping[str, Any], prefix: str = "") -> Dict[str, np.ndarray]:
    out: Dict[str, np.ndarray] = {}
    for k, v in tree.items():
        path = f"{prefix}/{k}" if prefix else str(k)
        if isinstance(v, Mapping):
            out.update(_flatten(v, path))
        else:
            out[path] = _numpy(v)
    return out


def _contiguous(arr: np.ndarray) -> np.ndarray:
    """A C-contiguous copy that keeps a scalar a scalar (``np.ascontiguousarray``
    makes it 1-d)."""
    return np.ascontiguousarray(arr).reshape(arr.shape)


def _torch_leaf(path: str, arr: np.ndarray, contiguous: bool = True):
    """(torch parameter name, array in torch layout) for one flax leaf; the array
    is a view of ``arr`` unless ``contiguous``."""
    *mods, leaf = path.split("/")
    name = {"kernel": "weight", "scale": "weight", "embedding": "weight"}.get(leaf, leaf)
    if leaf == "kernel":
        if arr.ndim == 2:
            arr = arr.T
        elif arr.ndim == 4:
            arr = arr.transpose(3, 2, 0, 1)
        elif arr.ndim == 5:  # one HWIO kernel a plane -> groups of a grouped conv
            P, kh, kw, ci, co = arr.shape
            arr = arr.transpose(0, 4, 3, 1, 2).reshape(P * co, ci, kh, kw)
        else:
            raise ValueError(f"{path}: kernel of rank {arr.ndim}")
    elif leaf == "bias" and "planes" in mods:
        arr = arr.reshape(-1)
    return ".".join(mods + [name]), _contiguous(arr) if contiguous else arr


def flax_tree_to_named(tree: Mapping[str, Any]) -> Dict[str, np.ndarray]:
    """A flax-shaped tree (parameters, gradients, moments) as a dict from the
    port's parameter names to arrays in the port's layout."""
    return dict(_torch_leaf(p, a) for p, a in _flatten(tree).items())


def module_to_flax_tree(module: nn.Module) -> Dict[str, Any]:
    """``module``'s parameters as the flax tree of the JAX package's counterpart (the
    nested dict under ``"params"``), in the flax layout: the inverse of
    :func:`flax_tree_to_named`. A ``Linear`` weight becomes ``kernel`` ``[in, out]``, a
    ``Conv2d`` weight ``kernel`` HWIO (a plane-stacked grouped conv's ``[P, kh, kw, I,
    O]``, its bias ``[P, O]``), a norm's weight ``scale`` and an ``Embedding``'s
    ``embedding``; every other parameter keeps its name and layout. The leaves are
    detached views of the parameters, on their device and in their dtype."""
    tree: Dict[str, Any] = {}
    for mod_name, m in module.named_modules():
        mods = mod_name.split(".") if mod_name else []
        for leaf, p in m.named_parameters(recurse=False):
            t = p.detach()
            if leaf == "weight" and isinstance(m, nn.Linear):
                leaf, t = "kernel", t.T
            elif leaf == "weight" and isinstance(m, nn.Conv2d):
                if "planes" in mods:  # the groups of a grouped conv, one a plane
                    P = m.groups
                    t = t.reshape(P, t.shape[0] // P, *t.shape[1:]).permute(0, 3, 4, 2, 1)
                else:
                    t = t.permute(2, 3, 1, 0)
                leaf = "kernel"
            elif leaf == "weight" and isinstance(m, (nn.GroupNorm, nn.LayerNorm)):
                leaf = "scale"
            elif leaf == "weight" and isinstance(m, nn.Embedding):
                leaf = "embedding"
            elif leaf == "bias" and "planes" in mods:
                t = t.reshape(m.groups, -1)
            node = tree
            for k in mods:
                node = node.setdefault(k, {})
            node[leaf] = t
    return tree


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
            if leaf.ndim == 5:
                P, kh, kw, ci, co = leaf.shape
                arr = arr.reshape(P, co, ci, kh, kw).transpose(0, 3, 4, 2, 1)
            else:
                arr = arr.T if arr.ndim == 2 else arr.transpose(2, 3, 1, 0)
        arr = arr.reshape(leaf.shape)
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
    biases 0, norms 1 and 0, embeddings N(0, 1), the text towers' position
    embedding N(0, 0.01²), the image tower's class and position embeddings
    N(0, 0.02²); LoRA ``down`` N(0, 1)/rank, LoCon ``down`` kaiming uniform,
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
        elif isinstance(m, (LoConAdapter, PlaneLoConAdapter)):
            down, up = (m.down, m.up) if isinstance(m, LoConAdapter) else (
                m.planes["down"], m.planes["up"])
            fan_in = down.weight[0].numel()  # k * k * C_in, a plane's too
            bound = math.sqrt(6.0 / fan_in)
            u = torch.rand(down.weight.shape, generator=generator, device=down.weight.device)
            down.weight.copy_(u * 2 * bound - bound)
            up.weight.zero_()
            done.update(id(p) for p in m.parameters())
        elif isinstance(m, (nn.Linear, nn.Conv2d)) and id(m.weight) not in done:
            _normal_(m.weight, 1.0 / math.sqrt(m.weight[0].numel()), generator)
        elif isinstance(m, (nn.GroupNorm, nn.LayerNorm)):
            m.weight.fill_(1.0)
        elif isinstance(m, nn.Embedding):
            _normal_(m.weight, 1.0, generator)
        elif "class_embedding" in own:  # the CLIP image tower: flax's normal(0.02)
            _normal_(own["class_embedding"], 0.02, generator)
            _normal_(own["position_embedding"], 0.02, generator)
        elif "position_embedding" in own:
            _normal_(own["position_embedding"], 0.01, generator)
        for name, p in own.items():
            if name == "bias":
                p.zero_()
