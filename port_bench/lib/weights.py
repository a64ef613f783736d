"""Random weights made by the benchmark from the seed and handed to the program and to
the reference alike.

The parameter names, shapes and kinds come from the reference's modules (built on the
meta device); the values come from one ``torch.randn`` call in bf16 per block of
``_BLOCK`` elements on the run's device, scaled leaf by leaf after the flax
initializers the port uses, except that the adapters' ``up`` leaves and every bias are
small and nonzero, so that the LoRA and LoCon paths and the biases take part in what
is compared. Each value is rounded to bf16 once, so a bf16 program and an f32
reference hold exactly the same numbers.
"""

from __future__ import annotations

import math
from typing import Dict, List, Tuple

import torch
from torch import nn

from ..reference.ttref.models.background.hashgrid_env_map import LinearHyperNetwork
from ..reference.ttref.models.lora import (
    LoConAdapter,
    LoRAAdapter,
    PlaneLoConAdapter,
    PlaneLoRAAdapter,
)
from ..reference.ttref.models.renderers.volume_renderer import GenerativeSpaceSDFVolumeRenderer
from ..reference.ttref.ops.hashgrid import HashGridEncoding
from .seeds import derive

_BLOCK = 1 << 28
_BIAS_STD = 0.01
_UP_GAIN = 0.1  # an adapter's `up` against 1/fan-in: the adapters add about a tenth


def _rules(module: nn.Module) -> List[Tuple[str, Tuple[int, ...], str, float]]:
    """(name, shape, kind, scale) of every parameter: kind "normal" (N(0, scale²)) or
    "const" (filled with scale)."""
    out = []
    for mname, m in module.named_modules():
        for pname, p in m.named_parameters(recurse=False):
            name = f"{mname}.{pname}" if mname else pname
            shape = tuple(p.shape)
            if isinstance(m, GenerativeSpaceSDFVolumeRenderer):
                out.append((name, shape, "const", float(m.cfg.learned_variance_init)))
            elif isinstance(m, HashGridEncoding):
                out.append((name, shape, "normal", 1e-4))
            elif isinstance(m, LinearHyperNetwork):
                pass  # its Linear children are visited themselves
            elif isinstance(m, (LoRAAdapter, PlaneLoRAAdapter)):
                rank = m.rank
                scale = {"down": 1.0 / rank, "up": _UP_GAIN / math.sqrt(rank)}.get(pname, _BIAS_STD)
                out.append((name, shape, "normal", scale))
            elif pname == "bias":
                out.append((name, shape, "normal", _BIAS_STD))
            elif isinstance(m, (nn.GroupNorm, nn.LayerNorm)):
                out.append((name, shape, "const", 1.0))
            elif isinstance(m, nn.Embedding):
                out.append((name, shape, "normal", 1.0))
            elif pname == "position_embedding":
                out.append((name, shape, "normal", 0.01))
            elif pname == "class_embedding":
                out.append((name, shape, "normal", 0.02))
            elif isinstance(m, (nn.Linear, nn.Conv2d)) and pname == "weight":
                fan_in = math.prod(shape[1:])
                parent = mname.rsplit(".", 1)[-1]
                gain = _UP_GAIN if parent == "up" and _in_locon(module, mname) else 1.0
                if isinstance(_owner(module, mname), LinearHyperNetwork):
                    std = math.sqrt(2.0 / (shape[0] + shape[1]))
                else:
                    std = gain / math.sqrt(fan_in)
                out.append((name, shape, "normal", std))
            else:
                raise ValueError(f"no weight rule for parameter {name} of {type(m).__name__}")
    return out


def _owner(root: nn.Module, mname: str):
    parent = mname.rsplit(".", 1)[0] if "." in mname else ""
    return root.get_submodule(parent) if parent else root


def _in_locon(root: nn.Module, mname: str) -> bool:
    names = mname.split(".")
    for i in range(len(names), 0, -1):
        if isinstance(root.get_submodule(".".join(names[:i])), (LoConAdapter, PlaneLoConAdapter)):
            return True
    return False


@torch.no_grad()
def make_weights(reference_module: nn.Module, seed: int, tag: str,
                 device: torch.device) -> Dict[str, torch.Tensor]:
    """name -> bf16 tensor on ``device`` for every parameter of ``reference_module``
    (meta or not), from ``seed`` and ``tag`` (one tag a module, so that each module's
    weights do not depend on the sizes of the others)."""
    rules = _rules(reference_module)
    gen = torch.Generator(device=device).manual_seed(derive(seed, "weights", tag))
    out: Dict[str, torch.Tensor] = {}
    block, used = None, 0
    for name, shape, kind, scale in rules:
        n = math.prod(shape)
        if kind == "const":
            out[name] = torch.full(shape, scale, device=device, dtype=torch.bfloat16)
            continue
        if block is None or used + n > block.numel():
            block = torch.randn(max(_BLOCK, n), generator=gen, device=device, dtype=torch.bfloat16)
            used = 0
        out[name] = (block[used:used + n].view(shape).float() * scale).to(torch.bfloat16)
        used += n
    return out


@torch.no_grad()
def load(module: nn.Module, weights: Dict[str, torch.Tensor]) -> None:
    """Copy ``weights`` into ``module``'s parameters by name; every parameter must be
    given, with its shape."""
    params = dict(module.named_parameters())
    missing = sorted(set(params) - set(weights))
    unused = sorted(set(weights) - set(params))
    if missing or unused:
        raise ValueError(f"weights do not match {type(module).__name__}: missing {missing[:5]} "
                         f"({len(missing)}), unused {unused[:5]} ({len(unused)})")
    for name, p in params.items():
        w = weights[name]
        if tuple(w.shape) != tuple(p.shape):
            raise ValueError(f"{name}: module {tuple(p.shape)} vs weights {tuple(w.shape)}")
        p.copy_(w)
