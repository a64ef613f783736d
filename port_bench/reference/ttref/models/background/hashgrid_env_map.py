"""Hypernet environment-map background and the LinearHyperNetwork.

Counterpart of ``triplaneturbo_tpu/models/background/hashgrid_env_map.py``:
the prompt's pooled text embedding generates a per-prompt 2-layer MLP
[encoding -> 64 -> 3]; view directions are hash-encoded and pushed through
those generated weights (bias-free batched products), ending in the
MipNeRF-clamped sigmoid. Eval returns a fixed colour.

Parameter names follow the flax modules (``hypernet.fc_in``, ``ln_in``,
``fc_out``, ``encoding.table``), so ``utils.weights`` bridges the flax tree
both ways. flax's LayerNorm eps is 1e-6 (torch's default is 1e-5).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ...ops.hashgrid import HashGridConfig, HashGridEncoding
from ..networks import get_activation


@dataclass(frozen=True)
class HyperNetConfig:
    c_dim: int = 1024
    out_dims: Tuple[Tuple[str, Tuple[int, ...]], ...] = (("bg_weights", (64, 3)),)
    n_neurons: int = 64
    n_hidden_layers: int = 1
    output_activation: Optional[str] = None


class LinearHyperNetwork(nn.Module):
    """Text embedding [B, c_dim] -> a list of per-prompt weight matrices
    [B, in, out] for each named chain of ``out_dims``."""

    def __init__(self, n_input_dims: int, cfg: HyperNetConfig = HyperNetConfig()):
        super().__init__()
        self.cfg = c = cfg
        self.chains = {name: (n_input_dims,) + tuple(dims) for name, dims in c.out_dims}
        n_out = sum(i * o for dims in self.chains.values() for i, o in zip(dims[:-1], dims[1:]))
        self.fc_in = nn.Linear(c.c_dim, c.n_neurons, bias=False)
        self.ln_in = nn.LayerNorm(c.n_neurons, eps=1e-6)
        for i in range(c.n_hidden_layers - 1):
            self.add_module(f"fc_{i}", nn.Linear(c.n_neurons, c.n_neurons))
            self.add_module(f"ln_{i}", nn.LayerNorm(c.n_neurons, eps=1e-6))
        self.fc_out = nn.Linear(c.n_neurons, n_out)
        self._out_act = get_activation(c.output_activation)

    def forward(self, x: torch.Tensor) -> Dict[str, List[torch.Tensor]]:
        h = F.silu(self.ln_in(self.fc_in(x.float())))
        for i in range(self.cfg.n_hidden_layers - 1):
            h = F.silu(getattr(self, f"ln_{i}")(getattr(self, f"fc_{i}")(h)))
        h = self._out_act(self.fc_out(h))
        out: Dict[str, List[torch.Tensor]] = {}
        start = 0
        for name, dims in self.chains.items():
            mats = []
            for i, o in zip(dims[:-1], dims[1:]):
                mats.append(h[:, start:start + i * o].reshape(-1, i, o))
                start += i * o
            out[name] = mats
        return out


@dataclass
class HashgridBackgroundConfig:
    n_output_dims: int = 3
    color_activation: str = "sigmoid-mipnerf"
    encoding: HashGridConfig = field(default_factory=HashGridConfig)
    hypernet: HyperNetConfig = field(default_factory=HyperNetConfig)
    random_aug: bool = False
    random_aug_prob: float = 0.5
    eval_color: Optional[Tuple[float, float, float]] = (1.0, 1.0, 1.0)


class HashgridEnvironmentMapBackground(nn.Module):
    def __init__(self, cfg: Optional[HashgridBackgroundConfig] = None):
        super().__init__()
        self.cfg = c = cfg or HashgridBackgroundConfig()
        self.encoding = HashGridEncoding(c.encoding)
        self.hypernet = LinearHyperNetwork(c.encoding.n_output_dims, c.hypernet)
        self._act = get_activation(c.color_activation)

    def forward(self, dirs: torch.Tensor, text_embed: Optional[torch.Tensor] = None,
                train: bool = True, aug_generator: Optional[torch.Generator] = None
                ) -> torch.Tensor:
        """dirs [B, H, W, 3] normalised view directions, text_embed [Bp, c_dim]
        pooled (B a multiple of Bp) -> colour [B, H, W, n_output_dims].

        With ``random_aug`` on, training colours are replaced, with
        probability ``random_aug_prob``, by one random colour a view, drawn
        from ``aug_generator``."""
        c = self.cfg
        B, H, W, _ = dirs.shape
        if not train and c.eval_color is not None:
            color = torch.tensor(c.eval_color, dtype=dirs.dtype, device=dirs.device)
            return color.expand(B, H, W, c.n_output_dims)
        weights = self.hypernet(text_embed)["bg_weights"]
        h = self.encoding(((dirs + 1.0) / 2.0).reshape(-1, 3)).reshape(B, H * W, -1)
        for idx, wmat in enumerate(weights):
            h = torch.bmm(h, wmat.repeat_interleave(B // wmat.shape[0], dim=0))
            if idx < len(weights) - 1:
                h = torch.relu(h)
        color = self._act(h).reshape(B, H, W, c.n_output_dims)
        if train and c.random_aug and aug_generator is not None:
            dev = dirs.device
            use_aug = torch.rand((), generator=aug_generator, device=dev) < c.random_aug_prob
            rand_color = torch.rand((B, 1, 1, c.n_output_dims), generator=aug_generator,
                                    device=dev)
            color = torch.where(use_aug, rand_color.expand(color.shape), color)
        return color


class SolidColorBackground(nn.Module):
    """A fixed solid colour."""

    def __init__(self, color: Tuple[float, float, float] = (1.0, 1.0, 1.0)):
        super().__init__()
        self.color = tuple(color)

    def forward(self, dirs: torch.Tensor, text_embed=None, train: bool = True,
                aug_generator=None) -> torch.Tensor:
        B, H, W, _ = dirs.shape
        return torch.tensor(self.color, dtype=dirs.dtype, device=dirs.device).expand(B, H, W, 3)
