"""Activations and the bias-free VanillaMLP.

Counterpart of ``triplaneturbo_tpu/models/networks.py``. The MLPs compute in
float32 whatever the surrounding model's dtype, like the JAX package (and the
reference's autocast-disable).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable, Dict, Optional, Union

import torch
import torch.nn.functional as F
from torch import nn


class _TruncExp(torch.autograd.Function):
    """exp(x) whose backward takes exp of x clipped to [-15, 15]: the gradient
    stays finite where the value overflows."""

    @staticmethod
    def forward(ctx, x):
        ctx.save_for_backward(x)
        return torch.exp(x)

    @staticmethod
    def backward(ctx, g):
        (x,) = ctx.saved_tensors
        return g * torch.exp(torch.clamp(x, -15, 15))


def trunc_exp(x: torch.Tensor) -> torch.Tensor:
    return _TruncExp.apply(x)


def get_activation(name: Optional[str]) -> Callable[[torch.Tensor], torch.Tensor]:
    """Activation registry, including the MipNeRF-clamped sigmoid for colors."""
    if name is None:
        return lambda x: x
    key = name.lower()
    if key == "none":
        return lambda x: x
    if key == "sigmoid-mipnerf":
        return lambda x: torch.sigmoid(x) * (1 + 2 * 0.001) - 0.001
    if key == "exp":
        return torch.exp
    if key == "shifted_exp":
        return lambda x: torch.exp(x - 1.0)
    if key == "trunc_exp":
        return trunc_exp
    if key == "shifted_trunc_exp":
        return lambda x: trunc_exp(x - 1.0)
    if key == "sigmoid":
        return torch.sigmoid
    if key == "tanh":
        return torch.tanh
    if key == "relu":
        return torch.relu
    if key == "softplus":
        return F.softplus
    if key == "scale_-11_01":
        return lambda x: x * 0.5 + 0.5
    if hasattr(F, key):
        return getattr(F, key)
    raise ValueError(f"Unknown activation function: {name}")


@dataclass
class MLPConfig:
    otype: str = "VanillaMLP"
    activation: str = "ReLU"
    output_activation: str = "none"
    n_neurons: int = 64
    n_hidden_layers: int = 2


class VanillaMLP(nn.Module):
    """Bias-free MLP: dim_in -> n_neurons x n_hidden_layers -> dim_out, float32.

    The layers are named ``Dense_0 .. Dense_n`` like the flax module's.
    """

    def __init__(self, dim_in: int, dim_out: int, config: MLPConfig):
        super().__init__()
        self.config = config
        dims = [dim_in] + [config.n_neurons] * config.n_hidden_layers + [dim_out]
        self.n_layers = len(dims) - 1
        for i in range(self.n_layers):
            self.add_module(f"Dense_{i}", nn.Linear(dims[i], dims[i + 1], bias=False,
                                                    dtype=torch.float32))
        self._act = get_activation(config.activation)
        self._out_act = get_activation(config.output_activation)

    def layer(self, i: int) -> nn.Linear:
        return getattr(self, f"Dense_{i}")

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        orig_dtype = x.dtype
        x = x.float()
        for i in range(self.n_layers - 1):
            x = self._act(self.layer(i)(x))
        x = self._out_act(self.layer(self.n_layers - 1)(x))
        return x.to(orig_dtype)


def get_mlp(dim_in: int, dim_out: int, config: Union[Dict[str, Any], MLPConfig]) -> VanillaMLP:
    if isinstance(config, dict):
        config = MLPConfig(**{k: v for k, v in config.items() if k in MLPConfig.__dataclass_fields__})
    if config.otype != "VanillaMLP":
        raise ValueError(f"Unknown MLP type: {config.otype}")
    return VanillaMLP(dim_in, dim_out, config)
