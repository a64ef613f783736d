"""`no-material`: colour = activation(geometry features).

Counterpart of ``triplaneturbo_tpu/models/materials/no_material.py``.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import torch

from ..networks import get_activation


@dataclass
class NoMaterialConfig:
    n_output_dims: int = 3
    color_activation: str = "sigmoid-mipnerf"
    requires_normal: bool = True


class NoMaterial:
    def __init__(self, cfg: Optional[NoMaterialConfig] = None):
        self.cfg = cfg or NoMaterialConfig()
        self.requires_normal = self.cfg.requires_normal
        self._act = get_activation(self.cfg.color_activation)

    def __call__(self, features: torch.Tensor, **kwargs) -> torch.Tensor:
        return self._act(features[..., : self.cfg.n_output_dims])
