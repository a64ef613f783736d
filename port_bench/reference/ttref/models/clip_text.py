"""CLIP text encoder: the SD-2.1 prompt tower (OpenCLIP ViT-H text, by default).

Counterpart of ``triplaneturbo_tpu/models/clip_text.py``: pre-LN causal
transformer over token ids, returning per-token states and the state at the
first EOS. Causal mask at -1e9; LayerNorm eps ``cfg.eps``. The default is the
OpenCLIP-H tower with the exact GELU; :func:`sd15_text_config` is the SD-1.5
tower (width 768, 12 layers, quick GELU) of RichDreamer's text space. Its
attention is plain PyTorch (causal, 77 tokens), not the flash kernel.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Tuple

import torch
import torch.nn.functional as F
from torch import nn


@dataclass(frozen=True)
class CLIPTextConfig:
    vocab_size: int = 49408
    width: int = 1024
    layers: int = 23
    heads: int = 16
    intermediate: int = 4096
    max_length: int = 77
    hidden_act: str = "gelu"  # the SD-1.5 tower uses "quick_gelu"
    eps: float = 1e-5
    eos_token_id: int = 49407


def sd15_text_config() -> CLIPTextConfig:
    return CLIPTextConfig(width=768, layers=12, heads=12, intermediate=3072,
                          hidden_act="quick_gelu")


def hidden_act(name: str, x: torch.Tensor) -> torch.Tensor:
    """The MLP activation: exact GELU, or quick GELU x * sigmoid(1.702 x)."""
    if name == "gelu":
        return F.gelu(x, approximate="none")
    if name == "quick_gelu":
        return x * torch.sigmoid(1.702 * x)
    raise ValueError(name)


class CLIPAttention(nn.Module):
    def __init__(self, cfg: CLIPTextConfig):
        super().__init__()
        self.cfg = cfg
        w = cfg.width
        self.q_proj = nn.Linear(w, w)
        self.k_proj = nn.Linear(w, w)
        self.v_proj = nn.Linear(w, w)
        self.out_proj = nn.Linear(w, w)

    def forward(self, x: torch.Tensor, causal_mask: torch.Tensor) -> torch.Tensor:
        c = self.cfg
        B, L, _ = x.shape
        head_dim = c.width // c.heads

        def split(t):
            return t.reshape(B, L, c.heads, head_dim)

        qh, kh, vh = split(self.q_proj(x)), split(self.k_proj(x)), split(self.v_proj(x))
        scores = torch.einsum("bqhd,bkhd->bhqk", qh, kh) / math.sqrt(head_dim)
        scores = torch.where(causal_mask, scores, torch.full_like(scores, -1e9))
        probs = torch.softmax(scores.float(), dim=-1).to(qh.dtype)
        out = torch.einsum("bhqk,bkhd->bqhd", probs, vh).reshape(B, L, c.width)
        return self.out_proj(out)


class CLIPLayer(nn.Module):
    def __init__(self, cfg: CLIPTextConfig):
        super().__init__()
        self.act = cfg.hidden_act
        self.layer_norm1 = nn.LayerNorm(cfg.width, eps=cfg.eps)
        self.self_attn = CLIPAttention(cfg)
        self.layer_norm2 = nn.LayerNorm(cfg.width, eps=cfg.eps)
        self.mlp_fc1 = nn.Linear(cfg.width, cfg.intermediate)
        self.mlp_fc2 = nn.Linear(cfg.intermediate, cfg.width)

    def forward(self, x: torch.Tensor, causal_mask: torch.Tensor) -> torch.Tensor:
        x = x + self.self_attn(self.layer_norm1(x), causal_mask)
        h = self.mlp_fc2(hidden_act(self.act, self.mlp_fc1(self.layer_norm2(x))))
        return x + h


class CLIPTextEncoder(nn.Module):
    """float32 whatever the UNet's dtype, as the JAX pipeline runs it."""

    def __init__(self, cfg: CLIPTextConfig = CLIPTextConfig()):
        super().__init__()
        self.cfg = cfg
        self.token_embedding = nn.Embedding(cfg.vocab_size, cfg.width)
        self.position_embedding = nn.Parameter(torch.empty(cfg.max_length, cfg.width))
        for i in range(cfg.layers):
            self.add_module(f"layers_{i}", CLIPLayer(cfg))
        self.final_layer_norm = nn.LayerNorm(cfg.width, eps=cfg.eps)

    def forward(self, input_ids: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        """input_ids [B, L] -> (last hidden [B, L, W], pooled [B, W]), float32.

        Pooling takes the first EOS position (HF CLIPTextModel semantics).
        """
        c = self.cfg
        B, L = input_ids.shape
        x = self.token_embedding(input_ids) + self.position_embedding[None, :L]
        causal = torch.ones(L, L, dtype=torch.bool, device=input_ids.device).tril()[None, None]
        for i in range(c.layers):
            x = getattr(self, f"layers_{i}")(x, causal)
        x = self.final_layer_norm(x)
        eos_pos = (input_ids == c.eos_token_id).int().argmax(dim=-1)
        pooled = x[torch.arange(B, device=x.device), eos_pos]
        return x.float(), pooled.float()
