"""Attention and transformer blocks of the diffusion UNet.

Counterpart of ``triplaneturbo_tpu/models/attention.py``. Token tensors are
``[N, L, C]``; ``Transformer2D`` takes NCHW feature maps. Attention goes
through :func:`triplaneturbo_torch.ops.flash_attention.attention`, which
keeps the JAX package's gate between the flash kernel and the einsum path.

LoRA placement, as in the JAX package:
  hexa:    the q/k/v adapters see the projection input; the out adapter sees
           the base out-projection output, regrouped ``[N/P, P, L, C]``;
  vanilla: every adapter sees the projection input.
In joint mode the ``(N/G, G·L, C)`` reshape comes after the adapters. Folded
(``lora.Fold``), each projection is one linear layer, per plane for hexa.
Flax's defaults carry over: LayerNorm eps 1e-6, and GEGLU uses the tanh GELU.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.flash_attention import attention as attention_dispatch
from .lora import (
    FoldSite,
    LoRAAdapter,
    PlaneLoRAAdapter,
    fold_lora,
    fold_plane_lora,
    plane_linear,
)
from .unet_blocks import GroupNorm


@dataclass(frozen=True)
class AdapterSpec:
    """Which adapters an attention layer carries."""

    self_lora_type: str = "none"  # "none" | "vanilla" | "basic" | "hexa_v1"
    cross_lora_type: str = "none"
    self_rank: int = 16
    cross_rank: int = 16
    n_planes: int = 6
    with_bias: bool = False
    # joint self-attention across the plane axis (triplanes: 6)
    joint_self_attention: bool = False
    joint_group: int = 6


NO_ADAPTERS = AdapterSpec()


class Attention(FoldSite, nn.Module):
    """Multi-head attention with optional plane LoRA and joint-token mode."""

    def __init__(self, query_dim: int, heads: int, dim_head: int,
                 cross_attention_dim: Optional[int] = None, out_bias: bool = True,
                 qkv_bias: bool = False, adapters: AdapterSpec = NO_ADAPTERS,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.query_dim, self.heads, self.dim_head = query_dim, heads, dim_head
        self.is_cross = cross_attention_dim is not None
        self.adapters = adapters
        inner = heads * dim_head
        ctx_dim = cross_attention_dim if self.is_cross else query_dim
        self.to_q = nn.Linear(query_dim, inner, bias=qkv_bias, dtype=dtype)
        self.to_k = nn.Linear(ctx_dim, inner, bias=qkv_bias, dtype=dtype)
        self.to_v = nn.Linear(ctx_dim, inner, bias=qkv_bias, dtype=dtype)
        self.to_out = nn.Linear(inner, query_dim, bias=out_bias, dtype=dtype)
        self.lora_type = adapters.cross_lora_type if self.is_cross else adapters.self_lora_type
        rank = adapters.cross_rank if self.is_cross else adapters.self_rank
        kw = dict(rank=rank, with_bias=adapters.with_bias)
        if self.lora_type in ("vanilla", "basic"):
            self.lora_q = LoRAAdapter(query_dim, inner, **kw)
            self.lora_k = LoRAAdapter(ctx_dim, inner, **kw)
            self.lora_v = LoRAAdapter(ctx_dim, inner, **kw)
            self.lora_out = LoRAAdapter(inner, query_dim, **kw)
        elif self.lora_type == "hexa_v1":
            P = adapters.n_planes
            self.lora_q = PlaneLoRAAdapter(query_dim, inner, n_planes=P, **kw)
            self.lora_k = PlaneLoRAAdapter(ctx_dim, inner, n_planes=P, **kw)
            self.lora_v = PlaneLoRAAdapter(ctx_dim, inner, n_planes=P, **kw)
            self.lora_out = PlaneLoRAAdapter(query_dim, query_dim, n_planes=P, **kw)
        elif self.lora_type not in ("none", None):
            raise ValueError(f"Unknown lora type {self.lora_type}")

    @property
    def foldable(self) -> bool:
        return self.lora_type in ("vanilla", "basic", "hexa_v1")

    def fold_weights(self):
        """(weight, bias) of q, k, v and out, flat: ``[out, in]`` weights for a
        vanilla LoRA, per-plane ``[P, in, out]`` for hexa."""
        pairs = ((self.to_q, self.lora_q), (self.to_k, self.lora_k),
                 (self.to_v, self.lora_v), (self.to_out, self.lora_out))
        if self.lora_type == "hexa_v1":
            return sum((fold_plane_lora(base, lora, on_output=base is self.to_out)
                        for base, lora in pairs), ())
        return sum((fold_lora(base, lora) for base, lora in pairs), ())

    def _with_lora(self, base: nn.Linear, lora: Optional[nn.Module], x: torch.Tensor,
                   folded: Optional[tuple] = None) -> torch.Tensor:
        if folded is not None:
            w, b = folded
            return plane_linear(x, w, b) if w.ndim == 3 else F.linear(x, w, b)
        y = base(x)
        if self.lora_type in ("vanilla", "basic"):
            return y + lora(x)
        if self.lora_type == "hexa_v1":
            N, L, C = x.shape
            P = self.adapters.n_planes
            return y + lora(x.reshape(N // P, P, L, C)).reshape(N, L, -1)
        return y

    def forward(self, hidden_states: torch.Tensor,
                encoder_hidden_states: Optional[torch.Tensor] = None) -> torch.Tensor:
        inner = self.heads * self.dim_head
        N, L, _ = hidden_states.shape
        ctx = hidden_states if encoder_hidden_states is None else encoder_hidden_states
        f = self.folded_now()
        fq, fk, fv, fo = (None,) * 4 if f is None else (f[0:2], f[2:4], f[4:6], f[6:8])
        q = self._with_lora(self.to_q, getattr(self, "lora_q", None), hidden_states, fq)
        k = self._with_lora(self.to_k, getattr(self, "lora_k", None), ctx, fk)
        v = self._with_lora(self.to_v, getattr(self, "lora_v", None), ctx, fv)

        joint = not self.is_cross and self.adapters.joint_self_attention
        if joint:
            G = self.adapters.joint_group
            q = q.reshape(N // G, G * L, inner)
            k = k.reshape(N // G, G * k.shape[1], inner)
            v = v.reshape(N // G, G * v.shape[1], inner)

        def split_heads(t):
            return t.reshape(t.shape[0], t.shape[1], self.heads, self.dim_head)

        attn_out = attention_dispatch(split_heads(q), split_heads(k), split_heads(v))
        attn_out = attn_out.reshape(attn_out.shape[0], attn_out.shape[1], inner)
        if joint:
            attn_out = attn_out.reshape(N, L, inner)

        if fo is not None:
            return self._with_lora(self.to_out, None, attn_out, fo)
        out = self.to_out(attn_out)
        if self.lora_type in ("vanilla", "basic"):
            out = out + self.lora_out(attn_out)
        elif self.lora_type == "hexa_v1":
            P = self.adapters.n_planes
            op = out.reshape(N // P, P, L, self.query_dim)
            out = out + self.lora_out(op).reshape(N, L, self.query_dim)
        return out


class GEGLU(nn.Module):
    def __init__(self, dim_in: int, dim_out: int, dtype: torch.dtype):
        super().__init__()
        self.proj = nn.Linear(dim_in, dim_out * 2, dtype=dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h, gate = self.proj(x).chunk(2, dim=-1)
        return h * F.gelu(gate, approximate="tanh")


class FeedForward(nn.Module):
    def __init__(self, dim: int, mult: int = 4, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.net_0 = GEGLU(dim, dim * mult, dtype)
        self.net_2 = nn.Linear(dim * mult, dim, dtype=dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.net_2(self.net_0(x))


class BasicTransformerBlock(nn.Module):
    """LN -> self-attn -> LN -> cross-attn -> LN -> FF, all residual."""

    def __init__(self, dim: int, heads: int, dim_head: int, cross_attention_dim: int,
                 adapters: AdapterSpec = NO_ADAPTERS, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.norm1 = nn.LayerNorm(dim, eps=1e-6, dtype=dtype)
        self.attn1 = Attention(dim, heads, dim_head, adapters=adapters, dtype=dtype)
        self.norm2 = nn.LayerNorm(dim, eps=1e-6, dtype=dtype)
        self.attn2 = Attention(dim, heads, dim_head, cross_attention_dim=cross_attention_dim,
                               adapters=adapters, dtype=dtype)
        self.norm3 = nn.LayerNorm(dim, eps=1e-6, dtype=dtype)
        self.ff = FeedForward(dim, dtype=dtype)

    def forward(self, x: torch.Tensor, context: torch.Tensor):
        x = x + self.attn1(self.norm1(x))
        x = x + self.attn2(self.norm2(x), encoder_hidden_states=context)
        return x + self.ff(self.norm3(x))


class Transformer2D(nn.Module):
    """GroupNorm -> linear proj in -> blocks -> proj out, plus the residual (NCHW)."""

    def __init__(self, channels: int, heads: int, dim_head: int, depth: int,
                 cross_attention_dim: int, adapters: AdapterSpec = NO_ADAPTERS,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        C = channels
        inner = heads * dim_head
        self.depth = depth
        # the JAX module's own group rule (not _n_groups): 32 when it divides C, else 1
        groups = min(32, C) if C % min(32, C) == 0 else 1
        self.norm = GroupNorm(groups, C, eps=1e-6, dtype=dtype)
        self.proj_in = nn.Linear(C, inner, dtype=dtype)
        for i in range(depth):
            self.add_module(f"transformer_blocks_{i}", BasicTransformerBlock(
                inner, heads, dim_head, cross_attention_dim, adapters=adapters, dtype=dtype))
        self.proj_out = nn.Linear(inner, C, dtype=dtype)

    def forward(self, x: torch.Tensor, context: torch.Tensor):
        N, C, H, W = x.shape
        h = self.norm(x).permute(0, 2, 3, 1).reshape(N, H * W, C)
        h = self.proj_in(h)
        for i in range(self.depth):
            h = getattr(self, f"transformer_blocks_{i}")(h, context)
        h = self.proj_out(h).reshape(N, H, W, C).permute(0, 3, 1, 2)
        return h + x
