"""Adan (Adaptive Nesterov Momentum) and the numerical armor around it.

Counterpart of ``triplaneturbo_tpu/systems/optimizers.py`` without optax.
Update rule (Xie et al. 2022, bias-corrected):

  m_k = (1-β1) m_{k-1} + β1 g_k
  v_k = (1-β2) v_{k-1} + β2 (g_k - g_{k-1})          (the first difference is 0)
  n_k = (1-β3) n_{k-1} + β3 [g_k + (1-β2)(g_k - g_{k-1})]²
  update = (m̂ + (1-β2) v̂) / (sqrt(n̂) + eps)         (eps after the square root)
  θ = θ - lr · (update + wd · θ)

:class:`GuardedAdan` adds, from the outside in: a finiteness gate that skips
a non-finite gradient batch and counts it, accumulation over k calls as a
running mean that changes nothing in mid-cycle, and an optional global-norm
clip on the accumulated gradient.
"""

from __future__ import annotations

from typing import Iterable, List, Optional, Sequence, Tuple

import numpy as np
import torch


class Adan(torch.optim.Optimizer):
    """Adan over ``params``; a parameter without ``.grad`` counts as a zero gradient,
    so every parameter's moments decay each step, as in a functional update."""

    def __init__(self, params: Iterable[torch.nn.Parameter], lr: float = 2e-4,
                 betas: Tuple[float, float, float] = (0.98, 0.92, 0.99), eps: float = 1e-15,
                 weight_decay: float = 0.0):
        super().__init__(params, dict(lr=lr, betas=tuple(betas), eps=eps,
                                      weight_decay=weight_decay))
        self.count = 0  # steps taken, shared by all parameters

    @torch.no_grad()
    def step(self, closure=None):
        if closure is not None:
            raise ValueError("Adan takes no closure")
        first = self.count == 0
        self.count += 1
        cf = np.float32(self.count)
        for group in self.param_groups:
            b1, b2, b3 = group["betas"]
            # the three bias corrections, in f32 as the JAX transformation computes them
            bc1, bc2, bc3 = (float(np.float32(1) - np.float32(1 - b) ** cf) for b in (b1, b2, b3))
            for p in group["params"]:
                g = p.grad if p.grad is not None else torch.zeros_like(p)
                st = self.state[p]
                if not st:
                    for key in ("m", "v", "n", "prev_grad"):
                        st[key] = torch.zeros_like(p)
                gd = torch.zeros_like(g) if first else g - st["prev_grad"]
                st["m"].mul_(1 - b1).add_(g, alpha=b1)
                st["v"].mul_(1 - b2).add_(gd, alpha=b2)
                st["n"].mul_(1 - b3).add_((g + (1 - b2) * gd) ** 2, alpha=b3)
                st["prev_grad"] = g.clone()
                denom = torch.sqrt(st["n"] / bc3) + group["eps"]
                update = (st["m"] / bc1 + (1 - b2) * st["v"] / bc2) / denom
                if group["weight_decay"] > 0:
                    update = update + group["weight_decay"] * p
                p.add_(update, alpha=-group["lr"])


class GuardedAdan:
    """Adan behind the clip, the accumulation and the finiteness gate: the
    counterpart of the JAX package's ``guarded_adan``, with its arguments.

    ``step(grads)`` takes one gradient per parameter, in the parameters' order.
    ``total_notfinite`` counts the batches the gate has skipped.
    """

    # after this many non-finite batches in a row the gate lets the update through
    MAX_CONSECUTIVE_ERRORS = 10_000

    def __init__(self, params: Iterable[torch.nn.Parameter], learning_rate: float = 2e-4,
                 betas: Tuple[float, float, float] = (0.98, 0.92, 0.99), eps: float = 1e-15,
                 weight_decay: float = 0.0, grad_clip_norm: Optional[float] = None,
                 accumulation_steps: int = 1, skip_nonfinite: bool = True):
        self.params: List[torch.nn.Parameter] = list(params)
        self.adan = Adan(self.params, learning_rate, betas, eps, weight_decay)
        self.grad_clip_norm = grad_clip_norm
        self.accumulation_steps = accumulation_steps
        self.skip_nonfinite = skip_nonfinite
        self.mini_step = 0
        self.acc_grads: Optional[List[torch.Tensor]] = None
        self.notfinite_count = 0
        self.total_notfinite = 0

    @torch.no_grad()
    def step(self, grads: Sequence[torch.Tensor]) -> bool:
        """One call of the guarded update; True when the parameters were updated."""
        if len(grads) != len(self.params):
            raise ValueError(f"{len(grads)} gradients for {len(self.params)} parameters")
        if self.skip_nonfinite:
            finite = bool(torch.stack([torch.isfinite(g).all() for g in grads]).all())
            if finite:
                self.notfinite_count = 0
            else:
                self.notfinite_count += 1
                self.total_notfinite += 1
                if self.notfinite_count <= self.MAX_CONSECUTIVE_ERRORS:
                    return False
        if self.accumulation_steps > 1:
            # running mean over the cycle; nothing else moves before its last call
            if self.acc_grads is None:
                self.acc_grads = [torch.zeros_like(g) for g in grads]
            for acc, g in zip(self.acc_grads, grads):
                acc.add_((g - acc) / (self.mini_step + 1))
            if self.mini_step < self.accumulation_steps - 1:
                self.mini_step += 1
                return False
            grads, self.acc_grads, self.mini_step = self.acc_grads, None, 0
        if self.grad_clip_norm is not None:
            norm = torch.sqrt(sum((g.float() ** 2).sum() for g in grads))
            if not bool(norm < self.grad_clip_norm):
                grads = [(g / norm.to(g.dtype)) * self.grad_clip_norm for g in grads]
        for p, g in zip(self.params, grads):
            p.grad = g
        self.adan.step()
        for p in self.params:
            p.grad = None
        return True
