"""DDIM sampling schedule and step.

Counterpart of ``triplaneturbo_tpu/models/schedulers.py``: the schedule, the
shifted DDIM timesteps, the deterministic DDIM step, the ancestral DDPM step,
``add_noise`` and the v-target ``velocity`` for training. ``pred_original`` and
``pred_epsilon`` take ᾱ_t itself (:func:`alpha_at` reads it for a timestep)
where the JAX functions take t. The β schedule is computed in float64
numpy and then cast to float32, as the JAX package does, so both packages
hold the same buffers.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import NamedTuple, Optional, Union

import numpy as np
import torch


@dataclass(frozen=True)
class SchedulerConfig:
    num_train_timesteps: int = 1000
    beta_start: float = 0.00085
    beta_end: float = 0.012
    beta_schedule: str = "scaled_linear"
    prediction_type: str = "epsilon"  # "epsilon" | "v_prediction" | "sample"
    steps_offset: int = 1
    set_alpha_to_one: bool = False
    timestep_spacing: str = "leading"


class Schedule(NamedTuple):
    betas: torch.Tensor  # [T] float32
    alphas_cumprod: torch.Tensor  # [T] float32
    final_alpha_cumprod: torch.Tensor  # [] float32
    config: SchedulerConfig


def make_schedule(config: SchedulerConfig = SchedulerConfig(),
                  device: Optional[Union[str, torch.device]] = None) -> Schedule:
    T = config.num_train_timesteps
    if config.beta_schedule == "scaled_linear":
        betas = np.linspace(config.beta_start**0.5, config.beta_end**0.5, T, dtype=np.float64) ** 2
    elif config.beta_schedule == "linear":
        betas = np.linspace(config.beta_start, config.beta_end, T, dtype=np.float64)
    else:
        raise ValueError(f"Unknown beta schedule {config.beta_schedule}")
    alphas_cumprod = np.cumprod(1.0 - betas)
    final = 1.0 if config.set_alpha_to_one else alphas_cumprod[0]

    def f32(a):
        return torch.as_tensor(np.asarray(a, np.float32), device=device)

    return Schedule(betas=f32(betas), alphas_cumprod=f32(alphas_cumprod),
                    final_alpha_cumprod=f32(final), config=config)


def alpha_at(sched: Schedule, t, ndim: int) -> torch.Tensor:
    """ᾱ_t for t ``[]`` or ``[B]``, shaped to broadcast against an ``ndim``-d sample."""
    t = torch.as_tensor(t, dtype=torch.long, device=sched.alphas_cumprod.device)
    a = sched.alphas_cumprod[t]
    return a.reshape(a.shape + (1,) * (ndim - a.ndim))


def add_noise(sched: Schedule, original: torch.Tensor, noise: torch.Tensor, t) -> torch.Tensor:
    """q(x_t | x_0): sqrt(ᾱ_t) x₀ + sqrt(1-ᾱ_t) ε."""
    a = alpha_at(sched, t, original.ndim)
    return torch.sqrt(a) * original + torch.sqrt(1.0 - a) * noise


def velocity(sched: Schedule, sample: torch.Tensor, noise: torch.Tensor, t) -> torch.Tensor:
    """The v-parameterization target: sqrt(ᾱ_t) ε − sqrt(1−ᾱ_t) x₀."""
    a = alpha_at(sched, t, sample.ndim)
    return torch.sqrt(a) * noise - torch.sqrt(1.0 - a) * sample


def pred_original(sched: Schedule, model_output: torch.Tensor, a: torch.Tensor,
                  sample: torch.Tensor) -> torch.Tensor:
    """x̂₀ from the model output; ``a`` is ᾱ_t."""
    p = sched.config.prediction_type
    if p == "epsilon":
        return (sample - torch.sqrt(1.0 - a) * model_output) / torch.sqrt(a)
    if p == "v_prediction":
        return torch.sqrt(a) * sample - torch.sqrt(1.0 - a) * model_output
    if p == "sample":
        return model_output
    raise ValueError(f"Unknown prediction type {p}")


def pred_epsilon(sched: Schedule, model_output: torch.Tensor, a: torch.Tensor,
                 sample: torch.Tensor) -> torch.Tensor:
    p = sched.config.prediction_type
    if p == "epsilon":
        return model_output
    if p == "v_prediction":
        return torch.sqrt(a) * model_output + torch.sqrt(1.0 - a) * sample
    if p == "sample":
        return (sample - torch.sqrt(a) * model_output) / torch.sqrt(1.0 - a)
    raise ValueError(f"Unknown prediction type {p}")


def ddim_timesteps(sched: Schedule, num_inference_steps: int,
                   shift_to_final: bool = True) -> np.ndarray:
    """Inference timesteps ('leading' spacing), shifted so sampling starts at T-1."""
    cfg = sched.config
    T = cfg.num_train_timesteps
    ratio = T // num_inference_steps
    ts = (np.arange(num_inference_steps) * ratio).round()[::-1].astype(np.int64)
    ts = ts + cfg.steps_offset
    if shift_to_final:
        ts = ts + (T - 1 - ts.max())
    return ts


class DDIMStepOutput(NamedTuple):
    prev_sample: torch.Tensor
    pred_original_sample: torch.Tensor


def ddim_step(sched: Schedule, model_output: torch.Tensor, t: int, sample: torch.Tensor,
              num_inference_steps: int) -> DDIMStepOutput:
    """One deterministic DDIM update (η = 0)."""
    T = sched.config.num_train_timesteps
    t = int(t)
    prev_t = t - T // num_inference_steps
    a_t = sched.alphas_cumprod[t]
    a_prev = sched.alphas_cumprod[prev_t] if prev_t >= 0 else sched.final_alpha_cumprod
    x0 = pred_original(sched, model_output, a_t, sample)
    eps = pred_epsilon(sched, model_output, a_t, sample)
    dir_xt = torch.sqrt(torch.clamp(1.0 - a_prev, min=0.0)) * eps
    prev = torch.sqrt(a_prev) * x0 + dir_xt
    return DDIMStepOutput(prev_sample=prev, pred_original_sample=x0)


class DDPMStepOutput(NamedTuple):
    prev_sample: torch.Tensor
    pred_original_sample: torch.Tensor


def ddpm_step(sched: Schedule, model_output: torch.Tensor, t: int, sample: torch.Tensor,
              generator: Optional[torch.Generator] = None,
              noise: Optional[torch.Tensor] = None) -> DDPMStepOutput:
    """One ancestral DDPM update: the posterior mean of x_{t-1} (DDPM eq. 7), plus
    sqrt(posterior variance) times ``noise`` (drawn from ``generator`` when only it is
    given; neither: the mean alone) when t > 0."""
    t = int(t)
    a_t = sched.alphas_cumprod[t]
    a_prev = sched.alphas_cumprod[t - 1] if t > 0 else torch.ones_like(a_t)
    beta_t = sched.betas[t]
    x0 = pred_original(sched, model_output, a_t, sample)
    coef_x0 = torch.sqrt(a_prev) * beta_t / (1.0 - a_t)
    coef_xt = torch.sqrt(1.0 - beta_t) * (1.0 - a_prev) / (1.0 - a_t)
    mean = coef_x0 * x0 + coef_xt * sample
    var = torch.clamp((1.0 - a_prev) / (1.0 - a_t) * beta_t, min=1e-20)
    if noise is None and generator is not None:
        noise = torch.randn(sample.shape, generator=generator, device=generator.device,
                            dtype=sample.dtype).to(sample.device)
    if noise is not None and t > 0:
        mean = mean + torch.sqrt(var) * noise
    return DDPMStepOutput(prev_sample=mean, pred_original_sample=x0)
