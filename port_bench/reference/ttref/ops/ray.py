"""Dense ray-marching primitives: a fixed number of samples a ray.

Counterpart of ``triplaneturbo_tpu/ops/ray.py``. Every ray carries the same
number of samples, so weights, transmittance and accumulation are dense
``[n_rays, n_samples]`` cumulative products, sums and weighted sums.

Randomness is an explicit tensor: ``sample_pdf`` takes its stratified jitter
``u_jitter`` (uniform in [0, 1), one row a ray), and ``importance_sampling``
takes the two jitters of its two levels or a ``torch.Generator`` that draws
them (:func:`draw_jitter`). Without either, both levels take midpoints.
"""

from __future__ import annotations

from typing import Callable, Optional, Tuple, Union

import torch

Jitter = Tuple[torch.Tensor, torch.Tensor]


def render_weight_from_alpha(alpha: torch.Tensor) -> torch.Tensor:
    """alpha [Nr, Ns] -> volume-rendering weights w_i = a_i * prod_{j<i}(1 - a_j)."""
    t = torch.cumprod(1.0 - alpha + 1e-10, dim=-1)
    trans = torch.cat([torch.ones_like(t[..., :1]), t[..., :-1]], dim=-1)
    return alpha * trans


def accumulate_along_rays(weights: torch.Tensor, values: Optional[torch.Tensor] = None
                          ) -> torch.Tensor:
    """weights [Nr, Ns] (and values [Nr, Ns, C]) -> [Nr, C], or the opacity [Nr, 1]."""
    if values is None:
        return weights.sum(-1, keepdim=True)
    return torch.einsum("rs,rsc->rc", weights, values)


def render_transmittance_from_density(t_starts: torch.Tensor, t_ends: torch.Tensor,
                                      sigmas: torch.Tensor) -> torch.Tensor:
    """T_i = exp(-sum_{j<i} sigma_j * dt_j), dense [Nr, Ns]."""
    acc = torch.cumsum((t_ends - t_starts) * sigmas, dim=-1)
    acc = torch.cat([torch.zeros_like(acc[..., :1]), acc[..., :-1]], dim=-1)
    return torch.exp(-acc)


def pdf_interval(cdfs: torch.Tensor, u: torch.Tensor) -> torch.Tensor:
    """For each u [Nr, n] the index of the first CDF value above it, clamped to
    [0, K]: ``searchsorted(side="right")`` on the monotone rows of cdfs [Nr, K+1]."""
    idx = torch.searchsorted(cdfs.contiguous(), u.contiguous(), right=True)
    return idx.clamp(0, cdfs.shape[-1] - 1)


def sample_pdf(bins: torch.Tensor, cdfs: torch.Tensor, n_samples: int,
               u_jitter: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Inverse-CDF sampling of ``n_samples + 1`` interval boundaries.

    bins [Nr, K+1] monotone boundaries, cdfs [Nr, K+1] the CDF at them (0 first,
    1 last); u_jitter [Nr, n_samples + 1] stratified jitter, or None for the
    midpoints of the strata. Returns [Nr, n_samples + 1] boundaries.
    """
    Nr = bins.shape[0]
    n = n_samples + 1
    strata = torch.arange(n, device=bins.device, dtype=bins.dtype)
    if u_jitter is not None:
        u = (strata + u_jitter) / n
    else:
        u = ((strata + 0.5) / n).expand(Nr, n)
    u = torch.clamp(u, 1e-7, 1.0 - 1e-7)
    idx1 = pdf_interval(cdfs, u)
    idx0 = (idx1 - 1).clamp_min(0)
    c1, c0 = cdfs.gather(-1, idx1), cdfs.gather(-1, idx0)
    b1, b0 = bins.gather(-1, idx1), bins.gather(-1, idx0)
    denom = torch.where(torch.abs(c1 - c0) < 1e-12, torch.ones_like(c1), c1 - c0)
    t = torch.clamp((u - c0) / denom, 0.0, 1.0)
    return b0 + t * (b1 - b0)


def draw_jitter(n_rays: int, num_prop_samples: int, num_fine_samples: int,
                generator: torch.Generator, device: Union[str, torch.device] = "cpu") -> Jitter:
    """The two stratified jitters of :func:`importance_sampling`, uniform in [0, 1):
    [n_rays, num_prop + 1] and [n_rays, num_fine + 1]."""
    return (torch.rand((n_rays, num_prop_samples + 1), generator=generator, device=device),
            torch.rand((n_rays, num_fine_samples + 1), generator=generator, device=device))


def importance_sampling(prop_sigma_fn: Callable[[torch.Tensor, torch.Tensor], torch.Tensor],
                        n_rays: int, num_prop_samples: int, num_fine_samples: int,
                        near: float, far: float, jitter: Optional[Jitter] = None,
                        generator: Optional[torch.Generator] = None,
                        device: Union[str, torch.device] = "cpu"
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Proposal-based sampling: uniform CDF -> proposal intervals -> proposal
    density (no gradient) -> CDF from the transmittance -> fine intervals ->
    the merged, sorted boundaries of both.

    ``jitter`` holds the two levels' stratified jitters; without it a
    ``generator`` draws them, and without either both levels take midpoints.
    Returns (t_starts, t_ends), each [n_rays, num_prop + num_fine + 1].
    """
    if jitter is None and generator is not None:
        jitter = draw_jitter(n_rays, num_prop_samples, num_fine_samples, generator, device)
    u1, u2 = jitter if jitter is not None else (None, None)

    unit = torch.tensor([0.0, 1.0], device=device).expand(n_rays, 2)
    s_vals = sample_pdf(unit, unit, num_prop_samples, u1)  # [Nr, P+1]
    t_vals = near + s_vals * (far - near)

    t_starts, t_ends = t_vals[..., :-1], t_vals[..., 1:]
    sigmas = prop_sigma_fn(t_starts, t_ends).detach()
    trans = render_transmittance_from_density(t_starts, t_ends, sigmas)
    # the CDF over the proposal boundaries: 1 - T, with a trailing 1
    cdf = 1.0 - torch.cat([trans, torch.zeros_like(trans[..., :1])], dim=-1)
    s_fine = sample_pdf(s_vals, cdf, num_fine_samples, u2)
    t_fine = near + s_fine * (far - near)

    t_all = torch.sort(torch.cat([t_vals, t_fine], dim=-1), dim=-1).values
    return t_all[..., :-1], t_all[..., 1:]


def neus_alpha(sdf: torch.Tensor, normal: torch.Tensor, dirs: torch.Tensor,
               dists: torch.Tensor, inv_std: torch.Tensor,
               cos_anneal_ratio: float = 1.0) -> torch.Tensor:
    """NeuS sigmoid-CDF alpha: sdf [..., 1], normal and dirs [..., 3], dists
    [..., 1] -> alpha [..., 1]."""
    true_cos = (dirs * normal).sum(-1, keepdim=True)
    iter_cos = -(torch.relu(-true_cos * 0.5 + 0.5) * (1.0 - cos_anneal_ratio)
                 + torch.relu(-true_cos) * cos_anneal_ratio)
    est_next = sdf + iter_cos * dists * 0.5
    est_prev = sdf - iter_cos * dists * 0.5
    prev_cdf = torch.sigmoid(est_prev * inv_std)
    next_cdf = torch.sigmoid(est_next * inv_std)
    p = prev_cdf - next_cdf
    c = prev_cdf
    return torch.clamp((p + 1e-5) / (c + 1e-5), 0.0, 1.0)


def volsdf_density(sdf: torch.Tensor, inv_std: torch.Tensor) -> torch.Tensor:
    """Laplace-CDF density of VolSDF, inv_std clamped to [0, 80]."""
    inv_std = torch.clamp(inv_std, 0.0, 80.0)
    beta = 1.0 / inv_std
    return inv_std * (0.5 + 0.5 * torch.sign(sdf) * torch.expm1(-torch.abs(sdf) / beta))


def neus_density_from_sdf(sdf: torch.Tensor, inv_std: torch.Tensor, step_size: float
                          ) -> torch.Tensor:
    """The proposal density: NeuS alpha at a fixed step, over the step."""
    est_next = sdf - step_size * 0.5
    est_prev = sdf + step_size * 0.5
    prev_cdf = torch.sigmoid(est_prev * inv_std)
    next_cdf = torch.sigmoid(est_next * inv_std)
    alpha = torch.clamp((prev_cdf - next_cdf + 1e-5) / (prev_cdf + 1e-5), 0.0, 1.0)
    return alpha / step_size
