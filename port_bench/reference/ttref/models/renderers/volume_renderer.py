"""NeuS SDF volume renderer over generative triplane spaces, the second renderer.

Counterpart of ``triplaneturbo_tpu/models/renderers/volume_renderer.py``:
proposal-based importance sampling (uniform CDF -> NeuS density -> resample),
the NeuS sigmoid-CDF alpha with a learned inverse standard deviation, the
weights and their accumulations, the z-variance, the RichDreamer disparity, the
eikonal, orientation and |sdf| terms, and the camera-space normal images. Every
ray carries the same number of samples (:mod:`triplaneturbo_torch.ops.ray`).

The field with normals is evaluated in chunks of ``field_chunk`` samples a
view. Where gradients flow, each chunk keeps only its inputs and is evaluated
again in the backward (the JAX package's ``jax.checkpoint``), by
:class:`_RecomputeInBackward`: ``torch.utils.checkpoint`` would run the chunk
twice in the forward, since the normals' own backward inside it asks for the
tensors the checkpoint dropped.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable, Dict, List, Optional, Sequence, Union

import torch
import torch.nn.functional as F
from torch import nn
from torch.autograd.function import once_differentiable

from ...ops.ray import (
    Jitter,
    accumulate_along_rays,
    draw_jitter,
    importance_sampling,
    neus_alpha,
    neus_density_from_sdf,
    render_weight_from_alpha,
    volsdf_density,
)
from ...utils.ops import safe_normalize


@dataclass
class VolumeRendererConfig:
    radius: float = 1.0
    # final samples a ray, and proposal samples a ray
    num_samples_per_ray: int = 64
    num_samples_per_ray_importance: int = 128
    near_plane: float = 0.1
    far_plane: float = 4.0
    learned_variance_init: float = 0.4605170185988091  # log(100) / 10
    trainable_variance: bool = True
    cos_anneal_ratio: float = 1.0
    use_volsdf: bool = False
    rgb_grad_shrink: float = 1.0
    normal_direction: str = "camera"  # "camera" | "world" | "front"
    randomized: bool = True
    # > 0: evaluate the field with normals over the ray samples in chunks of this
    # many samples a view, each evaluated again in the backward; 0: one call
    field_chunk: int = 0


class _RecomputeInBackward(torch.autograd.Function):
    """``field_fn(points, True)``'s tensors, keeping only the inputs: the
    backward evaluates the chunk again with grad on (so the field keeps the
    graph of its normals) and takes the gradients of ``inputs``, the tensors
    that ``field_fn`` reads and gradients flow to."""

    @staticmethod
    def forward(ctx, field_fn, keys: List[str], points, *inputs):
        ctx.field_fn = field_fn
        ctx.save_for_backward(points, *inputs)
        ctx.set_materialize_grads(False)
        out = field_fn(points, True)
        keys.extend(out)
        ctx.keys = list(out)
        return tuple(out[k].detach() for k in ctx.keys)

    @staticmethod
    @once_differentiable
    def backward(ctx, *grads):
        points, *inputs = ctx.saved_tensors
        with torch.enable_grad():
            out = ctx.field_fn(points, True)
        pairs = [(out[k], g) for k, g in zip(ctx.keys, grads)
                 if g is not None and out[k].requires_grad]
        if not pairs:
            return (None, None, None) + (None,) * len(inputs)
        wanted = [x for x, need in zip(inputs, ctx.needs_input_grad[3:]) if need]
        got = iter(torch.autograd.grad([o for o, _ in pairs], wanted, [g for _, g in pairs],
                                       allow_unused=True))
        return (None, None, None) + tuple(next(got) if need else None
                                          for need in ctx.needs_input_grad[3:])


def _field_with_normal(field_fn: Callable, points: torch.Tensor, chunk: int,
                       inputs: Sequence[torch.Tensor]) -> Dict[str, torch.Tensor]:
    """``field_fn(points [B, M, 3], True)`` over chunks of ``chunk`` samples along M
    (the tail padded with zeros), each recomputed in the backward where grad is on
    and ``inputs`` are given."""
    inputs = [x for x in inputs if x.requires_grad]

    def one(p):
        if torch.is_grad_enabled() and inputs:
            keys: List[str] = []
            vals = _RecomputeInBackward.apply(field_fn, keys, p, *inputs)
            return dict(zip(keys, vals))
        return field_fn(p, True)

    M = points.shape[1]
    if not chunk or M <= chunk:
        return one(points)
    n_chunks = -(-M // chunk)
    padded = F.pad(points, (0, 0, 0, n_chunks * chunk - M))
    outs = [one(p) for p in padded.split(chunk, dim=1)]
    return {k: torch.cat([o[k] for o in outs], dim=1)[:, :M] for k in outs[0]}


class GenerativeSpaceSDFVolumeRenderer(nn.Module):
    """Owns the learned ``variance_inv_std``; the field and background closures
    carry the other weights."""

    def __init__(self, cfg: Optional[VolumeRendererConfig] = None):
        super().__init__()
        self.cfg = cfg or VolumeRendererConfig()
        self.variance_inv_std = nn.Parameter(torch.tensor(self.cfg.learned_variance_init))

    @property
    def render_step_size(self) -> float:
        return 1.732 * 2 * self.cfg.radius / self.cfg.num_samples_per_ray

    def draw_jitter(self, n_rays: int, generator: torch.Generator,
                    device: Union[str, torch.device] = "cpu") -> Jitter:
        """The stratified jitters of one render of ``n_rays`` rays."""
        c = self.cfg
        return draw_jitter(n_rays, c.num_samples_per_ray_importance, c.num_samples_per_ray,
                           generator, device)

    def forward(self, rays_o: torch.Tensor, rays_d: torch.Tensor, field_fn: Callable,
                background_fn: Callable, camera_distances: Optional[torch.Tensor] = None,
                c2w: Optional[torch.Tensor] = None, text_embed: Optional[torch.Tensor] = None,
                bg_color: Optional[torch.Tensor] = None, jitter: Optional[Jitter] = None,
                train: bool = True, rgb_grad_shrink: Optional[float] = None,
                field_inputs: Sequence[torch.Tensor] = ()) -> Dict[str, Any]:
        """Render views from rays_o, rays_d [B, H, W, 3].

        ``field_fn(points [B, M, 3], mode)`` returns a dict: mode True ``sdf``
        [B, M, 1], ``features`` [B, M, C], ``normal`` [B, M, 3] and optionally
        ``sdf_grad``, keeping the graph of the normals when grad is on; mode
        "sdf" at least ``sdf`` (the proposal pass, run without grad).
        ``background_fn(dirs [B, H, W, 3], text_embed)`` -> colour. ``jitter``
        holds the sampler's stratified draws (used when ``train`` and
        ``randomized``; midpoints otherwise). ``field_inputs`` are the tensors
        ``field_fn`` reads that gradients flow to (the field's weights, the
        space cache): given them, each chunk of the field with normals keeps
        only its inputs and is evaluated again in the backward.
        """
        cfg = self.cfg
        B, H, W, _ = rays_o.shape
        n_rays = B * H * W
        ro = rays_o.reshape(n_rays, 3)
        rd = rays_d.reshape(n_rays, 3)

        inv_std_param = self.variance_inv_std
        if not cfg.trainable_variance:
            inv_std_param = inv_std_param.detach()
        inv_std = torch.clamp(torch.exp(inv_std_param * 10.0), 1e-6, 1e6)
        step = self.render_step_size

        def prop_sigma_fn(t_starts, t_ends):
            # the proposal density needs only the SDF, and no gradient
            mid = (t_starts + t_ends) * 0.5
            pts = ro[:, None, :] + rd[:, None, :] * mid[..., None]
            with torch.no_grad():
                sdf = field_fn(pts.reshape(B, -1, 3), "sdf")["sdf"].reshape(n_rays, -1)
                if cfg.use_volsdf:
                    return volsdf_density(sdf, inv_std)
                return neus_density_from_sdf(sdf, inv_std, step)

        t_starts, t_ends = importance_sampling(
            prop_sigma_fn, n_rays, cfg.num_samples_per_ray_importance, cfg.num_samples_per_ray,
            cfg.near_plane, cfg.far_plane,
            jitter=jitter if (train and cfg.randomized) else None, device=rays_o.device)
        S = t_starts.shape[-1]
        t_mid = (t_starts + t_ends) * 0.5  # [Nr, S]
        t_intervals = (t_ends - t_starts)[..., None]
        positions = ro[:, None, :] + rd[:, None, :] * t_mid[..., None]

        geo = _field_with_normal(field_fn, positions.reshape(B, -1, 3), cfg.field_chunk,
                                 field_inputs)
        sdf = geo["sdf"].reshape(n_rays, S, 1)
        normal = geo["normal"].reshape(n_rays, S, 3)
        rgb_fg = geo["features"].reshape(n_rays, S, -1)

        shrink = cfg.rgb_grad_shrink if rgb_grad_shrink is None else rgb_grad_shrink
        rgb_fg = shrink * rgb_fg + (1.0 - shrink) * rgb_fg.detach()

        dirs = rd[:, None, :].expand(normal.shape)
        alpha = neus_alpha(sdf, normal, dirs, t_intervals, inv_std, cfg.cos_anneal_ratio)

        weights = render_weight_from_alpha(alpha[..., 0])  # [Nr, S]
        opacity = accumulate_along_rays(weights)  # [Nr, 1]
        depth = accumulate_along_rays(weights, t_mid[..., None])
        comp_rgb_fg = accumulate_along_rays(weights, rgb_fg)
        z_variance = accumulate_along_rays(weights, (t_mid[..., None] - depth[:, None, :]) ** 2)

        comp_rgb_bg = background_fn(rays_d, text_embed)
        if bg_color is None:
            bg = comp_rgb_bg.reshape(n_rays, -1)
        else:
            bg = bg_color.reshape(n_rays, -1) if bg_color.ndim >= 3 else bg_color
        comp_rgb = comp_rgb_fg + bg * (1.0 - opacity)

        out: Dict[str, Any] = {
            "comp_rgb": comp_rgb.reshape(B, H, W, -1),
            "comp_rgb_fg": comp_rgb_fg.reshape(B, H, W, -1),
            "comp_rgb_bg": comp_rgb_bg.reshape(B, H, W, -1),
            "opacity": opacity.reshape(B, H, W, 1),
            "depth": depth.reshape(B, H, W, 1),
            "z_variance": z_variance.reshape(B, H, W, 1),
            "inv_std": inv_std,
        }

        if camera_distances is not None:  # RichDreamer disparity
            far = camera_distances.reshape(-1, 1, 1, 1) + 3.0 ** 0.5
            near = camera_distances.reshape(-1, 1, 1, 1) - 3.0 ** 0.5
            d_img, o_img = out["depth"], out["opacity"]
            disparity_tmp = d_img * o_img + (1.0 - o_img) * far
            out["disparity"] = torch.clamp((far - disparity_tmp) / (far - near), 0.0, 1.0)

        if "sdf_grad" in geo:
            sg = geo["sdf_grad"].reshape(n_rays, S, 3)
            # eps inside the max: the norm's backward is 0/0 at an exactly zero SDF
            # gradient, which the field has wherever it is constant
            sg_norm = torch.sqrt(torch.clamp_min((sg * sg).sum(-1), 1e-24))
            out["eikonal"] = ((sg_norm - 1.0) ** 2).mean()
        cos = (normal * dirs).sum(-1)
        out["orient"] = (weights.detach() * torch.clamp_min(cos, 0.0) ** 2).sum() / torch.clamp_min(
            (opacity > 0).sum(), 1)
        out["sdf_abs"] = torch.abs(sdf).mean()

        # empty rays accumulate an exactly zero normal: safe_normalize keeps its backward finite
        comp_normal = safe_normalize(accumulate_along_rays(weights, normal))
        out["comp_normal"] = comp_normal.reshape(B, H, W, 3)

        if cfg.normal_direction == "camera" and c2w is not None:
            w2c = c2w[:, :3, :3].transpose(-1, -2)  # rigid: the inverse rotation is the transpose
            n_cam = torch.einsum("bnc,bkc->bnk", comp_normal.reshape(B, -1, 3), w2c)
            n_cam = (n_cam * torch.tensor([-1.0, 1.0, 1.0], device=n_cam.device)).reshape(n_rays, 3)
            bg_normal = torch.tensor([0.5, 0.5, 1.0], device=n_cam.device)
            vis = (n_cam + 1.0) / 2.0 * opacity + (1.0 - opacity) * bg_normal
            vis_white = (n_cam + 1.0) / 2.0 * opacity + (1.0 - opacity)
            out["comp_normal_cam_vis"] = vis.reshape(B, H, W, 3)
            out["comp_normal_cam_vis_white"] = vis_white.reshape(B, H, W, 3)
        return out
