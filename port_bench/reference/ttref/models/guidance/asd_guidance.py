"""Asynchronous Score Distillation (ASD) guidance with three frozen teachers.

Counterpart of ``triplaneturbo_tpu/models/guidance/asd_guidance.py``:

* three teachers: MVDream (4-view SD-2.1 with camera conditioning), RichDreamer
  (4-view normal-depth diffusion in the 768-d SD-1.5 text space, no VAE) and
  SD-2.1, each a :class:`~triplaneturbo_torch.models.unet.UNet2DConditionModel`;
* per teacher, the renders go to its latent space: MV VAE-encodes 256² renders to
  32², RD box-averages cat(normal, disparity) to 32² x 4 directly, SD VAE-encodes
  one view a prompt at 512²;
* ASD: a timestep t a prompt, a second timestep t⁺ = t + clamp(ratio (t - t_min))·U,
  ONE no-grad UNet pass over ``[cond@t, uncond@t, cond@t⁺]``, the "dmd" weighting
  (x̂₀(second) - x̂₀(first)) / (mean |x - x̂₀(first)| + eps) or one of four others,
  and the loss as the MSE to a detached target;
* the dual mode stacks both renderers' images through one teacher pass and returns
  a loss a renderer.

The teachers' math runs under ``torch.no_grad()`` (the JAX package stop-gradients
it); gradients reach the rendered images only through the VAE encode (or RD's
pooling) and the reparameterised loss. The random draws of one teacher call arrive
as a :class:`GuidanceDraws` (:meth:`ASDGuidance.draw` makes them), where the JAX
package splits a key inside each branch.
"""

from __future__ import annotations

from dataclasses import dataclass, fields, replace
from typing import Dict, NamedTuple, Optional, Tuple, Union

import numpy as np
import torch
import torch.nn.functional as F

from ..schedulers import Schedule, SchedulerConfig, make_schedule
from ..unet import UNet2DConditionModel
from ..vae import AutoencoderKLEncoder

Step = Union[int, torch.Tensor]


def _avg_pool_to(x: torch.Tensor, size: int) -> torch.Tensor:
    """Exact box-average downsample of [B, H, W, C] to (size, size), for sizes that
    divide H and W (torch's adaptive_avg_pool2d at those sizes)."""
    B, H, W, C = x.shape
    if H % size or W % size:
        raise ValueError(f"{H}x{W} is not a multiple of {size}")
    return x.reshape(B, size, H // size, size, W // size, C).mean(dim=(2, 4))


def _resize(x: torch.Tensor, size: int) -> torch.Tensor:
    """Bilinear resize of [B, H, W, C] to (size, size) without antialiasing, half-pixel
    centres: ``jax.image.resize(..., "bilinear", antialias=False)`` in either direction."""
    y = F.interpolate(x.permute(0, 3, 1, 2), size=(size, size), mode="bilinear",
                      align_corners=False, antialias=False)
    return y.permute(0, 2, 3, 1)


class TeacherBundle(NamedTuple):
    """A frozen teacher: its UNet and, for MV and SD, its VAE encoder."""

    unet: UNet2DConditionModel
    vae: Optional[AutoencoderKLEncoder] = None


@dataclass
class GuidanceDraws:
    """The random draws of one teacher call.

    ``t`` the timesteps in [min_step, max_step) (a prompt for MV and RD, an image
    for SD), ``u`` the uniforms in [0, 1) that scale t⁺, ``noise`` the forward
    process's noise (the latents' shape), ``eps`` the VAE posterior's noise (MV and
    SD) and ``view`` SD's scored view a prompt."""

    t: torch.Tensor
    u: torch.Tensor
    noise: torch.Tensor
    eps: Optional[torch.Tensor] = None
    view: Optional[torch.Tensor] = None

    def to(self, device) -> "GuidanceDraws":
        return replace(self, **{f.name: getattr(self, f.name).to(device) for f in fields(self)
                                if getattr(self, f.name) is not None})


@dataclass
class ASDConfig:
    n_view: int = 4
    mv_weighting_strategy: str = "dmd"
    rd_weighting_strategy: str = "dmd"
    sd_weighting_strategy: str = "dmd"
    mv_plus_ratio: float = 0.1
    rd_plus_ratio: float = 0.1
    sd_plus_ratio: float = 0.1
    mv_plus_random: bool = True
    rd_plus_random: bool = True
    sd_plus_random: bool = True
    eps: float = 0.01
    grad_clip_val: Optional[float] = None
    mv_image_size: int = 256
    rd_image_size: int = 32
    sd_image_size: int = 512
    sd_oppo_side: bool = True
    num_train_timesteps: int = 1000


class ASDGuidance:
    """The three teachers and the ASD loss of each branch."""

    def __init__(self, cfg: Optional[ASDConfig] = None, mv: Optional[TeacherBundle] = None,
                 rd: Optional[TeacherBundle] = None, sd: Optional[TeacherBundle] = None,
                 schedule: Optional[Schedule] = None):
        self.cfg = cfg or ASDConfig()
        self.mv, self.rd, self.sd = mv, rd, sd
        if schedule is None:
            device = next(mv.unet.parameters()).device if mv is not None else None
            schedule = make_schedule(SchedulerConfig(), device=device)
        self.schedule = schedule
        self.alphas = schedule.alphas_cumprod

    # -- draws ----------------------------------------------------------------

    def _latent_hw(self, kind: str) -> int:
        cfg = self.cfg
        if kind == "rd":
            return cfg.rd_image_size
        vae = (self.mv if kind == "mv" else self.sd).vae
        factor = 2 ** (len(vae.cfg.block_out_channels) - 1)
        return (cfg.mv_image_size if kind == "mv" else cfg.sd_image_size) // factor

    def draw(self, kind: str, views: int, dual: bool, min_step: int, max_step: int,
             generator: torch.Generator) -> GuidanceDraws:
        """The draws of one call of branch ``kind`` ("mv", "rd" or "sd") on ``views``
        rendered views a renderer (both renderers' when ``dual``), on ``generator``'s
        device."""
        cfg = self.cfg
        dev = generator.device
        prompts = views // cfg.n_view
        images = views * (2 if dual else 1)
        hw = self._latent_hw(kind)
        view = None
        if kind == "sd":
            view = torch.randint(0, cfg.n_view, (prompts,), generator=generator, device=dev)
            images = prompts * (2 if dual else 1)
            n_t = images
        else:
            n_t = images // cfg.n_view
        t = torch.randint(int(min_step), int(max_step), (n_t,), generator=generator, device=dev)
        u = torch.rand((n_t,), generator=generator, device=dev)
        shape = (images, hw, hw, 4)
        noise = torch.randn(shape, generator=generator, device=dev)
        eps = None if kind == "rd" else torch.randn(shape, generator=generator, device=dev)
        return GuidanceDraws(t, u, noise, eps, view)

    # -- ASD core -------------------------------------------------------------

    def get_t_plus(self, t: torch.Tensor, u: torch.Tensor, plus_ratio: float,
                   plus_random: bool, min_step: Step) -> torch.Tensor:
        """The second (larger) timestep: t + trunc(clip(ratio (t - t_min), 0, T-1-t) u),
        clipped to [1, T-1]. The float is truncated toward zero, as ``astype(int32)``."""
        T = self.cfg.num_train_timesteps
        tf = t.float()
        t_plus = plus_ratio * (tf - min_step)
        t_plus = torch.minimum(torch.clamp_min(t_plus, 0.0), (T - 1) - tf)
        if plus_random:
            t_plus = t_plus * u
        return torch.clamp(t + t_plus.to(torch.int32), 1, T - 1)

    def _q_sample(self, latents: torch.Tensor, noise: torch.Tensor,
                  t: torch.Tensor) -> torch.Tensor:
        a = self.alphas[t].reshape(-1, 1, 1, 1)
        return torch.sqrt(a) * latents + torch.sqrt(1.0 - a) * noise

    def _asd_loss(self, latents: torch.Tensor, noise_pred_text: torch.Tensor,
                  noise_pred_uncond: torch.Tensor, noise_pred_text_second: torch.Tensor,
                  t: torch.Tensor, guidance_scale: float, weighting: str,
                  is_dual: bool) -> Tuple[torch.Tensor, torch.Tensor]:
        """The ASD gradient as a reparameterised MSE loss; returns (loss, |grad|), each a
        pair (first renderer, second) in the dual mode."""
        cfg = self.cfg
        first = noise_pred_uncond + guidance_scale * (noise_pred_text - noise_pred_uncond)
        second = noise_pred_text_second
        lat_sg = latents.detach()
        a = self.alphas[t].reshape(-1, 1, 1, 1)
        alpha, sigma = torch.sqrt(a), torch.sqrt(1.0 - a)
        if weighting in ("sds", "uniform", "fantasia3d", "sds_sqrt"):
            if weighting == "sds":
                w = 1 - a
            elif weighting == "uniform":
                w = 1.0
            elif weighting == "fantasia3d":
                w = torch.sqrt(a) * (1 - a)
            else:
                w = torch.sqrt(1 - a)
            grad = (first - second) * w
        elif weighting == "dmd":
            latent_first = (lat_sg - sigma * first) / alpha
            latent_second = (lat_sg - sigma * second) / alpha
            w = (lat_sg - latent_first).abs().mean(dim=(1, 2, 3), keepdim=True)
            grad = (latent_second - latent_first) / (w + cfg.eps)
        else:
            raise ValueError(f"Unknown weighting {weighting}")
        grad = torch.nan_to_num(grad)
        if cfg.grad_clip_val is not None:
            grad = torch.clamp(grad, -cfg.grad_clip_val, cfg.grad_clip_val)
        target = (lat_sg - grad).detach()

        def mse(x, y):
            return 0.5 * ((x - y) ** 2).sum() / cfg.n_view

        if not is_dual:
            return mse(latents, target), torch.linalg.vector_norm(grad)
        vb = latents.shape[0] // 2
        loss = torch.stack([mse(latents[:vb], target[:vb]), mse(latents[vb:], target[vb:])])
        gn = torch.stack([torch.linalg.vector_norm(grad[:vb]),
                          torch.linalg.vector_norm(grad[vb:])])
        return loss, gn

    @torch.no_grad()
    def _three_way_pred(self, bundle: TeacherBundle, noisy: torch.Tensor,
                        noisy_second: torch.Tensor, t: torch.Tensor, t_plus: torch.Tensor,
                        ctx_cond: torch.Tensor, ctx_uncond: torch.Tensor,
                        camera: Optional[torch.Tensor]):
        """One batched UNet pass over [cond@t, uncond@t, cond@t⁺], without grad."""
        x = torch.cat([noisy, noisy, noisy_second])
        ts = torch.cat([t, t, t_plus])
        ctx = torch.cat([ctx_cond, ctx_uncond, ctx_cond])
        cam = None if camera is None else torch.cat([camera] * 3)
        return bundle.unet(x, ts, ctx, cam).chunk(3)

    def _score(self, bundle: TeacherBundle, latents: torch.Tensor, d: GuidanceDraws,
               t: torch.Tensor, t_plus: torch.Tensor, text_cond: torch.Tensor,
               text_uncond: torch.Tensor, camera: Optional[torch.Tensor],
               guidance_scale: float, weighting: str, is_dual: bool):
        """Noise the detached latents at t and t⁺, the teacher's three predictions,
        and the ASD loss of ``latents``."""
        lat_sg = latents.detach()
        noisy = self._q_sample(lat_sg, d.noise, t)
        noisy_second = self._q_sample(lat_sg, d.noise, t_plus)
        B = latents.shape[0]
        ctx_c = self._dual_ctx(text_cond, B, is_dual)
        ctx_u = self._dual_ctx(text_uncond, B, is_dual)
        p_text, p_uncond, p_second = self._three_way_pred(bundle, noisy, noisy_second, t, t_plus,
                                                          ctx_c, ctx_u, camera)
        loss, gn = self._asd_loss(latents, p_text, p_uncond, p_second, t, guidance_scale,
                                  weighting, is_dual)
        return {"loss_asd": loss, "grad_norm": gn, "t": t}

    # -- the branches -----------------------------------------------------------

    def mv_branch(self, draws: GuidanceDraws, rgb: torch.Tensor, text_cond: torch.Tensor,
                  text_uncond: torch.Tensor, c2w: torch.Tensor, min_step: Step,
                  guidance_scale: float,
                  rgb_2nd: Optional[torch.Tensor] = None) -> Dict[str, torch.Tensor]:
        """MVDream: VAE-encode the renders at ``mv_image_size`` (each renderer's resized
        before they are stacked), the 4-view camera-conditioned UNet."""
        cfg = self.cfg
        is_dual = rgb_2nd is not None
        rgb = _resize(rgb, cfg.mv_image_size)
        if is_dual:
            rgb = torch.cat([rgb, _resize(rgb_2nd, cfg.mv_image_size)])
            c2w = torch.cat([c2w, c2w])
        latents = self.mv.vae.encode(rgb * 2.0 - 1.0, draws.eps)
        t = draws.t.repeat_interleave(cfg.n_view)
        t_plus = self.get_t_plus(draws.t, draws.u, cfg.mv_plus_ratio, cfg.mv_plus_random,
                                 min_step).repeat_interleave(cfg.n_view)
        return self._score(self.mv, latents, draws, t, t_plus, text_cond, text_uncond,
                           self._mv_camera(c2w), guidance_scale, cfg.mv_weighting_strategy,
                           is_dual)

    def rd_branch(self, draws: GuidanceDraws, normal: torch.Tensor, disparity: torch.Tensor,
                  text_cond: torch.Tensor, text_uncond: torch.Tensor, c2w: torch.Tensor,
                  camera_distances_relative: torch.Tensor, min_step: Step,
                  guidance_scale: float, normal_2nd: Optional[torch.Tensor] = None,
                  disparity_2nd: Optional[torch.Tensor] = None,
                  cam_method: str = "rel_x2") -> Dict[str, torch.Tensor]:
        """RichDreamer: cat(normal in [0, 1], disparity) box-averaged to
        ``rd_image_size`` is the 4-channel latent itself (no VAE)."""
        cfg = self.cfg
        is_dual = normal_2nd is not None
        latents = _avg_pool_to(torch.cat([normal, disparity], dim=-1), cfg.rd_image_size)
        if is_dual:
            geo2 = _avg_pool_to(torch.cat([normal_2nd, disparity_2nd], dim=-1), cfg.rd_image_size)
            latents = torch.cat([latents, geo2])
            c2w = torch.cat([c2w, c2w])
            camera_distances_relative = torch.cat([camera_distances_relative] * 2)
        t = draws.t.repeat_interleave(cfg.n_view)
        t_plus = self.get_t_plus(draws.t, draws.u, cfg.rd_plus_ratio, cfg.rd_plus_random,
                                 min_step).repeat_interleave(cfg.n_view)
        dist = camera_distances_relative * 2.0 if cam_method == "rel_x2" \
            else camera_distances_relative
        return self._score(self.rd, latents, draws, t, t_plus, text_cond, text_uncond,
                           self._rd_camera(c2w, dist), guidance_scale,
                           cfg.rd_weighting_strategy, is_dual)

    def sd_branch(self, draws: GuidanceDraws, rgb: torch.Tensor, text_cond: torch.Tensor,
                  text_uncond: torch.Tensor, min_step: Step, guidance_scale: float,
                  rgb_2nd: Optional[torch.Tensor] = None) -> Dict[str, torch.Tensor]:
        """SD-2.1: one drawn view a prompt at ``sd_image_size`` (and, for the second
        renderer, the opposite view when ``sd_oppo_side``); a timestep an image."""
        cfg = self.cfg
        is_dual = rgb_2nd is not None
        Bp = rgb.shape[0] // cfg.n_view
        base = torch.arange(Bp, device=rgb.device) * cfg.n_view
        sel = _resize(rgb.index_select(0, base + draws.view), cfg.sd_image_size)
        if is_dual:
            oppo = ((draws.view + cfg.n_view // 2) % cfg.n_view if cfg.sd_oppo_side
                    else draws.view)
            sel2 = _resize(rgb_2nd.index_select(0, base + oppo), cfg.sd_image_size)
            sel = torch.cat([sel, sel2])
        latents = self.sd.vae.encode(sel * 2.0 - 1.0, draws.eps)
        t_plus = self.get_t_plus(draws.t, draws.u, cfg.sd_plus_ratio, cfg.sd_plus_random,
                                 min_step)
        out = self._score(self.sd, latents, draws, draws.t, t_plus, text_cond, text_uncond,
                          None, guidance_scale, cfg.sd_weighting_strategy, is_dual)
        # one view a prompt is scored: undo the /n_view of the loss
        out["loss_asd"] = out["loss_asd"] * cfg.n_view
        return out

    # -- conditioning -----------------------------------------------------------

    @staticmethod
    def _dual_ctx(text: torch.Tensor, batch: int, is_dual: bool) -> torch.Tensor:
        """Per-view text states: each prompt's repeated over its views, and in the dual
        mode the whole tiled over the two renderers' halves ([renderer 1 | renderer 2],
        prompts interleaved within each)."""
        half = batch // 2 if is_dual else batch
        per_view = text.repeat_interleave(half // text.shape[0], dim=0)
        return torch.cat([per_view, per_view]) if is_dual else per_view

    @staticmethod
    def _mv_camera(c2w: torch.Tensor) -> torch.Tensor:
        """MVDream: c2w with its position on the unit sphere, flattened to 16."""
        pos = c2w[:, :3, 3]
        pos = pos / torch.clamp_min(torch.linalg.vector_norm(pos, dim=-1, keepdim=True), 1e-8)
        out = c2w.clone()
        out[:, :3, 3] = pos
        return out.reshape(out.shape[0], 16)

    @staticmethod
    def _rd_camera(c2w: torch.Tensor, distances: torch.Tensor) -> torch.Tensor:
        """RichDreamer: the normalised camera rotated -90° about z, its translation
        scaled by ``distances``, flattened to 16."""
        pos = c2w[:, :3, 3]
        pos = pos / torch.clamp_min(torch.linalg.vector_norm(pos, dim=-1, keepdim=True), 1e-8)
        cam = c2w.clone()
        cam[:, :3, 3] = pos
        ang = -np.pi / 2
        rot = torch.tensor([[np.cos(ang), -np.sin(ang), 0, 0], [np.sin(ang), np.cos(ang), 0, 0],
                            [0, 0, 1, 0], [0, 0, 0, 1]], dtype=cam.dtype, device=cam.device)
        cam = torch.einsum("ij,bjk->bik", rot, cam)
        cam[:, :3, 3] = cam[:, :3, 3] * distances[:, None]
        return cam.reshape(cam.shape[0], 16)
