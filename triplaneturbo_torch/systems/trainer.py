"""Training system: the student's half of the staged distillation step.

Counterpart of ``triplaneturbo_tpu/systems/trainer.py``. The JAX trainer's
staged step (``auto_grad``) runs, for each of the ``num_parts_training`` denoise
parts, a render program (R), a teacher program (G), one render-backward
program per branch (B-R "1st" mesh, "2nd" volume) and ONE generator backward
(B-G, ``_stage_student_space``) that takes the two branches' space-cache
cotangents and returns the adapter gradients; ``_stage_update`` then applies
guarded Adan to the accumulated gradients.

Ported here: program R and program B-R for the first (mesh rasterize) branch,
with the hash-grid background, the material and the renderer the trainer
owns; B-G and the update, with what they stand on (``_denoise_decode``, the
timestep strata, the host-side schedules, the step metrics). The volume
branch, the teachers and ``train_step`` itself raise ``NotImplementedError``
until they are ported (ROADMAP A9 (b)-(d)).

PyTorch runs eagerly, so a "program" is a method; gradients travel as
dictionaries keyed by parameter name, the counterpart of the JAX trainable
partition: the geometry's trainable names as they are, the background's
under ``background.``. Noise is an explicit argument: the render and the
backward programs of a part must see the same draw.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch
from torch.profiler import record_function

from ..models.background.hashgrid_env_map import (
    HashgridBackgroundConfig,
    HashgridEnvironmentMapBackground,
)
from ..models.geometry.space_generator import SpaceGeneratorConfig
from ..models.geometry.triplane_geometry import (
    TriplaneGeometry,
    TriplaneGeometryConfig,
    mark_trainable,
)
from ..models.materials.no_material import NoMaterial
from ..models.renderers.rasterize_renderer import (
    GenerativeSpaceMeshRasterizeRenderer,
    RasterizeRendererConfig,
)
from ..models.schedulers import (
    Schedule,
    SchedulerConfig,
    add_noise,
    alpha_at,
    ddim_timesteps,
    make_schedule,
    pred_original,
)
from ..utils.schedule import C, schedule_is_zero
from ..utils.weights import init_random_
from .optimizers import GuardedAdan

Grads = Dict[str, torch.Tensor]


def sample_timesteps(all_timesteps: np.ndarray, num_parts: int,
                     rng: np.random.RandomState) -> np.ndarray:
    """Stratified timestep sampling: cut the training timesteps into
    ``num_parts`` strata and draw one from each (descending)."""
    n = len(all_timesteps)
    per = n // num_parts
    out = []
    for p in range(num_parts):
        lo = p * per
        hi = n if p == num_parts - 1 else (p + 1) * per
        out.append(all_timesteps[rng.randint(lo, hi)])
    return np.asarray(out)


@dataclass
class LossConfig:
    lambda_asd: Any = 1.0
    lambda_asd_2nd: Any = 1.0
    lambda_sparsity: Any = 0.0
    lambda_sparsity_2nd: Any = 0.0
    lambda_opaque: Any = 0.0
    lambda_opaque_2nd: Any = 0.0
    lambda_z_variance_2nd: Any = 0.0
    lambda_eikonal_2nd: Any = 0.0
    lambda_orient_2nd: Any = 0.0
    lambda_sdf_abs: Any = 0.0
    lambda_normal_consistency: Any = 0.0
    lambda_laplacian_smoothness: Any = 0.0


@dataclass
class TrainerConfig:
    num_parts_training: int = 4
    num_steps_training: int = 4
    gradient_accumulation_steps: int = 1
    prediction_type: str = "epsilon"
    learning_rate: float = 2e-4
    adan_betas: Tuple[float, float, float] = (0.98, 0.92, 0.99)
    adan_eps: float = 1e-15
    # armor at the optimizer boundary: optional global-norm clip on the
    # parameter gradients, and a finiteness gate that skips a poisoned batch
    # and counts it instead of bricking the parameters
    grad_clip_norm: Optional[float] = None
    skip_nonfinite_grads: bool = True
    loss: LossConfig = field(default_factory=LossConfig)
    # guidance schedules (every one a C() spec)
    mv_guidance_scale: Any = 10.0
    rd_guidance_scale: Any = 5.0
    sd_guidance_scale: Any = 7.5
    mv_min_step_percent: Any = 0.02
    mv_max_step_percent: Any = 0.98
    rd_min_step_percent: Any = 0.02
    rd_max_step_percent: Any = 0.98
    sd_min_step_percent: Any = 0.02
    sd_max_step_percent: Any = 0.98
    rgb_grad_shrink: Any = 1.0
    sdf_grad_shrink: Any = 0.001
    def_grad_shrink: Any = 0.001


class TriplaneTurboTrainer:
    """Owns the geometry, the background, the material, the rasterize
    renderer, the optimizer, ``global_step`` and the training timesteps; runs
    programs R and B-R "1st", the generator backward and the update."""

    _GUIDANCE_IMAGE_KEYS = ("comp_rgb", "comp_normal_cam_vis", "disparity")

    def __init__(self, cfg: TrainerConfig, geometry: TriplaneGeometry, schedule: Schedule,
                 background: Optional[HashgridEnvironmentMapBackground] = None,
                 rasterize_renderer: Optional[GenerativeSpaceMeshRasterizeRenderer] = None):
        self.cfg = cfg
        self.geometry = geometry
        self.schedule = schedule
        if background is None:
            background = HashgridEnvironmentMapBackground().to(schedule.betas.device)
        self.background = background
        self.rasterize_renderer = rasterize_renderer or GenerativeSpaceMeshRasterizeRenderer()
        self.material_fn = NoMaterial()
        self.global_step = 0
        self.rng = np.random.RandomState(0)
        # the optimizer sees only the trainable partition: the geometry's
        # adapters and field MLPs, and every background leaf; frozen leaves are
        # never differentiated
        named = dict(geometry.named_parameters())
        self.params_train: Dict[str, torch.nn.Parameter] = {
            n: named[n] for n in mark_trainable(geometry)}
        for n, p in self.background.named_parameters():
            self.params_train[f"background.{n}"] = p.requires_grad_(True)
        self.trainable: List[str] = list(self.params_train)
        self.optimizer = GuardedAdan(
            self.params_train.values(), cfg.learning_rate, cfg.adan_betas, cfg.adan_eps,
            grad_clip_norm=cfg.grad_clip_norm,
            accumulation_steps=cfg.gradient_accumulation_steps,
            skip_nonfinite=cfg.skip_nonfinite_grads,
        )
        # fixed training timesteps: the shifted schedule of num_steps_training steps
        self.all_timesteps = ddim_timesteps(schedule, cfg.num_steps_training)

    @classmethod
    def build(cls, cfg: Optional[TrainerConfig] = None, seed: int = 0,
              space_generator_overrides: Optional[Dict[str, Any]] = None,
              device: Union[str, torch.device] = "cuda",
              background_cfg: Optional[HashgridBackgroundConfig] = None,
              renderer_cfg: Optional[RasterizeRendererConfig] = None) -> "TriplaneTurboTrainer":
        """A trainer on ``device`` with random weights from ``seed``.

        The geometry and the background are built on the meta device and
        materialised on ``device``, so the full-size model never passes
        through host memory. Adapter ``up`` leaves start at zero, as in the
        JAX package.
        """
        device = torch.device(device)
        if device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError("no CUDA device: pass device='cpu' to run on the CPU")
        cfg = cfg or TrainerConfig()
        geometry_cfg = TriplaneGeometryConfig(
            space_generator=SpaceGeneratorConfig(**(space_generator_overrides or {})))
        with torch.device("meta"):
            geometry = TriplaneGeometry(geometry_cfg)
            background = HashgridEnvironmentMapBackground(background_cfg)
        gen = torch.Generator(device=device).manual_seed(seed)
        geometry = geometry.to_empty(device=device)
        init_random_(geometry, gen)
        background = background.to_empty(device=device)
        init_random_(background, gen)
        schedule = make_schedule(SchedulerConfig(prediction_type=cfg.prediction_type),
                                 device=device)
        return cls(cfg, geometry, schedule, background,
                   GenerativeSpaceMeshRasterizeRenderer(renderer_cfg))

    # ------------------------------------------------------------------

    def host_scalars(self) -> Dict[str, Union[float, int]]:
        """Every C() schedule at the current step, on the host: floats, and
        the teachers' timestep bounds as ints."""
        s = self.global_step
        cfg = self.cfg
        T = self.schedule.config.num_train_timesteps
        out: Dict[str, Union[float, int]] = {
            name: C(getattr(cfg, name), 0, s)
            for name in ("mv_guidance_scale", "rd_guidance_scale", "sd_guidance_scale",
                         "rgb_grad_shrink", "sdf_grad_shrink", "def_grad_shrink")
        }
        for mod in ("mv", "rd", "sd"):
            out[f"{mod}_min_step"] = int(C(getattr(cfg, f"{mod}_min_step_percent"), 0, s) * T)
            out[f"{mod}_max_step"] = int(C(getattr(cfg, f"{mod}_max_step_percent"), 0, s) * T)
        for f_ in LossConfig.__dataclass_fields__:
            out[f_] = C(getattr(cfg.loss, f_), 0, s)
        return out

    def _step_metrics(self, fids: torch.Tensor, regus: torch.Tensor,
                      gns: torch.Tensor) -> Dict[str, torch.Tensor]:
        """The step's metric dict from the per-part fidelity, regularization
        and guidance-gradient-norm series."""
        cfg = self.cfg
        metrics = {
            "loss": (fids.sum() + regus.sum()) / cfg.num_parts_training,
            "fidelity": fids.mean(),
            "regularization": regus.mean(),
            "grad_norm": gns.mean(),
        }
        for i in range(cfg.num_parts_training):
            metrics[f"fidelity_{i}"] = fids[i]
            metrics[f"regularization_{i}"] = regus[i]
            metrics[f"grad_norm_{i}"] = gns[i]
        return metrics

    # ------------------------------------------------------------------

    def _denoise_decode(self, latent: torch.Tensor, t, text_embeds: Dict[str, torch.Tensor],
                        noise: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        """Generator half of the student forward: noise the latent at t, UNet
        ε, x̂₀, VAE decode to the space cache. Returns (denoised, space_cache)."""
        noisy = add_noise(self.schedule, latent, noise, t)
        eps = self.geometry.denoise(noisy, text_embeds["cond_local"], t)
        denoised = pred_original(self.schedule, eps, alpha_at(self.schedule, t, noisy.ndim), noisy)
        return denoised, self.geometry.decode(denoised)

    def _stage_student_space(self, latent: torch.Tensor, t, text_embeds: Dict[str, torch.Tensor],
                             g_space_1st: torch.Tensor, g_space_2nd: torch.Tensor,
                             noise: torch.Tensor) -> Grads:
        """Program B-G: UNet denoise + VAE decode forward and backward with the
        injected space-cache cotangent, the two render branches' summed.

        Returns one gradient per trainable parameter (zeros for those the
        generator does not reach, such as the field MLPs).
        """
        g_space = (g_space_1st + g_space_2nd).detach()
        params = list(self.params_train.values())
        with record_function("generator_backward"), torch.enable_grad():
            _, space_cache = self._denoise_decode(latent, t, text_embeds, noise)
            grads = torch.autograd.grad(space_cache, params, grad_outputs=g_space,
                                        allow_unused=True)
        return {n: torch.zeros_like(p) if g is None else g
                for (n, p), g in zip(self.params_train.items(), grads)}

    def _stage_update(self, grads: Grads) -> bool:
        """Divide the step's accumulated gradients by the number of parts and
        apply guarded Adan; True when the parameters were updated."""
        if set(grads) != set(self.trainable):
            raise ValueError("the gradients do not cover the trainable partition")
        n = self.cfg.num_parts_training
        return self.optimizer.step([grads[name] / n for name in self.trainable])

    @staticmethod
    def accumulate(acc: Optional[Grads], grads: Grads) -> Grads:
        """acc + grads, leaf by leaf (in place on ``acc``)."""
        if acc is None:
            return {n: g.clone() for n, g in grads.items()}
        for n, g in grads.items():
            acc[n].add_(g)
        return acc

    # -- the first renderer: programs R and B-R "1st" ---------------------

    def _render_branch(self, batch: Dict[str, Any], space_cache: torch.Tensor,
                       scalars: Dict[str, Any], text_global: torch.Tensor, branch: str):
        """Render "1st" (mesh rasterize) from ``space_cache`` with the current
        weights; returns (out_1st, None). ``batch`` holds the step-batch's
        tensors (``MultiviewMultipromptDataModule.to_device``)."""
        if branch != "1st":
            raise NotImplementedError(
                f"branch {branch!r} needs the volume and patch renderers: ROADMAP A9 (b)")
        geo = self.geometry
        H = batch["rays_d_rasterize"].shape[1]
        out_1st = self.rasterize_renderer(
            batch["mvp_mtx"], batch["camera_positions"], space_cache,
            geo.forward_field, lambda p, sc: geo.export(p, sc)["features"], self.material_fn,
            lambda dirs, te: self.background(dirs, te, train=True), H, H,
            text_embed=text_global, rays_d_rasterize=batch["rays_d_rasterize"],
            camera_distances=batch["camera_distances"], c2w=batch["c2w"],
            sdf_grad_shrink=scalars["sdf_grad_shrink"],
            def_grad_shrink=scalars["def_grad_shrink"],
            forward_field_grid=geo.forward_field_grid)
        return out_1st, None

    def _term_on(self, name: str) -> bool:
        """Static gate: a loss term whose lambda schedule is identically zero
        is not built at all (a zero cotangent times a NaN partial would still
        poison the gradients)."""
        return not schedule_is_zero(getattr(self.cfg.loss, name))

    def _regularizers_1st(self, out_1st: Dict[str, Any], scalars: Dict[str, Any]) -> torch.Tensor:
        op1 = out_1st["opacity"]
        loss = op1.new_zeros(())
        if self._term_on("lambda_sparsity"):
            loss = loss + scalars["lambda_sparsity"] * torch.sqrt(op1 ** 2 + 0.01).mean()
        if self._term_on("lambda_opaque"):
            opc = torch.clamp(op1, 1e-3, 1 - 1e-3)
            loss = loss + scalars["lambda_opaque"] * (
                -(opc * torch.log(opc) + (1 - opc) * torch.log(1 - opc))).mean()
        if "mesh" in out_1st:
            if self._term_on("lambda_normal_consistency"):
                nc = torch.stack([m.normal_consistency() for m in out_1st["mesh"]]).mean()
                loss = loss + scalars["lambda_normal_consistency"] * nc
            if self._term_on("lambda_laplacian_smoothness"):
                lap = torch.stack([m.laplacian() for m in out_1st["mesh"]]).mean()
                loss = loss + scalars["lambda_laplacian_smoothness"] * lap
        return loss

    def _stage_render(self, batch: Dict[str, Any], latent: torch.Tensor, t,
                      text_embeds: Dict[str, torch.Tensor], scalars: Dict[str, Any],
                      noise: torch.Tensor):
        """Program R, first branch: no-grad generator forward and render.

        Returns (denoised, space_cache, images, overflow): the images the
        teachers score, keyed ``{comp_rgb, comp_normal_cam_vis, disparity}_1st``,
        and the rasterizer's overflow counts a view (``n_span_overflow``,
        ``n_list_overflow``, [B]), which the JAX program does not return. The
        volume branch's images wait for ROADMAP A9 (b)."""
        with torch.no_grad():
            with record_function("generator_forward"):
                denoised, space_cache = self._denoise_decode(latent, t, text_embeds, noise)
            with record_function("render_1st"):
                out_1st, _ = self._render_branch(batch, space_cache, scalars,
                                                 text_embeds["global_21"], "1st")
        images = {f"{name}_1st": out_1st[name] for name in self._GUIDANCE_IMAGE_KEYS}
        overflow = {k: out_1st[k] for k in ("n_span_overflow", "n_list_overflow")}
        return denoised, space_cache, images, overflow

    def _stage_student_render(self, batch: Dict[str, Any], space_cache: torch.Tensor,
                              text_embeds: Dict[str, torch.Tensor], scalars: Dict[str, Any],
                              grad_images: Dict[str, torch.Tensor], branch: str = "1st"):
        """Program B-R: one renderer's forward and backward from the detached
        space cache, loss = sum(g * image) over the guidance images plus the
        branch's regularizers.

        Returns (grads, g_space, regu): a gradient per trainable parameter
        (the field MLPs and the background; zeros for the adapters, which
        B-G reaches through ``g_space``), d(loss)/d(space_cache) and the
        regularizer's value."""
        if branch != "1st":
            raise NotImplementedError(
                f"program B-R {branch!r} needs the volume and patch renderers: ROADMAP A9 (b)")
        sc = space_cache.detach().requires_grad_()
        params = list(self.params_train.values())
        with record_function(f"render_backward_{branch}"), torch.enable_grad():
            out, _ = self._render_branch(batch, sc, scalars, text_embeds["global_21"], branch)
            fid_proxy = sum((grad_images[f"{name}_{branch}"].detach() * out[name]).sum()
                            for name in self._GUIDANCE_IMAGE_KEYS)
            regu = self._regularizers_1st(out, scalars)
            g_space, *grads = torch.autograd.grad(fid_proxy + regu, [sc, *params],
                                                  allow_unused=True)
        grads = {n: torch.zeros_like(p) if g is None else g
                 for (n, p), g in zip(self.params_train.items(), grads)}
        return grads, g_space, regu.detach()

    # -- programs that wait for the teachers --------------------------------

    def _stage_teacher(self, *args, **kwargs):
        raise NotImplementedError(
            "program G needs the teachers and ASD guidance: ROADMAP A9 (c)")

    def train_step(self, batch_list: Sequence[Dict[str, Any]], text_embeds: Dict[str, Any],
                   generator: torch.Generator):
        raise NotImplementedError(
            "train_step needs program G, the volume branch and the launcher: ROADMAP A9 (b)-(d)")
