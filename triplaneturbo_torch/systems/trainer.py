"""Training system: the multi-step progressive rendering distillation step.

Counterpart of ``triplaneturbo_tpu/systems/trainer.py``. One optimization step
(:meth:`TriplaneTurboTrainer.train_step`) samples one timestep from each of the
``num_parts_training`` strata and, for each denoise part, adds noise to the
latent, denoises it with the student UNet, decodes the space cache, renders it
with both renderers (mesh rasterize, patch-wrapped NeuS volume), scores the six
images with the three frozen teachers (ASD guidance) and adds the regularizers;
the next part starts from the detached denoised latent, and guarded Adan applies
the parts' mean gradient.

With ``auto_grad`` (the v1 recipe) the step is staged as in the JAX package: a
part runs a render program (R: no-grad generator forward and both renders), a
teacher program (G: the teachers' image gradients), one render-backward program
per branch (B-R "1st" mesh, "2nd" volume) and ONE generator backward (B-G,
``_stage_student_space``) that takes the two branches' space-cache cotangents;
the gradients accumulate in place and ``_stage_update`` applies them. Without it
the step is one autograd graph over the parts (``_train_step_monolithic``), each
part under ``torch.utils.checkpoint``. Validation renders a DDIM sample's
turntable with the mesh renderer (``render_eval_views``). :meth:`step_cost_flops`
takes a step under ``utils/flops.py``'s count and returns its FLOPs.

PyTorch runs eagerly, so a "program" is a method; gradients travel as
dictionaries keyed by parameter name, the counterpart of the JAX trainable
partition: the geometry's trainable names as they are, the background's
under ``background.``, the volume renderer's under ``renderer.``. Random
draws are explicit arguments (:class:`PartDraws`): the render and the backward
programs of a part must see the same noise and the same volume draws (patch
origin, sampler jitter; :meth:`TriplaneTurboTrainer.draw_volume`), where the JAX
package derives both programs' keys from one; program G takes the teachers'
draws (:meth:`TriplaneTurboTrainer.draw_guidance`).

Under ``torch.distributed`` (``parallel/mesh.py``) every rank runs ``train_step`` on the
step's whole batch with the same generator: it makes every draw for the whole batch,
keeps its own prompts' share of the batch, text states and draws, averages the
gradients across the ranks before the update and reduces the metrics over them, so
each rank takes the step one process would take on the whole batch. The teachers'
loss is a sum over prompts (the regularizers are means), so a rank's image gradients
are scaled by the world size before they are averaged. The two ratio terms over the
batch (``lambda_z_variance_2nd``, ``lambda_orient_2nd``; the v1 recipe sets neither)
become the mean of the ranks' ratios.
"""

from __future__ import annotations

import contextlib
import os
from dataclasses import dataclass, field, fields, replace
from typing import Any, Dict, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from ..models.background.hashgrid_env_map import (
    HashgridBackgroundConfig,
    HashgridEnvironmentMapBackground,
)
from ..models.geometry.space_generator import SpaceGeneratorConfig
from ..models.guidance.asd_guidance import ASDConfig, ASDGuidance, GuidanceDraws
from ..models.geometry.triplane_geometry import (
    TriplaneGeometry,
    TriplaneGeometryConfig,
    mark_trainable,
)
from ..data.multiview_multiprompt import MultiviewMultipromptDataModule
from ..models.materials.no_material import NoMaterial, NoMaterialConfig
from ..models.renderers.patch_renderer import PatchDraws, PatchRenderer, PatchRendererConfig
from ..models.renderers.rasterize_renderer import (
    GenerativeSpaceMeshRasterizeRenderer,
    RasterizeRendererConfig,
)
from ..models.renderers.volume_renderer import (
    GenerativeSpaceSDFVolumeRenderer,
    VolumeRendererConfig,
)
from ..models.schedulers import (
    Schedule,
    SchedulerConfig,
    add_noise,
    alpha_at,
    ddim_step,
    ddim_timesteps,
    make_schedule,
    pred_original,
)
from ..parallel.mesh import all_reduce_mean, all_reduce_sum, shard_batch, shard_rows
from ..utils.flops import FlopCount, count_flops
from ..utils.misc import get_rank, get_world_size
from ..utils.ops import safe_normalize
from ..utils.profiling import span, stage
from ..utils.schedule import C, schedule_is_zero
from ..utils.weights import init_random_
from .builder import build_teacher
from .optimizers import GuardedAdan

Grads = Dict[str, torch.Tensor]


def _detached(t: torch.Tensor) -> torch.Tensor:
    return t.detach()


def _same(t: torch.Tensor) -> torch.Tensor:
    return t


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
    # program G: the two renderers' images through one teacher pass each (True), or
    # the renderers one after the other (False, the v1 default: half the activations)
    parallel_guidance: bool = False
    # the v1 recipe's staged step (programs R, G, B-R, B-G a part); False runs the
    # parts as one autograd graph, each part checkpointed
    auto_grad: bool = False
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


@dataclass
class PartDraws:
    """One denoise part's random draws: the noise added to the latent, the volume
    branch's (patch origin, sampler jitter) and program G's."""

    noise: torch.Tensor
    volume: PatchDraws
    guidance: Dict[str, List[GuidanceDraws]]


class TriplaneTurboTrainer:
    """Owns the geometry, the background, the material, the rasterize and the
    volume renderer with the patch config, the guidance with its frozen teachers,
    the optimizer, ``global_step`` and the training timesteps; runs programs R, G
    and B-R, the generator backward and the update."""

    _GUIDANCE_IMAGE_KEYS = ("comp_rgb", "comp_normal_cam_vis", "disparity")

    def __init__(self, cfg: TrainerConfig, geometry: TriplaneGeometry, schedule: Schedule,
                 background: Optional[HashgridEnvironmentMapBackground] = None,
                 rasterize_renderer: Optional[GenerativeSpaceMeshRasterizeRenderer] = None,
                 volume_renderer: Optional[GenerativeSpaceSDFVolumeRenderer] = None,
                 patch_cfg: Optional[PatchRendererConfig] = None,
                 guidance: Optional[ASDGuidance] = None,
                 material_fn: Optional[NoMaterial] = None):
        self.cfg = cfg
        self.geometry = geometry
        self.schedule = schedule
        device = schedule.betas.device
        if background is None:
            background = HashgridEnvironmentMapBackground().to(device)
        self.background = background
        self.rasterize_renderer = rasterize_renderer or GenerativeSpaceMeshRasterizeRenderer()
        self.volume_renderer = volume_renderer or GenerativeSpaceSDFVolumeRenderer().to(device)
        self.patch_cfg = patch_cfg or PatchRendererConfig()
        self.material_fn = material_fn or NoMaterial()
        self.guidance = guidance
        self.global_step = 0
        self.rng = np.random.RandomState(0)
        # the optimizer sees only the trainable partition: the geometry's
        # adapters and field MLPs, every background leaf and the volume
        # renderer's variance (which ``trainable_variance: false`` detaches in
        # the render, so that its gradient is zero); frozen leaves are never
        # differentiated
        named = dict(geometry.named_parameters())
        self.params_train: Dict[str, torch.nn.Parameter] = {
            n: named[n] for n in mark_trainable(geometry)}
        for prefix, module in (("background", self.background),
                               ("renderer", self.volume_renderer)):
            for n, p in module.named_parameters():
                self.params_train[f"{prefix}.{n}"] = p.requires_grad_(True)
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
              renderer_cfg: Optional[RasterizeRendererConfig] = None,
              volume_cfg: Optional[VolumeRendererConfig] = None,
              patch_cfg: Optional[PatchRendererConfig] = None,
              teacher_sizes: Optional[Dict[str, Dict[str, Any]]] = None,
              teacher_dtype: str = "bfloat16",
              teacher_ckpt_paths: Optional[Dict[str, Optional[str]]] = None,
              guidance_cfg: Optional[ASDConfig] = None,
              geometry_overrides: Optional[Dict[str, Any]] = None,
              color_activation: str = "sigmoid-mipnerf") -> "TriplaneTurboTrainer":
        """A trainer on ``device`` with random weights from ``seed``.

        The geometry and the background are built on the meta device and
        materialised on ``device``, so the full-size model never passes
        through host memory. Adapter ``up`` leaves start at zero, as in the
        JAX package. ``teacher_sizes`` ({"mv": {...}, "rd": {...}, "sd": {...}},
        overrides of each teacher's config, ``{}`` for the full size) builds the
        three frozen teachers in ``teacher_dtype`` from ``seed + 1``, and the
        guidance over them; without it the trainer has no teachers and program G
        raises (programs R, B-R, B-G and the update need none). ``teacher_ckpt_paths``
        ({"mv": path, ...}) loads a teacher's weights over the random ones.
        ``geometry_overrides`` sets fields of the geometry's config besides the
        space generator's; ``color_activation`` is the material's.
        :func:`~triplaneturbo_torch.systems.builder.build_system` calls this with
        what a config file holds.
        """
        device = torch.device(device)
        if device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError("no CUDA device: pass device='cpu' to run on the CPU")
        cfg = cfg or TrainerConfig()
        geometry_cfg = TriplaneGeometryConfig(
            space_generator=SpaceGeneratorConfig(**(space_generator_overrides or {})),
            **(geometry_overrides or {}))
        with torch.device("meta"):
            geometry = TriplaneGeometry(geometry_cfg)
            background = HashgridEnvironmentMapBackground(background_cfg)
        gen = torch.Generator(device=device).manual_seed(seed)
        geometry = geometry.to_empty(device=device)
        init_random_(geometry, gen)
        background = background.to_empty(device=device)
        init_random_(background, gen)
        volume_renderer = GenerativeSpaceSDFVolumeRenderer(volume_cfg).to(device)
        schedule = make_schedule(SchedulerConfig(prediction_type=cfg.prediction_type),
                                 device=device)
        guidance = None
        if teacher_sizes is not None:
            teacher_gen = torch.Generator(device=device).manual_seed(seed + 1)
            paths = teacher_ckpt_paths or {}
            teachers = {kind: build_teacher(kind, teacher_gen, teacher_sizes.get(kind),
                                            teacher_dtype, device, ckpt_path=paths.get(kind))
                        for kind in ("mv", "rd", "sd")}
            guidance = ASDGuidance(guidance_cfg, schedule=schedule, **teachers)
        return cls(cfg, geometry, schedule, background,
                   GenerativeSpaceMeshRasterizeRenderer(renderer_cfg), volume_renderer, patch_cfg,
                   guidance, NoMaterial(NoMaterialConfig(color_activation=color_activation)))

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
        world = get_world_size()
        if world > 1:  # the whole batch's: fidelity sums, regularizers average
            fids, regus = all_reduce_sum(fids), all_reduce_sum(regus) / world
            gns = torch.sqrt(all_reduce_sum(gns * gns))
        metrics = {
            "loss": (fids.sum() + regus.sum()) / cfg.num_parts_training,
            "fidelity": fids.mean(),
            "regularization": regus.mean(),
            "grad_norm": gns.mean(),
        }
        for i in range(len(fids)):
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
        with stage("generator_backward"), torch.enable_grad():
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
        with span("stage_update"):
            return self.optimizer.step([grads[name] / n for name in self.trainable])

    @staticmethod
    def accumulate(acc: Optional[Grads], grads: Grads) -> Grads:
        """acc + grads, leaf by leaf (in place on ``acc``)."""
        if acc is None:
            return {n: g.clone() for n, g in grads.items()}
        for n, g in grads.items():
            acc[n].add_(g)
        return acc

    # -- the renderers: programs R and B-R ---------------------------------

    def draw_volume(self, batch: Dict[str, Any], generator: torch.Generator) -> PatchDraws:
        """The second branch's draws for one part (patch origin, both base
        renders' sampler jitter), on ``generator``'s device; programs R and B-R
        "2nd" of the part take the same."""
        B, H, W, _ = batch["rays_o"].shape
        vol = self.volume_renderer
        return PatchRenderer.draw(self.patch_cfg, generator, B, H, W,
                                  lambda n: vol.draw_jitter(n, generator, generator.device))

    def _render_branch(self, batch: Dict[str, Any], space_cache: torch.Tensor,
                       scalars: Dict[str, Any], text_global: torch.Tensor, branch: str,
                       draws: Optional[PatchDraws] = None):
        """Render "1st" (mesh rasterize), "2nd" (patch-wrapped volume) or "both"
        from ``space_cache`` with the current weights; returns (out_1st,
        out_2nd), None for a branch not rendered. ``batch`` holds the
        step-batch's tensors (``MultiviewMultipromptDataModule.to_device``);
        ``draws`` the second branch's (:meth:`draw_volume`). Each branch
        renders the same whichever of the three is asked for."""
        if branch not in ("1st", "2nd", "both"):
            raise ValueError(f"unknown branch {branch!r}")
        geo = self.geometry

        def background_fn(dirs, te):
            return self.background(dirs, te, train=True)

        out_1st = out_2nd = None
        if branch in ("1st", "both"):
            H = batch["rays_d_rasterize"].shape[1]
            out_1st = self.rasterize_renderer(
                batch["mvp_mtx"], batch["camera_positions"], space_cache,
                geo.forward_field, lambda p, sc: geo.export(p, sc)["features"], self.material_fn,
                background_fn, H, H,
                text_embed=text_global, rays_d_rasterize=batch["rays_d_rasterize"],
                camera_distances=batch["camera_distances"], c2w=batch["c2w"],
                sdf_grad_shrink=scalars["sdf_grad_shrink"],
                def_grad_shrink=scalars["def_grad_shrink"],
                forward_field_grid=geo.forward_field_grid)
        if branch == "1st":
            return out_1st, None

        views = batch["rays_o"].shape[0] // space_cache.shape[0]
        field_fn = self._field_fn_2nd(space_cache, views)
        field_inputs = [space_cache, *geo.field.parameters()]

        def base_renderer(ro, rd, jitter=None, train=True):
            return self.volume_renderer(
                ro, rd, field_fn, background_fn, camera_distances=batch["camera_distances"],
                c2w=batch["c2w"], text_embed=text_global, jitter=jitter, train=train,
                rgb_grad_shrink=scalars["rgb_grad_shrink"], field_inputs=field_inputs)

        out_2nd = PatchRenderer(self.patch_cfg, base_renderer)(
            batch["rays_o"], batch["rays_d"], draws=draws, train=True)
        return out_1st, out_2nd

    def _field_fn_2nd(self, space_cache: torch.Tensor, views: int):
        """The volume renderer's field query over ``space_cache`` [Bsc, ...], whose
        item i is seen by views i * views ... (i + 1) * views - 1.

        Points arrive grouped by view, [B, M, 3]; the field takes them grouped by
        space-cache item, [Bsc, views * M, 3], so that the cache is never repeated
        once a view (``views`` times the gathers' gradient temporaries)."""
        geo = self.geometry
        Bsc = space_cache.shape[0]

        def field_fn(points, mode):
            B, M, _ = points.shape
            pts = points.reshape(Bsc, views * M, 3)

            def ungroup(x):
                return x.reshape(B, M, *x.shape[2:])

            if mode == "sdf":  # the proposal pass reads the SDF alone
                return {"sdf": ungroup(geo.forward_sdf(pts, space_cache))}
            if mode:
                # one field evaluation and its input gradient (the analytic
                # normal), whose graph is kept when the caller differentiates on.
                # Where it is not, the inner graph saves detached copies of its own:
                # inside a checkpointed part (the monolithic step) the checkpoint's
                # hooks would drop its tensors, and the inner gradient would recompute
                # the part up to here (a saved tensor with its history would keep the
                # nodes the inner gradient does not run alive, through their outputs)
                outer = torch.is_grad_enabled()
                own = (contextlib.nullcontext() if outer else
                       torch.autograd.graph.saved_tensors_hooks(_detached, _same))
                with torch.enable_grad(), own:
                    p = pts.detach().requires_grad_()
                    out = geo(p, space_cache)
                    (grad,) = torch.autograd.grad(out["sdf"].sum(), p, create_graph=outer)
                if not outer:
                    out = {k: v.detach() for k, v in out.items()}
                out = {k: ungroup(v) for k, v in out.items()}
                out["sdf_grad"] = ungroup(grad)
                # the SDF gradient is exactly zero where the field is constant
                out["normal"] = safe_normalize(out["sdf_grad"])
            else:
                out = {k: ungroup(v) for k, v in geo(pts, space_cache).items()}
            out["features"] = self.material_fn(out["features"])
            return out

        return field_fn

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

    def _regularizers_2nd(self, out_2nd: Dict[str, Any], scalars: Dict[str, Any]) -> torch.Tensor:
        op2 = out_2nd["opacity"]
        loss = op2.new_zeros(())
        if self._term_on("lambda_sparsity_2nd"):
            loss = loss + scalars["lambda_sparsity_2nd"] * torch.sqrt(op2 ** 2 + 0.01).mean()
        if self._term_on("lambda_opaque_2nd"):
            opc2 = torch.clamp(op2, 1e-3, 1 - 1e-3)
            loss = loss + scalars["lambda_opaque_2nd"] * (
                -(opc2 * torch.log(opc2) + (1 - opc2) * torch.log(1 - opc2))).mean()
        if self._term_on("lambda_z_variance_2nd"):
            zv = out_2nd["z_variance"]
            sel = (op2 > 0.5).to(zv.dtype)
            loss = loss + scalars["lambda_z_variance_2nd"] * (zv * sel).sum() / torch.clamp_min(
                sel.sum(), 1)
        for term, lam in (("eikonal", "lambda_eikonal_2nd"), ("orient", "lambda_orient_2nd"),
                          ("sdf_abs", "lambda_sdf_abs")):
            if term in out_2nd and self._term_on(lam):
                loss = loss + scalars[lam] * out_2nd[term]
        return loss

    def _stage_render(self, batch: Dict[str, Any], latent: torch.Tensor, t,
                      text_embeds: Dict[str, torch.Tensor], scalars: Dict[str, Any],
                      noise: torch.Tensor, draws: PatchDraws):
        """Program R: no-grad generator forward and both renders.

        Returns (denoised, space_cache, images, overflow): the six images the
        teachers score, keyed ``{comp_rgb, comp_normal_cam_vis, disparity}_{1st,2nd}``,
        and the rasterizer's overflow counts a view (``n_span_overflow``,
        ``n_list_overflow``, [B]), which the JAX program does not return."""
        text_global = text_embeds["global_21"]
        with torch.no_grad():
            with stage("generator_forward"):
                denoised, space_cache = self._denoise_decode(latent, t, text_embeds, noise)
            with stage("render_1st"):
                out_1st, _ = self._render_branch(batch, space_cache, scalars, text_global, "1st")
            with stage("render_2nd"):
                _, out_2nd = self._render_branch(batch, space_cache, scalars, text_global, "2nd",
                                                 draws)
        images = {f"{name}_{side}": out[name] for side, out in (("1st", out_1st), ("2nd", out_2nd))
                  for name in self._GUIDANCE_IMAGE_KEYS}
        overflow = {k: out_1st[k] for k in ("n_span_overflow", "n_list_overflow")}
        return denoised, space_cache, images, overflow

    def _stage_student_render(self, batch: Dict[str, Any], space_cache: torch.Tensor,
                              text_embeds: Dict[str, torch.Tensor], scalars: Dict[str, Any],
                              grad_images: Dict[str, torch.Tensor], branch: str = "1st",
                              draws: Optional[PatchDraws] = None):
        """Program B-R: one renderer's forward and backward from the detached
        space cache, loss = sum(g * image) over the branch's guidance images
        plus its regularizers; ``draws`` are the part's (the same as program
        R's) for the second branch.

        Returns (grads, g_space, regu): a gradient per trainable parameter
        (the field MLPs, the background and the volume renderer's variance;
        zeros for the adapters, which B-G reaches through ``g_space``),
        d(loss)/d(space_cache) and the regularizers' value."""
        if branch not in ("1st", "2nd"):
            raise ValueError(f"program B-R renders one branch, not {branch!r}")
        sc = space_cache.detach().requires_grad_()
        params = list(self.params_train.values())
        with stage(f"render_backward_{branch}"), torch.enable_grad():
            out_1st, out_2nd = self._render_branch(batch, sc, scalars, text_embeds["global_21"],
                                                   branch, draws)
            out = out_1st if branch == "1st" else out_2nd
            fid_proxy = sum((grad_images[f"{name}_{branch}"].detach() * out[name]).sum()
                            for name in self._GUIDANCE_IMAGE_KEYS)
            regu = (self._regularizers_1st(out, scalars) if branch == "1st"
                    else self._regularizers_2nd(out, scalars))
            g_space, *grads = torch.autograd.grad(fid_proxy + regu, [sc, *params],
                                                  allow_unused=True)
        grads = {n: torch.zeros_like(p) if g is None else g
                 for (n, p), g in zip(self.params_train.items(), grads)}
        return grads, g_space, regu.detach()

    # -- the teachers: program G ---------------------------------------------

    def draw_guidance(self, batch: Dict[str, Any],
                      generator: torch.Generator) -> Dict[str, List[GuidanceDraws]]:
        """Program G's draws for one part, on ``generator``'s device: a list a
        teacher, one call's draws for each renderer in turn, or one for both
        stacked under ``parallel_guidance``. The timesteps are drawn within the
        current step's bounds (:meth:`host_scalars`)."""
        scalars = self.host_scalars()
        views = batch["c2w"].shape[0]
        dual = self.cfg.parallel_guidance
        return {kind: [self.guidance.draw(kind, views, dual, scalars[f"{kind}_min_step"],
                                          scalars[f"{kind}_max_step"], generator)
                       for _ in range(1 if dual else 2)]
                for kind in ("mv", "rd", "sd")}

    def _guidance_losses(self, out_1st: Dict[str, torch.Tensor], out_2nd: Dict[str, torch.Tensor],
                         batch: Dict[str, Any], text_embeds: Dict[str, torch.Tensor],
                         scalars: Dict[str, Any], draws: Dict[str, List[GuidanceDraws]]):
        """The teacher ensemble over both renderers' images: (fid, grad_norm_mv), the
        latter the MV teacher's ASD gradient norm (of the first renderer's call when
        they run one after the other, of both, a pair, when stacked)."""
        g = self.guidance
        te = text_embeds

        def mv(d, rgb, rgb_2nd):
            with span("teacher.mv"):
                return g.mv_branch(d, rgb, te["cond_21"], te["uncond_21"], batch["c2w"],
                                   scalars["mv_min_step"], scalars["mv_guidance_scale"],
                                   rgb_2nd=rgb_2nd)

        def rd(d, n, disp, n2, disp2):
            with span("teacher.rd"):
                return g.rd_branch(d, n, disp, te["cond_15"], te["uncond_15"], batch["c2w"],
                                   batch["camera_distances_relative"], scalars["rd_min_step"],
                                   scalars["rd_guidance_scale"], normal_2nd=n2,
                                   disparity_2nd=disp2)

        def sd(d, rgb, rgb_2nd):
            with span("teacher.sd"):
                return g.sd_branch(d, rgb, te["cond_21"], te["uncond_21"],
                                   scalars["sd_min_step"], scalars["sd_guidance_scale"],
                                   rgb_2nd=rgb_2nd)

        fid = 0.0
        if self.cfg.parallel_guidance:
            mv_o = mv(draws["mv"][0], out_1st["comp_rgb"], out_2nd["comp_rgb"])
            rd_o = rd(draws["rd"][0], out_1st["comp_normal_cam_vis"], out_1st["disparity"],
                      out_2nd["comp_normal_cam_vis"], out_2nd["disparity"])
            sd_o = sd(draws["sd"][0], out_1st["comp_rgb"], out_2nd["comp_rgb"])
            for branch in (mv_o, rd_o, sd_o):
                fid = fid + scalars["lambda_asd"] * branch["loss_asd"][0]
                fid = fid + scalars["lambda_asd_2nd"] * branch["loss_asd"][1]
            return fid, mv_o["grad_norm"]
        gn = None
        for i, (out, lam) in enumerate(((out_1st, "lambda_asd"), (out_2nd, "lambda_asd_2nd"))):
            mv_o = mv(draws["mv"][i], out["comp_rgb"], None)
            rd_o = rd(draws["rd"][i], out["comp_normal_cam_vis"], out["disparity"], None, None)
            sd_o = sd(draws["sd"][i], out["comp_rgb"], None)
            fid = fid + scalars[lam] * (mv_o["loss_asd"] + rd_o["loss_asd"] + sd_o["loss_asd"])
            if gn is None:
                gn = mv_o["grad_norm"]
        return fid, gn

    def _stage_teacher(self, images: Dict[str, torch.Tensor], batch: Dict[str, Any],
                       text_embeds: Dict[str, torch.Tensor], scalars: Dict[str, Any],
                       draws: Dict[str, List[GuidanceDraws]]):
        """Program G: the teacher ensemble over program R's six images (range
        ``teacher``). Returns ((fid, grad_norm_mv), grad_images): d(fid)/d(image) for
        each image, from the images detached, so that nothing upstream of them is
        reached; the teachers run without grad."""
        if self.guidance is None:
            raise RuntimeError("the trainer was built without teachers (teacher_sizes)")
        imgs = {k: v.detach().requires_grad_() for k, v in images.items()}
        with stage("teacher"), torch.enable_grad():
            o1 = {name: imgs[f"{name}_1st"] for name in self._GUIDANCE_IMAGE_KEYS}
            o2 = {name: imgs[f"{name}_2nd"] for name in self._GUIDANCE_IMAGE_KEYS}
            fid, gn = self._guidance_losses(o1, o2, batch, text_embeds, scalars, draws)
            grads = torch.autograd.grad(fid, list(imgs.values()), allow_unused=True)
        grad_images = {k: torch.zeros_like(v) if g is None else g
                       for (k, v), g in zip(imgs.items(), grads)}
        return (fid.detach(), gn.detach()), grad_images

    # -- the step ------------------------------------------------------------

    def draw_part(self, batch: Dict[str, Any], latent_shape: Sequence[int],
                  generator: torch.Generator) -> PartDraws:
        """One part's draws on ``generator`` (and its device): the noise, then the
        volume branch's draws, then program G's."""
        noise = torch.randn(tuple(latent_shape), generator=generator, device=generator.device)
        return PartDraws(noise, self.draw_volume(batch, generator),
                         self.draw_guidance(batch, generator))

    def _shard_draws(self, d: PartDraws, rank: int, world: int, n_prompts: int) -> PartDraws:
        """Rank ``rank``'s share of one part's draws of ``n_prompts`` prompts. Stacked
        renderers (``parallel_guidance``) put program G's draws in two blocks, one a
        renderer, but for SD's scored view a prompt."""
        halves = 2 if self.cfg.parallel_guidance else 1

        def guidance(g: GuidanceDraws) -> GuidanceDraws:
            return replace(g, **{f.name: shard_rows(getattr(g, f.name), rank, world, n_prompts,
                                                    1 if f.name == "view" else halves)
                                 for f in fields(g) if getattr(g, f.name) is not None})

        return PartDraws(shard_rows(d.noise, rank, world, n_prompts),
                         shard_batch(d.volume, rank, world, n_prompts),
                         {k: [guidance(g) for g in v] for k, v in d.guidance.items()})

    def train_step(self, batch_list: Sequence[Dict[str, Any]], text_embeds: Dict[str, Any],
                   generator: Optional[torch.Generator] = None,
                   draws: Optional[Sequence[PartDraws]] = None) -> Dict[str, Any]:
        """One optimization step over the data module's ``num_parts_training``
        step-batches (host arrays; the first carries the latent ``noise``) and the
        prompts' text states (``embeds_for``): the timesteps from the strata on
        ``self.rng``, the schedules at ``global_step``, the staged step under
        ``auto_grad`` and the monolithic one otherwise, then ``global_step + 1``.

        Every part's draws are made on ``generator`` before the first part; an
        explicit ``draws`` (one :class:`PartDraws` a part) replaces them. Returns
        the metrics (``loss``, ``fidelity``, ``regularization``, ``grad_norm``, the
        per-part series and, with ``skip_nonfinite_grads``, ``skipped_nonfinite``:
        the batches the finiteness gate has skipped so far). The step is the span
        ``train_step``, the root of its request."""
        with span("train_step"):  # the root: a step is one request
            cfg = self.cfg
            n = cfg.num_parts_training
            if len(batch_list) != n:
                raise ValueError(f"{len(batch_list)} step-batches for {n} parts")
            ts = sample_timesteps(self.all_timesteps, n, self.rng)
            scalars = self.host_scalars()
            device = self.schedule.betas.device
            batches = [MultiviewMultipromptDataModule.to_device(
                {k: v for k, v in b.items() if k != "noise" and not isinstance(v, (list, str))},
                device) for b in batch_list]
            latent = torch.as_tensor(batch_list[0]["noise"], dtype=torch.float32).to(device)
            if draws is None:
                if generator is None:
                    raise ValueError("train_step needs a generator or explicit draws")
                draws = [self.draw_part(b, latent.shape, generator) for b in batches]
            if len(draws) != n:
                raise ValueError(f"{len(draws)} draws for {n} parts")
            text_embeds = {k: v.to(device) for k, v in text_embeds.items()}
            rank, world = get_rank(), get_world_size()
            if world > 1:  # this rank's prompts, taken after every draw of the whole batch
                n_prompts = latent.shape[0]
                batches = [shard_batch(b, rank, world, n_prompts) for b in batches]
                latent = shard_rows(latent, rank, world, n_prompts)
                text_embeds = shard_batch(text_embeds, rank, world, n_prompts)
                draws = [self._shard_draws(d, rank, world, n_prompts) for d in draws]
            step = self._train_step_staged if cfg.auto_grad else self._train_step_monolithic
            metrics = step(batches, [int(t) for t in ts], latent, text_embeds, scalars, draws)
            if cfg.skip_nonfinite_grads:
                metrics["skipped_nonfinite"] = self.optimizer.total_notfinite
            self.global_step += 1
            return metrics

    def step_cost_flops(self, batch_list: Sequence[Dict[str, Any]], text_embeds: Dict[str, Any],
                        generator: Optional[torch.Generator] = None) -> FlopCount:
        """The FLOPs of one optimization step: ``train_step`` with these arguments, run
        once under ``utils/flops.py`` ``count_flops`` (every product the step executes,
        its parts, recomputes and update included; the hand-written kernels counted as
        their plain versions). The counterpart of the JAX trainer's ``step_cost_flops``,
        which sums XLA's ``cost_analysis`` over the programs a step dispatches, and like
        it this takes a real step: the trainer is advanced by it (its parameters,
        optimizer state, ``global_step`` and timestep generator). Staged or monolithic
        as ``auto_grad`` says; under data parallelism the count is this rank's. Returns
        the :class:`FlopCount` (``total``; ``by_range`` splits it by the trainer's
        ``record_function`` programs)."""
        _, count = count_flops(self.train_step, batch_list, text_embeds, generator)
        return count

    def _train_step_staged(self, batches, timesteps, latent, text_embeds, scalars, draws):
        """Per part programs R, G, B-R "1st", B-R "2nd" and B-G; the parts'
        gradients accumulate in place, are averaged across the ranks of a process
        group, and one update follows. Each part's images, caches, cotangents and
        gradients are dropped as soon as they are used, so that the peak is one part's."""
        acc: Optional[Grads] = None
        fids, regus, gns = [], [], []
        world = get_world_size()
        for batch, t, d in zip(batches, timesteps, draws):
            latent_in = latent
            latent, space_cache, images, _ = self._stage_render(
                batch, latent_in, t, text_embeds, scalars, d.noise, d.volume)
            (fid, gn), grad_images = self._stage_teacher(images, batch, text_embeds, scalars,
                                                         d.guidance)
            del images
            if world > 1:  # the fidelity sums over prompts: this rank's share of the sum
                grad_images = {k: g * world for k, g in grad_images.items()}
            grads, g_space_1st, regu = self._stage_student_render(
                batch, space_cache, text_embeds, scalars, grad_images, branch="1st")
            grads_2nd, g_space_2nd, regu_2nd = self._stage_student_render(
                batch, space_cache, text_embeds, scalars, grad_images, branch="2nd",
                draws=d.volume)
            del space_cache, grad_images
            grads_g = self._stage_student_space(latent_in, t, text_embeds, g_space_1st,
                                                g_space_2nd, d.noise)
            del g_space_1st, g_space_2nd
            for name, g in grads.items():
                g.add_(grads_2nd[name]).add_(grads_g[name])
            del grads_2nd, grads_g
            acc = grads if acc is None else self.accumulate(acc, grads)
            del grads
            fids.append(fid)
            regus.append(regu + regu_2nd)
            gns.append(gn)
        self._stage_update(all_reduce_mean(acc))
        return self._step_metrics(torch.stack(fids), torch.stack(regus), torch.stack(gns))

    def _part_loss(self, latent, t, batch, text_embeds, scalars, d: PartDraws):
        """One part of the monolithic step with grad: noise, denoise, decode, both
        renders, the teachers and the regularizers. Returns (denoised, fid, regu,
        grad_norm_mv)."""
        denoised, space_cache = self._denoise_decode(latent, t, text_embeds, d.noise)
        out_1st, out_2nd = self._render_branch(batch, space_cache, scalars,
                                               text_embeds["global_21"], "both", d.volume)
        fid, gn = self._guidance_losses(out_1st, out_2nd, batch, text_embeds, scalars, d.guidance)
        regu = self._regularizers_1st(out_1st, scalars) + self._regularizers_2nd(out_2nd, scalars)
        return denoised, fid, regu, gn.detach()

    def _train_step_monolithic(self, batches, timesteps, latent, text_embeds, scalars, draws):
        """One autograd graph over the parts, each under ``torch.utils.checkpoint``
        (the JAX package's ``jax.checkpoint`` of the scan body: a part keeps only its
        inputs and runs again in the backward), its draws made outside it; one
        backward of (Σ fid + Σ regu) / num_parts, the gradients averaged across the
        ranks of a process group, and the update."""
        from torch.utils.checkpoint import checkpoint

        if self.guidance is None:
            raise RuntimeError("the trainer was built without teachers (teacher_sizes)")
        fids, regus, gns = [], [], []
        with torch.enable_grad():
            for batch, t, d in zip(batches, timesteps, draws):
                denoised, fid, regu, gn = checkpoint(self._part_loss, latent, t, batch,
                                                     text_embeds, scalars, d,
                                                     use_reentrant=False)
                latent = denoised.detach()
                fids.append(fid)
                regus.append(regu)
                gns.append(gn)
            fids, regus = torch.stack(fids), torch.stack(regus)
            world = get_world_size()
            # the fidelity sums over prompts: this rank's share of the sum
            fid = fids.sum() * world if world > 1 else fids.sum()
            total = (fid + regus.sum()) / self.cfg.num_parts_training
            params = list(self.params_train.values())
            grads = torch.autograd.grad(total, params, allow_unused=True)
        self.optimizer.step(all_reduce_mean([torch.zeros_like(p) if g is None else g
                                             for p, g in zip(params, grads)]))
        return self._step_metrics(fids.detach(), regus.detach(), torch.stack(gns))

    # -- validation: turntable renders of a DDIM sample --------------------------

    @torch.no_grad()
    def diffusion_reverse(self, noise: torch.Tensor, text_local: torch.Tensor) -> torch.Tensor:
        """The shifted ``num_steps_training``-step DDIM sample from ``noise``; returns
        the last step's x̂₀."""
        latents = denoised = noise
        n = len(self.all_timesteps)
        for t in self.all_timesteps:
            eps = self.geometry.denoise(latents, text_local, int(t))
            out = ddim_step(self.schedule, eps, int(t), latents, n)
            latents, denoised = out.prev_sample, out.pred_original_sample
        return denoised

    @torch.no_grad()
    def render_eval_views(self, batch: Dict[str, Any], text_embeds: Dict[str, torch.Tensor],
                          chunk_views: int = 4) -> Dict[str, np.ndarray]:
        """A turntable batch (``eval_views``, host arrays) of the prompt whose text
        states ``text_embeds`` holds, rendered by the mesh renderer ``chunk_views``
        views at a time from the DDIM sample of ``batch["noise"]``. Returns host
        arrays ``rgb``, ``normal``, ``opacity`` and ``depth``, [views, H, W, C]."""
        device = self.schedule.betas.device
        te = {k: v.to(device) for k, v in text_embeds.items()}
        latents = self.diffusion_reverse(torch.as_tensor(batch["noise"]).to(device),
                                         te["cond_local"])
        space_cache = self.geometry.decode(latents)
        geo = self.geometry
        dev = MultiviewMultipromptDataModule.to_device(
            {k: batch[k] for k in ("mvp_mtx", "camera_positions", "rays_d_rasterize",
                                   "camera_distances", "c2w")}, device)
        H, W = batch["rays_d_rasterize"].shape[1:3]
        n = batch["mvp_mtx"].shape[0]
        frames = []
        for i in range(0, n, chunk_views):
            sl = slice(i, min(i + chunk_views, n))
            out = self.rasterize_renderer(
                dev["mvp_mtx"][sl], dev["camera_positions"][sl], space_cache,
                geo.forward_field, lambda p, sc: geo.export(p, sc)["features"], self.material_fn,
                lambda dirs, t_: self.background(dirs, t_, train=False), H, W,
                text_embed=te["global_21"], rays_d_rasterize=dev["rays_d_rasterize"][sl],
                camera_distances=dev["camera_distances"][sl], c2w=dev["c2w"][sl],
                forward_field_grid=geo.forward_field_grid)
            frames.append({k: out[src].float().cpu().numpy() for k, src in (
                ("rgb", "comp_rgb"), ("normal", "comp_normal"), ("opacity", "opacity"),
                ("depth", "depth"))})
        return {k: np.concatenate([f[k] for f in frames]) for k in frames[0]}

    def save_eval_artifacts(self, views: Dict[str, np.ndarray], save_dir: str, tag: str
                            ) -> List[str]:
        """The middle view's rgb | normal | opacity | depth grid (PNG) and the rgb
        turntable (:func:`~triplaneturbo_torch.utils.saving.save_video`)."""
        from ..utils.saving import save_image_grid, save_video

        mid = views["rgb"].shape[0] // 2
        d = views["depth"][mid, ..., 0]
        d = (d - d.min()) / max(float(d.max() - d.min()), 1e-6)
        grid = save_image_grid(os.path.join(save_dir, f"{tag}-grid.png"),
                               [views["rgb"][mid], views["normal"][mid],
                                views["opacity"][mid].repeat(3, -1), np.stack([d] * 3, -1)])
        return [grid, save_video(os.path.join(save_dir, f"{tag}-rgb.mp4"), list(views["rgb"]))]
