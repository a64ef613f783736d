"""Training system: the student's half of the staged distillation step.

Counterpart of ``triplaneturbo_tpu/systems/trainer.py``. The JAX trainer's
staged step (``auto_grad``) runs, for each of the ``num_parts_training`` denoise
parts, a render program (R), a teacher program (G), one render-backward
program per branch (B-R "1st" mesh, "2nd" volume) and ONE generator backward
(B-G, ``_stage_student_space``) that takes the two branches' space-cache
cotangents and returns the adapter gradients; ``_stage_update`` then applies
guarded Adan to the accumulated gradients.

Ported here: B-G and the update, with what they stand on (``_denoise_decode``,
the timestep strata, the host-side schedules, the step metrics), and the
isosurface half of the mesh branch (:func:`mesh_branch_isosurface`), through
which a vertex cotangent reaches the space cache and the field MLPs. The
render, teacher and render-backward programs and ``train_step`` itself wait
for the renderers and teachers and raise ``NotImplementedError`` until then.

PyTorch runs eagerly, so a "program" is a method; gradients travel as
dictionaries keyed by parameter name, the counterpart of the JAX trainable
partition. Noise is an explicit argument: the render and the backward
programs of a part must see the same draw.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from ..models.geometry.space_generator import SpaceGeneratorConfig
from ..models.geometry.triplane_geometry import (
    TriplaneGeometry,
    TriplaneGeometryConfig,
    mark_trainable,
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
from ..ops.isosurface import ExtractedMesh, extract_isosurface, force_field_crossing
from ..utils.schedule import C
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


def mesh_branch_isosurface(geometry: TriplaneGeometry, space_cache: torch.Tensor,
                           resolution: int, sdf_grad_shrink: float, def_grad_shrink: float,
                           method: str = "mc", max_verts: int = 98304,
                           max_faces: int = 196608) -> List[ExtractedMesh]:
    """One fixed-capacity mesh per space-cache item, differentiable in its
    vertex positions: the isosurface half of the mesh-rasterize renderer
    (``rasterize_renderer.py:71-135``).

    Field on the dense grid, gradient damping (value unchanged, gradient
    scaled by the shrink), the empty-field fallback, marching cubes. Vertices
    come in world coordinates [-1, 1] and carry gradients to the space cache
    and to the sdf and deformation MLPs.
    """
    R = resolution
    deformable = geometry.cfg.isosurface_deformable_grid
    meshes = []
    for i in range(space_cache.shape[0]):
        sdf, deform = geometry.forward_field_grid(space_cache[i:i + 1], R)
        sdf = sdf.reshape(-1)
        if deform is None:
            deform = torch.zeros((R ** 3, 3), dtype=sdf.dtype, device=sdf.device)
        sdf = sdf_grad_shrink * sdf + (1.0 - sdf_grad_shrink) * sdf.detach()
        deform = def_grad_shrink * deform + (1.0 - def_grad_shrink) * deform.detach()
        sdf = force_field_crossing(sdf, R)
        m = extract_isosurface(sdf.reshape(R, R, R),
                               deform.reshape(R, R, R, 3) if deformable else None,
                               method=method, max_verts=max_verts, max_faces=max_faces)
        meshes.append(m._replace(verts=m.verts * 2.0 - 1.0))
    return meshes


class TriplaneTurboTrainer:
    """Owns the geometry module, the optimizer, ``global_step`` and the
    training timesteps; runs the generator backward and the update."""

    def __init__(self, cfg: TrainerConfig, geometry: TriplaneGeometry, schedule: Schedule):
        self.cfg = cfg
        self.geometry = geometry
        self.schedule = schedule
        self.global_step = 0
        self.rng = np.random.RandomState(0)
        # the optimizer sees only the trainable partition; frozen leaves are
        # never differentiated
        self.trainable: List[str] = mark_trainable(geometry)
        named = dict(geometry.named_parameters())
        self.params_train: Dict[str, torch.nn.Parameter] = {n: named[n] for n in self.trainable}
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
              device: Union[str, torch.device] = "cuda") -> "TriplaneTurboTrainer":
        """A trainer on ``device`` with random weights from ``seed``.

        The geometry is built on the meta device and materialised on ``device``,
        so the full-size model never passes through host memory. Adapter ``up``
        leaves start at zero, as in the JAX package.
        """
        device = torch.device(device)
        if device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError("no CUDA device: pass device='cpu' to run on the CPU")
        cfg = cfg or TrainerConfig()
        geometry_cfg = TriplaneGeometryConfig(
            space_generator=SpaceGeneratorConfig(**(space_generator_overrides or {})))
        with torch.device("meta"):
            geometry = TriplaneGeometry(geometry_cfg)
        geometry = geometry.to_empty(device=device)
        init_random_(geometry, torch.Generator(device=device).manual_seed(seed))
        schedule = make_schedule(SchedulerConfig(prediction_type=cfg.prediction_type),
                                 device=device)
        return cls(cfg, geometry, schedule)

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
        with torch.enable_grad():
            _, space_cache = self._denoise_decode(latent, t, text_embeds, noise)
        params = list(self.params_train.values())
        grads = torch.autograd.grad(space_cache, params, grad_outputs=g_space, allow_unused=True)
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

    # -- programs that wait for the renderers and the teachers -----------------

    def _stage_render(self, *args, **kwargs):
        raise NotImplementedError(
            "program R needs the rasterizer and the volume renderer: ROADMAP A9 (a), (b)")

    def _stage_teacher(self, *args, **kwargs):
        raise NotImplementedError(
            "program G needs the teachers and ASD guidance: ROADMAP A9 (c)")

    def _stage_student_render(self, *args, **kwargs):
        raise NotImplementedError(
            "program B-R needs the rasterizer (1st) and the volume renderer (2nd): "
            "ROADMAP A9 (a), (b)")

    def train_step(self, batch_list: Sequence[Dict[str, Any]], text_embeds: Dict[str, Any],
                   generator: torch.Generator):
        raise NotImplementedError(
            "train_step needs programs R, G and B-R: ROADMAP A9 (a)-(d)")
