"""Multi-view multi-prompt data module: the training and eval camera + prompt feed.

Counterpart of ``triplaneturbo_tpu/data/multiview_multiprompt.py`` (the port
keeps its own copy; the JAX package's module is not imported). Each training
item is ``batch_size // n_view`` random prompts with ``n_steps`` independently
sampled 4-view rigs (azimuths jointly covering 360°, one elevation, fov and
distance a rig), the MVDream relative radius, a low-resolution ray grid for
volume rendering and a full-resolution one for rasterization, dreamfusion
light positions, and one Gaussian latent a prompt. Val/test are turntables.

Everything is numpy on the host, and the same seed gives the JAX module's
batches key for key; :meth:`MultiviewMultipromptDataModule.to_device` turns
a step-batch into tensors. The supervised Objaverse branch (``obj_library``,
``sample_sup_batch``) is refused: neither package has a loss path that consumes
its batches (the reference's collate raises on supervised data in a multi-step
run), and the v1 recipe trains unsupervised.
"""

from __future__ import annotations

import functools
import json
import os
import warnings
from dataclasses import dataclass
from typing import Any, Dict, List, Optional, Tuple, Union

import numpy as np
import torch

_REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


@dataclass
class DataModuleConfig:
    batch_size: int = 8  # views a step-batch (= prompts * n_view)
    n_view: int = 4
    height: int = 512
    width: int = 512
    ray_height: int = 128
    ray_width: int = 128
    n_steps: int = 4
    prompt_library: str = "dreamfusion_415_prompt_library"
    prompt_library_dir: str = "datasets"
    unsup_elevation_range: Tuple[float, float] = (0, 30)
    unsup_camera_distance_range: Tuple[float, float] = (0.8, 1.0)
    unsup_fovy_range: Tuple[float, float] = (60, 60)
    unsup_azimuth_range: Tuple[float, float] = (-180, 180)
    unsup_light_distance_range: Tuple[float, float] = (0.8, 1.5)
    relative_radius: bool = True
    eval_elevation_deg: float = 15.0
    eval_camera_distance: float = 3.0
    eval_fovy_deg: float = 40.0
    eval_height: int = 512
    eval_width: int = 512
    n_val_views: int = 40
    n_test_views: int = 120
    dim_gaussian: Tuple[int, ...] = (6, 4, 32, 32)  # NCHW order of the reference
    pure_zeros: bool = False
    obj_library: str = "none"  # the supervised branch; only "none" is accepted


def load_prompt_library(cfg: DataModuleConfig) -> Dict[str, List[str]]:
    """{train, val, test} prompt lists. A relative ``prompt_library_dir`` is
    looked up from the working directory, then from the repository's root;
    with no file, a small built-in set."""
    path = os.path.join(cfg.prompt_library_dir, f"{cfg.prompt_library}.json")
    if not os.path.isabs(path) and not os.path.exists(path):
        path = os.path.join(_REPO, path)
    if os.path.exists(path):
        with open(path) as f:
            lib = json.load(f)
        if isinstance(lib, dict):
            return {k: list(v) for k, v in lib.items()}
        return {"train": list(lib), "val": list(lib)[:4], "test": list(lib)}
    warnings.warn(f"prompt library {path} not found; using builtin sample prompts")
    sample = [
        "a DSLR photo of a hamburger",
        "a zoomed out DSLR photo of a stack of pancakes",
        "a DSLR photo of a blue jay standing on a basket of macarons",
        "a ceramic lion",
        "a DSLR photo of an origami crane",
        "a DSLR photo of a corgi wearing a top hat",
        "a marble bust of an angel",
        "a DSLR photo of a robot dinosaur",
    ]
    return {"train": sample, "val": sample[:2], "test": sample}


@functools.lru_cache(maxsize=8)
def _directions_unit_focal(h: int, w: int) -> np.ndarray:
    """Pixel directions at unit focal length, cached (read-only)."""
    i, j = np.meshgrid(np.arange(w, dtype=np.float32) + 0.5,
                       np.arange(h, dtype=np.float32) + 0.5, indexing="xy")
    return np.stack([(i - w / 2), -(j - h / 2), -np.ones_like(i)], -1)


def create_camera_from_angle(elevation_deg: np.ndarray, azimuth_deg: np.ndarray,
                             camera_distances: np.ndarray, fovy_deg: np.ndarray,
                             cfg: DataModuleConfig, relative_radius: bool = True,
                             phase: str = "train",
                             rng: Optional[np.random.RandomState] = None) -> Dict[str, Any]:
    """One camera batch: rays, the rasterization rays, MVP, c2w, lights and
    the scalars (numpy arrays, and ``height`` / ``width`` as ints)."""
    B = elevation_deg.shape[0]
    fovy = np.deg2rad(fovy_deg)
    azimuth = np.deg2rad(azimuth_deg)
    elevation = np.deg2rad(elevation_deg)

    camera_distances_relative = camera_distances.copy()
    if relative_radius:
        camera_distances = camera_distances / np.tan(0.5 * fovy)

    pos = np.stack([camera_distances * np.cos(elevation) * np.cos(azimuth),
                    camera_distances * np.cos(elevation) * np.sin(azimuth),
                    camera_distances * np.sin(elevation)], axis=-1).astype(np.float32)
    center = np.zeros_like(pos)
    up = np.broadcast_to(np.asarray([0, 0, 1], np.float32), pos.shape)

    def normalize(v):
        return v / np.maximum(np.linalg.norm(v, axis=-1, keepdims=True), 1e-8)

    lookat = normalize(center - pos)
    right = normalize(np.cross(lookat, up))
    up2 = normalize(np.cross(right, lookat))
    c2w = np.zeros((B, 4, 4), np.float32)
    c2w[:, :3, 0] = right
    c2w[:, :3, 1] = up2
    c2w[:, :3, 2] = -lookat
    c2w[:, :3, 3] = pos
    c2w[:, 3, 3] = 1.0

    if phase == "train":
        rng = rng or np.random
        nv = cfg.n_view
        light_dist = (rng.uniform(*cfg.unsup_light_distance_range, size=B // nv)
                      .repeat(nv).astype(np.float32))
        light_positions = normalize(pos) * light_dist[:, None]
    else:
        light_positions = pos

    h = cfg.height if phase == "train" else cfg.eval_height
    w = cfg.width if phase == "train" else cfg.eval_width
    rh = cfg.ray_height if phase == "train" else cfg.eval_height
    rw = cfg.ray_width if phase == "train" else cfg.eval_width

    # one focal, from the ray grid's height, divides both direction grids, as in
    # the reference: the rasterization directions have height/ray_height x the spread
    def rays_dirs_for(hh, ww, focal):
        dirs = _directions_unit_focal(hh, ww)[None].repeat(B, axis=0)
        dirs[..., :2] /= focal[:, None, None, None]
        rays_d = np.einsum("bhwc,bkc->bhwk", dirs, c2w[:, :3, :3])
        return (rays_d / np.linalg.norm(rays_d, axis=-1, keepdims=True)).astype(np.float32)

    focal = 0.5 * rh / np.tan(0.5 * fovy)
    rays_d = rays_dirs_for(rh, rw, focal)
    rays_o = np.broadcast_to(pos[:, None, None, :], rays_d.shape).astype(np.float32)
    rays_d_rasterize = rays_dirs_for(h, w, focal)

    # near 0.1 and far 1000, as the reference hard-codes them
    f = 1.0 / np.tan(fovy / 2.0)
    proj = np.zeros((B, 4, 4), np.float32)
    proj[:, 0, 0] = f / (w / h)
    proj[:, 1, 1] = -f
    proj[:, 2, 2] = -(1000.0 + 0.1) / (1000.0 - 0.1)
    proj[:, 2, 3] = -2.0 * 1000.0 * 0.1 / (1000.0 - 0.1)
    proj[:, 3, 2] = -1.0
    mvp = np.einsum("bij,bjk->bik", proj, np.linalg.inv(c2w))

    return {
        "rays_o": rays_o,
        "rays_d": rays_d,
        "rays_d_rasterize": rays_d_rasterize,
        "mvp_mtx": mvp,
        "camera_positions": pos,
        "c2w": c2w,
        "light_positions": light_positions.astype(np.float32),
        "elevation": elevation_deg.astype(np.float32),
        "azimuth": azimuth_deg.astype(np.float32),
        "camera_distances": camera_distances.astype(np.float32),
        "camera_distances_relative": camera_distances_relative.astype(np.float32),
        "fovy": fovy.astype(np.float32),
        "height": h,
        "width": w,
    }


class MultiviewMultipromptDataModule:
    """Training step-batches and val/test turntable batches."""

    def __init__(self, cfg: Optional[DataModuleConfig] = None, seed: int = 0):
        self.cfg = cfg or DataModuleConfig()
        if self.cfg.obj_library.lower() != "none":
            raise ValueError(
                f"data.obj_library={self.cfg.obj_library!r}: the supervised (Objaverse) "
                "branch has no loss path in either package (the reference's collate "
                "raises on supervised data); use obj_library=none")
        self.library = load_prompt_library(self.cfg)
        self.rng = np.random.RandomState(seed)
        self.data_schedule = ["unsup"]
        self.sup_or_unsup = "unsup"

    def update_step(self, global_step: int) -> None:
        """Pick supervised or unsupervised data for the coming step."""
        self.sup_or_unsup = self.data_schedule[global_step % len(self.data_schedule)]

    def sample_train_batch(self) -> List[Dict[str, Any]]:
        """A list of ``n_steps`` step-batches; the first carries the latent
        noise, channels-last ``[prompts, 6, h, w, 4]``."""
        cfg = self.cfg
        nv = cfg.n_view
        real_b = cfg.batch_size // nv
        prompts = [self.library["train"][self.rng.randint(len(self.library["train"]))]
                   for _ in range(real_b)]
        step_batches = []
        for step in range(cfg.n_steps):
            elev = self.rng.uniform(*cfg.unsup_elevation_range, size=real_b).repeat(nv)
            azim = ((self.rng.rand(real_b)[:, None] + np.arange(nv)[None, :]).reshape(-1) / nv
                    * (cfg.unsup_azimuth_range[1] - cfg.unsup_azimuth_range[0])
                    + cfg.unsup_azimuth_range[0])
            fovy = self.rng.uniform(*cfg.unsup_fovy_range, size=real_b).repeat(nv)
            dist = self.rng.uniform(*cfg.unsup_camera_distance_range, size=real_b).repeat(nv)
            batch = create_camera_from_angle(elev, azim, dist, fovy, cfg,
                                             relative_radius=cfg.relative_radius,
                                             phase="train", rng=self.rng)
            batch["prompt"] = prompts
            if step == 0:
                P, C, hh, ww = cfg.dim_gaussian
                batch["noise"] = (np.zeros((real_b, P, hh, ww, C), np.float32) if cfg.pure_zeros
                                  else self.rng.randn(real_b, P, hh, ww, C).astype(np.float32))
            step_batches.append(batch)
        return step_batches

    def __iter__(self):
        while True:
            yield self.sample_train_batch()

    def eval_views(self, prompt: str, n_views: Optional[int] = None, split: str = "val"
                   ) -> Dict[str, Any]:
        """Turntable rig: ``n_views`` azimuths over [0, 360] inclusive."""
        cfg = self.cfg
        n = n_views or (cfg.n_val_views if split == "val" else cfg.n_test_views)
        azim = np.linspace(0.0, 360.0, n)
        elev = np.full((n,), cfg.eval_elevation_deg)
        fovy = np.full((n,), cfg.eval_fovy_deg)
        dist = np.full((n,), cfg.eval_camera_distance)
        batch = create_camera_from_angle(elev, azim, dist, fovy, cfg, relative_radius=False,
                                         phase=split)
        batch["prompt"] = [prompt]
        P, C, hh, ww = cfg.dim_gaussian
        batch["noise"] = self.rng.randn(1, P, hh, ww, C).astype(np.float32)
        return batch

    @staticmethod
    def to_device(batch: Dict[str, Any], device: Union[str, torch.device]) -> Dict[str, Any]:
        """The step-batch with every array as a tensor on ``device``; the
        prompts and the image size stay as they are."""
        return {k: torch.from_numpy(np.ascontiguousarray(v)).to(device)
                if isinstance(v, np.ndarray) else v for k, v in batch.items()}
