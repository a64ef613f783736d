"""Patch renderer: a global render at reduced resolution plus one full-resolution patch.

Counterpart of ``triplaneturbo_tpu/models/renderers/patch_renderer.py``. In
training the base renderer runs twice: on the rays resized to 1/``global_downsample``
of the resolution, and on one ``patch_size`` square of the full-resolution
rays; each image output of the global render is resized back and the patch is
written over it. Resizing is bilinear with antialiasing, as
``jax.image.resize`` does when it downsamples.

The patch origin and the two base renders' sampler jitters are explicit draws
(:class:`PatchDraws`, from :meth:`PatchRenderer.draw`), so that two programs
can render the same patch with the same samples.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable, Dict, Optional

import torch
import torch.nn.functional as F

from ...ops.ray import Jitter


@dataclass
class PatchRendererConfig:
    patch_size: int = 40
    global_downsample: int = 3
    global_detach: bool = False


@dataclass
class PatchDraws:
    """The random choices of one training render: the patch origin (row, column)
    and the base renderer's jitter for the global and the patch render."""

    patch_y: int
    patch_x: int
    jitter_global: Optional[Jitter] = None
    jitter_patch: Optional[Jitter] = None


def resize(x: torch.Tensor, h: int, w: int) -> torch.Tensor:
    """Bilinear resize of [B, H, W, C] to [B, h, w, C], antialiased when it shrinks."""
    y = F.interpolate(x.permute(0, 3, 1, 2), size=(h, w), mode="bilinear",
                      align_corners=False, antialias=True)
    return y.permute(0, 2, 3, 1)


class PatchRenderer:
    """Wraps a base renderer callable ``(rays_o, rays_d, jitter=, train=, **kw)``."""

    def __init__(self, cfg: PatchRendererConfig, base_renderer: Callable):
        self.cfg = cfg
        self.base_renderer = base_renderer

    @staticmethod
    def draw(cfg: PatchRendererConfig, generator: torch.Generator, B: int, H: int, W: int,
             draw_jitter: Callable[[int], Jitter]) -> PatchDraws:
        """The draws of one training render of B views of H x W rays:
        ``draw_jitter(n_rays)`` gives a base render's jitter."""
        PS = cfg.patch_size
        dev = generator.device
        patch_y = int(torch.randint(0, H - PS, (), generator=generator, device=dev))
        patch_x = int(torch.randint(0, W - PS, (), generator=generator, device=dev))
        gh, gw = H // cfg.global_downsample, W // cfg.global_downsample
        return PatchDraws(patch_y, patch_x, draw_jitter(B * gh * gw), draw_jitter(B * PS * PS))

    def __call__(self, rays_o: torch.Tensor, rays_d: torch.Tensor,
                 draws: Optional[PatchDraws] = None, train: bool = True,
                 **kwargs) -> Dict[str, Any]:
        if not train:
            return self.base_renderer(rays_o, rays_d, jitter=None, train=train, **kwargs)
        if draws is None:
            raise ValueError("a training render needs its draws (PatchRenderer.draw)")

        B, H, W, _ = rays_o.shape
        ds = self.cfg.global_downsample
        PS = self.cfg.patch_size
        gh, gw = H // ds, W // ds
        py, px = draws.patch_y, draws.patch_x

        out_global = self.base_renderer(resize(rays_o, gh, gw), resize(rays_d, gh, gw),
                                        jitter=draws.jitter_global, train=train, **kwargs)
        out_patch = self.base_renderer(rays_o[:, py:py + PS, px:px + PS],
                                       rays_d[:, py:py + PS, px:px + PS],
                                       jitter=draws.jitter_patch, train=train, **kwargs)

        ref = out_patch["comp_rgb"]
        out: Dict[str, Any] = {}
        for k, vg in out_global.items():
            vp = out_patch.get(k)
            if (isinstance(vg, torch.Tensor) and vp is not None and vg.ndim == ref.ndim
                    and vp.shape[:3] == ref.shape[:3]):
                up = resize(vg, H, W)
                if self.cfg.global_detach:
                    up = up.detach()
                up = up.clone()
                up[:, py:py + PS, px:px + PS] = vp
                out[k] = up
            else:
                out[k] = vg
        return out
