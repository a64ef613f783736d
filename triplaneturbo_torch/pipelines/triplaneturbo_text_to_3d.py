"""Text -> textured 3D mesh pipeline.

Counterpart of ``triplaneturbo_tpu/pipelines/triplaneturbo_text_to_3d.py``:
CLIP text encoding -> 4-step shifted DDIM over 6 plane latents (hexa-LoRA
UNet) -> VAE decode of the last step's x̂₀ -> channel split -> SDF and
deformation on the dense grid -> marching cubes -> vertex colors. PyTorch
runs eagerly, so the JAX ``scan`` is a Python loop and each batch item is
extracted in turn. Only the OBJ write touches the host.

``from_pretrained(path)`` reads ``path/config.json`` and loads the weights of a
directory that either package's ``tools/convert_checkpoints.py`` wrote (``geometry``
and ``text_encoder``, each a ``.pt`` of the port's or a flax ``.msgpack``; the JAX
docstring's ``params.msgpack`` is no file its reader reads), or of the reference's
adapter ``.pth`` over random backbone weights; without a path the weights are
random, made from ``seed``.
The entry point runs on the GPU unless the caller passes ``device="cpu"``.
"""

from __future__ import annotations

import json
import os
from dataclasses import dataclass
from typing import Any, Dict, List, Optional, Tuple, Union

import torch

from ..models.clip_text import CLIPTextConfig, CLIPTextEncoder
from ..models.geometry.space_generator import SpaceGeneratorConfig
from ..models.geometry.triplane_geometry import TriplaneGeometry, TriplaneGeometryConfig
from ..models.networks import MLPConfig, get_activation
from ..models.schedulers import Schedule, SchedulerConfig, ddim_step, ddim_timesteps, make_schedule
from ..models.tokenizer import CLIPTokenizer
from ..ops.isosurface import ExtractedMesh, marching_cubes, marching_tets
from ..utils.cuda_graphs import PiecewiseGraph, can_capture
from ..utils.mesh import Mesh
from ..utils.profiling import count, span, stage
from ..utils.saving import save_obj
from ..utils.weights import init_random_


@dataclass
class TriplaneTurboPipelineConfig:
    base_model_name_or_path: str = ""
    num_inference_steps: int = 4
    latent_channels: int = 4
    latent_resolution: int = 32
    n_planes: int = 6
    radius: float = 1.0
    sdf_bias: str = "sphere"
    sdf_bias_params: float = 0.5
    rotate_planes: str = "v1"
    split_channels: str = "v1"
    geo_interpolate: str = "v1"
    tex_interpolate: str = "v2"
    n_feature_dims: int = 3
    color_activation: str = "sigmoid-mipnerf"
    isosurface_resolution: int = 160
    isosurface_deformable_grid: bool = True
    isosurface_method: str = "mc"
    max_verts: int = 98304
    max_faces: int = 196608
    dtype_str: str = "float32"

    @classmethod
    def from_pretrained(cls, path: Optional[str], **kw) -> "TriplaneTurboPipelineConfig":
        """The fields of ``path/config.json`` (when there is one), then ``kw``. Keys of
        the file that are not fields are left out, as in the JAX pipeline (whose files
        may carry more); an unknown key in ``kw`` raises ``TypeError``."""
        cfg_dict: Dict[str, Any] = {}
        if path is not None:
            cfg_path = os.path.join(path, "config.json")
            if os.path.exists(cfg_path):
                with open(cfg_path) as f:
                    names = set(cls.__dataclass_fields__)
                    cfg_dict = {k: v for k, v in json.load(f).items() if k in names}
        return cls(**{**cfg_dict, **kw})


class TriplaneTurboTextTo3DPipeline:
    """Prompt in -> vertex-colored mesh out."""

    def __init__(self, cfg: TriplaneTurboPipelineConfig, geometry: TriplaneGeometry,
                 text_encoder: CLIPTextEncoder, tokenizer: CLIPTokenizer, schedule: Schedule,
                 device: torch.device):
        self.cfg = cfg
        self.geometry = geometry
        self.text_encoder = text_encoder
        self.tokenizer = tokenizer
        self.schedule = schedule
        self.device = device
        self.material = get_activation(cfg.color_activation)
        self._unet_graphs: Dict[tuple, _GraphedDenoise] = {}

    @classmethod
    def from_pretrained(cls, pretrained_model_name_or_path: Optional[str] = None, seed: int = 0,
                        space_generator_overrides: Optional[Dict[str, Any]] = None,
                        text_config: Optional[CLIPTextConfig] = None,
                        device: Union[str, torch.device] = "cuda",
                        **kwargs) -> "TriplaneTurboTextTo3DPipeline":
        """Build the pipeline on ``device`` with random weights from ``seed``, then load
        ``pretrained_model_name_or_path`` when given: a directory (its ``config.json``
        sets the config under ``kwargs``; its ``geometry`` and ``text_encoder`` files,
        ``.pt`` or ``.msgpack``, the weights) or the reference's adapter ``.pth``
        (``utils/checkpoint.py`` ``maybe_load_pipeline_params``).

        The modules are built on the meta device and materialised directly on
        ``device``, so the full-size model never passes through host memory.
        """
        path = pretrained_model_name_or_path
        device = torch.device(device)
        if device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError("no CUDA device: pass device='cpu' to run on the CPU")
        cfg = TriplaneTurboPipelineConfig.from_pretrained(
            path if path and os.path.isdir(path) else None, **kwargs)
        sg_cfg = SpaceGeneratorConfig(dtype_str=cfg.dtype_str, **(space_generator_overrides or {}))
        # the text tower stays float32, as in the JAX pipeline
        text_cfg = text_config or CLIPTextConfig(width=sg_cfg.cross_attention_dim)
        geo_cfg = TriplaneGeometryConfig(
            n_feature_dims=cfg.n_feature_dims,
            sdf_bias=cfg.sdf_bias,
            sdf_bias_params=cfg.sdf_bias_params,
            rotate_planes=cfg.rotate_planes,
            split_channels=cfg.split_channels,
            geo_interpolate=cfg.geo_interpolate,
            tex_interpolate=cfg.tex_interpolate,
            isosurface_deformable_grid=cfg.isosurface_deformable_grid,
            radius=cfg.radius,
            space_generator=sg_cfg,
            mlp=MLPConfig(),
        )
        with torch.device("meta"):
            geometry = TriplaneGeometry(geo_cfg)
            text_encoder = CLIPTextEncoder(text_cfg)
        gen = torch.Generator(device=device).manual_seed(seed)
        geometry = geometry.to_empty(device=device).eval()
        text_encoder = text_encoder.to_empty(device=device).eval()
        init_random_(geometry, gen)
        init_random_(text_encoder, gen)
        if path:
            from ..utils.checkpoint import maybe_load_pipeline_params

            maybe_load_pipeline_params(path, geometry, text_encoder)
        tok_dir = os.path.join(cfg.base_model_name_or_path, "tokenizer")
        tokenizer = (CLIPTokenizer.from_pretrained(tok_dir)
                     if cfg.base_model_name_or_path and os.path.isdir(tok_dir)
                     else CLIPTokenizer())
        return cls(cfg, geometry, text_encoder, tokenizer,
                   make_schedule(SchedulerConfig(), device=device), device)

    # -- stages ------------------------------------------------------------

    def encode_prompt(self, prompts: List[str]) -> torch.Tensor:
        """Prompts -> text states [B, 77, width], float32."""
        ids = torch.as_tensor(self.tokenizer.batch_encode(prompts), dtype=torch.long,
                              device=self.device)
        return self.text_encoder(ids)[0]

    def denoise_latents(self, text_embed: torch.Tensor, init_latents: torch.Tensor
                        ) -> torch.Tensor:
        """The DDIM loop; returns the last step's x̂₀ (what gets decoded).

        Where ``utils/cuda_graphs.py`` ``can_capture`` allows it (on the card, without
        grad or a FLOP count), the student UNet replays as a piecewise CUDA graph, one a
        shape of latents and text states, captured at the first call of that shape;
        elsewhere it runs eagerly. Each step counts ``unet_graph_calls`` and
        ``unet_eager_calls`` on its span. The DDIM update runs eagerly either way, so
        nothing returned lies in a graph's memory."""
        cfg = self.cfg
        unet = self._graphed_unet(text_embed, init_latents)
        latents = x0 = init_latents
        for t in ddim_timesteps(self.schedule, cfg.num_inference_steps):
            with span("ddim_step"):
                count("unet_graph_calls", int(unet is not None))
                count("unet_eager_calls", int(unet is None))
                if unet is None:
                    eps = self.geometry.denoise(latents, text_embed, int(t))
                else:
                    eps = unet(latents, int(t))
                out = ddim_step(self.schedule, eps, int(t), latents, cfg.num_inference_steps)
            latents, x0 = out.prev_sample, out.pred_original_sample
        return x0

    def _graphed_unet(self, text_embed: torch.Tensor, latents: torch.Tensor
                      ) -> Optional["_GraphedDenoise"]:
        """The graphed ``geometry.denoise`` at these shapes, its text states set, or
        None where the UNet runs eagerly."""
        if not can_capture(latents):
            return None
        key = (tuple(latents.shape), tuple(text_embed.shape), text_embed.dtype, latents.device)
        unet = self._unet_graphs.get(key)
        if unet is None:
            unet = self._unet_graphs[key] = _GraphedDenoise(self.geometry, latents, text_embed)
        unet.text.copy_(text_embed)
        return unet

    def field_on_grid(self, space_cache_i: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        """SDF [R³] and deformation [R³, 3] on the dense grid of one item."""
        R = self.cfg.isosurface_resolution
        sdf, deform = self.geometry.forward_field_grid(space_cache_i[None], R)
        if deform is None:
            deform = torch.zeros((R * R * R, 3), dtype=sdf.dtype, device=sdf.device)
        return sdf.reshape(-1), deform

    def extract_mesh(self, sdf: torch.Tensor, deform: torch.Tensor) -> ExtractedMesh:
        """Marching cubes (or tets) on the grid; vertices in world coordinates [-1, 1]."""
        cfg = self.cfg
        R = cfg.isosurface_resolution
        # empty-field fallback: a sphere SDF
        lin = torch.linspace(-1.0, 1.0, R, device=sdf.device)
        grid = torch.stack(torch.meshgrid(lin, lin, lin, indexing="ij"), dim=-1).reshape(-1, 3)
        has_crossing = (sdf > 0).any() & (sdf < 0).any()
        sdf = torch.where(has_crossing, sdf, torch.linalg.norm(grid, dim=-1) - 1.0)
        extract = {"mc": marching_cubes, "mt": marching_tets}[cfg.isosurface_method]
        m = extract(sdf.reshape(R, R, R),
                    deform.reshape(R, R, R, 3) if cfg.isosurface_deformable_grid else None,
                    max_verts=cfg.max_verts, max_faces=cfg.max_faces)
        return m._replace(verts=m.verts * 2.0 - 1.0)

    def colorize(self, verts: torch.Tensor, space_cache_i: torch.Tensor) -> torch.Tensor:
        feats = self.geometry.export(verts[None], space_cache_i[None])["features"][0]
        return self.material(feats)

    # -- public API ----------------------------------------------------------

    @torch.no_grad()
    def __call__(self, prompt: Union[str, List[str]], num_results_per_prompt: int = 1,
                 generator: Optional[torch.Generator] = None,
                 latents: Optional[torch.Tensor] = None, colorize: bool = True,
                 return_dict: bool = True):
        """``latents`` [B, 6, r, r, 4] float32, or drawn from ``generator`` (seed 42
        when neither is given)."""
        with span("pipeline"):  # the root: its id is the call's request id
            if isinstance(prompt, str):
                prompt = [prompt]
            prompt = [p for p in prompt for _ in range(num_results_per_prompt)]
            B = len(prompt)
            cfg = self.cfg
            if latents is None:
                if generator is None:
                    generator = torch.Generator(device=self.device).manual_seed(42)
                r = cfg.latent_resolution
                latents = torch.randn((B, cfg.n_planes, r, r, cfg.latent_channels),
                                      generator=generator, device=self.device)
            latents = latents.to(device=self.device, dtype=torch.float32)

            with stage("text_encoder"):
                text_embed = self.encode_prompt(prompt)
            with stage("denoise"):
                out_latents = self.denoise_latents(text_embed, latents)
            with stage("vae_decode"):
                space_cache = self.geometry.decode(out_latents)
            meshes = []
            for i in range(B):
                with stage("field_grid"):
                    sdf, deform = self.field_on_grid(space_cache[i])
                with stage("marching_cubes"):
                    m = self.extract_mesh(sdf, deform)
                with stage("colorize"):
                    color = self.colorize(m.verts, space_cache[i]) if colorize else None
                meshes.append(Mesh(v_pos=m.verts, t_pos_idx=m.faces, v_mask=m.vert_mask,
                                   t_mask=m.face_mask, v_rgb=color))
            if return_dict:
                return {"space_cache": space_cache, "latents": out_latents, "mesh": meshes}
            return meshes


class _GraphedDenoise:
    """``geometry.denoise`` at one shape as a :class:`PiecewiseGraph` over static
    buffers: the latents (f32), the text states, the timestep (``long``, one a plane)
    and ε, the output. A call copies the latents in, fills the timestep and replays
    (capturing first, at the first call); the text states are set once a pipeline call.
    """

    def __init__(self, geometry: TriplaneGeometry, latents: torch.Tensor,
                 text_embed: torch.Tensor):
        B, P = latents.shape[:2]
        self.latents = torch.empty_like(latents, memory_format=torch.contiguous_format)
        self.text = torch.empty_like(text_embed, memory_format=torch.contiguous_format)
        self.t = torch.empty(B * P, dtype=torch.long, device=latents.device)
        self.graph = PiecewiseGraph(lambda: geometry.denoise(self.latents, self.text, self.t))

    def __call__(self, latents: torch.Tensor, t: int) -> torch.Tensor:
        self.latents.copy_(latents)
        self.t.fill_(t)
        if not self.graph.steps:
            self.graph.capture()
        return self.graph.replay()


def export_obj(mesh: Mesh, save_path: str, save_normal: bool = False) -> List[str]:
    """Vertex-colored OBJ of one mesh, with its area-weighted vertex normals when
    ``save_normal`` (the native writer without them, the Python one with)."""
    v_nrm = mesh.vertex_normals() if save_normal else None
    return [save_obj(save_path, mesh.v_pos, mesh.t_pos_idx, v_rgb=mesh.v_rgb, v_nrm=v_nrm,
                     v_mask=mesh.v_mask, t_mask=mesh.t_mask)]
