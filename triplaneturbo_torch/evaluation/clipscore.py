"""CLIP-score evaluation: CLIPScore and Recall@1 on rendered mesh views.

Counterpart of ``triplaneturbo_tpu/evaluation/clipscore.py``: each prompt's views
are scored against "A photo depicts <prompt>" as W · max(cos, 0) (W = 2.5),
averaged over views and prompts, and R@1 is the share of prompts whose mean image
feature is nearest its own text among the prompt gallery. The towers are ViT-B/32
(:mod:`..models.clip_vision`) and its 512-wide text tower
(:mod:`..models.clip_text`). Without a checkpoint they are random, from a
``torch.Generator`` seeded with ``seed``: the scores are then only self-consistent.
"""

from __future__ import annotations

import math
import os
from typing import Dict, List, Optional, Union

import numpy as np
import torch

from ..models.clip_text import CLIPTextConfig, CLIPTextEncoder
from ..models.clip_vision import CLIPVisionConfig, CLIPVisionEncoder, preprocess_for_clip
from ..models.tokenizer import CLIPTokenizer
from ..utils.weights import init_random_

PREFIX = "A photo depicts "
W = 2.5


def clip_b32_text_config() -> CLIPTextConfig:
    return CLIPTextConfig(width=512, layers=12, heads=8, intermediate=2048,
                          hidden_act="quick_gelu")


def _normalize(f: torch.Tensor) -> torch.Tensor:
    return f / torch.linalg.vector_norm(f, dim=-1, keepdim=True)


class CLIPScorer:
    """Image and text features, CLIPScore and R@1, on ``device``."""

    def __init__(self, vision: Optional[CLIPVisionEncoder] = None,
                 text: Optional[CLIPTextEncoder] = None,
                 text_projection: Optional[torch.Tensor] = None,
                 tokenizer: Optional[CLIPTokenizer] = None, seed: int = 0,
                 device: Union[str, torch.device] = "cuda"):
        """Towers not given are built with random weights from ``seed`` (the image
        tower, then the text tower, then the text projection N(0, 1/width))."""
        device = torch.device(device)
        if device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError("no CUDA device: pass device='cpu' to run on the CPU")
        gen = torch.Generator(device=device).manual_seed(seed)
        if vision is None:
            vision = CLIPVisionEncoder(CLIPVisionConfig()).to(device)
            init_random_(vision, gen)
        if text is None:
            text = CLIPTextEncoder(clip_b32_text_config()).to(device)
            init_random_(text, gen)
        self.vision = vision.to(device).eval().requires_grad_(False)
        self.text = text.to(device).eval().requires_grad_(False)
        if text_projection is None:
            width, proj = self.text.cfg.width, self.vision.cfg.projection_dim
            text_projection = torch.randn((width, proj), generator=gen,
                                          device=device) / math.sqrt(width)
        self.text_projection = text_projection.to(device=device, dtype=torch.float32)
        self.tokenizer = tokenizer or CLIPTokenizer()
        self.device = device

    @classmethod
    def from_msgpack(cls, path: str, seed: int = 0,
                     device: Union[str, torch.device] = "cuda") -> "CLIPScorer":
        """A scorer from a ``clip_scorer.msgpack`` (``{"vision", "text",
        "text_projection"}``, the towers as flax trees), what the JAX package's
        ``tools/convert_checkpoints.py --clip`` writes and the port's with ``--format
        msgpack`` (:func:`save_scorer`). Like the JAX reader and the HF route, it raises on a parameter the
        file leaves random."""
        from ..utils.checkpoint import load_flax_tree, load_msgpack

        tree = load_msgpack(path)
        if not (isinstance(tree, dict) and {"vision", "text", "text_projection"} <= set(tree)):
            raise ValueError(f"{path}: a scorer msgpack holds vision, text and text_projection")
        scorer = cls(seed=seed, device=device)
        load_flax_tree(tree["vision"], scorer.vision, "clip vision")
        load_flax_tree(tree["text"], scorer.text, "clip text")
        proj = tree["text_projection"]
        proj = proj.float() if isinstance(proj, torch.Tensor) else torch.from_numpy(
            np.array(proj, dtype=np.float32))
        if tuple(proj.shape) != tuple(scorer.text_projection.shape):
            raise ValueError(f"{path}: text_projection {tuple(proj.shape)}, the scorer's "
                             f"{tuple(scorer.text_projection.shape)}")
        scorer.text_projection = proj.to(scorer.device)
        return scorer

    @classmethod
    def from_checkpoint(cls, path: str, seed: int = 0,
                        device: Union[str, torch.device] = "cuda") -> "CLIPScorer":
        """A scorer from ``path``, by its extension: a ``.msgpack``
        (:meth:`from_msgpack`), the ``clip_scorer.pt`` that
        ``tools/convert_checkpoints.py --clip`` writes (``{"vision", "text",
        "text_projection"}``, :func:`save_scorer`), or an HF ``CLIPModel`` (ViT-B/32) state dict, converted
        here. Unpickles a torch ``path``."""
        from ..utils.checkpoint import _state_numpy, _torch_load

        if str(path).endswith(".msgpack"):
            return cls.from_msgpack(path, seed=seed, device=device)
        scorer = cls(seed=seed, device=device)
        ckpt = _torch_load(path)
        if isinstance(ckpt, dict) and {"vision", "text", "text_projection"} <= set(ckpt):
            scorer.vision.load_state_dict(ckpt["vision"])
            scorer.text.load_state_dict(ckpt["text"])
            scorer.text_projection = torch.as_tensor(ckpt["text_projection"]).to(
                device=scorer.device, dtype=torch.float32)
            return scorer
        load_hf_clip(_state_numpy(ckpt.get("state_dict", ckpt)), scorer, strict=True)
        return scorer

    @torch.no_grad()
    def image_features(self, images: torch.Tensor) -> torch.Tensor:
        """[V, H, W, 3] in [0, 1] -> unit image features [V, projection_dim]."""
        x = preprocess_for_clip(images.to(self.device, torch.float32),
                                self.vision.cfg.image_size)
        return _normalize(self.vision(x))

    @torch.no_grad()
    def text_features(self, prompts: List[str], prefix: str = PREFIX) -> torch.Tensor:
        ids = torch.as_tensor(self.tokenizer.batch_encode([prefix + p for p in prompts]),
                              dtype=torch.long, device=self.device)
        return _normalize(self.text(ids)[1] @ self.text_projection)

    @torch.no_grad()
    def score(self, images_per_prompt: Dict[str, torch.Tensor]) -> Dict[str, float]:
        """prompt -> [V, H, W, 3] in [0, 1]; returns {"clip_score", "recall_at_1"}."""
        prompts = list(images_per_prompt)
        tfeat = self.text_features(prompts)
        sims, mean_feats = [], []
        for i, p in enumerate(prompts):
            ifeat = self.image_features(torch.as_tensor(images_per_prompt[p]))
            cos = ifeat @ tfeat[i]
            sims.append(float(torch.clamp_min(cos, 0.0).mean() * W))
            mean_feats.append(ifeat.mean(dim=0))
        gallery = _normalize(torch.stack(mean_feats))
        sim = gallery @ tfeat.T  # image x text
        hits = torch.argmax(sim, dim=1) == torch.arange(len(prompts), device=sim.device)
        return {"clip_score": float(np.mean(sims)), "recall_at_1": float(hits.float().mean())}


def save_scorer(path: str, scorer: CLIPScorer) -> str:
    """A scorer's ``{"vision", "text", "text_projection"}`` into ``path``, as
    :meth:`CLIPScorer.from_checkpoint` reads it: state dicts in a ``.pt``, flax trees in
    a ``.msgpack``."""
    from ..utils.checkpoint import flax_params, save_msgpack

    if str(path).endswith(".msgpack"):
        return save_msgpack(path, {"vision": flax_params(scorer.vision),
                                   "text": flax_params(scorer.text),
                                   "text_projection": scorer.text_projection})
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    torch.save({"vision": {k: v.cpu() for k, v in scorer.vision.state_dict().items()},
                "text": {k: v.cpu() for k, v in scorer.text.state_dict().items()},
                "text_projection": scorer.text_projection.cpu()}, path)
    return path


def load_hf_clip(sd: Dict[str, np.ndarray], scorer: CLIPScorer, strict: bool = True):
    """An HF ``CLIPModel`` state dict (numpy) onto ``scorer``'s towers and text
    projection, in place; returns (names loaded, keys that did not land). With
    ``strict`` a key that did not land or a parameter left random raises."""
    from ..utils.checkpoint import _apply, _unloaded
    from ..utils.convert_torch import convert_clip_text, convert_clip_vision

    vis = convert_clip_vision(sd, n_layers=scorer.vision.cfg.layers)
    proj = vis.pop("__text_projection__", None)
    loaded, bad = _apply(vis, scorer.vision, "clip vision", strict)
    _unloaded("clip vision", scorer.vision, loaded, strict)
    t_loaded, t_bad = _apply(convert_clip_text(sd, n_layers=scorer.text.cfg.layers),
                             scorer.text, "clip text", strict)
    _unloaded("clip text", scorer.text, t_loaded, strict)
    if proj is None:
        if strict:
            raise ValueError("strict clip load failed: no text_projection.weight")
    else:
        scorer.text_projection = torch.tensor(np.ascontiguousarray(proj), dtype=torch.float32,
                                              device=scorer.device)
    return loaded + t_loaded, bad + t_bad
