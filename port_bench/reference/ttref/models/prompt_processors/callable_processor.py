"""Prompt processors: precomputed CLIP text states, cached on disk.

Counterpart of ``triplaneturbo_tpu/models/prompt_processors/callable_processor.py``:

* the states are encoded in batches and cached one ``.npz`` a prompt, keyed by
  md5(model tag, encoder width, prompt, kind), so training never encodes a prompt
  twice, and two encoders of one tag but different widths do not share entries;
* with ``torch.distributed`` initialised, each rank encodes its
  ``prompts[rank::world]`` share of the uncached prompts, then every rank loads the
  whole set from the shared cache;
* the dual processor carries both teacher text spaces: SD-1.5 (768-d, RichDreamer)
  and SD-2.1 (1024-d, the student, MVDream and SD), each with its negative prompt's
  states as the unconditional ones.

The cache is the JAX package's format (``local`` [77, D] and ``pooled`` [D], f32).
"""

from __future__ import annotations

import hashlib
import os
from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from ..clip_text import CLIPTextEncoder
from ..tokenizer import CLIPTokenizer


def _cache_key(model_tag: str, prompt: str, kind: str = "local", width: int = 0) -> str:
    # the width is in the key: encoders of one tag and other sizes must not collide
    ident = f"{model_tag}-w{width}-{prompt}-{kind}"
    return hashlib.md5(ident.encode()).hexdigest()


def _rank_world() -> Tuple[int, int]:
    """This process's rank and the world size; 0 and 1 without torch.distributed."""
    dist = torch.distributed
    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


def _barrier() -> None:
    dist = torch.distributed
    if dist.is_available() and dist.is_initialized():
        dist.barrier()


@dataclass
class PromptProcessorConfig:
    model_tag: str = "sd21"
    negative_prompt: str = ""
    cache_dir: str = ".cache/text_embeddings"
    use_local_text_embeddings: bool = True
    batch_size: int = 32


class PromptProcessorOutput:
    """The states of N prompts and of the unconditional (negative) prompt."""

    def __init__(self, local: torch.Tensor, pooled: torch.Tensor, uncond_local: torch.Tensor,
                 uncond_pooled: torch.Tensor, use_local_text_embeddings: bool = True):
        self.local_text_embeddings = local  # [N, 77, D]
        self.global_text_embeddings = pooled  # [N, D]
        self.uncond_local = uncond_local  # [1, 77, D]
        self.uncond_pooled = uncond_pooled  # [1, D]
        self.use_local = use_local_text_embeddings

    def get_global_text_embeddings(self, use_local_text_embeddings: Optional[bool] = None):
        use_local = self.use_local if use_local_text_embeddings is None else use_local_text_embeddings
        return self.local_text_embeddings if use_local else self.global_text_embeddings

    def get_uncond_text_embeddings(self) -> torch.Tensor:
        """The unconditional states repeated once a prompt."""
        n = self.local_text_embeddings.shape[0]
        u = self.uncond_local if self.use_local else self.uncond_pooled
        return u.repeat_interleave(n, dim=0)

    def get_text_embeddings(self) -> torch.Tensor:
        """cat(cond, uncond), the guidance's input."""
        return torch.cat([self.get_global_text_embeddings(), self.get_uncond_text_embeddings()])


class _Encoder:
    """One text encoder, its tokenizer and its cache directory."""

    def __init__(self, cfg: PromptProcessorConfig, text_encoder: CLIPTextEncoder,
                 tokenizer: CLIPTokenizer):
        self.cfg = cfg
        self.text_encoder = text_encoder
        self.tokenizer = tokenizer
        self.width = int(text_encoder.cfg.width)
        os.makedirs(cfg.cache_dir, exist_ok=True)

    @property
    def device(self) -> torch.device:
        return next(self.text_encoder.parameters()).device

    def _path(self, prompt: str) -> str:
        return os.path.join(self.cfg.cache_dir,
                            _cache_key(self.cfg.model_tag, prompt, width=self.width) + ".npz")

    @torch.no_grad()
    def prepare(self, prompts: List[str]) -> None:
        """Encode this rank's share of the uncached prompts and write their entries."""
        todo = [p for p in dict.fromkeys(prompts) if not os.path.exists(self._path(p))]
        rank, world = _rank_world()
        shard = todo[rank::world]
        bs = self.cfg.batch_size
        for i in range(0, len(shard), bs):
            chunk = shard[i:i + bs]
            ids = torch.as_tensor(self.tokenizer.batch_encode(chunk), dtype=torch.long,
                                  device=self.device)
            local, pooled = (x.cpu().numpy() for x in self.text_encoder(ids))
            for j, p in enumerate(chunk):
                np.savez(self._path(p), local=local[j], pooled=pooled[j])
        _barrier()

    def load(self, prompts: List[str]) -> Tuple[torch.Tensor, torch.Tensor]:
        """([N, 77, D], [N, D]) of ``prompts`` from the cache (encoding what is missing),
        on the encoder's device."""
        missing = [p for p in prompts if not os.path.exists(self._path(p))]
        if missing:
            self.prepare(missing)
        locals_, pooleds, stale = [], [], []
        for p in prompts:
            with np.load(self._path(p)) as z:
                if z["local"].shape[-1] != self.width:
                    stale.append(p)
                    continue
                locals_.append(z["local"])
                pooleds.append(z["pooled"])
        if stale:
            # an entry of another width under this key (a cache written before the
            # width was in the key): encode it again
            for p in stale:
                os.remove(self._path(p))
            self.prepare(stale)
            return self.load(prompts)
        dev = self.device
        return (torch.from_numpy(np.stack(locals_)).to(dev),
                torch.from_numpy(np.stack(pooleds)).to(dev))


class StableDiffusionMultipromptPromptProcessor:
    """One text space (SD-2.1 by default)."""

    def __init__(self, cfg: PromptProcessorConfig, text_encoder: CLIPTextEncoder,
                 tokenizer: Optional[CLIPTokenizer] = None):
        self.cfg = cfg
        self.enc = _Encoder(cfg, text_encoder, tokenizer or CLIPTokenizer())

    def prepare_text_embeddings(self, prompts: List[str]) -> None:
        self.enc.prepare(prompts + [self.cfg.negative_prompt, ""])

    def __call__(self, prompts: List[str]) -> PromptProcessorOutput:
        local, pooled = self.enc.load(prompts)
        u_local, u_pooled = self.enc.load([self.cfg.negative_prompt])
        return PromptProcessorOutput(local, pooled, u_local, u_pooled,
                                     self.cfg.use_local_text_embeddings)


class DualStableDiffusionPromptProcessor:
    """Both teacher text spaces: SD-1.5 (768) for RichDreamer and SD-2.1 (1024)."""

    def __init__(self, cfg_1st: PromptProcessorConfig, enc_1st: CLIPTextEncoder,
                 cfg_2nd: PromptProcessorConfig, enc_2nd: CLIPTextEncoder,
                 tokenizer: Optional[CLIPTokenizer] = None):
        tok = tokenizer or CLIPTokenizer()
        self.p1 = StableDiffusionMultipromptPromptProcessor(cfg_1st, enc_1st, tok)
        self.p2 = StableDiffusionMultipromptPromptProcessor(cfg_2nd, enc_2nd, tok)

    def prepare_text_embeddings(self, prompts: List[str]) -> None:
        self.p1.prepare_text_embeddings(prompts)
        self.p2.prepare_text_embeddings(prompts)

    def __call__(self, prompts: List[str]) -> Dict[str, PromptProcessorOutput]:
        return {"first": self.p1(prompts), "second": self.p2(prompts)}
