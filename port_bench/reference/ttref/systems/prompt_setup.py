"""The dual prompt processor and the text-state dict the trainer reads.

Counterpart of ``triplaneturbo_tpu/systems/prompt_setup.py``: the SD-1.5 and
SD-2.1 text towers (random weights from ``seed``; f32, as the JAX package runs
them) behind one :class:`DualStableDiffusionPromptProcessor`, and
``embeds_for(prompts)``, which gives the trainer's keys.
"""

from __future__ import annotations

from typing import Callable, Dict, List, Optional, Tuple, Union

import torch

from ..models.clip_text import CLIPTextConfig, CLIPTextEncoder, sd15_text_config
from ..models.prompt_processors.callable_processor import (
    DualStableDiffusionPromptProcessor,
    PromptProcessorConfig,
)
from ..utils.weights import init_random_


def _text_encoder(cfg: CLIPTextConfig, seed: int, device: torch.device) -> CLIPTextEncoder:
    with torch.device("meta"):
        enc = CLIPTextEncoder(cfg)
    enc = enc.to_empty(device=device).eval().requires_grad_(False)
    init_random_(enc, torch.Generator(device=device).manual_seed(seed))
    return enc


def build_prompt_setup(cross_attention_dim: int, seed: int = 0, negative_prompt: str = "",
                       device: Union[str, torch.device] = "cuda",
                       cache_dir: Optional[str] = None,
                       ) -> Tuple[DualStableDiffusionPromptProcessor,
                                  Callable[[List[str]], Dict[str, torch.Tensor]]]:
    """(processor, embeds_for). ``embeds_for(prompts)`` gives: ``cond_local`` and
    ``cond_21`` (SD-2.1-width states of the prompts, for the student and the MV and SD
    teachers), ``uncond_21``, ``cond_15`` and ``uncond_15`` (SD-1.5 width, for
    RichDreamer; the full SD-1.5 tower only when ``cross_attention_dim`` is 1024, else
    a tower of that width) and ``global_21`` (the pooled SD-2.1 states, for the
    background's hypernetwork). The encoders are on ``device`` and the cache under
    ``cache_dir`` (the config's default when None)."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: pass device='cpu' to run on the CPU")
    c_dim = cross_attention_dim
    enc21 = _text_encoder(CLIPTextConfig(width=c_dim), seed + 1, device)
    enc15 = _text_encoder(sd15_text_config() if c_dim == 1024 else CLIPTextConfig(width=c_dim),
                          seed + 2, device)
    extra = {} if cache_dir is None else {"cache_dir": cache_dir}
    processor = DualStableDiffusionPromptProcessor(
        PromptProcessorConfig(model_tag="sd15", negative_prompt=negative_prompt, **extra), enc15,
        PromptProcessorConfig(model_tag="sd21", negative_prompt=negative_prompt, **extra), enc21)

    def embeds_for(prompts: List[str]) -> Dict[str, torch.Tensor]:
        out = processor(list(prompts))
        first, second = out["first"], out["second"]
        return {"cond_local": second.local_text_embeddings,
                "cond_21": second.local_text_embeddings,
                "uncond_21": second.get_uncond_text_embeddings(),
                "cond_15": first.local_text_embeddings,
                "uncond_15": first.get_uncond_text_embeddings(),
                "global_21": second.global_text_embeddings}

    return processor, embeds_for
