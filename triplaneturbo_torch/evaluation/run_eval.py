"""Evaluation loop: prompts -> meshes -> 4-view renders -> CLIP score.

    python3 -m triplaneturbo_torch.evaluation.run_eval [--prompts LIB.json] [--out DIR] \
        [--limit N] [--weights DIR_OR_PTH] [--views 4] [--render-size 512] [--save-obj] \
        [--save-grid] [--clip-ckpt clip_scorer.pt] [--device cuda|cpu]

Counterpart of the root ``evaluation/run_eval.py``: the test split of the prompt
library (or ``--prompts``), the first ``--limit`` of them, each through the pipeline
(its latents from a generator seeded by ``fold_seed(42, prompt index)``), rendered
with :func:`~triplaneturbo_torch.evaluation.mesh_render.render_mesh_views` and scored by
:class:`~triplaneturbo_torch.evaluation.clipscore.CLIPScorer` (random towers unless
``--clip-ckpt``: the scores are then only self-consistent). With a
``torch.distributed`` process group up, rank r takes prompts ``[r::world]`` and
writes ``metrics_rank{r}.json``. The metrics also hold each prompt's per-view
rasterizer overflow counts, which the JAX harness drops; any count above 0 is
warned of. The card is synchronised before the clock is read. Runs on ``cuda``
unless ``--device cpu``.
"""

from __future__ import annotations

import argparse
import json
import os
import re
import sys
import time
import warnings
from typing import Any, Dict, List, Optional



def prompt_slug(i: int, prompt: str) -> str:
    """A file-safe, unique name for prompt ``i``'s files: the index first, then the
    prompt with every run of other characters than [A-Za-z0-9_-] made one ``_``, cut
    to 60 characters."""
    return f"{i:03d}_" + re.sub(r"[^A-Za-z0-9_-]+", "_", prompt)[:60]


def _parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(prog="python3 -m triplaneturbo_torch.evaluation.run_eval")
    ap.add_argument("--prompts", default=None, help="json prompt library (its test split)")
    ap.add_argument("--out", default="outputs/eval")
    ap.add_argument("--limit", type=int, default=8)
    ap.add_argument("--weights", default=None, help="a converted directory or an adapter .pth")
    ap.add_argument("--views", type=int, default=4)
    ap.add_argument("--render-size", type=int, default=512)
    ap.add_argument("--save-obj", action="store_true")
    ap.add_argument("--save-grid", action="store_true",
                    help="a PNG grid of each prompt's rendered views")
    ap.add_argument("--clip-ckpt", default=None,
                    help="clip_scorer.pt (tools/convert_checkpoints.py --clip) or an HF "
                         "clip-vit-base-patch32 state dict; random towers when absent")
    ap.add_argument("--device", default="cuda", help="cuda (the default) or cpu")
    return ap


def load_prompts(path: Optional[str]) -> List[str]:
    """The test split of the library at ``path`` (a dict with "test", or a list), or
    of the data module's default library."""
    if path and os.path.exists(path):
        with open(path) as f:
            lib = json.load(f)
        return list(lib["test"] if isinstance(lib, dict) else lib)
    from ..data.multiview_multiprompt import DataModuleConfig, load_prompt_library

    return load_prompt_library(DataModuleConfig())["test"]


def main(argv: Optional[List[str]] = None, pipe=None, scorer=None) -> Dict[str, Any]:
    """Run the evaluation ``argv`` asks for and return the metrics. ``pipe`` and
    ``scorer`` replace the pipeline and the scorer the arguments would build (a caller
    that holds them already)."""
    args = _parser().parse_args(sys.argv[1:] if argv is None else list(argv))
    import torch

    from ..pipelines.triplaneturbo_text_to_3d import TriplaneTurboTextTo3DPipeline, export_obj
    from ..utils.misc import fold_seed, get_rank, get_world_size
    from ..utils.saving import save_image_grid
    from .clipscore import CLIPScorer
    from .mesh_render import render_mesh_views

    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: pass --device cpu to run on the CPU")
    prompts = load_prompts(args.prompts)[:args.limit]
    rank, world = get_rank(), get_world_size()
    mine = list(range(len(prompts)))[rank::world]

    if pipe is None:
        pipe = TriplaneTurboTextTo3DPipeline.from_pretrained(args.weights, device=device,
                                                             dtype_str="bfloat16")
    if scorer is None:
        scorer = (CLIPScorer.from_checkpoint(args.clip_ckpt, device=device) if args.clip_ckpt
                  else CLIPScorer(device=device))
    os.makedirs(args.out, exist_ok=True)

    def sync():
        if device.type == "cuda":
            torch.cuda.synchronize(device)

    images, overflow = {}, {}
    t_total = 0.0
    for n, i in enumerate(mine):
        prompt = prompts[i]
        sync()
        t0 = time.perf_counter()
        gen = torch.Generator(device=pipe.device).manual_seed(fold_seed(42, i))
        mesh = pipe(prompt, generator=gen)["mesh"][0]
        views = render_mesh_views(mesh, n_views=args.views, height=args.render_size,
                                  width=args.render_size)
        sync()
        dt = time.perf_counter() - t0
        t_total += dt
        images[prompt] = views.images
        counts = {"n_span_overflow": views.n_span_overflow.tolist(),
                  "n_list_overflow": views.n_list_overflow.tolist()}
        overflow[prompt] = counts
        if any(c > 0 for v in counts.values() for c in v):
            warnings.warn(f"{prompt!r}: the rasterizer dropped faces in its eval views "
                          f"({counts}); those faces are missing from the images")
        slug = prompt_slug(i, prompt)
        if args.save_obj:
            export_obj(mesh, os.path.join(args.out, slug, "model.obj"))
        if args.save_grid:
            save_image_grid(os.path.join(args.out, f"{slug}.png"),
                            list(views.images.float().cpu().numpy()))
        print(f"[triplaneturbo_torch] [{n + 1}/{len(mine)}] {dt:.2f}s  {prompt}", flush=True)

    metrics: Dict[str, Any] = scorer.score(images) if images else {}
    metrics["prompts"] = len(mine)
    metrics["mean_latency_s"] = t_total / max(len(mine), 1)
    metrics["overflow"] = overflow
    with open(os.path.join(args.out, f"metrics_rank{rank}.json"), "w") as f:
        json.dump(metrics, f, indent=2)
    print(json.dumps({k: v for k, v in metrics.items() if k != "overflow"}), flush=True)
    return metrics


if __name__ == "__main__":
    main()
