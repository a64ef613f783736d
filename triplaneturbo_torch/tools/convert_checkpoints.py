"""Convert the reference's released checkpoints into the port's own files.

    python3 -m triplaneturbo_torch.tools.convert_checkpoints --out DIR \
        [--adapter triplane_turbo_sd_v1.pth] [--sd-base SD21_DIFFUSERS_DIR] \
        [--mvdream sd-v2.1-base-4view.pt] [--richdreamer nd_mv_ema.ckpt] \
        [--sd-teacher SD21_DIFFUSERS_DIR] [--clip CLIP_B32.bin] [--device cuda|cpu] \
        [--format pt|msgpack] [--strict]

Counterpart of the root ``tools/convert_checkpoints.py``, which writes the JAX
package's ``.msgpack`` files. ``--format pt`` (the default) writes the port's files
below; ``--format msgpack`` writes the JAX tool's names and layout instead
(``geometry.msgpack`` and ``text_encoder.msgpack`` of ``{"params": tree}``,
``{kind}_teacher.msgpack`` of ``{"unet", "vae"}``, ``clip_scorer.msgpack`` of
``{"vision", "text", "text_projection"}``, the trees in the flax layout of
``utils/weights.py`` ``module_to_flax_tree``), which the JAX package loads as its own
and the port reads as well:

* ``--sd-base`` and ``--adapter``: the student (the SD-2.1-base UNet and VAE decoder
  under the adapter: hexa-LoRA, LoCon, the ``conv_out`` retrofit, the field MLPs)
  -> ``geometry.pt``, and the SD-2.1 text tower -> ``text_encoder.pt``, with a
  ``config.json``: the directory ``TriplaneTurboTextTo3DPipeline.from_pretrained``
  reads;
* ``--mvdream``, ``--richdreamer``, ``--sd-teacher``: the teachers (LDM layout with
  EMA shadows, or diffusers) -> ``{mv,rd,sd}_teacher.pt``, which the guidance's
  ``{kind}_ckpt_path`` and ``load_teacher_params`` read;
* ``--clip``: the evaluation harness's scorer (an HF ``CLIPModel`` ViT-B/32 state
  dict: both towers and the text projection) -> ``clip_scorer.pt``
  (``{"vision", "text", "text_projection"}``), which ``CLIPScorer.from_checkpoint``
  and ``run_eval --clip-ckpt`` read.

Each module is built as ``from_pretrained`` and ``build_teacher`` build it (random
weights from seed 0, the student in float32, the teachers in bf16, as the JAX tool
builds them, on ``--device``), the converted tensors are written onto it and its
``state_dict`` is saved; ``from_pretrained``'s ``dtype_str`` casts the student at load
time. Every conversion prints its counts: parameters, loaded, parameters not loaded
(left at their random initialisation), keys the module has no place for (the SD-base
VAE's encoder, ``quant_conv`` and 3-channel ``conv_out``, which the student's
decoder lacks) and keys that did not land. ``--strict`` fails on a key that did not
land and on a parameter not loaded; without it both are warned of. Reads the checkpoints with
``torch.load``'s unpickling: convert only checkpoints you trust.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
from typing import Any, Dict, List, Optional

import torch

from ..utils.checkpoint import (
    _apply,
    _torch_state_numpy,
    _unloaded,
    _without,
    load_teacher_params,
    load_torch_adapter,
    save_params,
    save_teacher,
)
from ..utils.convert_torch import convert_clip_text, convert_unet, convert_vae

# what the SD-2.1-base VAE holds and the student's decoder has no place for: the
# encoder, quant_conv and the 3-channel conv_out that the retrofit replaces
_STUDENT_VAE_LACKS = ("encoder/", "quant_conv/", "decoder/conv_out/")


def _report(what: str, module: torch.nn.Module, loaded: List[str], dropped: int,
            mismatched: List[str], strict: bool) -> Dict[str, Any]:
    """Print and return the counts of one conversion; with ``strict``, a parameter
    not loaded raises."""
    not_loaded = _unloaded(what, module, loaded, strict)
    stats = {"params": len(list(module.parameters())), "loaded": len(set(loaded)),
             "not_loaded": len(not_loaded), "dropped": dropped, "mismatched": len(mismatched)}
    print(f"{what}: {json.dumps(stats)}", flush=True)
    return stats


def convert_student(adapter: Optional[str], sd_base: Optional[str], out_dir: str, strict: bool,
                    pipe, fmt: str = "pt") -> Dict[str, Any]:
    """The SD-base UNet and VAE (diffusers) and the adapter ``.pth`` onto the geometry
    of ``pipe`` (a ``TriplaneTurboTextTo3DPipeline``) -> ``out_dir/geometry.{fmt}``;
    returns the counts."""
    geometry = pipe.geometry
    loaded, dropped, mismatched = [], 0, []
    for sub, convert, prefix, lacks in (("unet", convert_unet, "space_generator/unet/", ()),
                                        ("vae", convert_vae, "space_generator/vae/",
                                         _STUDENT_VAE_LACKS)):
        path = os.path.join(sd_base or "", sub, "diffusion_pytorch_model.bin")
        if sd_base and os.path.exists(path):
            flat = convert(_torch_state_numpy(path))
            kept = _without(flat, lacks)
            got, bad = _apply(kept, geometry, f"student {sub}", strict, prefix)
            loaded += got
            dropped += len(flat) - len(kept)
            mismatched += bad
    if adapter:
        got, bad = load_torch_adapter(adapter, geometry, strict=strict)
        loaded += got
        mismatched += bad
    stats = _report("student", geometry, loaded, dropped, mismatched, strict)
    save_params(os.path.join(out_dir, f"geometry.{fmt}"), geometry)
    return stats


def convert_text_encoder(sd_base: str, out_dir: str, strict: bool,
                         pipe, fmt: str = "pt") -> Optional[Dict[str, Any]]:
    """``sd_base/text_encoder/pytorch_model.bin`` (HF ``CLIPTextModel``) onto the text
    encoder of ``pipe`` -> ``out_dir/text_encoder.{fmt}``; returns the counts, or None
    without the file."""
    path = os.path.join(sd_base, "text_encoder", "pytorch_model.bin")
    if not os.path.exists(path):
        print(f"skip text encoder ({path} absent)", flush=True)
        return None
    enc = pipe.text_encoder
    loaded, mismatched = _apply(convert_clip_text(_torch_state_numpy(path),
                                                  n_layers=enc.cfg.layers),
                                enc, "text encoder", strict)
    stats = _report("text encoder", enc, loaded, 0, mismatched, strict)
    save_params(os.path.join(out_dir, f"text_encoder.{fmt}"), enc)
    return stats


def convert_teacher(kind: str, ckpt: str, out_dir: str, strict: bool,
                    dtype_str: str = "bfloat16", device: str = "cuda",
                    sizes: Optional[Dict[str, Any]] = None, fmt: str = "pt") -> Dict[str, Any]:
    """A teacher checkpoint (LDM or diffusers) -> ``out_dir/{kind}_teacher.{fmt}``
    (:func:`save_teacher`); returns the counts."""
    from ..systems.builder import build_teacher

    bundle = build_teacher(kind, torch.Generator(device=device).manual_seed(0), sizes,
                           dtype_str, device)
    cfg = bundle.unet.cfg
    got = load_teacher_params(ckpt, bundle.unet, bundle.vae, n_blocks=len(cfg.block_out_channels),
                              layers_per_block=cfg.layers_per_block, strict=strict)
    stats = {}
    for what in ("unet", "vae"):
        module = getattr(bundle, what)
        if module is not None:
            loaded, mismatched = got.get(what, ([], []))
            stats[what] = _report(f"{kind} teacher {what}", module, loaded, 0, mismatched,
                                  strict)
    save_teacher(os.path.join(out_dir, f"{kind}_teacher.{fmt}"), bundle.unet, bundle.vae)
    return stats


def convert_clip(ckpt: str, out_dir: str, strict: bool, device: str = "cuda",
                 fmt: str = "pt") -> Dict[str, Any]:
    """An HF ``CLIPModel`` (ViT-B/32) state dict onto the scorer's random towers (seed
    0) -> ``out_dir/clip_scorer.{fmt}`` (:func:`save_scorer`); returns the counts."""
    from ..evaluation.clipscore import CLIPScorer, load_hf_clip, save_scorer

    scorer = CLIPScorer(seed=0, device=device)
    loaded, mismatched = load_hf_clip(_torch_state_numpy(ckpt), scorer, strict=strict)
    n_params = sum(len(list(m.parameters())) for m in (scorer.vision, scorer.text))
    # the towers share parameter names (layers_0.self_attn ...): count them apart
    stats = {"params": n_params, "loaded": len(loaded), "not_loaded": n_params - len(loaded),
             "dropped": 0,
             "mismatched": len(mismatched)}
    print(f"clip scorer: {json.dumps(stats)}", flush=True)
    save_scorer(os.path.join(out_dir, f"clip_scorer.{fmt}"), scorer)
    return stats


def write_config(out_dir: str, sd_base: Optional[str] = None) -> str:
    """``config.json``: the pipeline config's default fields, with, when the SD base
    has a ``tokenizer/``, that directory as ``base_model_name_or_path``."""
    from ..pipelines.triplaneturbo_text_to_3d import TriplaneTurboPipelineConfig

    cfg = TriplaneTurboPipelineConfig()
    if sd_base and os.path.isdir(os.path.join(sd_base, "tokenizer")):
        cfg.base_model_name_or_path = os.path.abspath(sd_base)
    path = os.path.join(out_dir, "config.json")
    with open(path, "w") as f:
        json.dump(dataclasses.asdict(cfg), f, indent=2)
        f.write("\n")
    return path


def _parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(prog="python3 -m triplaneturbo_torch.tools.convert_checkpoints",
                                 description=__doc__.split("\n\n")[0])
    ap.add_argument("--adapter", help="triplane_turbo_sd_v1.pth")
    ap.add_argument("--sd-base", help="stable-diffusion-2-1-base diffusers directory")
    ap.add_argument("--mvdream", help="sd-v2.1-base-4view.pt")
    ap.add_argument("--richdreamer", help="nd_mv_ema.ckpt")
    ap.add_argument("--sd-teacher", help="diffusers directory of the SD teacher (often --sd-base)")
    ap.add_argument("--clip", help="HF clip-vit-base-patch32 state dict (pytorch_model.bin)")
    ap.add_argument("--out", default="pretrained_converted")
    ap.add_argument("--device", default="cuda", help="cuda (the default) or cpu")
    ap.add_argument("--format", default="pt", choices=("pt", "msgpack"),
                    help="the port's .pt files (the default) or the JAX package's .msgpack")
    ap.add_argument("--strict", action="store_true")
    return ap


def main(argv: Optional[List[str]] = None) -> Dict[str, Any]:
    """Run the conversions ``argv`` asks for; returns each one's counts."""
    args = _parser().parse_args(argv)
    if args.device.startswith("cuda") and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: pass --device cpu to convert on the CPU")
    os.makedirs(args.out, exist_ok=True)
    stats: Dict[str, Any] = {}
    if args.adapter or args.sd_base:
        from ..pipelines.triplaneturbo_text_to_3d import TriplaneTurboTextTo3DPipeline

        pipe = TriplaneTurboTextTo3DPipeline.from_pretrained(None, seed=0, device=args.device)
        stats["student"] = convert_student(args.adapter, args.sd_base, args.out, args.strict,
                                           pipe=pipe, fmt=args.format)
        if args.sd_base:
            stats["text_encoder"] = convert_text_encoder(args.sd_base, args.out, args.strict,
                                                         pipe=pipe, fmt=args.format)
        write_config(args.out, args.sd_base)
        del pipe
    for kind, path in (("mv", args.mvdream), ("rd", args.richdreamer), ("sd", args.sd_teacher)):
        if path:
            stats[f"{kind}_teacher"] = convert_teacher(kind, path, args.out, args.strict,
                                                       device=args.device, fmt=args.format)
    if args.clip:
        stats["clip_scorer"] = convert_clip(args.clip, args.out, args.strict, device=args.device,
                                            fmt=args.format)
    return stats


if __name__ == "__main__":
    main()
