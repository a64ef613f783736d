"""The readings that a cell's correctness limits are set from, on the card.

    python3 port_bench/calibrate.py --workload <cell> --seeds 1,2,... \
        [--control-seeds a,b,c] [--fault-seeds a,b,c] [--lr-fault-seeds a,b,c] \
        [--render-fault-seeds a,b,c] [--witness-seeds a,b] [--ref-steps n]

In one process: the program on each seed (what a run's window produces for the
sampled calls, or a run's checked steps) against the reference, the control (the
reference in fp8 products, ``lib/control.py``) on ``--control-seeds``, and, for a
training cell, the half-batch fault (the second prompt's image gradients left out and
the mean taken over the first) on ``--fault-seeds``, the learning-rate fault (every
update at 1.5 times the rate) on ``--lr-fault-seeds`` and the render fault (the first
view of each prompt's RGB images left out) on ``--render-fault-seeds``; on
``--witness-seeds``, the reference with its teachers in the configuration's type, judged
as the program is. ``--ref-steps`` sets how many steps each side drives. One JSON line a reading; PERF.md gives the limits set from
them. The benchmark's own runs do not run this.
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import sys
import tempfile
import time

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)


def _emit(**row) -> None:
    print(json.dumps(row), flush=True)


def _no_limits(names):
    return {n: float("inf") for n in names}


SERVE_NUMBERS = ("text_gap", "latent_gap", "plane_gap", "sdf_gap", "deform_gap", "mc_gap",
                 "color_gap")
TRAIN_NUMBERS = ("loss_gap", "image_grad_gap", "image_grad_median_gap", "rgb_image_grad_gap",
                 "rd_image_grad_gap", "grad_gap", "grad_median_gap", "grad_cos_gap",
                 "first_change_median_gap", "change_gap", "change_median_gap",
                 "rgb_render_gap", "geo_render_gap", "rgb_teacher_gap", "rd_teacher_gap")


def calibrate_serve(cell, seeds, control_seeds, device) -> None:
    import torch

    from port_bench.lib import common, serve
    from port_bench.lib.compare import Checks

    pipe = serve.build_program(cell.config, device)
    meta = serve.reference_pipeline(cell.config, "meta", "float32")
    ref = serve.reference_pipeline(cell.config, device, "float32")
    k = int(cell.traffic["sample_calls"])
    for seed in seeds:
        serve.load_weights(seed, device, [("geometry", meta.geometry, pipe.geometry),
                                          ("text_encoder", meta.text_encoder, pipe.text_encoder),
                                          ("geometry", meta.geometry, ref.geometry),
                                          ("text_encoder", meta.text_encoder, ref.text_encoder)])
        traffic = serve.Traffic(cell, seed, device)
        rec = serve._record_calls(pipe)
        checks = Checks(_no_limits(SERVE_NUMBERS))
        for i in range(k):
            prompts, latents = traffic.call(i)
            rec.clear()
            rec["grids"] = []
            out = pipe(prompts, latents=latents)
            record = {**out, "text": rec["text"], "grids": list(rec["grids"])}
            with common.reference_precision():
                serve.compare_call(ref, prompts, latents, record, checks)
        pipe.encode_prompt = type(pipe).encode_prompt.__get__(pipe)
        pipe.field_on_grid = type(pipe).field_on_grid.__get__(pipe)
        _emit(cell=cell.name, side="program", seed=seed, **checks.values)
    del pipe, ref
    common.free(device)
    for seed in control_seeds:
        traffic = serve.Traffic(cell, seed, device)
        checks = Checks(_no_limits(SERVE_NUMBERS))
        serve.run_control(cell.config, traffic, range(k), device, seed, checks)
        common.free(device)
        _emit(cell=cell.name, side="control", seed=seed, **checks.values)
    del torch


def fresh_state(trainer) -> None:
    """The trainer as built: step 0 and a new optimizer over the same leaves."""
    cfg = trainer.cfg
    trainer.global_step = 0
    trainer.optimizer = type(trainer.optimizer)(
        trainer.params_train.values(), cfg.learning_rate, cfg.adan_betas, cfg.adan_eps,
        grad_clip_norm=cfg.grad_clip_norm, accumulation_steps=cfg.gradient_accumulation_steps,
        skip_nonfinite=cfg.skip_nonfinite_grads)


def half_batch(grads, n_view: int):
    """The half-batch fault on program G's image gradients: every prompt's but the first
    half's left out, and the first half's scaled up to the mean over the rest."""
    out = {}
    for name, g in grads.items():
        n_prompts = g.shape[0] // n_view
        keep = (n_prompts + 1) // 2
        h = g.clone()
        h[:keep * n_view] *= n_prompts / keep
        h[keep * n_view:] = 0
        out[name] = h
    return out


def plant_half_batch(trainer):
    """Plant :func:`half_batch` in ``trainer``'s program G; returns the undo."""
    orig = trainer._stage_teacher
    n_view = trainer.guidance.cfg.n_view

    def stage_teacher(*a, **k):
        losses, grads = orig(*a, **k)
        return losses, half_batch(grads, n_view)

    had = "_stage_teacher" in trainer.__dict__
    trainer._stage_teacher = stage_teacher

    def undo():
        if had:
            trainer._stage_teacher = orig
        else:
            trainer.__dict__.pop("_stage_teacher", None)

    return undo


def plant_lr(trainer, factor: float):
    """The learning-rate fault: every update taken at ``factor`` times the configured
    rate. Returns the undo."""
    groups = trainer.optimizer.adan.param_groups
    old = [g["lr"] for g in groups]
    for g in groups:
        g["lr"] *= factor

    def undo():
        for g, lr in zip(groups, old):
            g["lr"] = lr

    return undo


LR_FAULT = 1.5


def drop_first_views(images, n_view: int):
    """The render fault: the first view of each prompt of both renderers' RGB images
    left out (zeros)."""
    out = dict(images)
    for name in ("comp_rgb_1st", "comp_rgb_2nd"):
        x = images[name].clone()
        x[::n_view] = 0
        out[name] = x
    return out


def plant_render(trainer):
    """Plant :func:`drop_first_views` in ``trainer``'s program R; returns the undo."""
    orig = trainer._stage_render
    n_view = trainer.guidance.cfg.n_view

    def stage_render(*a, **k):
        latent, space_cache, images, rest = orig(*a, **k)
        return latent, space_cache, drop_first_views(images, n_view), rest

    had = "_stage_render" in trainer.__dict__
    trainer._stage_render = stage_render

    def undo():
        if had:
            trainer._stage_render = orig
        else:
            trainer.__dict__.pop("_stage_render", None)

    return undo


def calibrate_train(cell, seeds, control_seeds, fault_seeds, lr_seeds, ref_steps,
                    device, render_seeds=(), witness_seeds=()) -> None:
    from port_bench.lib import common, train
    from port_bench.lib.compare import Checks

    n_steps = ref_steps or int(cell.traffic["reference_steps"])
    meta = train.reference_modules_meta(cell.config)
    cache = tempfile.mkdtemp(prefix="port_bench_text_")
    runs = {}  # (side, seed) -> the side's first steps, on the host
    plants = {"program": None, "fault": plant_half_batch, "render-fault": plant_render,
              "lr-fault": lambda tr: plant_lr(tr, LR_FAULT)}
    todo = ([("program", s) for s in seeds] + [("fault", s) for s in fault_seeds]
            + [("render-fault", s) for s in render_seeds]
            + [("lr-fault", s) for s in lr_seeds])
    try:
        trainer, processor, embeds_for = train.build_program(cell.config, device, cache)
        for side, seed in todo:
            shutil.rmtree(cache)
            os.makedirs(cache)
            train._load_all(seed, device, meta, train._targets(trainer, processor))
            fresh_state(trainer)
            undo = plants[side](trainer) if plants[side] else None
            t0 = time.perf_counter()
            runs[side, seed] = train._to_host(train.drive_checked(
                trainer, embeds_for, train.Inputs(cell, seed, device), n_steps, n_steps,
                keep_stage=side != "lr-fault"))
            if undo:
                undo()
            _emit(cell=cell.name, side=side + "-run", seed=seed,
                  losses=runs[side, seed]["losses"], seconds=time.perf_counter() - t0)
        del trainer, processor, embeds_for
        common.free(device)
        with common.reference_precision():
            if witness_seeds:  # the reference with the teachers in the configuration's type
                dtype = cell.config["system"].get("teacher_dtype", "bfloat16")
                trainer, processor, embeds_for = train.build_reference(
                    cell.config, device, cache, teacher_dtype=dtype)
                for seed in witness_seeds:
                    shutil.rmtree(cache)
                    os.makedirs(cache)
                    train._load_all(seed, device, meta, train._targets(trainer, processor))
                    fresh_state(trainer)
                    t0 = time.perf_counter()
                    runs["witness", seed] = train._to_host(train.drive_checked(
                        trainer, embeds_for, train.Inputs(cell, seed, device), n_steps,
                        n_steps, keep_stage=True))
                    _emit(cell=cell.name, side="witness-run", seed=seed,
                          losses=runs["witness", seed]["losses"],
                          seconds=time.perf_counter() - t0)
                del trainer, processor, embeds_for
                common.free(device)
            trainer, processor, embeds_for = train.build_reference(cell.config, device, cache)
            for seed in sorted(set(seeds) | set(control_seeds) | set(fault_seeds)
                               | set(lr_seeds) | set(render_seeds) | set(witness_seeds)):
                for side in ("control", "reference"):
                    if side == "control" and seed not in control_seeds:
                        continue
                    shutil.rmtree(cache)
                    os.makedirs(cache)
                    train._load_all(seed, device, meta, train._targets(trainer, processor))
                    fresh_state(trainer)
                    t0 = time.perf_counter()
                    inputs = train.Inputs(cell, seed, device)
                    if side == "control":
                        from port_bench.lib.control import Fp8Products

                        with Fp8Products():
                            res = train._to_host(train.drive_checked(
                                trainer, embeds_for, inputs, n_steps, n_steps,
                                keep_stage=True))
                        runs[side, seed] = res
                    else:
                        judged = [(s, runs[s, seed]) for s in ("program", "fault", "control",
                                                               "render-fault", "witness")
                                  if (s, seed) in runs]
                        res = ref = train._to_host(train.drive_checked(
                            trainer, embeds_for, inputs, n_steps, n_steps,
                            judge=[r.pop("stage") for _, r in judged]))
                    _emit(cell=cell.name, side=side + "-run", seed=seed, losses=res["losses"],
                          seconds=time.perf_counter() - t0)
                sides = [(side, res, j) for (side, res), j in zip(judged, ref["judged"])]
                if ("lr-fault", seed) in runs:
                    sides.append(("lr-fault", runs["lr-fault", seed], None))
                for side, res, j in sides:
                    checks = Checks(_no_limits(TRAIN_NUMBERS))
                    train.compare_steps(res, ref, checks, judged=j)
                    _emit(cell=cell.name, side=side, seed=seed, **checks.values)
                    _emit(cell=cell.name, side=side + "-readings", seed=seed,
                          losses=res["losses"], ref_losses=ref["losses"],
                          image_grad_names=res["image_grad_names"],
                          image_grads=res["image_grads"], ref_image_grads=ref["image_grads"],
                          judged=j, norms=train.leaf_norms(res), ref_norms=train.leaf_norms(ref))
                for key in [k for k in runs if k[1] == seed]:
                    del runs[key]
    finally:
        shutil.rmtree(cache, ignore_errors=True)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--control-seeds", default="")
    ap.add_argument("--fault-seeds", default="")
    ap.add_argument("--lr-fault-seeds", default="")
    ap.add_argument("--render-fault-seeds", default="")
    ap.add_argument("--witness-seeds", default="")
    ap.add_argument("--ref-steps", type=int, default=0,
                    help="steps each side drives and the reference follows (default: the "
                         "traffic's reference_steps)")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    import torch

    from port_bench.lib import cells

    ints = lambda s: [int(x) for x in s.split(",") if x]  # noqa: E731
    cell = cells.load(ROOT, args.workload)
    device = torch.device(args.device)
    if cell.runner == "serve":
        calibrate_serve(cell, ints(args.seeds), ints(args.control_seeds), device)
    else:
        calibrate_train(cell, ints(args.seeds), ints(args.control_seeds),
                        ints(args.fault_seeds), ints(args.lr_fault_seeds), args.ref_steps,
                        device, ints(args.render_fault_seeds), ints(args.witness_seeds))
    return 0


if __name__ == "__main__":
    sys.exit(main())
