"""Training, validation, test and export from a config file, on one GPU.

    python3 -m triplaneturbo_torch.launch --config configs/triplaneturbo_v1.yaml --train \
        [--max-steps N] [--seed S] [--resume DIR] [--device cuda|cpu] [key.path=value ...]

Counterpart of the JAX package's ``launch.py``, mode for mode: ``--train`` runs
``train_step`` for ``trainer.max_steps`` steps from the data module's batches,
logs every ``trainer.log_every_n_steps`` steps into ``metrics.jsonl``, writes
``ckpt_<step>/geometry.pt`` and ``ckpt_<step>/train_state.pt`` every
``trainer.checkpoint_every`` steps and renders the validation prompts every
``trainer.val_check_interval`` steps (0: never); ``--resume`` restores a train
state (a checkpoint directory, ``LAST`` allowed) in every mode, and
``system.weights=<geometry.pt, geometry.msgpack or adapter .pth>`` the geometry;
``--validate`` and ``--test`` render the turntables of the val or test prompts;
``--export`` writes a test prompt's mesh in ``system.exporter.fmt`` (``obj``, or
``obj-mtl`` with the texture baked from the field on the card).
A step's noise and draws come from a generator seeded with the seed and the step
(the JAX launcher's ``fold_in(key, step)``), and a checkpoint holds the host
generators of the batches and timesteps, so a resumed run takes the steps an
uninterrupted one would. The trial directory (``<exp_root_dir>/<name>/<tag>@<timestamp>``)
gets the parsed and raw configs, the command line and the code.

It runs on ``cuda`` unless ``--device cpu`` is given, and never falls back to the
CPU. The text-embedding cache lives under the experiment directory. :func:`main`
returns the trainer.

Several processes (``torchrun --nproc_per_node=N -m triplaneturbo_torch.launch ...``,
``WORLD_SIZE`` > 1) train data-parallel (``parallel/mesh.py``): NCCL on
``cuda:LOCAL_RANK``, gloo with ``--device cpu``. Every rank builds the system and the
data module from the same seed, so all hold the same weights and sample the same
global batch (``data.batch_size`` prompts x views in all), and ``train_step`` keeps
each rank's prompts and averages the gradients: the run is the one-process run on
the whole batch. Rank 0 alone writes the log, the snapshots and the checkpoints, with
a barrier around each checkpoint; ``--validate``, ``--test`` and ``--export`` split the
prompts ``[rank::world]``, each rank drawing every prompt's noise so that prompt i
gets what one process would give it.
"""

from __future__ import annotations

import argparse
import os
import sys
import time
from typing import List, Optional


def _parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(prog="python3 -m triplaneturbo_torch.launch")
    parser.add_argument("--config", required=True)
    group = parser.add_mutually_exclusive_group(required=True)
    group.add_argument("--train", action="store_true")
    group.add_argument("--validate", action="store_true")
    group.add_argument("--test", action="store_true")
    group.add_argument("--export", action="store_true")
    parser.add_argument("--max-steps", type=int, default=None)
    parser.add_argument("--seed", type=int, default=None)
    parser.add_argument("--resume", default=None, help="checkpoint directory of a train state")
    parser.add_argument("--device", default="cuda", help="cuda (the default) or cpu")
    parser.add_argument("extras", nargs="*", help="dotlist config overrides")
    return parser


def _log(msg: str) -> None:
    print(f"[triplaneturbo_torch] {msg}", flush=True)


def main(argv: Optional[List[str]] = None):
    argv = sys.argv[1:] if argv is None else list(argv)
    args = _parser().parse_intermixed_args(argv)

    import torch

    from .data.multiview_multiprompt import DataModuleConfig, MultiviewMultipromptDataModule
    from .systems.builder import build_system
    from .systems.prompt_setup import build_prompt_setup
    from .utils.callbacks import MetricsLogger, snapshot_code, snapshot_config
    from .utils.checkpoint import load_train_state, save_params, save_train_state
    from .utils.config import load_config, parse_structured
    from .utils.misc import (barrier, broadcast_host, find_last_path, fold_seed, get_rank,
                             get_world_size)

    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: pass --device cpu to run on the CPU")
    own_group = False
    if int(os.environ.get("WORLD_SIZE", "1")) > 1 and not torch.distributed.is_initialized():
        from .parallel.mesh import init_data_parallel

        _, _, device = init_data_parallel(device.type)
        own_group = True
    rank, world = get_rank(), get_world_size()
    cfg = load_config(args.config, cli_args=args.extras, n_devices=world)
    if world > 1:  # one trial directory: rank 0's timestamp
        cfg.update(broadcast_host({k: cfg[k] for k in ("timestamp", "trial_name", "trial_dir")}))
    # no rank offset: every rank holds the same weights and samples the same global
    # batch, of which train_step keeps the rank's prompts
    seed = args.seed if args.seed is not None else cfg.get("seed", 0)
    tcfg = cfg.get("trainer", {})

    dm = MultiviewMultipromptDataModule(parse_structured(DataModuleConfig, cfg.get("data", {})),
                                        seed=seed)
    trainer = build_system(cfg, seed=seed, device=device)
    if args.resume:
        resume = find_last_path(args.resume)
        load_train_state(resume, trainer, data_rng=dm.rng)
        _log(f"resumed from {resume} at step {trainer.global_step}")
    os.makedirs(cfg.trial_dir, exist_ok=True)
    mlog = None
    if rank == 0:
        snapshot_config(cfg.trial_dir, dict(cfg), raw_path=args.config,
                        cmd=["python3", "-m", "triplaneturbo_torch.launch", *argv])
        snapshot_code(cfg.trial_dir)
        mlog = MetricsLogger(cfg.trial_dir)
    processor, embeds_for = build_prompt_setup(
        trainer.geometry.cfg.space_generator.cross_attention_dim, seed=seed,
        negative_prompt=cfg.get("data", {}).get("negative_prompt", ""), device=device,
        cache_dir=os.path.join(cfg.exp_dir, "text_embeddings"))
    if world > 1:
        # the cache is filled by all ranks together, each encoding a share; encode the
        # whole library now, so that no rank later waits alone for the others
        processor.prepare_text_embeddings(
            list(dict.fromkeys(p for split in dm.library.values() for p in split)))
    save_dir = os.path.join(cfg.trial_dir, "save")

    def mine(prompts, split):
        """This rank's share ``[rank::world]`` of ``prompts``, with each one's eval
        batch: every rank draws every prompt's batch from the data module's generator,
        in order, so that prompt i's noise is what one process draws for it and the
        generator stays the same on every rank."""
        for i, prompt in enumerate(prompts):
            batch = dm.eval_views(prompt, split=split)
            if i % world == rank:
                yield i, prompt, batch

    def validate(prompts, split, step):
        for i, prompt, batch in mine(prompts, split):
            views = trainer.render_eval_views(batch, embeds_for([prompt]))
            trainer.save_eval_artifacts(views, save_dir, f"it{step}-{split}-{i}")
            _log(f"[{i + 1}/{len(prompts)}] rendered {prompt}")

    if args.train:
        from .utils.profiling import maybe_trace

        max_steps = args.max_steps or tcfg.get("max_steps", 15000)
        log_every = tcfg.get("log_every_n_steps", 10)
        ckpt_every = tcfg.get("checkpoint_every", 5000)
        val_every = tcfg.get("val_check_interval", ckpt_every)
        t0 = time.time()
        for step in range(trainer.global_step, max_steps):
            dm.update_step(step)
            batch_list = dm.sample_train_batch()
            generator = torch.Generator(device=device).manual_seed(fold_seed(seed, step))
            with maybe_trace(step):
                metrics = trainer.train_step(batch_list, embeds_for(batch_list[0]["prompt"]),
                                             generator)
            if step % log_every == 0 and rank == 0:
                _log(f"step {step}: loss {float(metrics['loss']):.4f} ({time.time() - t0:.1f}s)")
                mlog.log(step, metrics)
                mlog.progress(step, max_steps)
            # validation draws its noise from the data module's generator: checkpoint
            # after it, so that a run resumed here draws what an uninterrupted one would
            if val_every and (step + 1) % val_every == 0:
                validate(dm.library["val"], "val", step + 1)
            if (step + 1) % ckpt_every == 0:
                barrier("before checkpoint")
                if rank == 0:
                    ckpt = os.path.join(cfg.trial_dir, f"ckpt_{step + 1:06d}")
                    save_params(os.path.join(ckpt, "geometry.pt"), trainer.geometry)
                    save_train_state(ckpt, trainer, step + 1, data_rng=dm.rng)
                barrier("after checkpoint")
        if rank == 0:
            save_params(os.path.join(cfg.trial_dir, "last", "geometry.pt"), trainer.geometry)
    elif args.validate or args.test:
        split = "val" if args.validate else "test"
        validate(dm.library[split], split, trainer.global_step)
    elif args.export:
        from .models.exporters.mesh_exporter import MeshExporterConfig, MultipromptMeshExporter

        prompts = dm.library["test"]
        exporter = MultipromptMeshExporter(parse_structured(
            MeshExporterConfig, cfg.get("system", {}).get("exporter", {})))
        export_dir = os.path.join(cfg.trial_dir, f"it{trainer.global_step}-export")
        geo = trainer.geometry

        def color_closure(cache):
            """Points [N, 3] -> colors: the texture field and the material, on ``device``
            (``obj-mtl`` bakes its texture through it)."""
            return lambda p: trainer.material_fn(
                geo.export(p[None].to(device=device, dtype=torch.float32), cache)["features"][0])

        for i, prompt, batch in mine(prompts, "val"):
            emb = embeds_for([prompt])
            noise = torch.as_tensor(batch["noise"]).to(device)
            with torch.no_grad():
                space_cache = geo.decode(trainer.diffusion_reverse(noise, emb["cond_local"]))
                meshes = exporter.extract(space_cache, geo.forward_field_grid,
                                          lambda p, sc: geo.export(p, sc)["features"],
                                          trainer.material_fn)
            name = "".join(c if c.isalnum() else "_" for c in prompt)[:80]
            exporter(meshes, export_dir, [name],
                     color_fns=[color_closure(space_cache[j:j + 1])
                                for j in range(space_cache.shape[0])])
            _log(f"[{i + 1}/{len(prompts)}] exported {prompt}")
    if own_group:
        barrier("end")
        torch.distributed.destroy_process_group()
    return trainer


if __name__ == "__main__":
    main()
