"""Smoke run of the PyTorch/CUDA port (``triplaneturbo_torch``) on one GPU.

    python3 chip_smoke.py

Phases, each printing one JSON line; any failure exits non-zero:

1. device   -- ``nvidia-smi`` name and power limit, the torch device name and count;
               exits 2 when CUDA is unavailable.
2. build    -- builds every kernel from ``triplaneturbo_torch/csrc`` with nvcc and
               prints each one's ``-Xptxas -v`` lines; where the toolkit has
               ``cuobjdump``, counts in the SASS of the flash forward and backward
               and of the field grid the tensor-core (HGMMA), exp, async-copy and
               shared-store instructions of each kernel and requires HGMMA, async
               copies and no shared-memory store (no score tile leaves the
               registers) in the bf16 flash kernels, and HGMMA and async copies in
               the field-grid kernel.
3. kernels  -- holds each kernel against its plain PyTorch version at every shape its
               main path gives it, and times kernel, plain version and the library
               call: the flash forward at the serving shapes (one prompt) and the
               field grid at R=160 (and at the edges of its tiling, R = 37, 63, 64,
               65, 129); the flash forward with stats, the dq and the
               dk/dv kernels at the training shapes (two prompts), in bf16 at all six
               sites and in f32 at the joint and VAE sites, plus ragged lengths
               (700/700, 300/1200); both forms of the forward at the edges of its
               tensor-core tiling (one row or key below and above a tile, one key,
               one batch-head, Lk = 77, q scaled by 8; bf16 and f32), where they
               must also agree with each other and from run to run bit for bit;
               program G's new shapes: the forward at the MV teacher's 4-view joint
               self-attention (30, 4096, 4096, 64) and SD's cross-attention (30, 4096,
               77, 64), the forward with stats and both backward kernels at the VAE
               encoders' mid attention (8, 1024, 1024, 512) and (2, 4096, 4096, 512);
               the dq and dk/dv kernels at the edges of their tensor-core tiling
               (bf16: one row or key below and above each tile on both sides, one
               key, one batch-head, Lk = 77, q scaled by 8, q = -12 times the first
               key, D = 512 at 63/65/129) against the plain backward and from run
               to run bit for bit;
               the field-grid slab backward against autograd of the plain field at
               R=160 (v1) and R=40 (v2). Times are CUDA-event means of calls
               through the wrapper, queued behind a spin kernel that outlasts the
               host's enqueueing, so that a kernel shorter than its wrapper's host
               time is still timed on the device.
               The field grid is also held against its split-TF32 emulation
               (``field_grid_split_tf32_reference``); its ``bound_ms`` is that of its
               route, three TF32 products on the tensor cores, and ``bound_f32_ms``
               that of every product in f32 on the CUDA cores.
               Tolerances: f32 1e-4 absolute (sums run in another order than the
               plain version's); the field grid against its emulation 2e-6 absolute; bf16 1e-2 of the largest reference value at the
               site, for each output (a bf16 result's own rounding is at most 2^-9
               of it, the tensor-core kernels round P, and the backward dS, to bf16
               before the products that read them, and the backward also takes
               delta from the bf16-rounded forward output), at the backward's edge
               cases never tighter than 1e-4 (with one key dq and dk vanish);
               the logsumexp 1e-4 absolute in both types; field grid 1e-4 absolute, its backward
               1e-4 of the largest reference gradient of each input.
4. reference -- a small model (head dim 64, so every attention and the field grid
               take the kernels) on the card against the same weights on the CPU
               (plain versions), in f32, one prompt: latents, space cache and SDF.
5. train_reference -- the same small model's training slice: the generator backward
               (program B-G) and the guarded Adan update on the card (kernels), with
               and without gradient checkpointing, against the CPU (plain versions)
               from the same weights, latent, noise, timestep, text states and
               space-cache cotangent; and its program B-R "1st" (R = 16, 2 prompts x 2
               views at 64², the hash-grid background) on the card against the CPU
               from the same weights, cameras, space cache and image cotangents:
               images, the space-cache cotangent and every field and background
               gradient; and its program B-R "2nd" (the patch-wrapped volume renderer,
               16² rays: a 5² global render and one 8² patch, 32 + 32 samples a ray) on
               the card against the CPU from the same weights, space cache, cotangents
               and draws (patch origin, sampler jitter): images, the space-cache
               cotangent and every field, background and variance gradient; and its
               program G (2 prompts x 4 views, 64² and 32² images; MV and SD teachers
               of 64 and 128 channels at head dim 64, VAE encoders to 64 channels, so
               that their attention and the encoders' take the kernels; RichDreamer's
               8 heads take the einsum path), the renderers one after the other and
               stacked, on the card against the CPU from the same teacher weights,
               images, cameras, text states and draws: fid, grad_norm_mv and the six
               image gradients, with exact launch counts; and one whole ``train_step`` of
               the small model (2 parts of 2 prompts x 4 views at 64², 32² rays, those
               teachers), staged and monolithic, on the card against the CPU from the
               same weights, step-batches, text states and draws, the CPU taking the
               card's sample boundaries, downsampled rays, space caches and grid values
               (with its own gradients): the metrics, every leaf's gradient of the step
               and every trainable leaf after the update.
6. pipeline -- prompt -> textured mesh at full width (SD-2.1 student UNet, OpenCLIP-H
               text tower, retrofitted VAE, R=160 marching cubes) in bf16 on random
               weights from a seed: one warm-up prompt and three timed prompts through
               ``__call__`` with every launch count reset just before the timed ones
               and read just after, an exported OBJ, then one more ``__call__`` prompt under
               ``torch.profiler``: device-busy ms of each stage (the pipeline's
               ``record_function`` ranges), the idle share and the heaviest kernels;
               then one more prompt under ``utils/flops.py`` ``count_flops`` (its FLOPs
               by stage, operator and kernel, for the ``flops`` line below).
7. locon    -- the per-plane LoCon (``locon_type="hexa_v1"``): the small kernel-taking
               student with every plane's ``up`` drawn nonzero, card against CPU
               (latents, space cache; SMALL_REL_TOL); then the full-width student with
               ``hexa_v1`` in bf16, three prompts timed against the shipped ``vanilla_v1``
               pipeline's, alternating, with their launch counts (101 + 1 a prompt), and
               one more prompt of each under ``torch.profiler`` (device-busy ms, in all
               and of the denoise stage).
8. eval     -- the evaluation harness: ``render_mesh_views`` of the full-width prompt's
               mesh at 4 x 512² (each view's ms and its rasterize share, the per-view
               overflow counts that the JAX harness drops), ``CLIPScorer`` at ViT-B/32
               and its 512-wide text tower on random towers (features, scores, ms), and
               ``run_eval.main`` over 3 prompts into a temporary directory (the metrics
               file, OBJs and grids; launch counts).
9. demo     -- the demo server (``triplaneturbo_torch.demo``) around the full-width
               pipeline in a thread on a free localhost port: three ``/generate``
               requests over ``http.client``, each answered with a PNG strip of four 256²
               views and an OBJ with faces, the median request ms; ``/file`` refuses a
               sibling of its root and a path outside it.
10. msgpack -- the JAX package's own flax msgpack files out of the port and back, at full
               width: the seed-0 bf16 pipeline written by the port's codec
               (``utils/msgpack_io.py``) as ``geometry.msgpack`` and ``text_encoder.msgpack``
               in the JAX layout and read back by ``from_pretrained(dir)`` (every parameter
               and a prompt with fixed latents bit-equal to the source's), a full MVDream
               teacher through ``mv_teacher.msgpack`` and the ViT-B/32 scorer through
               ``clip_scorer.msgpack`` (bit-equal); file sizes, write and read seconds, and
               whether ``import msgpack`` works on the machine (the port never imports it).
11. checkpoint -- the reference's checkpoints in, at full width in bf16:
               ``tools/reference_layout.py`` writes the seed-0 pipeline as an SD-2.1-base
               diffusers directory (``unet``, ``vae``, ``text_encoder``) and
               ``triplane_turbo_sd_v1.pth``, and a full MVDream teacher as an LDM ``.pt``
               whose ``model_ema`` shadows hold the weights, each tensor in its
               module's dtype; ``tools/convert_checkpoints.py --strict`` converts them
               (the student in f32), ``from_pretrained(dir, dtype_str="bfloat16")`` and ``build_teacher("mv", ckpt_path=...)`` load
               them: no unmatched key, every parameter loaded, state dicts bit-equal to
               their sources, one prompt with fixed latents equal to the source
               pipeline's (latents, space cache, mesh); seconds of writing, converting,
               loading and the first prompt.
12. export  -- the loaded pipeline's full-width mesh in every format: ``export_obj``
               (the native C++ writer), ``export_obj(save_normal=True)`` (the Python
               writer) and the mesh exporter's ``obj-mtl`` (a 1024² texture baked from
               the texture field on the card): counts equal to the masks' sums, the
               baked colors finite and in [0, 1], host seconds of each; the same for
               a torus at the pipeline's whole capacity (98,304 vertices, 196,608
               faces); the card's bake against the CPU route's: the UV atlas equal,
               bit-equal textures with a pointwise ramp (the same winning faces and
               texels), within 1e-3 with the field closure.
13. launcher -- ``python3 -m triplaneturbo_torch.launch`` through ``launch.main`` on the
               card, ``configs/smoke_tiny.yaml`` widened to the small kernel-taking model:
               ``--train`` for 2 steps (every kernel launched), ``--resume`` from its
               step-2 checkpoint for one more (the restored trainable partition, Adan
               state and step bit-equal to the saved ones), ``--validate`` (4 views: the
               grid PNG and the turntable) and ``--export`` (a non-empty OBJ a prompt).
14. training -- the v1 recipe at full width through the port's launcher: ``launch.main``
               with ``configs/triplaneturbo_v1.yaml`` as written (gradient checkpointing
               on) but for the log, checkpoint and validation intervals and
               ``field_chunk``, for three steps of ``train_step``: two prompts x four
               views from the data module, bf16 frozen backbone, f32 trainables, R=160,
               512² mesh renders, 128² rays for the volume renderer (a 42² global render
               and one 40² patch, 128 proposal and 64 fine samples a ray, the variance not
               trained), the hash-grid background (c_dim 1024), the v1 loss; the three
               frozen teachers in bf16 (SD-2.1 base, MVDream 4-view with camera,
               RichDreamer 768-d with camera, and the MV and SD VAE encoders), and the
               dual prompt processor (OpenCLIP-H and SD-1.5 towers, its cache in the
               temporary experiment directory). Each step's host ms and launch counts
               (all five kernels, asserted) are read around ``train_step``; then
               ``metrics.jsonl`` (a finite line a step), the step-2 checkpoint (bit-equal
               to the partition it was saved from), which leaves moved, one part through
               the trainer's staged loop under ``torch.profiler`` (device-busy ms of each
               program's range), and one validation prompt's turntable (40 views at 512²:
               ``render_eval_views`` and ``save_eval_artifacts``, CUDA events). Then the ``guidance`` line:
               CUDA-event ms of one part's program G and of its pieces (each teacher's
               UNet passes, the encoders' forward and backward, RichDreamer's einsum
               attention); the ``rasterize`` line: CUDA-event ms of one 512²
               view of the full-width mesh, the select pass (culling, binning, winners;
               no grad) and the differentiable recompute (forward and backward) apart;
               and the ``volume`` line: CUDA-event ms of one part's second branch, the
               proposal pass, the field with normals (program R's form), the whole
               ``render_2nd`` and ``render_backward_2nd``, with the ray and sample
               counts, and ``render_backward_2nd``'s time and peak memory at each
               ``field_chunk`` of a sweep. Last, one more v1 step through
               ``TriplaneTurboTrainer.step_cost_flops`` (its FLOPs by program, and its
               launch counts, asserted).
15. flops   -- the FLOP count of what the port executes (``utils/flops.py``: every
               matrix product the plain PyTorch route runs, each DDIM step, part and
               checkpoint recompute; the hand-written kernels counted as their plain
               versions): the full-width prompt's, by stage, with TFLOP/s and its share of
               the dense bf16 peak (989 TFLOP/s) over the prompt's host median and over
               its device-busy ms, by stage over the stages' device-busy ms; the v1
               step's, by program, over the timed steps' median and over a part's
               device-busy ms times the parts; the kernels' share of each; and the small
               model's prompt and whole staged and monolithic ``train_step`` (phases 4
               and 5, counted there), whose counts on the card must equal the CPU's as
               integers.
16. parallel -- data parallelism (``triplaneturbo_torch/parallel``) on the one card: NCCL
               at world size 1, the small model's staged step (2 prompts x 4 views, the v1
               loss; every kernel launched) through the reduced-gradient path against the
               same step with no process group, bit for bit where two steps with no group
               repeat bit for bit, and a gradient replayed through the reduction bit for
               bit; then two gloo ranks spawned on the card (``chip_smoke.py
               --parallel-worker``), one prompt each: both hold the same parameters bit
               for bit after the step, equal to the one-process step within
               WHOLE_STEP_TOL and WHOLE_STEP_GRAD_TOL; the step and reduction times. A
               run across several cards waits for a machine with more than one.

Then a ``{"kernels": [...]}`` line, the ``nvidia-smi`` line, and last
``{"ok": true, "device": {...}}``. Float32 matmuls and cuDNN convolutions run
with TF32 off throughout, so every f32 comparison is against full-f32 PyTorch.
"""

from __future__ import annotations

import json
import math
import os
import subprocess
import sys
import tempfile
import time
from pathlib import Path

REPO = Path(__file__).resolve().parent

# H100 SXM peaks (NVIDIA data sheet, dense): bf16 and TF32 tensor cores, f32 CUDA cores, HBM3.
PEAK_FLOPS = {"bfloat16": 989e12, "tfloat32": 495e12, "float32": 67e12}
PEAK_BYTES = 3.35e12

# Main-path attention sites at B=1: (site, BH, L, Lk, D, launches per prompt).
ATTN_SHAPES = [
    ("self 32x32 (joint 6 planes)", 5, 6144, 6144, 64, 20),
    ("self 16x16 (joint 6 planes)", 10, 1536, 1536, 64, 20),
    ("self 8x8 (joint 6 planes)", 20, 384, 384, 64, 20),
    ("cross 32x32", 30, 1024, 77, 64, 20),
    ("cross 16x16", 60, 256, 77, 64, 20),
    ("vae mid attention", 6, 1024, 1024, 512, 1),
]
K1_LAUNCHES_PER_PROMPT = sum(s[-1] for s in ATTN_SHAPES)  # 101
K2_LAUNCHES_PER_PROMPT = 1
# Training attention sites at two prompts: (site, BH, L, Lk, D, launches per UNet + VAE pass).
TRAIN_PROMPTS = 2
TRAIN_ATTN_SHAPES = [(site, BH * TRAIN_PROMPTS, L, Lk, D, n // 4 if D == 64 else 1)
                     for site, BH, L, Lk, D, n in ATTN_SHAPES]
RAGGED_SHAPES = [("ragged 700/700", 2, 700, 700, 64, 0), ("ragged 300/1200", 2, 300, 1200, 64, 0)]
# Edges of the tensor-core forward's tiling (64 query rows a warpgroup, 64 or 128 a CTA;
# 128 keys a tile at D = 64, 64 at D = 512): (site, BH, L, Lk, D, scale of q).
EDGE_SHAPES = [("cross 256/77", 2, 256, 77, 64, 1.0), ("one key 130/1", 2, 130, 1, 64, 1.0),
               ("one batch-head 128/128", 1, 128, 128, 64, 1.0),
               ("below the tiles 63/127", 2, 63, 127, 64, 1.0),
               ("above the tiles 65/129", 2, 65, 129, 64, 1.0),
               ("below the tiles 127/255", 3, 127, 255, 64, 1.0),
               ("above the tiles 129/257", 3, 129, 257, 64, 1.0),
               ("128-row CTAs 129/129", 70, 129, 129, 64, 1.0),
               ("128-row CTAs 520/77", 34, 520, 77, 64, 1.0),
               ("q times 8 700/700", 2, 700, 700, 64, 8.0),
               ("D=512 below the tiles 63/63", 1, 63, 63, 512, 1.0),
               ("D=512 above the tiles 65/65", 2, 65, 65, 512, 1.0),
               ("D=512 64/129", 1, 64, 129, 512, 1.0)]
# Edges of the tensor-core backward's tiling (64 rows of the owned side a warpgroup: queries
# for dq, keys for dk/dv; 64 rows of the streamed side a tile at D = 64, 32 at D = 512):
# (site, BH, L, Lk, D, scale of q; a negative scale makes every query that multiple of the
# first key, so that lse is about -96 and an unmasked zero-filled key gives exp(96) = inf).
BWD_EDGE_SHAPES = [("below the tiles 63/63", 2, 63, 63, 64, 1.0),
                   ("above the tiles 65/65", 2, 65, 65, 64, 1.0),
                   ("queries below, keys above 63/129", 2, 63, 129, 64, 1.0),
                   ("queries above, keys below 129/63", 2, 129, 63, 64, 1.0),
                   ("around two tiles 127/129", 3, 127, 129, 64, 1.0),
                   ("around two tiles 129/127", 3, 129, 127, 64, 1.0),
                   ("one batch-head 128/128", 1, 128, 128, 64, 1.0),
                   ("cross 256/77", 2, 256, 77, 64, 1.0), ("one key 130/1", 2, 130, 1, 64, 1.0),
                   ("one key, lse -96, 130/1", 2, 130, 1, 64, -12.0),
                   ("large grid 129/129", 70, 129, 129, 64, 1.0),
                   ("q times 8 700/700", 2, 700, 700, 64, 8.0),
                   ("D=512 63/65", 1, 63, 65, 512, 1.0), ("D=512 65/63", 2, 65, 63, 512, 1.0),
                   ("D=512 129/129", 1, 129, 129, 512, 1.0),
                   ("D=512 31/33", 2, 31, 33, 512, 1.0)]
FLASH_PER_PASS = sum(s[-1] for s in TRAIN_ATTN_SHAPES)  # 26: one UNet pass and one VAE decode
# Program G's flash sites at the v1 recipe (2 prompts x 4 views, the renderers one after
# the other; MV scores 256² images, SD one view a prompt at 512²): (site, BH, L, Lk, D).
# The teachers' UNets run without grad (the plain forward), the VAE encoders' single-head
# D = 512 mid attention with grad (stats forward, dq, dk/dv).
TEACHER_FWD_SHAPES = [("MV joint self 32x32 (4 views)", 30, 4096, 4096, 64),
                      ("SD cross 64x64", 30, 4096, 77, 64)]
ENCODER_SHAPES = [("MV encoder mid attention 32x32", 8, 1024, 1024, 512),
                  ("SD encoder mid attention 64x64", 2, 4096, 4096, 512)]
# flash-forward launches of one teacher UNet pass (the sites with D = 64 and L >= 128):
# MVDream 25 (its 8² cross and its mid block fail the gate), SD-2.1 30 (its 8² mid block);
# RichDreamer none (8 heads: D = 40, 80 and 160 take the einsum path)
MV_FLASH_PER_PASS, SD_FLASH_PER_PASS = 25, 30
FIELD_GRID_EDGE_R = (37, 63, 64, 65, 129)
# absolute, except flash attention in bf16: a fraction of max |reference|
TOL = {("flash_attn_fwd", "float32"): 1e-4, ("flash_attn_fwd", "bfloat16"): 1e-2,
       ("flash_attn_fwd_stats", "float32"): 1e-4, ("flash_attn_fwd_stats", "bfloat16"): 1e-2,
       ("flash_attn_bwd", "float32"): 1e-4, ("flash_attn_bwd", "bfloat16"): 1e-2,
       ("field_grid", "float32"): 1e-4, ("field_grid_bwd", "float32"): 1e-4,
       # the field-grid kernel against its split-TF32 emulation: the order of f32 sums only
       ("field_grid_split", "float32"): 2e-6}
TIMED_PROMPTS = 3
STAGES = ("text_encoder", "denoise", "vae_decode", "field_grid", "marching_cubes", "colorize")
TRAIN_STAGES = ("generator_forward", "render_1st", "render_2nd", "teacher",
                "render_backward_1st", "render_backward_2nd", "generator_backward")
TRAIN_STEPS = 3  # one warm-up step and two timed ones, four parts each
# samples a view that the volume renderer's field with normals takes at once; chosen
# from the volume line's sweep of render_backward_2nd (PERF.md, section 5)
FIELD_CHUNK = 65536
FIELD_CHUNK_SWEEP = (32768, 65536, 131072)
# the training phase: configs/triplaneturbo_v1.yaml as written through the port's launcher,
# but for these overrides (and exp_root_dir, a temporary directory)
TRAIN_CONFIG = "configs/triplaneturbo_v1.yaml"
TRAIN_CKPT_STEP = 2
TRAIN_OVERRIDES = ["trainer.log_every_n_steps=1", f"trainer.checkpoint_every={TRAIN_CKPT_STEP}",
                   "trainer.val_check_interval=0",
                   f"system.renderer_2nd.field_chunk={FIELD_CHUNK}"]
# Launches a part of the v1 step, whose generator runs with gradient_checkpoint:
# - program R (no grad) takes the plain forward once at each of the generator's 26 sites
#   (FLASH_PER_PASS: the UNet's 25 and the VAE decoder's mid attention);
# - program G takes it once per MV and SD teacher site for each renderer's images, and the
#   stats forward, dq and dk/dv once per MV and SD encoder call (2 teachers x 2 renderers);
# - program B-G runs each checkpointed UNet block's forward twice with grad (once dropping
#   what it saves, once in the backward) and its backward once, and decodes the six planes
#   one by one, each under its own checkpoint (6 mid attentions in place of 1): the stats
#   forward 2 x 31, dq and dk/dv 31 each;
# - the field grid runs once per prompt in R and once per prompt in B-R "1st".
BG_FLASH_SITES = (FLASH_PER_PASS - 1) + 6  # 31
ENCODER_CALLS = 2 * 2
LAUNCHES_PER_PART = {"flash_attn_fwd": FLASH_PER_PASS + 2 * (MV_FLASH_PER_PASS + SD_FLASH_PER_PASS),
                     "flash_attn_fwd_stats": 2 * BG_FLASH_SITES + ENCODER_CALLS,
                     "flash_attn_bwd_dq": BG_FLASH_SITES + ENCODER_CALLS,
                     "flash_attn_bwd_dkdv": BG_FLASH_SITES + ENCODER_CALLS,
                     "field_grid": 2 * TRAIN_PROMPTS}


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


class SmokeFailure(RuntimeError):
    pass


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise SmokeFailure(msg)


def cuda_ms(fn, iters: int, warmup: int = 2) -> float:
    """Mean device time of ``fn()`` from CUDA events over ``iters`` calls.

    The calls are queued behind a spin kernel that outlasts the host's enqueueing of
    them, so the events bracket back-to-back device work even where one call's host
    time (wrapper, allocator, launch) is longer than its kernel."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    enqueue_s = time.perf_counter() - t0
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    # cycles at 2 GHz, more than the card's clock: twice the expected enqueue time, at most 0.25 s
    torch.cuda._sleep(int(min(2.0 * enqueue_s * iters, 0.25) * 2e9))
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def bound(flops: float, nbytes: float, dtype: str):
    t_ops = flops / PEAK_FLOPS[dtype]
    t_bytes = nbytes / PEAK_BYTES
    return max(t_ops, t_bytes) * 1e3, ("operations" if t_ops >= t_bytes else "bytes")


def phase_device():
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; this run needs one NVIDIA GPU",
              file=sys.stderr)
        sys.exit(2)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    info = {"phase": "device", "nvidia_smi": smi, "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count(), "torch": torch.__version__,
            "cuda": torch.version.cuda, "python": sys.version.split()[0]}
    emit(info)
    return info


def sass_census(library: Path):
    """Per kernel of one built library, from ``cuobjdump -sass``: how many tensor-core
    (HGMMA, the SASS of ``wgmma``), exponential (MUFU.EX2), asynchronous-copy (LDGSTS) and
    plain shared-memory store (STS) instructions it holds, and its first HGMMA line.
    None where the toolkit has no ``cuobjdump``."""
    import shutil

    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    if not os.path.exists(tool):
        return None
    text = subprocess.run([tool, "-sass", str(library)], capture_output=True, text=True,
                          check=True, timeout=300).stdout
    census, cur = {}, None
    for ln in text.splitlines():
        if "Function :" in ln:
            cur = census.setdefault(ln.split("Function :")[1].strip(),
                                    {"HGMMA": 0, "MUFU.EX2": 0, "LDGSTS": 0, "STS": 0,
                                     "first_hgmma": None})
            continue
        if cur is None:
            continue
        for op in ("HGMMA", "MUFU.EX2", "LDGSTS", "STS"):
            if f" {op}" in ln and (op != "STS" or "LDGSTS" not in ln):
                cur[op] += 1
                if op == "HGMMA" and cur["first_hgmma"] is None:
                    cur["first_hgmma"] = " ".join(ln.split("*/")[-2 if ln.count("*/") > 1 else -1]
                                                   .split(";")[0].split())
    return census


def phase_build():
    from triplaneturbo_torch.ops import _build

    t0 = time.perf_counter()
    libraries = _build.build_all()
    seconds = time.perf_counter() - t0
    report = {}
    for name in _build.sources():
        lines = [ln.strip() for ln in _build.ptxas_report(name).splitlines()
                 if "ptxas info" in ln and ("Used" in ln or "spill" in ln or "Compiling" in ln)]
        report[name] = lines
    # the bf16 flash kernels run every product on the tensor cores and keep no score tile
    # in shared memory: each holds HGMMA, async copies and not one plain shared-memory store
    sass = {}
    for lib, symbol, n_kernels in (("flash_attn_fwd", "flash_fwd_kernel_wgmma", 3),
                                   ("flash_attn_bwd", "_kernel_wgmma", 4)):
        sass[lib] = sass_census(libraries[lib])
        if sass[lib] is None:
            continue
        wgmma = {k: v for k, v in sass[lib].items() if symbol in k}
        check(len(wgmma) >= n_kernels,
              f"expected the tensor-core kernels of {lib} in the SASS: {list(sass[lib])}")
        for k, v in wgmma.items():
            check(v["HGMMA"] > 0 and v["STS"] == 0 and v["LDGSTS"] > 0 and v["MUFU.EX2"] > 0,
                  f"{k}: SASS census {v}")
    # the field-grid kernel runs its products on the tensor cores (TF32 HGMMA); its STS are
    # the one-time staging of W2 and w3, h1 stays in registers
    sass["field_grid"] = sass_census(libraries["field_grid"])
    if sass["field_grid"] is not None:
        fg_kernels = {k: v for k, v in sass["field_grid"].items() if "field_grid_kernel" in k}
        check(len(fg_kernels) == 1, f"expected field_grid_kernel in the SASS: {list(sass['field_grid'])}")
        for k, v in fg_kernels.items():
            check(v["HGMMA"] > 0 and v["LDGSTS"] > 0, f"{k}: SASS census {v}")
    emit({"phase": "build", "seconds": seconds, "ptxas": report,
          "sass_flash_attn_fwd": sass["flash_attn_fwd"],
          "sass_flash_attn_bwd": sass["flash_attn_bwd"], "sass_field_grid": sass["field_grid"]})


def attention_case(site, BH, L, Lk, D, dtype_name, gen):
    import torch
    import torch.nn.functional as F
    from triplaneturbo_torch.ops import flash_attention as fa

    dtype = getattr(torch, dtype_name)
    q = torch.randn(BH, L, D, device="cuda", generator=gen).to(dtype)
    k = torch.randn(BH, Lk, D, device="cuda", generator=gen).to(dtype)
    v = torch.randn(BH, Lk, D, device="cuda", generator=gen).to(dtype)
    out = fa.flash_attention(q, k, v)
    torch.cuda.synchronize()
    ref = fa.flash_attention_reference(q.float(), k.float(), v.float())
    err = (out.float() - ref).abs().max().item()
    check(math.isfinite(err), f"flash_attn_fwd {site} {dtype_name}: non-finite output")
    ref_max = ref.abs().max().item()
    tol = TOL[("flash_attn_fwd", dtype_name)] * (ref_max if dtype_name == "bfloat16" else 1.0)
    check(err <= tol, f"flash_attn_fwd {site} {dtype_name}: max abs err {err} > {tol}")
    iters = 20 if L * Lk >= 1 << 20 else 100
    ms = cuda_ms(lambda: fa.flash_attention(q, k, v), iters)
    plain_ms = cuda_ms(lambda: fa.flash_attention_reference(q, k, v), max(iters // 4, 5))
    q4, k4, v4 = q[None], k[None], v[None]
    lib_ms = cuda_ms(lambda: F.scaled_dot_product_attention(q4, k4, v4), iters)
    esize = q.element_size()
    bound_ms, bound_by = bound(4.0 * BH * L * Lk * D, (2 * BH * L * D + 2 * BH * Lk * D) * esize,
                               dtype_name)
    row = {"phase": "kernel_case", "kernel": "flash_attn_fwd", "site": site, "dtype": dtype_name,
           "BH": BH, "L": L, "Lk": Lk, "D": D, "max_abs_err": err, "tol": tol,
           "ref_max_abs": ref_max, "ms": ms,
           "plain_ms": plain_ms, "library_ms": lib_ms, "bound_ms": bound_ms,
           "bound_by": bound_by}
    emit(row)
    return row


def field_grid_case(R, C, concat, gen):
    import torch
    from triplaneturbo_torch.ops import field_grid as fg

    cin = 3 * C if concat else C

    def rnd(*shape, s):
        return torch.randn(*shape, device="cuda", generator=gen) * s

    m = [rnd(R, R, C, s=0.3) for _ in range(3)]
    ws = [rnd(cin, 64, s=0.1), rnd(64, 64, s=0.1), rnd(64, 1, s=0.1),
          rnd(cin, 64, s=0.1), rnd(64, 64, s=0.1), rnd(64, 3, s=0.1)]
    args = (*m, *ws, 1.0, 0.5, concat)
    sdf, deform = fg.fused_field_grid(*args)
    torch.cuda.synchronize()
    sdf_r, deform_r = fg.field_grid_reference(*args)
    err = max((sdf - sdf_r).abs().max().item(), (deform - deform_r).abs().max().item())
    check(math.isfinite(err), "field_grid: non-finite output")
    tol = TOL[("field_grid", "float32")]
    name = f"R={R} C={C} {'v2 concat' if concat else 'v1 sum'}"
    check(err <= tol, f"field_grid {name}: max abs err {err} > {tol}")
    del sdf_r, deform_r
    # the kernel against its split-TF32 emulation on the same folded inputs
    prepped = fg._prep(m[0], m[1], m[2], ws[0], ws[3], ws[1], ws[4], ws[2], ws[5], concat)
    sdf_e, deform_e = fg.field_grid_split_tf32_reference(*prepped, 1.0, 0.5)
    split_err = max((sdf - sdf_e).abs().max().item(), (deform - deform_e).abs().max().item())
    split_tol = TOL[("field_grid_split", "float32")]
    check(split_err <= split_tol,
          f"field_grid {name}: max abs err against the split emulation {split_err} > {split_tol}")
    del sdf_e, deform_e
    ms = cuda_ms(lambda: fg.fused_field_grid(*args), 10)
    kernel_ms = cuda_ms(lambda: fg._launch(*prepped, 1.0, 0.5), 10)
    plain_ms = cuda_ms(lambda: fg.field_grid_reference(*args), 3, warmup=1)
    H, HB = 128, 64
    # layer-1 fold (three [R^2, C] x [C, H] products), then per grid point the plane sum,
    # the two diagonal [HB, HB] blocks of the block-diagonal W2 and the four heads
    # (the sdf head reads the first HB columns, the three deformation heads the rest)
    products = R ** 3 * 2 * 2 * HB * HB
    rest = 3 * R * R * C * H * 2 + R ** 3 * (2 * H + 2 * 4 * HB)
    nbytes = 3 * R * R * C * 4 + sum(w.numel() for w in ws) * 4 + 4 * R ** 3 * 4
    # The least time for an f32-accurate result: the products as three TF32 products on
    # the tensor cores, the rest in f32 on the CUDA cores beside them. `bound_f32_ms` is
    # the bound of every product in f32 on the CUDA cores (the rows of PRs 1-4).
    t_ops = max(3 * products / PEAK_FLOPS["tfloat32"], rest / PEAK_FLOPS["float32"])
    t_bytes = nbytes / PEAK_BYTES
    bound_ms, bound_by = max(t_ops, t_bytes) * 1e3, ("operations" if t_ops >= t_bytes else "bytes")
    bound_f32_ms, _ = bound(products + rest, nbytes, "float32")
    row = {"phase": "kernel_case", "kernel": "field_grid", "site": name, "dtype": "float32",
           "R": R, "max_abs_err": err, "tol": tol, "split_emulation_err": split_err,
           "split_tol": split_tol, "ms": ms, "kernel_ms": kernel_ms, "plain_ms": plain_ms,
           "library_ms": None, "bound_ms": bound_ms, "bound_by": bound_by,
           "bound_f32_ms": bound_f32_ms}
    emit(row)
    return row


def _flash_bytes(BH, L, Lk, D, esize):
    """Bytes of q-like and k-like tensors and of one f32 row vector."""
    return BH * L * D * esize, BH * Lk * D * esize, BH * L * 4


def training_attention_case(site, BH, L, Lk, D, dtype_name, gen):
    """The forward with stats and both backward kernels at one shape: each against
    its plain version on the card, timed beside it and beside SDPA's forward and
    autograd backward (yardsticks; nothing on the port's path calls them)."""
    import torch
    import torch.nn.functional as F
    from triplaneturbo_torch.ops import flash_attention as fa

    dtype = getattr(torch, dtype_name)
    q, k, v, g = (torch.randn(BH, n, D, device="cuda", generator=gen).to(dtype)
                  for n in (L, Lk, Lk, L))
    out, lse = fa._launch(q, k, v, return_stats=True)
    delta = fa.flash_delta(out, g)
    dq = fa._launch_dq(q, k, v, g, lse, delta)
    dk, dv = fa._launch_dkdv(q, k, v, g, lse, delta)
    torch.cuda.synchronize()
    qf, kf, vf = q.float(), k.float(), v.float()
    o_ref, lse_ref = fa.flash_attention_reference(qf, kf, vf, return_stats=True)
    refs = fa.flash_attention_bwd_reference(qf, kf, vf, o_ref, lse_ref, g.float())

    def held(kernel, what, got, ref, absolute=False):
        err = (got.float() - ref).abs().max().item()
        ref_max = ref.abs().max().item()
        rel = dtype_name == "bfloat16" and not absolute
        tol = TOL[(kernel, "float32" if absolute else dtype_name)] * (ref_max if rel else 1.0)
        check(math.isfinite(err), f"{kernel} {site} {dtype_name}: non-finite {what}")
        check(err <= tol, f"{kernel} {site} {dtype_name}: {what} max abs err {err} > {tol}")
        return err, tol, ref_max

    errs = {"o": held("flash_attn_fwd_stats", "o", out, o_ref),
            # lse is f32 whatever the input type
            "lse": held("flash_attn_fwd_stats", "lse", lse, lse_ref, absolute=True),
            "dq": held("flash_attn_bwd", "dq", dq, refs[0]),
            "dk": held("flash_attn_bwd", "dk", dk, refs[1]),
            "dv": held("flash_attn_bwd", "dv", dv, refs[2])}
    del o_ref, lse_ref, refs, qf, kf, vf

    iters = 5 if L * Lk >= 1 << 20 else 30
    ms = {"flash_attn_fwd_stats": cuda_ms(lambda: fa._launch(q, k, v, return_stats=True), iters),
          "flash_attn_bwd_dq": cuda_ms(lambda: fa._launch_dq(q, k, v, g, lse, delta), iters),
          "flash_attn_bwd_dkdv": cuda_ms(lambda: fa._launch_dkdv(q, k, v, g, lse, delta), iters)}
    plain_fwd_ms = cuda_ms(lambda: fa.flash_attention_reference(q, k, v, return_stats=True), 3,
                           warmup=1)
    # the plain backward computes dq, dk and dv together
    plain_bwd_ms = cuda_ms(lambda: fa.flash_attention_bwd_reference(q, k, v, out, lse, g), 3,
                           warmup=1)
    q4, k4, v4 = (t[None].detach().requires_grad_() for t in (q, k, v))
    sdpa_fwd_ms = cuda_ms(lambda: F.scaled_dot_product_attention(q4, k4, v4), iters)
    o4 = F.scaled_dot_product_attention(q4, k4, v4)
    # SDPA's backward, too, computes all three gradients in one call
    sdpa_bwd_ms = cuda_ms(lambda: torch.autograd.grad(o4, (q4, k4, v4), g[None],
                                                      retain_graph=True), iters)
    del o4

    qb, kb, row = _flash_bytes(BH, L, Lk, D, q.element_size())
    work = BH * L * Lk * D
    spec = {
        "flash_attn_fwd_stats": (4.0 * work, 2 * qb + 2 * kb + row, plain_fwd_ms, sdpa_fwd_ms,
                                 max(errs["o"][0], errs["lse"][0]), errs["o"][1]),
        # three products: S, dP, dS K; reads q, dO, k, v, lse, delta, writes dq
        "flash_attn_bwd_dq": (6.0 * work, 3 * qb + 2 * kb + 2 * row, plain_bwd_ms, sdpa_bwd_ms,
                              errs["dq"][0], errs["dq"][1]),
        # four products: S, dP, P^T dO, dS^T Q; writes dk and dv
        "flash_attn_bwd_dkdv": (8.0 * work, 2 * qb + 4 * kb + 2 * row, plain_bwd_ms, sdpa_bwd_ms,
                                max(errs["dk"][0], errs["dv"][0]),
                                max(errs["dk"][1], errs["dv"][1])),
    }
    rows = []
    for kernel, (flops, nbytes, plain_ms, lib_ms, err, tol) in spec.items():
        bound_ms, bound_by = bound(flops, nbytes, dtype_name)
        row_ = {"phase": "kernel_case", "kernel": kernel, "site": site, "dtype": dtype_name,
                "BH": BH, "L": L, "Lk": Lk, "D": D, "max_abs_err": err, "tol": tol,
                "ms": ms[kernel], "plain_ms": plain_ms, "library_ms": lib_ms,
                "bound_ms": bound_ms, "bound_by": bound_by}
        if kernel != "flash_attn_fwd_stats":
            row_["plain_and_library_compute"] = "dq, dk and dv in one call"
            row_["errors"] = {n: errs[n][0] for n in ("dq", "dk", "dv")}
            row_["ref_max_abs"] = {n: errs[n][2] for n in ("dq", "dk", "dv")}
        emit(row_)
        rows.append(row_)
    return rows


def forward_edge_case(site, BH, L, Lk, D, q_scale, dtype_name, gen):
    """Both forms of the forward at an edge of the tiling: against the plain version,
    against each other and from run to run (bit for bit). No timing."""
    import torch
    from triplaneturbo_torch.ops import flash_attention as fa

    dtype = getattr(torch, dtype_name)
    q = (torch.randn(BH, L, D, device="cuda", generator=gen) * q_scale).to(dtype)
    k, v = (torch.randn(BH, Lk, D, device="cuda", generator=gen).to(dtype) for _ in range(2))
    out = fa.flash_attention(q, k, v)
    out_s, lse = fa._launch(q, k, v, return_stats=True)
    again, lse_again = fa._launch(q, k, v, return_stats=True)
    torch.cuda.synchronize()
    ref, lse_ref = fa.flash_attention_reference(q.float(), k.float(), v.float(), return_stats=True)
    name = f"{site} {dtype_name}"
    check(torch.equal(out, out_s), f"forward edge {name}: the two forms give different outputs")
    check(torch.equal(out_s, again) and torch.equal(lse, lse_again),
          f"forward edge {name}: two runs differ")
    err = (out.float() - ref).abs().max().item()
    lse_err = (lse - lse_ref).abs().max().item()
    ref_max = ref.abs().max().item()
    tol = TOL[("flash_attn_fwd", dtype_name)] * (ref_max if dtype_name == "bfloat16" else 1.0)
    lse_tol = TOL[("flash_attn_fwd_stats", "float32")]
    check(math.isfinite(err) and math.isfinite(lse_err), f"forward edge {name}: non-finite output")
    check(err <= tol, f"forward edge {name}: max abs err {err} > {tol}")
    check(lse_err <= lse_tol, f"forward edge {name}: lse max abs err {lse_err} > {lse_tol}")
    rows = []
    for kernel, e in (("flash_attn_fwd", err), ("flash_attn_fwd_stats", max(err, lse_err))):
        rows.append({"phase": "kernel_edge_case", "kernel": kernel, "site": site,
                     "dtype": dtype_name, "BH": BH, "L": L, "Lk": Lk, "D": D, "q_scale": q_scale,
                     "max_abs_err": e, "tol": tol, "lse_err": lse_err, "ref_max_abs": ref_max})
    emit(rows[1])
    return rows


def backward_edge_case(site, BH, L, Lk, D, q_scale, gen):
    """The bf16 dq and dk/dv kernels at an edge of their tiling: against the plain
    backward (fed by the plain forward's o and lse) and from run to run, bit for bit.
    No timing."""
    import torch
    from triplaneturbo_torch.ops import flash_attention as fa

    k = torch.randn(BH, Lk, D, device="cuda", generator=gen)
    if q_scale < 0:
        q = q_scale * k[:, :1] + 0.1 * torch.randn(BH, L, D, device="cuda", generator=gen)
    else:
        q = torch.randn(BH, L, D, device="cuda", generator=gen) * q_scale
    v, g = (torch.randn(BH, n, D, device="cuda", generator=gen) for n in (Lk, L))
    q, k, v, g = (t.bfloat16().contiguous() for t in (q, k, v, g))
    out, lse = fa._launch(q, k, v, return_stats=True)
    delta = fa.flash_delta(out, g)
    runs = [(fa._launch_dq(q, k, v, g, lse, delta), *fa._launch_dkdv(q, k, v, g, lse, delta))
            for _ in range(2)]
    torch.cuda.synchronize()
    name = f"{site} bfloat16"
    check(all(torch.equal(a, b) for a, b in zip(*runs)), f"backward edge {name}: two runs differ")
    qf, kf, vf = q.float(), k.float(), v.float()
    o_ref, lse_ref = fa.flash_attention_reference(qf, kf, vf, return_stats=True)
    refs = fa.flash_attention_bwd_reference(qf, kf, vf, o_ref, lse_ref, g.float())
    errs, tols = {}, {}
    for what, got, ref in zip(("dq", "dk", "dv"), runs[0], refs):
        errs[what] = (got.float() - ref).abs().max().item()
        tols[what] = max(TOL[("flash_attn_bwd", "bfloat16")] * ref.abs().max().item(),
                         TOL[("flash_attn_bwd", "float32")])
        check(math.isfinite(errs[what]), f"backward edge {name}: non-finite {what}")
        check(errs[what] <= tols[what],
              f"backward edge {name}: {what} max abs err {errs[what]} > {tols[what]}")
    rows = []
    for kernel, names in (("flash_attn_bwd_dq", ("dq",)), ("flash_attn_bwd_dkdv", ("dk", "dv"))):
        rows.append({"phase": "kernel_edge_case", "kernel": kernel, "site": site,
                     "dtype": "bfloat16", "BH": BH, "L": L, "Lk": Lk, "D": D, "q_scale": q_scale,
                     "max_abs_err": max(errs[n] for n in names),
                     "tol": max(tols[n] for n in names), "errors": errs, "tols": tols})
    emit(rows[1])
    return rows


def field_grid_backward_case(R, C, concat, gen):
    """The slab backward of the field grid (plain PyTorch, as the JAX package's is
    XLA) behind the kernel's autograd function, against autograd of the plain field."""
    import torch
    from triplaneturbo_torch.ops import field_grid as fg

    cin = 3 * C if concat else C

    def rnd(*shape, s):
        return (torch.randn(*shape, device="cuda", generator=gen) * s).requires_grad_()

    ins = [rnd(R, R, C, s=0.3) for _ in range(3)]
    ins += [rnd(cin, 64, s=0.1), rnd(64, 64, s=0.1), rnd(64, 1, s=0.1),
            rnd(cin, 64, s=0.1), rnd(64, 64, s=0.1), rnd(64, 3, s=0.1)]
    g_sdf = torch.randn(R, R, R, device="cuda", generator=gen)
    g_def = torch.randn(3, R, R, R, device="cuda", generator=gen)
    before = fg.LAUNCHES
    outs = fg.fused_field_grid(*ins, 1.0, 0.5, concat)
    check(fg.LAUNCHES == before + 1, "field_grid backward case: the forward launched no kernel")
    got = torch.autograd.grad(outs, ins, (g_sdf, g_def), retain_graph=True)
    ref = torch.autograd.grad(fg.field_grid_reference(*ins, 1.0, 0.5, concat), ins,
                              (g_sdf, g_def))
    torch.cuda.synchronize()
    rel = 0.0
    for i, (a, b) in enumerate(zip(got, ref)):
        check(bool(torch.isfinite(a).all()), f"field_grid backward: non-finite gradient {i}")
        rel = max(rel, ((a - b).abs().max() / b.abs().max().clamp_min(1e-12)).item())
    tol = TOL[("field_grid_bwd", "float32")]
    name = f"R={R} C={C} {'v2 concat' if concat else 'v1 sum'}"
    check(rel <= tol, f"field_grid backward {name}: rel err {rel} > {tol}")
    del ref
    ms = cuda_ms(lambda: torch.autograd.grad(outs, ins, (g_sdf, g_def), retain_graph=True), 3,
                 warmup=1)

    def plain():
        o = fg.field_grid_reference(*ins, 1.0, 0.5, concat)
        torch.autograd.grad(o, ins, (g_sdf, g_def))

    plain_ms = cuda_ms(plain, 2, warmup=1)
    row = {"phase": "kernel_case", "kernel": "field_grid_bwd", "site": name, "dtype": "float32",
           "what": "slab recompute in plain PyTorch (no kernel), 8 x-slabs",
           "R": R, "max_rel_err": rel, "tol": tol, "ms": ms,
           "plain_fwd_plus_bwd_whole_grid_ms": plain_ms}
    emit(row)
    return row


def phase_kernels():
    import torch

    gen = torch.Generator(device="cuda").manual_seed(0)
    rows = []
    for dtype_name in ("bfloat16", "float32"):
        for site, BH, L, Lk, D, _ in ATTN_SHAPES:
            rows.append(attention_case(site, BH, L, Lk, D, dtype_name, gen))
    rows.append(field_grid_case(160, 32, False, gen))
    rows.append(field_grid_case(160, 32, True, gen))
    # the edges of the field grid's 8 x 8 tiles: partial (37, 63, 65, 129) and whole (64)
    for R in FIELD_GRID_EDGE_R:
        rows.append(field_grid_case(R, 32, False, gen))
    for site, BH, L, Lk, D in TEACHER_FWD_SHAPES:
        rows.append(attention_case(site, BH, L, Lk, D, "bfloat16", gen))
        torch.cuda.empty_cache()
    for site, BH, L, Lk, D in ENCODER_SHAPES:
        rows += training_attention_case(site, BH, L, Lk, D, "bfloat16", gen)
        torch.cuda.empty_cache()
    for site, BH, L, Lk, D, _ in TRAIN_ATTN_SHAPES + RAGGED_SHAPES:
        rows += training_attention_case(site, BH, L, Lk, D, "bfloat16", gen)
        if "joint 6 planes" in site and L == 6144 or D == 512 or site.startswith("ragged"):
            rows += training_attention_case(site, BH, L, Lk, D, "float32", gen)
        torch.cuda.empty_cache()
    for site, BH, L, Lk, D, q_scale in EDGE_SHAPES:
        for dtype_name in ("bfloat16", "float32"):
            rows += forward_edge_case(site, BH, L, Lk, D, q_scale, dtype_name, gen)
    for site, BH, L, Lk, D, q_scale in BWD_EDGE_SHAPES:
        rows += backward_edge_case(site, BH, L, Lk, D, q_scale, gen)
    rows.append(field_grid_backward_case(160, 32, False, gen))
    rows.append(field_grid_backward_case(40, 32, True, gen))
    torch.cuda.empty_cache()
    return rows


# A small model whose every attention and field-grid call takes a kernel
# (head dim 64, 64-channel planes), for the CPU-vs-card comparison.
SMALL_SG = dict(block_out_channels=(64, 128), layers_per_block=1, cross_attention_dim=64,
                attention_head_dim=64, vae_block_out_channels=(32, 64), vae_layers_per_block=1,
                output_dim=64)
SMALL_TEXT = dict(width=64, layers=2, heads=1, intermediate=128)
SMALL_KW = dict(latent_resolution=16, isosurface_resolution=64)
# f32 on both sides with TF32 off; the card sums in other orders (flash attention's
# online softmax, cuDNN's convolution algorithms) and the DDIM step divides x0 by
# sqrt(alpha_bar) = 0.07 at t = 999, which amplifies those last-digit differences.
SMALL_REL_TOL = 1e-3
# the small model's FLOP counts on the card and on the CPU (a prompt in phase_reference,
# the staged and monolithic train_step in phase_train_reference), for the flops line
SMALL_FLOPS = {}
# the small model's whole train_step, card against CPU: the metrics, and every trainable
# leaf after the update, of its largest value
WHOLE_STEP_TOL = 1e-4
# ... and each leaf's gradient of the step, of its largest value (PR 10's run measured up
# to 1.7e-3, through the random mesh's thin faces)
WHOLE_STEP_GRAD_TOL = 5e-3


def phase_reference():
    """The small model on the card (kernels) against the same weights on the CPU
    (plain versions), f32, one prompt and the same initial latents."""
    import torch
    from triplaneturbo_torch.models.clip_text import CLIPTextConfig
    from triplaneturbo_torch.ops import field_grid as fg
    from triplaneturbo_torch.ops import flash_attention as fa
    from triplaneturbo_torch.pipelines.triplaneturbo_text_to_3d import (
        TriplaneTurboTextTo3DPipeline,
    )
    from triplaneturbo_torch.utils.flops import count_flops

    pipes = {dev: TriplaneTurboTextTo3DPipeline.from_pretrained(
        None, device=dev, seed=0, space_generator_overrides=SMALL_SG,
        text_config=CLIPTextConfig(**SMALL_TEXT), **SMALL_KW) for dev in ("cpu", "cuda")}
    pipes["cuda"].geometry.load_state_dict(pipes["cpu"].geometry.state_dict())
    pipes["cuda"].text_encoder.load_state_dict(pipes["cpu"].text_encoder.state_dict())
    r = SMALL_KW["latent_resolution"]
    latents = torch.randn((1, 6, r, r, 4), generator=torch.Generator().manual_seed(1))
    k1, k2 = fa.LAUNCHES, fg.LAUNCHES
    outs = {}
    for dev, p in pipes.items():  # counted on both routes for the flops line
        outs[dev], SMALL_FLOPS[f"prompt_{dev}"] = count_flops(p, "a photo of a hamburger",
                                                              latents=latents)
    torch.cuda.synchronize()
    check(fa.LAUNCHES > k1 and fg.LAUNCHES == k2 + 1,
          "the small model on the card did not go through both kernels")
    sdf = {dev: pipes[dev].field_on_grid(o["space_cache"][0])[0] for dev, o in outs.items()}
    row = {"phase": "reference", "what": "small model, card (kernels) vs CPU (plain), f32",
           "rel_tol": SMALL_REL_TOL}
    for name, a, b in (("latents", outs["cuda"]["latents"], outs["cpu"]["latents"]),
                       ("space_cache", outs["cuda"]["space_cache"], outs["cpu"]["space_cache"]),
                       ("sdf", sdf["cuda"], sdf["cpu"])):
        a = a.float().cpu()
        check(bool(torch.isfinite(a).all()), f"reference: non-finite {name} on the card")
        rel = ((a - b).abs().max() / b.abs().max().clamp_min(1e-12)).item()
        row[f"{name}_rel_err"] = rel
        check(rel <= SMALL_REL_TOL, f"reference: {name} rel err {rel} > {SMALL_REL_TOL}")
    faces = [int(o["mesh"][0].t_mask.sum()) for o in (outs["cuda"], outs["cpu"])]
    row["faces_cuda"], row["faces_cpu"] = faces
    check(abs(faces[0] - faces[1]) <= 0.01 * faces[1] and faces[1] > 0,
          f"reference: face counts differ, card {faces[0]} vs CPU {faces[1]}")
    emit(row)
    del pipes, outs
    torch.cuda.empty_cache()


def _profile_split(prof, stages=STAGES, top: int = 10):
    """Device-busy ms of the whole profiled run, of each of its ``stages``, and the
    ``top`` heaviest kernels by name.

    A stage's ``record_function`` range also shows on the device timeline, as a
    span from the first to the last device op the profiler ties to it. The
    stages run in order on one stream, so every device op from one stage's
    span start to the next one's belongs to that stage.
    """
    import bisect

    import torch

    cuda = torch.autograd.DeviceType.CUDA
    events = [e for e in prof.events() if e.device_type == cuda]
    spans = sorted((e.time_range.start, e.key) for e in events if e.key in stages)
    starts = [t for t, _ in spans]
    stage_ms = dict.fromkeys(stages, 0.0)
    total = 0.0
    for e in events:
        if e.key in stages or e.is_user_annotation:
            continue
        ms = (e.time_range.end - e.time_range.start) / 1e3
        total += ms
        i = bisect.bisect_right(starts, e.time_range.start) - 1
        if i >= 0:
            stage_ms[spans[i][1]] += ms
    kernels = sorted(((e.self_device_time_total / 1e3, e.count, e.key[:90])
                      for e in prof.key_averages()
                      if e.device_type == cuda and e.key not in stages
                      and not e.is_user_annotation), reverse=True)
    return (total, stage_ms, sorted({k for _, k in spans}),
            [{"ms": r[0], "calls": r[1], "name": r[2]} for r in kernels[:top]])


def phase_pipeline():
    """Prompt -> mesh at full width in bf16, R = 160, random weights from seed 0."""
    import torch
    from torch.profiler import ProfilerActivity
    from torch.profiler import profile as profiler
    from triplaneturbo_torch.ops import field_grid as fg
    from triplaneturbo_torch.ops import flash_attention as fa
    from triplaneturbo_torch.pipelines.triplaneturbo_text_to_3d import (
        TriplaneTurboTextTo3DPipeline,
        export_obj,
    )

    t0 = time.perf_counter()
    pipe = TriplaneTurboTextTo3DPipeline.from_pretrained(None, device="cuda",
                                                         dtype_str="bfloat16", seed=0)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    n_params = sum(p.numel() for m in (pipe.geometry, pipe.text_encoder) for p in m.parameters())
    # one warm-up prompt, then the timed ones
    prompts = ["a delicious hamburger", "a wooden chair", "a red sports car",
               "a ceramic teapot"][:1 + TIMED_PROMPTS]
    gen = torch.Generator(device="cuda").manual_seed(42)

    # the main path: one warm-up prompt and the timed prompts, through __call__; the
    # launches counted over the timed ones (the warm-up also captures the UNet's graph,
    # running its attention op three times in the first step)
    torch.cuda.reset_peak_memory_stats()
    outs, prompt_ms = [], []
    for i, p in enumerate(prompts):
        torch.cuda.synchronize()
        if i == 1:
            fa.LAUNCHES = 0
            fg.LAUNCHES = 0
        t = time.perf_counter()
        outs.append(pipe(p, generator=gen))
        torch.cuda.synchronize()
        prompt_ms.append((time.perf_counter() - t) * 1e3)
    launches = {"flash_attn_fwd": fa.LAUNCHES, "field_grid": fg.LAUNCHES}
    peak_bytes = torch.cuda.max_memory_allocated()

    n = len(prompts) - 1
    check(launches["flash_attn_fwd"] == K1_LAUNCHES_PER_PROMPT * n,
          f"flash_attn_fwd launched {launches['flash_attn_fwd']} times for {n} prompts, "
          f"expected {K1_LAUNCHES_PER_PROMPT * n}")
    check(launches["field_grid"] == K2_LAUNCHES_PER_PROMPT * n,
          f"field_grid launched {launches['field_grid']} times for {n} prompts, "
          f"expected {K2_LAUNCHES_PER_PROMPT * n}")
    counts = []
    for out in outs:
        check(tuple(out["latents"].shape) == (1, 6, 32, 32, 4), "latents shape")
        check(tuple(out["space_cache"].shape) == (1, 6, 256, 256, 32), "space cache shape")
        m = out["mesh"][0]
        nf, nv = int(m.t_mask.sum()), int(m.v_mask.sum())
        check(nf > 0 and nv > 0, "empty mesh")
        for name, x in (("latents", out["latents"]), ("space_cache", out["space_cache"]),
                        ("v_pos", m.v_pos[m.v_mask]), ("v_rgb", m.v_rgb[m.v_mask])):
            check(bool(torch.isfinite(x).all()), f"non-finite {name}")
        check(bool(((m.v_pos[m.v_mask].abs() <= 1.5).all())), "vertices outside the box")
        counts.append({"faces": nf, "verts": nv})

    with tempfile.TemporaryDirectory() as d:
        path = export_obj(outs[-1]["mesh"][0], os.path.join(d, "model.obj"))[0]
        with open(path) as fh:
            lines = fh.read().splitlines()
        obj = {"v": sum(ln.startswith("v ") for ln in lines),
               "f": sum(ln.startswith("f ") for ln in lines), "bytes": os.path.getsize(path)}
    check(obj["v"] == counts[-1]["verts"] and obj["f"] > 0, f"OBJ export: {obj}")

    # one more prompt through __call__ under the profiler: its device-busy time
    # against the timed prompts' median host time is the end-to-end idle share
    with profiler(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        pipe(prompts[0], generator=gen)
        torch.cuda.synchronize()
    prompt_busy_ms, stage_busy_ms, spanned, prompt_top = _profile_split(prof)
    check(prompt_busy_ms > 0, "the profiler recorded no device time")
    check(spanned == sorted(STAGES), f"stages with a device span: {spanned}")
    stage_share = sum(stage_busy_ms.values()) / prompt_busy_ms
    kernel_busy_ms = {name: sum(e.self_device_time_total for e in prof.key_averages()
                                if symbol in e.key) / 1e3
                      for name, symbol in (("flash_attn_fwd", "flash_fwd_kernel"),
                                           ("field_grid", "field_grid_kernel"))}
    timed = prompt_ms[1:]
    median_ms = sorted(timed)[len(timed) // 2]
    emit({"phase": "pipeline", "config": "SD-2.1 student UNet + OpenCLIP-H text + retrofit "
          "VAE (output_dim 64), latents 6x32x32x4, R=160, bf16, random weights seed 0",
          "params": n_params, "build_s": build_s, "warmup_prompt_ms": prompt_ms[0],
          "prompt_ms": timed, "prompt_ms_median": median_ms,
          "prompt_device_busy_ms": prompt_busy_ms,
          "prompt_device_idle_share": max(0.0, 1.0 - prompt_busy_ms / median_ms),
          "stage_device_busy_ms": stage_busy_ms,
          "stage_device_busy_share": stage_share, "kernel_device_busy_ms": kernel_busy_ms,
          "top_kernels": prompt_top,
          "launches": launches,
          "launches_per_prompt": {k: v / n for k, v in launches.items()},
          "meshes": counts, "obj": obj, "max_memory_allocated_bytes": peak_bytes})
    # every kernel of the prompt, the hand-written ones too, falls in a stage's range
    check(stage_share >= 0.95, f"the stage ranges hold only {stage_share:.3f} of the device time")
    return launches, pipe, {"prompt_ms_median": median_ms, "prompt_device_busy_ms": prompt_busy_ms,
                            "stage_device_busy_ms": stage_busy_ms}


CKPT_PROMPT = "a delicious hamburger"
TEX_SIZE = 1024  # the exporter's texture (the JAX package's default)


def _mesh_diffs(a, b) -> dict:
    """Largest absolute difference of each output of two pipeline calls."""
    ma, mb = a["mesh"][0], b["mesh"][0]
    pairs = {"latents": (a["latents"], b["latents"]), "space_cache": (a["space_cache"],
                                                                     b["space_cache"]),
             "v_pos": (ma.v_pos, mb.v_pos), "v_rgb": (ma.v_rgb, mb.v_rgb),
             "t_pos_idx": (ma.t_pos_idx, mb.t_pos_idx), "v_mask": (ma.v_mask, mb.v_mask),
             "t_mask": (ma.t_mask, mb.t_mask)}
    return {k: float((x.double() - y.double()).abs().max()) for k, (x, y) in pairs.items()}


def phase_checkpoint(src):
    """The reference's checkpoints in, at full width in bf16: ``reference_layout`` writes
    the seed-0 pipeline ``src`` as an SD-2.1-base diffusers directory (``unet``, ``vae``,
    ``text_encoder``) and ``triplane_turbo_sd_v1.pth``, and a full MVDream teacher as an
    LDM ``.pt`` whose ``model_ema`` shadows hold the weights (each tensor in its module's
    dtype); ``tools/convert_checkpoints.py`` converts them (``--strict``; the student in
    f32, which holds bf16 exactly); ``from_pretrained(dir, dtype_str="bfloat16")`` and
    ``build_teacher("mv", ckpt_path=...)`` load them: zero unmatched keys, every
    parameter loaded, state dicts bit-equal to the sources, and one prompt with fixed
    latents equal to the source pipeline's. Returns the loaded pipeline and its output."""
    import torch
    from triplaneturbo_torch.pipelines.triplaneturbo_text_to_3d import (
        TriplaneTurboTextTo3DPipeline,
    )
    from triplaneturbo_torch.systems.builder import build_teacher
    from triplaneturbo_torch.tools import convert_checkpoints
    from triplaneturbo_torch.tools import reference_layout as ref

    source_mv = build_teacher("mv", torch.Generator(device="cuda").manual_seed(1), {},
                              "bfloat16", "cuda")
    tmp = tempfile.TemporaryDirectory()
    d = Path(tmp.name)
    seconds, sizes = {}, {}
    t = time.perf_counter()
    sg = src.geometry.space_generator
    sd = ref.write_diffusers_dir(str(d / "ref" / "sd21"), sg.unet, sg.vae, src.text_encoder)
    pth = ref.write_adapter(str(d / "ref" / "triplane_turbo_sd_v1.pth"), src.geometry)
    mvp = str(d / "ref" / "sd-v2.1-base-4view.pt")
    torch.save(ref.ldm_teacher_state(source_mv.unet, source_mv.vae), mvp)
    seconds["write"] = time.perf_counter() - t
    for f in sorted((d / "ref").rglob("*")):
        if f.is_file():
            sizes[str(f.relative_to(d / "ref"))] = f.stat().st_size

    out = d / "converted"
    t = time.perf_counter()
    stats = convert_checkpoints.main(["--adapter", pth, "--sd-base", sd, "--mvdream", mvp,
                                      "--out", str(out), "--device", "cuda", "--strict"])
    torch.cuda.synchronize()
    seconds["convert"] = time.perf_counter() - t
    for part in (stats["student"], stats["text_encoder"], stats["mv_teacher"]["unet"],
                 stats["mv_teacher"]["vae"]):
        check(part["not_loaded"] == 0 and part["mismatched"] == 0 and part["loaded"] == part["params"],
              f"conversion left parameters or keys unmatched: {stats}")
    for f in (d / "ref").rglob("*"):  # the converted files are what a user keeps
        if f.is_file():
            f.unlink()

    torch.cuda.synchronize()
    t = time.perf_counter()
    pipe = TriplaneTurboTextTo3DPipeline.from_pretrained(str(out), device="cuda", seed=123,
                                                         dtype_str="bfloat16")
    torch.cuda.synchronize()
    seconds["from_pretrained"] = time.perf_counter() - t
    t = time.perf_counter()
    mv = build_teacher("mv", torch.Generator(device="cuda").manual_seed(2), {}, "bfloat16",
                       "cuda", ckpt_path=str(out / "mv_teacher.pt"))
    torch.cuda.synchronize()
    seconds["teacher_load"] = time.perf_counter() - t
    unequal = []
    for name, mine, theirs in (("geometry", pipe.geometry, src.geometry),
                               ("text_encoder", pipe.text_encoder, src.text_encoder),
                               ("mv_unet", mv.unet, source_mv.unet),
                               ("mv_vae", mv.vae, source_mv.vae)):
        unequal += _state_unequal(name, mine, theirs)
    check(not unequal, f"loaded state differs from its source: {unequal[:5]} ({len(unequal)})")
    n_params = {"pipeline": sum(p.numel() for m in (pipe.geometry, pipe.text_encoder)
                                for p in m.parameters()),
                "mv_teacher": sum(p.numel() for m in (mv.unet, mv.vae) for p in m.parameters())}
    del mv, source_mv

    lat = torch.randn((1, 6, 32, 32, 4), generator=torch.Generator(device="cuda").manual_seed(7),
                      device="cuda")
    torch.cuda.synchronize()
    t = time.perf_counter()
    loaded_out = pipe(CKPT_PROMPT, latents=lat)
    torch.cuda.synchronize()
    seconds["first_prompt"] = time.perf_counter() - t
    source_out = src(CKPT_PROMPT, latents=lat)
    diffs = _mesh_diffs(loaded_out, source_out)
    check(all(v == 0.0 for v in diffs.values()), f"the loaded pipeline differs: {diffs}")
    files = {f.name: f.stat().st_size for f in sorted(out.iterdir())}
    tmp.cleanup()
    emit({"phase": "checkpoint", "config": "SD-2.1-base diffusers directory + "
          "triplane_turbo_sd_v1.pth + MVDream LDM .pt with model_ema shadows, written by "
          "reference_layout from the seed-0 pipeline and a seed-1 MVDream teacher, bf16 "
          "backbone, f32 adapters and text tower", "reference_bytes": sizes,
          "converted_bytes": files, "params": n_params, "conversion": stats,
          "seconds": seconds, "prompt_max_abs_diff": diffs})
    return pipe, loaded_out


def _state_unequal(name, mine, theirs):
    """The state-dict entries of ``mine`` that differ from ``theirs`` in dtype or bits."""
    import torch

    a, b = mine.state_dict(), theirs.state_dict()
    check(set(a) == set(b), f"{name}: state dict keys differ")
    return [f"{name}.{k}" for k in b if a[k].dtype != b[k].dtype or not torch.equal(a[k], b[k])]


def phase_msgpack(src):
    """The JAX package's flax msgpack files out of the port and back, at full width
    (``utils/msgpack_io.py``; the CPU tests hold the bytes against flax's): the seed-0
    bf16 pipeline ``src`` as ``geometry.msgpack`` and ``text_encoder.msgpack`` (the JAX
    layout, ``{"params": tree}``) read back by ``from_pretrained(dir)``, every parameter
    bit-equal and a prompt with fixed latents equal to the source's; a full MVDream
    teacher through ``mv_teacher.msgpack`` and the ViT-B/32 scorer through
    ``clip_scorer.msgpack``, bit-equal. File sizes, write and read seconds, and whether
    ``import msgpack`` works here (for information: the port writes its own codec)."""
    import torch
    from triplaneturbo_torch.evaluation.clipscore import CLIPScorer, save_scorer
    from triplaneturbo_torch.pipelines.triplaneturbo_text_to_3d import (
        TriplaneTurboTextTo3DPipeline,
    )
    from triplaneturbo_torch.systems.builder import build_teacher
    from triplaneturbo_torch.utils.checkpoint import load_msgpack, save_params, save_teacher

    try:
        import msgpack  # noqa: F401

        msgpack_here = True
    except ImportError:
        msgpack_here = False
    t_phase = time.perf_counter()
    tmp = tempfile.TemporaryDirectory()
    d = Path(tmp.name)
    seconds, unequal = {}, []

    def timed(name, fn):
        torch.cuda.synchronize()
        t = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        seconds[name] = time.perf_counter() - t
        return out

    def write_pipeline():
        save_params(str(d / "pipe" / "geometry.msgpack"), src.geometry)
        save_params(str(d / "pipe" / "text_encoder.msgpack"), src.text_encoder)

    timed("write_pipeline", write_pipeline)
    head = load_msgpack(str(d / "pipe" / "text_encoder.msgpack"))
    check(set(head) == {"params"} and "final_layer_norm" in head["params"],
          "text_encoder.msgpack is not the JAX layout")
    del head
    pipe = timed("read_pipeline", lambda: TriplaneTurboTextTo3DPipeline.from_pretrained(
        str(d / "pipe"), device="cuda", seed=123, dtype_str="bfloat16"))
    unequal += _state_unequal("geometry", pipe.geometry, src.geometry)
    unequal += _state_unequal("text_encoder", pipe.text_encoder, src.text_encoder)
    lat = torch.randn((1, 6, 32, 32, 4), generator=torch.Generator(device="cuda").manual_seed(8),
                      device="cuda")
    diffs = _mesh_diffs(pipe(CKPT_PROMPT, latents=lat), src(CKPT_PROMPT, latents=lat))
    check(all(v == 0.0 for v in diffs.values()), f"msgpack: the loaded pipeline differs: {diffs}")
    del pipe

    source_mv = build_teacher("mv", torch.Generator(device="cuda").manual_seed(1), {},
                              "bfloat16", "cuda")
    path = timed("write_mv_teacher", lambda: save_teacher(str(d / "mv_teacher.msgpack"),
                                                           source_mv.unet, source_mv.vae))
    mv = timed("read_mv_teacher", lambda: build_teacher(
        "mv", torch.Generator(device="cuda").manual_seed(2), {}, "bfloat16", "cuda",
        ckpt_path=path))
    unequal += _state_unequal("mv_unet", mv.unet, source_mv.unet)
    unequal += _state_unequal("mv_vae", mv.vae, source_mv.vae)
    n_mv = sum(p.numel() for m in (mv.unet, mv.vae) for p in m.parameters())
    del mv, source_mv

    scorer = CLIPScorer(seed=0, device="cuda")
    path = timed("write_clip_scorer", lambda: save_scorer(str(d / "clip_scorer.msgpack"),
                                                           scorer))
    back = timed("read_clip_scorer", lambda: CLIPScorer.from_checkpoint(path, seed=1,
                                                                         device="cuda"))
    unequal += _state_unequal("clip_vision", back.vision, scorer.vision)
    unequal += _state_unequal("clip_text", back.text, scorer.text)
    if not torch.equal(back.text_projection, scorer.text_projection):
        unequal.append("clip text_projection")
    check(not unequal, f"msgpack: loaded state differs from its source: {unequal[:5]} "
          f"({len(unequal)})")
    files = {str(f.relative_to(d)): f.stat().st_size for f in sorted(d.rglob("*.msgpack"))}
    tmp.cleanup()
    emit({"phase": "msgpack", "what": "the seed-0 bf16 pipeline (student + OpenCLIP-H text "
          "tower), a seed-1 bf16 MVDream teacher and the seed-0 ViT-B/32 scorer through the "
          "port's flax msgpack writer and readers, the JAX package's file names and layout",
          "bytes": files, "seconds": seconds, "phase_s": time.perf_counter() - t_phase,
          "prompt_max_abs_diff": diffs,
          "mv_teacher_params": n_mv, "bit_equal": True,
          "import_msgpack_works_here": msgpack_here})


def phase_flops_prompt(pipe):
    """The FLOPs of one full-width prompt through ``__call__`` (``utils/flops.py``
    ``count_flops``): by stage (the pipeline's ``record_function`` ranges), by operator
    and by kernel, with the prompt's launches."""
    import torch
    from triplaneturbo_torch.utils.flops import count_flops

    reset_counts, read_counts = _count_launches()
    gen = torch.Generator(device="cuda").manual_seed(42)
    torch.cuda.synchronize()
    reset_counts()
    t = time.perf_counter()
    _, count = count_flops(pipe, "a delicious hamburger", generator=gen)
    torch.cuda.synchronize()
    launches = read_counts()
    check(launches["flash_attn_fwd"] == K1_LAUNCHES_PER_PROMPT
          and launches["field_grid"] == K2_LAUNCHES_PER_PROMPT,
          f"flops: the counted prompt's launches {launches}")
    check(count.total > 0 and sum(count.by_range.values()) == count.total
          and set(count.by_range) <= set(STAGES),
          f"flops: the prompt's count {count.total} by range {count.by_range}")
    return {"count": count, "counted_prompt_ms": (time.perf_counter() - t) * 1e3,
            "launches": launches}


def _rate(flops: float, ms: float) -> dict:
    """TFLOP/s over ``ms`` and its share of the card's dense bf16 peak."""
    per_s = flops / (ms * 1e-3) if ms > 0 else 0.0
    return {"tflops_per_s": per_s / 1e12, "mfu": per_s / PEAK_FLOPS["bfloat16"]}


def flops_line(prompt, timing, step):
    """The ``flops`` line: a full-width prompt's and a v1 step's FLOPs (what the plain
    PyTorch route executes, the hand-written kernels counted as their plain versions),
    their rates and shares of the bf16 peak over host and device time, by stage; and the
    small model's counts on the card against the CPU, which must be equal."""
    c = prompt["count"]
    busy = timing["stage_device_busy_ms"]
    serving = {
        "flops": c.total, "by_stage": c.by_range,
        "over_host_median": {"ms": timing["prompt_ms_median"],
                             **_rate(c.total, timing["prompt_ms_median"])},
        "over_device_busy": {"ms": timing["prompt_device_busy_ms"],
                             **_rate(c.total, timing["prompt_device_busy_ms"])},
        "by_stage_over_device_busy": {k: {"ms": busy.get(k, 0.0), **_rate(v, busy.get(k, 0.0))}
                                      for k, v in c.by_range.items()},
        "by_op": c.by_op, "by_kernel": c.by_kernel, "kernel_share": c.kernel_share(),
        "counted_prompt_ms": prompt["counted_prompt_ms"], "launches": prompt["launches"]}
    s = step["count"]
    part_busy = step["part_device_busy_ms"] * step["parts"]
    training = {
        "flops": s.total, "by_program": s.by_range,
        "over_step_median": {"ms": step["step_ms_median"],
                             **_rate(s.total, step["step_ms_median"])},
        "over_device_busy": {"ms": part_busy, "what": "one profiled part's device-busy ms "
                             "times the parts of a step", **_rate(s.total, part_busy)},
        "by_op": s.by_op, "by_kernel": s.by_kernel, "kernel_share": s.kernel_share(),
        "counted_step_ms": step["counted_step_ms"], "launches": step["launches"]}
    small = {}
    for what in ("prompt", "step_staged", "step_monolithic"):
        card, cpu = SMALL_FLOPS[f"{what}_cuda"], SMALL_FLOPS[f"{what}_cpu"]
        small[what] = {"cuda": card.total, "cpu": cpu.total, "equal": card.total == cpu.total,
                       "cuda_kernel_share": card.kernel_share(),
                       "cuda_by_kernel": card.by_kernel}
        check(card.total == cpu.total and card.by_range == cpu.by_range,
              f"flops: the small model's {what} counts {card.total} on the card and "
              f"{cpu.total} on the CPU ({card.by_range} against {cpu.by_range})")
        check(card.by_kernel and not cpu.by_kernel, f"flops: {what}'s kernel rows "
              f"{card.by_kernel} on the card, {cpu.by_kernel} on the CPU")
    return {"phase": "flops", "peak_flops": PEAK_FLOPS["bfloat16"],
            "counting": "torch.utils.flop_counter over the matrix products each call "
            "executes (elementwise work not counted); every DDIM step, checkpoint "
            "recompute and part counted; the hand-written kernels as their plain versions",
            "not_bf16": "the text tower runs in f32 and the field grid in f32 (its kernel's "
            "products as split TF32); both are held against the bf16 peak all the same",
            "serving": serving, "training": training, "small_model_card_vs_cpu": small}


def _png_pixels(path):
    """(height, width, pixels) of an 8-bit RGB PNG that ``utils.saving.write_png`` wrote
    (one IDAT, filter 0 on every row)."""
    import struct
    import zlib

    import numpy as np

    data = Path(path).read_bytes()
    w, h = struct.unpack(">II", data[16:24])
    pos, idat = 8, b""
    while pos < len(data):
        n = struct.unpack(">I", data[pos:pos + 4])[0]
        if data[pos + 4:pos + 8] == b"IDAT":
            idat += data[pos + 8:pos + 8 + n]
        pos += 12 + n
    rows = np.frombuffer(zlib.decompress(idat), np.uint8).reshape(h, 1 + 3 * w)
    check(not rows[:, 0].any(), "PNG rows with a filter")
    return h, w, rows[:, 1:].reshape(h, w, 3)


def _obj_counts(path) -> dict:
    counts = {"v": 0, "vn": 0, "vt": 0, "f": 0}
    with open(path) as fh:
        for line in fh:
            tag = line.split(" ", 1)[0]
            if tag in counts:
                counts[tag] += 1
    counts["bytes"] = os.path.getsize(path)
    return counts


def _torus(nu: int = 384, nv: int = 256):
    """A closed torus on the card with ``nu * nv`` vertices and twice as many faces
    (98,304 and 196,608: the pipeline's whole capacity), inside the field's cube."""
    import torch

    a = torch.arange(nu, device="cuda", dtype=torch.float32)[:, None] * (2 * math.pi / nu)
    b = torch.arange(nv, device="cuda", dtype=torch.float32)[None, :] * (2 * math.pi / nv)
    ring = 0.5 + 0.2 * torch.cos(b)
    v = torch.stack([ring * torch.cos(a), ring * torch.sin(a), (0.2 * torch.sin(b)).expand(nu, nv)],
                    -1).reshape(-1, 3)
    i, j = torch.meshgrid(torch.arange(nu, device="cuda"), torch.arange(nv, device="cuda"),
                          indexing="ij")
    c00, c10 = i * nv + j, (i + 1) % nu * nv + j
    c01, c11 = i * nv + (j + 1) % nv, (i + 1) % nu * nv + (j + 1) % nv
    f = torch.cat([torch.stack([c00, c10, c11], -1).reshape(-1, 3),
                   torch.stack([c00, c11, c01], -1).reshape(-1, 3)])
    return v, f.int()


def _ramp(p):
    """A pointwise color of float64 points, exact in IEEE arithmetic on either device and
    never 0, so that a texel's coverage shows in its color."""
    import torch

    k = torch.tensor([3.1, 5.3, 7.7], dtype=p.dtype, device=p.device)
    return 0.25 + 0.5 * torch.frac(p * k).abs()


def _bake_routes(v, faces, color_fn) -> dict:
    """The texture of ``v``, ``faces`` (compacted, on the card) baked on the card and on
    the CPU with the same closure (evaluated on the card for both): the UV atlases must
    be equal; the largest texel difference and the texels whose coverage differs."""
    import torch
    from triplaneturbo_torch.utils.uv_export import bake_texture, per_face_uv_atlas

    uv_card, _ = per_face_uv_atlas(faces.shape[0], TEX_SIZE, device=v.device)
    uv_cpu, _ = per_face_uv_atlas(faces.shape[0], TEX_SIZE)
    check(torch.equal(uv_card.cpu(), uv_cpu), "the UV atlas differs between card and CPU")
    card = bake_texture(v, faces, uv_card, color_fn, TEX_SIZE).cpu()
    cpu = bake_texture(v.cpu(), faces.cpu(), uv_cpu, lambda p: color_fn(p.cuda()).cpu(),
                       TEX_SIZE)
    covered = (card > 0).any(-1)
    return {"max_abs_err": float((card - cpu).abs().max()), "covered": int(covered.sum()),
            "coverage_differs": int((covered != (cpu > 0).any(-1)).sum())}


def _write_formats(mesh, color_fn, d: str, name: str) -> tuple:
    """``export_obj`` (native writer), ``export_obj(save_normal=True)`` and the exporter's
    ``obj-mtl`` of ``mesh`` under ``d``: (host seconds, counts of each file); the counts
    must equal the masks' sums."""
    import torch
    from triplaneturbo_torch.models.exporters.mesh_exporter import (
        MeshExporterConfig,
        MultipromptMeshExporter,
    )
    from triplaneturbo_torch.pipelines.triplaneturbo_text_to_3d import export_obj

    nv, nf = int(mesh.valid_vert_mask().sum()), int(mesh.valid_face_mask().sum())
    seconds, files = {}, {}
    for fmt, normal in (("obj", False), ("obj_normals", True)):
        torch.cuda.synchronize()
        t = time.perf_counter()
        path = export_obj(mesh, os.path.join(d, f"{name}_{fmt}.obj"), save_normal=normal)[0]
        seconds[fmt] = time.perf_counter() - t
        files[fmt] = _obj_counts(path)
        check(files[fmt]["v"] == nv and files[fmt]["f"] == nf
              and files[fmt]["vn"] == (nv if normal else 0),
              f"{name} {fmt}: {files[fmt]} for {nv} vertices and {nf} faces")
    exporter = MultipromptMeshExporter(MeshExporterConfig(fmt="obj-mtl"))
    torch.cuda.synchronize()
    t = time.perf_counter()
    path = exporter([mesh], d, [name], color_fns=[color_fn])[0]
    torch.cuda.synchronize()
    seconds["obj_mtl"] = time.perf_counter() - t
    files["obj_mtl"] = _obj_counts(path)
    check(files["obj_mtl"]["v"] == nv and files["obj_mtl"]["f"] == nf
          and files["obj_mtl"]["vt"] == 3 * nf, f"{name} obj-mtl: {files['obj_mtl']}")
    h, w, px = _png_pixels(os.path.join(d, name, "texture_kd.png"))
    check((h, w) == (TEX_SIZE, TEX_SIZE), f"{name} texture {h}x{w}")
    files["texture_bytes"] = os.path.getsize(os.path.join(d, name, "texture_kd.png"))
    files["texels_covered_share"] = float((px.max(axis=-1) > 0).mean())
    return seconds, files


def phase_export(pipe, out):
    """Every export format from the loaded pipeline's full-width mesh and from a torus
    at the pipeline's whole capacity (98,304 vertices, 196,608 faces): ``export_obj``
    through the native writer, ``export_obj(save_normal=True)`` through the Python
    writer, and the mesh exporter's ``obj-mtl`` at ``tex_size`` 1024 with the texture
    field's closure on the card; the vertex and face counts equal to the masks' sums,
    the baked colors finite and in [0, 1]; host seconds of each. The card's bake is
    held against the CPU route's: the UV atlas equal, with a pointwise ramp the texture
    bit-equal (every covered texel, so every winning face, and every texel index), and
    with the field closure (evaluated on the card in both) within 1e-3."""
    import torch
    from triplaneturbo_torch.utils import native
    from triplaneturbo_torch.utils.mesh import Mesh

    m = out["mesh"][0]
    cache = out["space_cache"][0]
    nv, nf = int(m.v_mask.sum()), int(m.t_mask.sum())
    faces_valid = int((m.t_mask & m.v_mask[m.t_pos_idx.long()].all(dim=1)).sum())
    check(faces_valid == nf, f"{nf - faces_valid} valid faces name an invalid vertex")
    baked = {"points": 0, "nonfinite": 0, "min": math.inf, "max": -math.inf}

    @torch.no_grad()
    def color_fn(p):
        c = pipe.material(pipe.geometry.export(p[None].float(), cache[None])["features"][0])
        baked["points"] += c.shape[0]
        baked["nonfinite"] += int((~torch.isfinite(c)).sum())
        baked["min"] = min(baked["min"], float(c.min()))
        baked["max"] = max(baked["max"], float(c.max()))
        return c

    tv, tf = _torus()
    torus = Mesh(v_pos=tv, t_pos_idx=tf, v_mask=torch.ones(tv.shape[0], dtype=torch.bool,
                                                           device="cuda"),
                 t_mask=torch.ones(tf.shape[0], dtype=torch.bool, device="cuda"),
                 v_rgb=color_fn(tv.double()).float())
    native.library()  # built before the timed writes
    with tempfile.TemporaryDirectory() as d:
        seconds, files = _write_formats(m, color_fn, d, "model")
        full_seconds, full_files = _write_formats(torus, color_fn, d, "torus")
    check(baked["points"] > 0 and baked["nonfinite"] == 0 and 0.0 <= baked["min"]
          and baked["max"] <= 1.0, f"baked colors: {baked}")

    vm = m.v_mask
    remap = torch.full((vm.shape[0],), -1, dtype=torch.long, device="cuda")
    remap[vm] = torch.arange(nv, device="cuda")
    faces = remap[m.t_pos_idx.long()[m.t_mask]]
    routes = {"mesh_ramp": _bake_routes(m.v_pos[vm], faces, _ramp),
              "mesh_field": _bake_routes(m.v_pos[vm], faces, color_fn),
              "torus_ramp": _bake_routes(tv, tf.long(), _ramp)}
    emit({"phase": "export", "mesh": {"verts": nv, "faces": nf, "capacity": [
          int(m.v_pos.shape[0]), int(m.t_pos_idx.shape[0])]}, "tex_size": TEX_SIZE,
          "files": files, "baked_colors": baked, "host_seconds": seconds,
          "full_capacity_torus": {"verts": int(tv.shape[0]), "faces": int(tf.shape[0]),
                                  "files": full_files, "host_seconds": full_seconds},
          "card_vs_cpu_bake": routes})
    for name, r in routes.items():
        if name.endswith("ramp"):
            ok = r["max_abs_err"] == 0.0 and r["coverage_differs"] == 0 and r["covered"] > 0
        else:
            ok = r["max_abs_err"] <= 1e-3
        check(ok, f"the card's bake differs from the CPU's ({name}): {r}")


# The small model's first renderer: R = 16 keeps the chance that the field grid's
# kernel and the plain field put a grid point on opposite sides of the surface (which
# moves faces, not rounding) near 0.1 % a mesh; 2 prompts x 2 views at 64².
SMALL_RENDER = dict(isosurface_resolution=16, max_verts=4096, max_faces=8192, field_chunk=4096)
SMALL_VIEWS, SMALL_HW, SMALL_RAYS = 2, 64, 16
# The small model's second renderer at its 16² rays: a 5² global render and one 8² patch.
# inv_std starts at e^3, not e^4.6: the NeuS alpha multiplies a sample position's rounding
# by the SDF's slope and inv_std, and the card and the CPU round the proposal pass's CDF
# differently in the last bit.
SMALL_VOLUME = dict(num_samples_per_ray=32, num_samples_per_ray_importance=32,
                    learned_variance_init=0.3, field_chunk=1000)
SMALL_PATCH = dict(patch_size=8, global_downsample=3)


def _small_render_inputs(gen):
    """Cameras from the port's data module, a seeded space cache, pooled text states and
    image cotangents for the small model's program B-R."""
    import torch
    from triplaneturbo_torch.data.multiview_multiprompt import (
        DataModuleConfig,
        MultiviewMultipromptDataModule,
    )

    dm = MultiviewMultipromptDataModule(DataModuleConfig(
        batch_size=2 * SMALL_VIEWS, n_view=SMALL_VIEWS, height=SMALL_HW, width=SMALL_HW,
        ray_height=SMALL_RAYS, ray_width=SMALL_RAYS, n_steps=1), seed=0)
    batch = {k: v for k, v in dm.sample_train_batch()[0].items() if k != "noise"}
    plane = SMALL_KW["latent_resolution"] * 2 ** (len(SMALL_SG["vae_block_out_channels"]) - 1)
    cache = torch.randn((2, 6, plane, plane, SMALL_SG["output_dim"] // 2), generator=gen) * 0.2
    text = torch.randn((2, SMALL_SG["cross_attention_dim"]), generator=gen)
    grads = {f"{k}_{side}": torch.randn((2 * SMALL_VIEWS, hw, hw, c), generator=gen)
             for k, c in (("comp_rgb", 3), ("comp_normal_cam_vis", 3), ("disparity", 1))
             for side, hw in (("1st", SMALL_HW), ("2nd", SMALL_RAYS))}
    return batch, cache, text, grads


def _draws_to(draws, device):
    """The second branch's draws with their jitter on ``device``."""
    from dataclasses import replace

    return replace(draws, jitter_global=tuple(u.to(device) for u in draws.jitter_global),
                   jitter_patch=tuple(u.to(device) for u in draws.jitter_patch))


def _rel(got, ref, what: str) -> float:
    """max |got - ref| / max |ref|, with ``got`` (from the card) required finite."""
    import torch

    got, ref = got.detach().float().cpu(), ref.detach().float().cpu()
    check(bool(torch.isfinite(got).all()), f"non-finite {what} on the card")
    return ((got - ref).abs().max() / ref.abs().max().clamp_min(1e-12)).item()


def _value_replay(owner, name):
    """Wrappers of ``owner.name`` that record the card's outputs and make the CPU's return
    the card's values, call for call, with the CPU's own gradient. Returns (original,
    recording, replaying, the card's outputs, the CPU's own)."""
    fn = getattr(owner, name)
    card, own = [], []

    def recording(*args, **kwargs):
        out = fn(*args, **kwargs)
        card.append(tuple(x.detach() for x in (out if isinstance(out, tuple) else (out,))))
        return out

    def replaying(*args, **kwargs):
        out = fn(*args, **kwargs)
        mine = out if isinstance(out, tuple) else (out,)
        own.append(tuple(x.detach() for x in mine))
        vals = tuple(x + (c.cpu() - x).detach() for x, c in zip(mine, card[len(own) - 1]))
        return vals if isinstance(out, tuple) else vals[0]
    return fn, recording, replaying, card, own


def _volume_against_cpu(on_card, on_cpu, step=False):
    """Run ``on_card`` and then ``on_cpu``, the CPU's volume renders taking the card's
    sample boundaries and the card's downsampled rays: ``importance_sampling`` and the
    patch renderer's ``resize`` are wrapped so that the card's calls are recorded and the
    CPU's return the card's results, call for call (a resize that enlarges, of the
    images, is not replayed). With ``step`` (a whole training step), the space cache that
    the generator decodes and the SDF and deformation on the grid too: the CPU's take the
    card's values and keep their own gradient.

    The renders are then the same function of the same points on both. The two inputs
    are held apart, since the renders' derivatives jump where they change: a sample
    boundary comes from an inverse CDF whose values near 1 are rounded to 6e-8, and one
    in an interval of little mass moves by that over the mass; the antialiased resize
    rounds otherwise on the card; and a sample moved by a rounding lands, now and then,
    across a texel edge or a ReLU kink of the field, where the analytic normal jumps --
    as does one whose space cache moved by the generator's rounding. Marching cubes
    places a vertex at sdf_a / (sdf_a - sdf_b) of a grid edge, which divides the field's
    rounding by the SDF's step there, and the deformation's gradient moves with it.
    Returns (card result, CPU result, agreement of the inputs: the share of the CPU's own
    boundaries within 1e-4 of the card's, the largest difference, the largest
    difference of the downsampled rays and, with ``step``, of the grid values, and the
    largest difference of the space cache over its largest value)."""
    import torch
    from triplaneturbo_torch.models.geometry import triplane_geometry as tg
    from triplaneturbo_torch.models.renderers import patch_renderer as pr
    from triplaneturbo_torch.models.renderers import volume_renderer as vr

    sample, resize = vr.importance_sampling, pr.resize
    card, cpu_own, card_rays, cpu_rays = [], [], [], []
    replays = {name: _value_replay(tg.TriplaneGeometry, name)
               for name in ("decode", "forward_field_grid")} if step else {}

    def recording(*args, **kwargs):
        card.append(sample(*args, **kwargs))
        return card[-1]

    def replaying(*args, **kwargs):
        cpu_own.append(sample(*args, **kwargs))
        return tuple(t.cpu() for t in card[len(cpu_own) - 1])

    def recording_rays(x, h, w):
        out = resize(x, h, w)
        if h < x.shape[1]:
            card_rays.append(out)
        return out

    def replaying_rays(x, h, w):
        out = resize(x, h, w)
        if h >= x.shape[1]:
            return out
        cpu_rays.append(out)
        return card_rays[len(cpu_rays) - 1].cpu()

    try:
        vr.importance_sampling, pr.resize = recording, recording_rays
        for name, (_, rec, _, _, _) in replays.items():
            setattr(tg.TriplaneGeometry, name, rec)
        got = on_card()
        torch.cuda.synchronize()
        vr.importance_sampling, pr.resize = replaying, replaying_rays
        for name, (_, _, rep, _, _) in replays.items():
            setattr(tg.TriplaneGeometry, name, rep)
        ref = on_cpu()
    finally:
        vr.importance_sampling, pr.resize = sample, resize
        for name, (fn, _, _, _, _) in replays.items():
            setattr(tg.TriplaneGeometry, name, fn)
    check(len(card) == len(cpu_own) > 0 and len(card_rays) == len(cpu_rays) > 0
          and all(len(c) == len(o) > 0 for _, _, _, c, o in replays.values()),
          f"the card sampled {len(card)} and resized {len(card_rays)} times, the CPU "
          f"{len(cpu_own)} and {len(cpu_rays)}; replayed "
          f"{({k: (len(v[3]), len(v[4])) for k, v in replays.items()})}")
    diffs = torch.cat([(c[0].cpu() - o[0]).abs().flatten() for c, o in zip(card, cpu_own)])
    agree = {"boundaries": int(diffs.numel()),
             "share_within_1e-4": float((diffs <= 1e-4).float().mean()),
             "max_abs_diff": float(diffs.max()),
             "rays_max_abs_diff": max(float((c.cpu() - o).abs().max())
                                      for c, o in zip(card_rays, cpu_rays))}
    if step:
        _, _, _, card_grid, cpu_grid = replays["forward_field_grid"]
        agree["grid_calls"] = len(card_grid)
        agree["grid_max_abs_diff"] = max(float((c.cpu() - o).abs().max())
                                         for cs, os_ in zip(card_grid, cpu_grid)
                                         for c, o in zip(cs, os_))
        _, _, _, card_cache, cpu_cache = replays["decode"]
        agree["space_cache_calls"] = len(card_cache)
        agree["space_cache_rel_diff"] = max(_rel(c[0], o[0], "space cache")
                                            for c, o in zip(card_cache, cpu_cache))
    check(agree["share_within_1e-4"] >= 0.99 and agree["rays_max_abs_diff"] <= 1e-5
          and agree.get("grid_max_abs_diff", 0.0) <= TOL[("field_grid", "float32")]
          and agree.get("space_cache_rel_diff", 0.0) <= SMALL_REL_TOL,
          f"the card's and the CPU's samplers, resized rays, grid values or space caches "
          f"disagree: {agree}")
    return got, ref, agree


# The small model's teachers for program G: head dim 64, and VAE encoders whose last block
# has 64 channels (single-head D = 64 mid attention), at image sizes that give every
# such site L >= 128 (32² latents), so that the MV and SD teachers' attention and the
# encoders' mid attention take the kernels on the card. RichDreamer keeps its 8 heads
# (D = 8, 16: the einsum path, as at full width).
SMALL_TEACHER = dict(block_out_channels=(64, 128), layers_per_block=1, attention_head_dim=64,
                     cross_attention_dim=64)
SMALL_TEACHER_VAE = dict(vae_block_out_channels=(32, 64), vae_layers_per_block=1)
SMALL_TEACHERS = {"mv": {**SMALL_TEACHER, **SMALL_TEACHER_VAE}, "rd": dict(SMALL_TEACHER),
                  "sd": {**SMALL_TEACHER, **SMALL_TEACHER_VAE}}
SMALL_GUIDANCE = dict(mv_image_size=64, rd_image_size=32, sd_image_size=64)
SMALL_G_HW = (64, 32)  # the small program G's first and second renders


def _draws_on(draws, device):
    """Program G's draws on ``device``."""
    return {kind: [d.to(device) for d in ds] for kind, ds in draws.items()}


def _small_program_g():
    """The small model's program G on the card (kernels) against the CPU (plain
    versions), f32, from the same teacher weights, images, cameras, text states and
    draws, with the renderers one after the other and stacked."""
    import torch
    from triplaneturbo_torch.data.multiview_multiprompt import (
        DataModuleConfig,
        MultiviewMultipromptDataModule,
    )
    from triplaneturbo_torch.models.background.hashgrid_env_map import (
        HashgridBackgroundConfig,
        HyperNetConfig,
    )
    from triplaneturbo_torch.models.guidance.asd_guidance import ASDConfig
    from triplaneturbo_torch.ops import flash_attention as fa
    from triplaneturbo_torch.systems.trainer import TrainerConfig, TriplaneTurboTrainer

    def build(device, parallel):
        return TriplaneTurboTrainer.build(
            TrainerConfig(parallel_guidance=parallel), seed=0, device=device,
            space_generator_overrides=SMALL_SG,
            background_cfg=HashgridBackgroundConfig(
                hypernet=HyperNetConfig(c_dim=SMALL_SG["cross_attention_dim"])),
            teacher_sizes=SMALL_TEACHERS, teacher_dtype="float32",
            guidance_cfg=ASDConfig(**SMALL_GUIDANCE))

    hw1, hw2 = SMALL_G_HW
    dm = MultiviewMultipromptDataModule(DataModuleConfig(
        batch_size=8, n_view=4, height=hw1, width=hw1, ray_height=hw2, ray_width=hw2,
        n_steps=1), seed=0)
    host_batch = {k: v for k, v in dm.sample_train_batch()[0].items() if k != "noise"}
    gen = torch.Generator().manual_seed(8)
    images = {f"{k}_{side}": torch.rand((8, hw, hw, c), generator=gen)
              for k, c in (("comp_rgb", 3), ("comp_normal_cam_vis", 3), ("disparity", 1))
              for side, hw in (("1st", hw1), ("2nd", hw2))}
    text = {k: torch.randn((2, 77, SMALL_TEACHER["cross_attention_dim"]), generator=gen)
            for k in ("cond_21", "uncond_21", "cond_15", "uncond_15")}
    rows = {}
    for parallel in (False, True):
        trainers = {dev: build(dev, parallel) for dev in ("cpu", "cuda")}
        for kind in ("mv", "rd", "sd"):
            src, dst = (getattr(trainers[d].guidance, kind) for d in ("cpu", "cuda"))
            dst.unet.load_state_dict(src.unet.state_dict())
            if src.vae is not None:
                dst.vae.load_state_dict(src.vae.state_dict())
        scalars = trainers["cpu"].host_scalars()
        draws = trainers["cpu"].draw_guidance(MultiviewMultipromptDataModule.to_device(
            host_batch, "cpu"), torch.Generator().manual_seed(9))
        outs, launches = {}, {}
        for dev, tr in trainers.items():
            fa.LAUNCHES = fa.LAUNCHES_STATS = fa.LAUNCHES_BWD_DQ = fa.LAUNCHES_BWD_DKDV = 0
            outs[dev] = tr._stage_teacher(
                {k: v.to(dev) for k, v in images.items()},
                MultiviewMultipromptDataModule.to_device(host_batch, dev),
                {k: v.to(dev) for k, v in text.items()}, scalars, _draws_on(draws, dev))
            if dev == "cuda":
                torch.cuda.synchronize()
            launches[dev] = {"flash_attn_fwd": fa.LAUNCHES,
                             "flash_attn_fwd_stats": fa.LAUNCHES_STATS,
                             "flash_attn_bwd_dq": fa.LAUNCHES_BWD_DQ,
                             "flash_attn_bwd_dkdv": fa.LAUNCHES_BWD_DKDV}
        # a teacher call a renderer (stacked: one for both); 8 kernel sites a small MV or SD
        # UNet pass; one encoder mid attention a MV or SD call
        calls = 1 if parallel else 2
        want = {"flash_attn_fwd": calls * 2 * 8, "flash_attn_fwd_stats": calls * 2,
                "flash_attn_bwd_dq": calls * 2, "flash_attn_bwd_dkdv": calls * 2}
        check(not any(launches["cpu"].values()) and launches["cuda"] == want,
              f"train_reference program G (parallel {parallel}): launches {launches}, "
              f"expected {want} on the card")
        (fid_c, gn_c), g_c = outs["cuda"]
        (fid_r, gn_r), g_r = outs["cpu"]
        row = {"fid": [float(fid_c), float(fid_r)],
               "fid_rel_err": _rel(fid_c.reshape(1), fid_r.reshape(1), "fid"),
               "grad_norm_mv": [gn_c.tolist(), gn_r.tolist()],
               "grad_norm_mv_rel_err": _rel(gn_c.reshape(-1), gn_r.reshape(-1), "grad_norm_mv"),
               "grads": {}, "launches": launches["cuda"]}
        for k, ref in g_r.items():
            check(bool(ref.any()), f"train_reference program G: zero CPU gradient for {k}")
            row["grads"][k] = _rel(g_c[k], ref, k)
        row["worst_rel_err"] = max([row["fid_rel_err"], row["grad_norm_mv_rel_err"],
                                    *row["grads"].values()])
        check(row["worst_rel_err"] <= SMALL_REL_TOL, f"train_reference program G (parallel "
              f"{parallel}): card against CPU rel err {row['worst_rel_err']}: {row}")
        rows["stacked" if parallel else "one_after_the_other"] = row
        del trainers, outs
        torch.cuda.empty_cache()
    return rows


def _small_train_step():
    """One ``train_step`` of the small model (head dim 64, 64-channel planes, teachers that
    take the kernels; 2 parts of 2 prompts x 4 views at 64², 32² rays), staged and
    monolithic, on the card (kernels) against the CPU (plain versions), f32, from the same
    weights, step-batches, text states and draws; the CPU's volume renders take the card's
    sample boundaries, downsampled rays, space caches and grid values (their gradients its
    own; ``_volume_against_cpu``). Held within WHOLE_STEP_TOL: each metric, and every
    trainable leaf after the update. Adan's first step moves an element by the learning
    rate times the sign of its gradient, so an element whose CPU gradient is under 1e-2
    of its leaf's largest (the CPU tests' rule) may move either way: it is held within
    four learning rates more. Held within WHOLE_STEP_GRAD_TOL: each leaf's gradient of
    the step (Adan's ``prev_grad``) on the card against the CPU; the mesh branch's vertex
    gradients pass through the barycentrics of the random field's thin faces, which
    divide a vertex's last bit by their area."""
    import torch
    from triplaneturbo_torch.data.multiview_multiprompt import (
        DataModuleConfig,
        MultiviewMultipromptDataModule,
    )
    from triplaneturbo_torch.models.background.hashgrid_env_map import (
        HashgridBackgroundConfig,
        HyperNetConfig,
    )
    from triplaneturbo_torch.models.guidance.asd_guidance import ASDConfig
    from triplaneturbo_torch.models.renderers.patch_renderer import PatchRendererConfig
    from triplaneturbo_torch.models.renderers.rasterize_renderer import RasterizeRendererConfig
    from triplaneturbo_torch.models.renderers.volume_renderer import VolumeRendererConfig
    from triplaneturbo_torch.systems.trainer import (
        LossConfig,
        PartDraws,
        TrainerConfig,
        TriplaneTurboTrainer,
    )
    from triplaneturbo_torch.utils.flops import count_flops

    reset_counts, read_counts = _count_launches()
    parts = 2

    def build(device, auto_grad):
        loss = LossConfig(lambda_sparsity_2nd=0.3, lambda_opaque_2nd=0.2,
                          lambda_z_variance_2nd=0.5, lambda_eikonal_2nd=0.1,
                          lambda_orient_2nd=2.0, lambda_sdf_abs=0.4)
        return TriplaneTurboTrainer.build(
            TrainerConfig(auto_grad=auto_grad, num_parts_training=parts,
                          num_steps_training=parts, loss=loss), seed=0, device=device,
            space_generator_overrides=SMALL_SG,
            background_cfg=HashgridBackgroundConfig(
                hypernet=HyperNetConfig(c_dim=SMALL_SG["cross_attention_dim"])),
            renderer_cfg=RasterizeRendererConfig(**SMALL_RENDER),
            volume_cfg=VolumeRendererConfig(**SMALL_VOLUME),
            patch_cfg=PatchRendererConfig(**SMALL_PATCH), teacher_sizes=SMALL_TEACHERS,
            teacher_dtype="float32", guidance_cfg=ASDConfig(**SMALL_GUIDANCE))

    hw1, hw2 = SMALL_G_HW
    r = SMALL_KW["latent_resolution"]
    dm = MultiviewMultipromptDataModule(DataModuleConfig(
        batch_size=8, n_view=4, height=hw1, width=hw1, ray_height=hw2, ray_width=hw2,
        n_steps=parts, dim_gaussian=(6, 4, r, r)), seed=0)
    batch_list = dm.sample_train_batch()
    gen = torch.Generator().manual_seed(11)
    text = {k: torch.randn((2, 77, SMALL_TEACHER["cross_attention_dim"]), generator=gen)
            for k in ("cond_local", "cond_21", "uncond_21", "cond_15", "uncond_15")}
    text["global_21"] = torch.randn((2, SMALL_SG["cross_attention_dim"]), generator=gen)
    rows = {}
    for auto_grad in (True, False):
        trainers = {dev: build(dev, auto_grad) for dev in ("cpu", "cuda")}
        src, dst = trainers["cpu"], trainers["cuda"]
        gen = torch.Generator().manual_seed(12)  # the same weights for both steps
        with torch.no_grad():
            for n, p in src.geometry.named_parameters():
                if n.endswith(".up") or ".up." in n:
                    p.copy_(torch.randn(p.shape, generator=gen) * 0.05)
        for name in ("geometry", "background", "volume_renderer"):
            getattr(dst, name).load_state_dict(getattr(src, name).state_dict())
        for kind in ("mv", "rd", "sd"):
            for m_src, m_dst in zip(getattr(src.guidance, kind), getattr(dst.guidance, kind)):
                if m_src is not None:
                    m_dst.load_state_dict(m_src.state_dict())
        batches = [MultiviewMultipromptDataModule.to_device(
            {k: v for k, v in b.items() if k != "noise"}, "cpu") for b in batch_list]
        draws = [src.draw_part(b, batch_list[0]["noise"].shape,
                               torch.Generator().manual_seed(20 + i))
                 for i, b in enumerate(batches)]
        card_draws = [PartDraws(d.noise.cuda(), _draws_to(d.volume, "cuda"),
                                _draws_on(d.guidance, "cuda")) for d in draws]
        m_cuda, m_cpu = [None], [None]
        reset_counts()

        name = "staged" if auto_grad else "monolithic"

        def on_card():  # each step counted for the flops line
            m_cuda[0], SMALL_FLOPS[f"step_{name}_cuda"] = count_flops(
                dst.train_step, batch_list, {k: v.cuda() for k, v in text.items()},
                draws=card_draws)

        def on_cpu():
            m_cpu[0], SMALL_FLOPS[f"step_{name}_cpu"] = count_flops(
                src.train_step, batch_list, text, draws=draws)

        _, _, sampler = _volume_against_cpu(on_card, on_cpu, step=True)
        launches = read_counts()
        check(all(v > 0 for v in launches.values()),
              f"train_reference whole step (auto_grad {auto_grad}): launches {launches}")
        row = {"launches": launches, "sampler": sampler, "metrics": {}, "grads": {},
               "params": {}}
        for k, ref in m_cpu[0].items():
            got, ref = float(m_cuda[0][k]), float(ref)
            check(math.isfinite(got), f"train_reference whole step: non-finite {k} on the card")
            row["metrics"][k] = abs(got - ref) / max(abs(ref), 1e-12)
        unsettled = total = 0
        lr = src.cfg.learning_rate
        for (n, p_ref), p_got in zip(src.params_train.items(), dst.params_train.values()):
            g_ref = src.optimizer.adan.state[p_ref]["prev_grad"]
            g_got = dst.optimizer.adan.state[p_got]["prev_grad"]
            row["grads"][n] = _rel(g_got, g_ref, f"gradient {n}")
            loose = g_ref.abs() < 1e-2 * g_ref.abs().max()  # from the CPU's gradient alone
            total += loose.numel()
            unsettled += int(loose.sum())
            diff = (p_got.detach().cpu() - p_ref.detach()).abs() - 4 * lr * loose
            row["params"][n] = (diff.max().clamp_min(0)
                                / p_ref.detach().abs().max().clamp_min(lr)).item()
        worst = {k: max(row[k].values()) for k in ("metrics", "grads", "params")}
        row.update(worst_rel_err=worst, unsettled_elements=unsettled, elements=total,
                   loss=[float(m_cuda[0]["loss"]), float(m_cpu[0]["loss"])])
        for k in ("grads", "params"):  # the five worst leaves of each
            row[k] = dict(sorted(row[k].items(), key=lambda kv: -kv[1])[:5])
        rows[name] = row
        check(worst["metrics"] <= WHOLE_STEP_TOL and worst["params"] <= WHOLE_STEP_TOL
              and worst["grads"] <= WHOLE_STEP_GRAD_TOL,
              f"train_reference whole step ({name}): card against CPU {row}")
        del trainers, src, dst
        torch.cuda.empty_cache()
    return rows


def phase_train_reference():
    """The small model's generator backward and update: card (kernels, with and
    without gradient checkpointing) against the CPU (plain versions), f32; its
    programs B-R "1st" and "2nd", and its program G, on the card against the CPU."""
    import torch
    from triplaneturbo_torch.data.multiview_multiprompt import MultiviewMultipromptDataModule
    from triplaneturbo_torch.models.background.hashgrid_env_map import (
        HashgridBackgroundConfig,
        HyperNetConfig,
    )
    from triplaneturbo_torch.models.renderers.patch_renderer import PatchRendererConfig
    from triplaneturbo_torch.models.renderers.rasterize_renderer import RasterizeRendererConfig
    from triplaneturbo_torch.models.renderers.volume_renderer import VolumeRendererConfig
    from triplaneturbo_torch.ops import field_grid as fg
    from triplaneturbo_torch.ops import flash_attention as fa
    from triplaneturbo_torch.systems.trainer import LossConfig, TrainerConfig, TriplaneTurboTrainer

    def build(device, checkpoint):
        # every second-branch regularizer on, so that B-R "2nd" differentiates them all
        loss = LossConfig(lambda_sparsity_2nd=0.3, lambda_opaque_2nd=0.2,
                          lambda_z_variance_2nd=0.5, lambda_eikonal_2nd=0.1,
                          lambda_orient_2nd=2.0, lambda_sdf_abs=0.4)
        return TriplaneTurboTrainer.build(
            TrainerConfig(loss=loss), seed=0, device=device,
            space_generator_overrides=dict(SMALL_SG, gradient_checkpoint=checkpoint),
            background_cfg=HashgridBackgroundConfig(
                hypernet=HyperNetConfig(c_dim=SMALL_SG["cross_attention_dim"])),
            renderer_cfg=RasterizeRendererConfig(**SMALL_RENDER),
            volume_cfg=VolumeRendererConfig(**SMALL_VOLUME),
            patch_cfg=PatchRendererConfig(**SMALL_PATCH))

    trainers = {"cpu": build("cpu", False), "cuda": build("cuda", False),
                "cuda_checkpoint": build("cuda", True)}
    # adapter ``up`` leaves start at zero; make them nonzero so that every adapter leaf
    # gets a gradient, then give all three trainers the same weights
    gen = torch.Generator().manual_seed(2)
    with torch.no_grad():
        for n, p in trainers["cpu"].geometry.named_parameters():
            if n.endswith(".up") or ".up." in n:
                p.copy_(torch.randn(p.shape, generator=gen) * 0.05)
    for name in ("cuda", "cuda_checkpoint"):
        trainers[name].geometry.load_state_dict(trainers["cpu"].geometry.state_dict())
        trainers[name].background.load_state_dict(trainers["cpu"].background.state_dict())

    # program B-R "1st" from the same space cache, before any update
    batch, cache, text_global, grad_images = _small_render_inputs(gen)
    scalars = trainers["cpu"].host_scalars()
    br, renders, launches_br = {}, {}, {}
    for name in ("cpu", "cuda"):
        tr = trainers[name]
        dev = tr.schedule.betas.device
        b = MultiviewMultipromptDataModule.to_device(batch, dev)
        te = {"global_21": text_global.to(dev)}
        fg.LAUNCHES = 0
        with torch.no_grad():
            renders[name], _ = tr._render_branch(b, cache.to(dev), scalars, te["global_21"], "1st")
        br[name] = tr._stage_student_render(b, cache.to(dev), te, scalars,
                                            {k: v.to(dev) for k, v in grad_images.items()})
        if dev.type == "cuda":
            torch.cuda.synchronize()
        launches_br[name] = fg.LAUNCHES
    check(launches_br == {"cpu": 0, "cuda": 4},
          f"train_reference: field-grid launches in R and B-R {launches_br}, expected 0 and 4")
    topology = all(torch.equal(a.t_pos_idx.cpu(), b.t_pos_idx) and torch.equal(a.t_mask.cpu(), b.t_mask)
                   for a, b in zip(renders["cuda"]["mesh"], renders["cpu"]["mesh"]))
    check(topology, "train_reference: the card's and the CPU's meshes differ in their faces")
    br_row = {"images": {}, "grads": {}}
    for k in ("comp_rgb", "comp_normal_cam_vis", "disparity", "opacity", "depth"):
        br_row["images"][k] = _rel(renders["cuda"][k], renders["cpu"][k], k)
    (g_cuda, gs_cuda, regu_cuda), (g_cpu, gs_cpu, regu_cpu) = br["cuda"], br["cpu"]
    check(bool(gs_cpu.any()), "train_reference: zero CPU space-cache cotangent from B-R")
    br_row["g_space_1st"] = _rel(gs_cuda, gs_cpu, "g_space_1st")
    for n, ref in g_cpu.items():
        if n.startswith(("field.", "background.")):
            check(bool(ref.any()), f"train_reference: zero CPU B-R gradient for {n}")
            br_row["grads"][n] = _rel(g_cuda[n], ref, n)
        else:
            check(not bool(g_cuda[n].any()), f"train_reference: B-R reached {n}")
    worst_br = max([br_row["g_space_1st"], *br_row["images"].values(), *br_row["grads"].values()])
    check(worst_br <= SMALL_REL_TOL, f"train_reference: B-R card against CPU rel err {worst_br}: "
          f"{br_row}")
    br_row["faces"] = [int(m.t_mask.sum()) for m in renders["cpu"]["mesh"]]
    del br, renders

    # program B-R "2nd" from the same space cache, cotangents and draws. The CPU renders
    # at the card's sample boundaries and downsampled rays, which are held on their own:
    # see _volume_against_cpu
    draws = trainers["cpu"].draw_volume(MultiviewMultipromptDataModule.to_device(batch, "cpu"),
                                        torch.Generator().manual_seed(5))

    def run_br2(name, perturb=0.0):
        tr = trainers[name]
        dev = tr.schedule.betas.device
        b = MultiviewMultipromptDataModule.to_device(batch, dev)
        if perturb:
            noise = torch.randn(b["rays_d"].shape, generator=torch.Generator().manual_seed(6))
            b["rays_d"] = b["rays_d"] * (1 + perturb * noise.to(dev))
        te = {"global_21": text_global.to(dev)}
        d = _draws_to(draws, dev)
        with torch.no_grad():
            _, render = tr._render_branch(b, cache.to(dev), scalars, te["global_21"], "2nd", d)
        out = tr._stage_student_render(b, cache.to(dev), te, scalars,
                                       {k: v.to(dev) for k, v in grad_images.items()},
                                       branch="2nd", draws=d)
        return render, out

    fa.LAUNCHES = fa.LAUNCHES_STATS = fa.LAUNCHES_BWD_DQ = fa.LAUNCHES_BWD_DKDV = 0
    fg.LAUNCHES = 0
    (render_cuda, br2_cuda), (render_cpu, br2_cpu), sampler = _volume_against_cpu(
        lambda: run_br2("cuda"), lambda: run_br2("cpu"))
    # the volume branch runs plain PyTorch only: gathers, MLPs, cumulative products
    launches_br2 = fa.LAUNCHES + fa.LAUNCHES_STATS + fg.LAUNCHES
    check(launches_br2 == 0, f"train_reference: {launches_br2} kernel launches in R and B-R 2nd")
    br2_row = {"inputs": sampler, "images": {}, "grads": {}}
    for k in ("comp_rgb", "comp_normal_cam_vis", "disparity", "opacity", "depth"):
        br2_row["images"][k] = _rel(render_cuda[k], render_cpu[k], k)
    (g_cuda, gs_cuda, regu_cuda), (g_cpu, gs_cpu, regu_cpu) = br2_cuda, br2_cpu
    check(bool(gs_cpu.any()), "train_reference: zero CPU space-cache cotangent from B-R 2nd")
    br2_row["g_space_2nd"] = _rel(gs_cuda, gs_cpu, "g_space_2nd")
    br2_row["regu"] = [float(regu_cuda), float(regu_cpu)]
    br2_row["regu_rel_err"] = abs(float(regu_cuda) - float(regu_cpu)) / abs(float(regu_cpu))
    for n, ref in g_cpu.items():
        if n.startswith(("field.", "background.", "renderer.")) and "deformation" not in n:
            check(bool(ref.any()), f"train_reference: zero CPU B-R 2nd gradient for {n}")
            br2_row["grads"][n] = _rel(g_cuda[n], ref, n)
        else:
            check(not bool(g_cuda[n].any()), f"train_reference: B-R 2nd reached {n}")
    worst_br2 = max([br2_row["g_space_2nd"], br2_row["regu_rel_err"],
                     *br2_row["images"].values(), *br2_row["grads"].values()])
    check(worst_br2 <= SMALL_REL_TOL, f"train_reference: B-R 2nd card against CPU rel err "
          f"{worst_br2}: {br2_row}")
    br2_row["opacity_range"] = [float(render_cpu["opacity"].min()),
                                float(render_cpu["opacity"].max())]
    # why the inputs are replayed: the outputs and gradients on the card with the ray
    # directions moved by 3e-7 of themselves (samples drawn anew), against the above
    render_p, (g_p, gs_p, _) = run_br2("cuda", perturb=3e-7)
    br2_row["rays_moved_3e-7_on_the_card_rel_err"] = max(
        [_rel(gs_p, gs_cuda, "g_space_2nd"), *[_rel(render_p[k], render_cuda[k], k)
                                               for k in br2_row["images"]],
         *[_rel(g_p[n], g_cuda[n], n) for n in br2_row["grads"]]])
    del br2_cuda, br2_cpu, render_cuda, render_cpu, render_p, g_p, gs_p

    r = SMALL_KW["latent_resolution"]
    latent = torch.randn((2, 6, r, r, 4), generator=gen)
    noise = torch.randn((2, 6, r, r, 4), generator=gen)
    text = torch.randn((2, 77, SMALL_SG["cross_attention_dim"]), generator=gen)
    plane = r * 2 ** (len(SMALL_SG["vae_block_out_channels"]) - 1)
    g1 = torch.randn((2, 6, plane, plane, SMALL_SG["output_dim"] // 2), generator=gen) * 0.1
    g2 = torch.randn(g1.shape, generator=gen) * 0.1
    t = 499

    grads, params, launches = {}, {}, {}
    for name, tr in trainers.items():
        dev = tr.schedule.betas.device
        fa.LAUNCHES = fa.LAUNCHES_STATS = fa.LAUNCHES_BWD_DQ = fa.LAUNCHES_BWD_DKDV = 0
        fg.LAUNCHES = 0
        g = tr._stage_student_space(latent.to(dev), t, {"cond_local": text.to(dev)},
                                    g1.to(dev), g2.to(dev), noise.to(dev))
        check(tr._stage_update({n: x * tr.cfg.num_parts_training for n, x in g.items()}),
              f"train_reference: the update on {name} was skipped")
        if dev.type == "cuda":
            torch.cuda.synchronize()
        launches[name] = {"flash_attn_fwd": fa.LAUNCHES, "flash_attn_fwd_stats": fa.LAUNCHES_STATS,
                          "flash_attn_bwd_dq": fa.LAUNCHES_BWD_DQ,
                          "flash_attn_bwd_dkdv": fa.LAUNCHES_BWD_DKDV}
        grads[name] = {n: x.float().cpu() for n, x in g.items()}
        params[name] = {n: p.detach().float().cpu() for n, p in tr.params_train.items()}
    check(not any(launches["cpu"].values()), "train_reference: a kernel launched on the CPU")
    n_sites = launches["cuda"]["flash_attn_fwd_stats"]
    check(n_sites > 0 and launches["cuda"] == {
        "flash_attn_fwd": 0, "flash_attn_fwd_stats": n_sites, "flash_attn_bwd_dq": n_sites,
        "flash_attn_bwd_dkdv": n_sites}, f"train_reference: launches {launches['cuda']}")
    # checkpointed: every block runs its forward twice with grad enabled (the first pass
    # drops what it saves, the backward recomputes it), and the VAE decodes plane by
    # plane (6 attention calls in place of 1)
    check(launches["cuda_checkpoint"] == {
        "flash_attn_fwd": 0, "flash_attn_fwd_stats": 2 * (n_sites + 5),
        "flash_attn_bwd_dq": n_sites + 5, "flash_attn_bwd_dkdv": n_sites + 5},
        f"train_reference: checkpointed launches {launches['cuda_checkpoint']}, plain {n_sites}")

    teacher_rows = _small_program_g()
    step_rows = _small_train_step()
    row = {"phase": "train_reference", "what": "small model, program B-R \"1st\" (R=16, 2x2 "
           "views at 64²), program B-R \"2nd\" (16² rays: 5² global, 8² patch, 32 + 32 "
           "samples), program G (2 prompts x 4 views, 64² and 32² images, teachers of 64 and "
           "128 channels, head dim 64, encoders to 64 channels), program B-G + guarded Adan "
           "update, and one whole train_step (2 parts, staged and monolithic), card (kernels) "
           "vs CPU (plain), f32",
           "rel_tol": SMALL_REL_TOL, "teacher": teacher_rows, "train_step": step_rows,
           "render_backward_1st": br_row,
           "render_backward_1st_worst_rel_err": worst_br, "render_backward_2nd": br2_row,
           "render_backward_2nd_worst_rel_err": worst_br2, "launches": launches,
           "leaves": len(grads["cpu"])}
    lr = trainers["cpu"].cfg.learning_rate
    for name in ("cuda", "cuda_checkpoint"):
        worst_g = worst_p = 0.0
        skipped = total = 0
        for n, ref in grads["cpu"].items():
            got = grads[name][n]
            check(bool(torch.isfinite(got).all()), f"train_reference: non-finite gradient {n}")
            scale = ref.abs().max().clamp_min(1e-12)
            if n.startswith(("field.", "background.", "renderer.")):
                check(not bool(got.any()) and not bool(ref.any()),
                      f"train_reference: the generator backward reached {n}")
                continue
            check(bool(ref.any()), f"train_reference: zero CPU gradient for {n}")
            rel = ((got - ref).abs().max() / scale).item()
            worst_g = max(worst_g, rel)
            check(rel <= SMALL_REL_TOL, f"train_reference {name}: gradient {n} rel err {rel}")
            # Adan's first step moves every element by lr * sign(g): where the gradient is at
            # rounding level its sign is noise, so hold the elements with a settled gradient
            settled = ref.abs() > 1e-3 * scale
            total += ref.numel()
            skipped += int((~settled).sum())
            p_ref, p_got = params["cpu"][n], params[name][n]
            rel = ((p_got - p_ref).abs()[settled].max() / p_ref.abs().max().clamp_min(lr)).item()
            worst_p = max(worst_p, rel)
            check(rel <= SMALL_REL_TOL, f"train_reference {name}: parameter {n} rel err {rel}")
        row[f"{name}_grad_rel_err"] = worst_g
        row[f"{name}_param_rel_err"] = worst_p
        row[f"{name}_unsettled_elements"] = skipped
        row["elements"] = total
    emit(row)
    del trainers
    torch.cuda.empty_cache()


def phase_guidance(trainer, batch, images, text, scalars, gen):
    """CUDA-event ms of one full-width part's program G (``_stage_teacher`` on the last
    part's images) and of its pieces at the part's shapes: each teacher's UNet passes
    (no grad), the MV and SD VAE encoders' forward (with grad) and forward + backward,
    and RichDreamer's einsum attention alone (its every site, recorded from one RD pass);
    the peak memory of an RD pass above its start."""
    import torch
    from triplaneturbo_torch.models import attention as attention_module
    from triplaneturbo_torch.ops import flash_attention as fa

    g = trainer.guidance
    gcfg = g.cfg
    parallel = trainer.cfg.parallel_guidance
    calls = 1 if parallel else 2
    views = batch["c2w"].shape[0] * (2 if parallel else 1)  # images a teacher call
    draws = trainer.draw_guidance(batch, gen)
    whole_ms = cuda_ms(lambda: trainer._stage_teacher(images, batch, text, scalars, draws), 2,
                       warmup=1)

    def randn(*shape):
        return torch.randn(shape, generator=gen, device="cuda")

    def unet_passes(kind, n, hw):
        bundle = getattr(g, kind)
        ucfg = bundle.unet.cfg
        x, ctx = randn(3 * n, hw, hw, 4), randn(3 * n, 77, ucfg.cross_attention_dim)
        ts = torch.randint(20, 980, (3 * n,), generator=gen, device="cuda")
        cam = randn(3 * n, ucfg.camera_dim) if ucfg.camera_dim else None

        def run():
            with torch.no_grad():
                for _ in range(calls):
                    bundle.unet(x, ts, ctx, cam)
        return run

    def encoder(kind, n, size):
        vae = getattr(g, kind).vae
        f = 2 ** (len(vae.cfg.block_out_channels) - 1)
        x = randn(n, size, size, 3).requires_grad_()
        eps, gy = randn(n, size // f, size // f, 4), randn(n, size // f, size // f, 4)

        def fwd():
            with torch.enable_grad():
                for _ in range(calls):
                    vae.encode(x, eps)

        def fwd_bwd():
            for _ in range(calls):
                with torch.enable_grad():
                    torch.autograd.grad(vae.encode(x, eps), x, gy)
        return fwd, fwd_bwd

    prompts = batch["c2w"].shape[0] // gcfg.n_view * (2 if parallel else 1)
    passes = {"mv": unet_passes("mv", views, g._latent_hw("mv")),
              "rd": unet_passes("rd", views, g._latent_hw("rd")),
              "sd": unet_passes("sd", prompts, g._latent_hw("sd"))}
    unet_ms = {k: cuda_ms(fn, 3, warmup=1) for k, fn in passes.items()}
    enc = {"mv": encoder("mv", views, gcfg.mv_image_size),
           "sd": encoder("sd", prompts, gcfg.sd_image_size)}
    enc_ms = {k: {"forward_ms": cuda_ms(f, 3, warmup=1), "forward_backward_ms": cuda_ms(fb, 3,
                                                                                      warmup=1)}
              for k, (f, fb) in enc.items()}

    # RichDreamer's attention: every site's shapes from one pass, then the einsum path alone
    sites, dispatch = [], attention_module.attention_dispatch

    def recording(q, k, v):
        sites.append((tuple(q.shape), tuple(k.shape)))
        return dispatch(q, k, v)

    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    attention_module.attention_dispatch = recording
    try:
        passes["rd"]()
    finally:
        attention_module.attention_dispatch = dispatch
    torch.cuda.synchronize()
    rd_peak = torch.cuda.max_memory_allocated() - base
    dtype = g.rd.unet.cfg.dtype
    tensors = [(randn(*qs).to(dtype), randn(*ks).to(dtype), randn(*ks).to(dtype))
               for qs, ks in sites[:len(sites) // calls]]

    def rd_attention():
        with torch.no_grad():
            for _ in range(calls):
                for q, k, v in tensors:
                    fa.attention(q, k, v)

    launches = fa.LAUNCHES
    rd_attention_ms = cuda_ms(rd_attention, 2, warmup=1)
    check(fa.LAUNCHES == launches, "guidance: RichDreamer's attention launched a kernel")
    pieces = sum(unet_ms.values()) + sum(e["forward_backward_ms"] for e in enc_ms.values())
    row = {"phase": "guidance", "what": "one full-width part's program G: 2 prompts x 4 views, "
           f"the renderers {'stacked' if parallel else 'one after the other'} ({calls} call(s) "
           f"a teacher); MV {views} images at {gcfg.mv_image_size}², RD at "
           f"{gcfg.rd_image_size}², SD {prompts} at {gcfg.sd_image_size}²",
           "program_g_ms": whole_ms, "unet_no_grad_ms": unet_ms, "encoder_ms": enc_ms,
           "rd_einsum_attention_ms": rd_attention_ms,
           "rd_attention_sites": [list(x) for x in sites[:len(sites) // calls]],
           "rd_pass_peak_above_start_bytes": rd_peak,
           "rest_ms": whole_ms - pieces}
    emit(row)
    return row


def phase_rasterize(trainer, batch, space_cache):
    """CUDA-event ms of one 512² view of the full-width mesh (item 0, view 0): the
    whole rasterizer without grad, the select pass (culling, binning and winners) and
    the binning alone, and the differentiable recompute's forward and backward."""
    import torch
    from triplaneturbo_torch.ops import rasterize as rz

    cfg = trainer.rasterize_renderer.cfg
    geo = trainer.geometry
    with torch.no_grad():
        mesh = trainer.rasterize_renderer.isosurface(space_cache[:1], geo.forward_field,
                                                     forward_field_grid=geo.forward_field_grid)[0]
        vh = torch.cat([mesh.v_pos, torch.ones_like(mesh.v_pos[:, :1])], dim=-1)
        v_clip = vh @ batch["mvp_mtx"][0].T
    H = batch["rays_d_rasterize"].shape[1]
    kw = dict(tile=cfg.tile, faces_per_tile=cfg.faces_per_tile, max_span=cfg.max_span)
    tri = rz._screen(v_clip, mesh.t_pos_idx, H, H)
    won = rz._winners(*tri, mesh.t_mask, H, H, cfg.tile, cfg.faces_per_tile, cfg.max_span, 128, 0)
    fid, hit, n_span, n_list = won
    vc = v_clip.detach().requires_grad_()

    def recompute():
        out = rz._recompute(*rz._screen(vc, mesh.t_pos_idx, H, H), *won)
        torch.autograd.grad(out.bary.sum() + out.edge_dist.sum() + out.depth[out.mask].sum(), vc)

    def binning():
        valid = mesh.t_mask & (tri[2] > 0).all(-1)
        rz._bin_faces(tri[0], valid, H, H, cfg.tile, cfg.faces_per_tile, cfg.max_span)

    with torch.no_grad():
        whole_ms = cuda_ms(lambda: rz.rasterize(v_clip, mesh.t_pos_idx, mesh.t_mask, H, H, **kw), 5)
        select_ms = cuda_ms(lambda: rz._winners(*tri, mesh.t_mask, H, H, cfg.tile,
                                                cfg.faces_per_tile, cfg.max_span, 128, 0), 5)
        bin_ms = cuda_ms(binning, 5)
    recompute_ms = cuda_ms(recompute, 5)
    row = {"phase": "rasterize", "what": "one 512² view of the full-width mesh (item 0, view 0)",
           "H": H, "tile": cfg.tile, "faces_per_tile": cfg.faces_per_tile,
           "max_span": cfg.max_span, "faces": int(mesh.t_mask.sum()),
           "covered_pixels": int(hit.sum()), "n_span_overflow": int(n_span),
           "n_list_overflow": int(n_list), "rasterize_no_grad_ms": whole_ms,
           "select_pass_ms": select_ms, "of_which_binning_ms": bin_ms,
           "recompute_fwd_bwd_ms": recompute_ms}
    emit(row)
    return row


def _count_launches():
    """(reset, read) of the five kernels' launch counts."""
    from triplaneturbo_torch.ops import field_grid as fg
    from triplaneturbo_torch.ops import flash_attention as fa

    def reset():
        fa.LAUNCHES = fa.LAUNCHES_STATS = fa.LAUNCHES_BWD_DQ = fa.LAUNCHES_BWD_DKDV = 0
        fg.LAUNCHES = 0

    def read():
        return {"flash_attn_fwd": fa.LAUNCHES, "flash_attn_fwd_stats": fa.LAUNCHES_STATS,
                "flash_attn_bwd_dq": fa.LAUNCHES_BWD_DQ, "flash_attn_bwd_dkdv": fa.LAUNCHES_BWD_DKDV,
                "field_grid": fg.LAUNCHES}
    return reset, read


def phase_training():
    """The v1 recipe at full width through the port's launcher: ``launch.main`` with
    ``configs/triplaneturbo_v1.yaml`` for TRAIN_STEPS steps of ``train_step`` (staged,
    gradient checkpointing on), every step's launch counts and host ms read around it;
    the metrics log and the checkpoint; one profiled part; the guidance, rasterize and
    volume lines on the returned trainer; one validation prompt's turntable."""
    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity
    from torch.profiler import profile as profiler
    from triplaneturbo_torch import launch
    from triplaneturbo_torch.data.multiview_multiprompt import (
        DataModuleConfig,
        MultiviewMultipromptDataModule,
    )
    from triplaneturbo_torch.systems import prompt_setup
    from triplaneturbo_torch.systems.trainer import TriplaneTurboTrainer
    from triplaneturbo_torch.utils.config import load_config, parse_structured

    reset_counts, read_counts = _count_launches()
    tmp = tempfile.TemporaryDirectory()
    steps, seen = [], {}
    step_fn, setup_fn = TriplaneTurboTrainer.train_step, prompt_setup.build_prompt_setup

    def counted_step(trainer, batch_list, text_embeds, generator=None, draws=None):
        if not steps:  # kept on the host, so that the copy does not count in the peak
            seen["before"] = {n: p.detach().cpu().clone() for n, p in _named_params(trainer)}
        torch.cuda.synchronize()
        reset_counts()
        t = time.perf_counter()
        metrics = step_fn(trainer, batch_list, text_embeds, generator, draws)
        torch.cuda.synchronize()
        steps.append({"ms": (time.perf_counter() - t) * 1e3, "launches": read_counts(),
                      "loss": float(metrics["loss"])})
        seen.update(batch_list=batch_list, text=text_embeds, generator=generator)
        if trainer.global_step == TRAIN_CKPT_STEP:
            seen["ckpt_params"] = {n: p.detach().cpu().clone()
                                   for n, p in trainer.params_train.items()}
        return metrics

    def capturing_setup(*args, **kwargs):
        out = setup_fn(*args, **kwargs)
        seen["embeds_for"] = out[1]
        return out

    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    TriplaneTurboTrainer.train_step, prompt_setup.build_prompt_setup = counted_step, capturing_setup
    t0 = time.perf_counter()
    try:
        trainer = launch.main(["--config", str(REPO / TRAIN_CONFIG), "--train", "--max-steps",
                               str(TRAIN_STEPS), *TRAIN_OVERRIDES, f"exp_root_dir={tmp.name}"])
    finally:
        TriplaneTurboTrainer.train_step, prompt_setup.build_prompt_setup = step_fn, setup_fn
    torch.cuda.synchronize()
    launcher_s = time.perf_counter() - t0
    peak_bytes = torch.cuda.max_memory_allocated()
    cfg = trainer.cfg
    n = cfg.num_parts_training
    expected = {k: v * n for k, v in LAUNCHES_PER_PART.items()}

    # what the recipe asks for, read back from the trainer the launcher built
    geo_cfg = trainer.geometry.cfg.space_generator
    check(cfg.auto_grad and geo_cfg.gradient_checkpoint and geo_cfg.dtype_str == "bfloat16"
          and trainer.volume_renderer.cfg.field_chunk == FIELD_CHUNK
          and not trainer.volume_renderer.cfg.trainable_variance,
          f"training: the launcher's trainer is not the v1 recipe: {cfg}, {geo_cfg}")
    g = trainer.guidance
    teacher_params = {kind: sum(p.numel() for m in getattr(g, kind) if m is not None
                                for p in m.parameters()) for kind in ("mv", "rd", "sd")}
    for kind in ("mv", "rd", "sd"):
        for m in getattr(g, kind):
            if m is not None:
                check(all(p.dtype == torch.bfloat16 and not p.requires_grad
                          for p in m.parameters()), f"training: the {kind} teacher is not "
                      "frozen in bf16")
    # every step through train_step, with every kernel's launches
    check(len(steps) == TRAIN_STEPS and trainer.global_step == TRAIN_STEPS,
          f"training: {len(steps)} steps, global_step {trainer.global_step}")
    for i, st in enumerate(steps):
        check(st["launches"] == expected, f"training step {i}: launches {st['launches']}, "
              f"expected {expected}")
    totals = {k: sum(st["launches"][k] for st in steps) for k in expected}
    # the metrics log: a line a step with finite scalars
    trial = Path(glob_one(tmp.name, "*", "*", "metrics.jsonl")).parent
    with open(trial / "metrics.jsonl") as fh:
        logged = [json.loads(ln) for ln in fh]
    series = ["loss", "fidelity", "regularization", "grad_norm", "skipped_nonfinite"] + [
        f"{k}_{i}" for k in ("fidelity", "regularization", "grad_norm") for i in range(n)]
    check([ln["step"] for ln in logged] == list(range(TRAIN_STEPS))
          and all(math.isfinite(ln[k]) for ln in logged for k in series),
          f"training: metrics.jsonl {logged}")
    # the checkpoint at step 2 loads back bit-equal to the partition it was saved from
    state = torch.load(trial / f"ckpt_{TRAIN_CKPT_STEP:06d}" / "train_state.pt",
                       map_location="cpu", weights_only=True)
    saved = seen.pop("ckpt_params")
    check(state["global_step"] == TRAIN_CKPT_STEP and set(state["params_train"]) == set(saved)
          and all(torch.equal(state["params_train"][k], v) for k, v in saved.items()),
          "training: the step-2 checkpoint differs from the partition it was saved from")
    check((trial / f"ckpt_{TRAIN_CKPT_STEP:06d}" / "geometry.pt").stat().st_size > 0
          and (trial / "last" / "geometry.pt").exists()
          and (trial / "configs" / "parsed.yaml").exists(), "training: trial files missing")
    del state, saved

    check(trainer.optimizer.total_notfinite == 0, "training: a gradient batch was not finite")
    before = seen.pop("before")
    changed = {n_ for n_, p in _named_params(trainer) if not torch.equal(p.detach().cpu(),
                                                                       before[n_])}
    del before
    check(changed <= set(trainer.trainable), "training: a frozen leaf changed: "
          f"{sorted(changed - set(trainer.trainable))[:5]}")
    ups = [n_ for n_ in trainer.trainable if n_.endswith(".up") or n_.endswith(".up.weight")]
    check(len(ups) > 100 and all(n_ in changed for n_ in ups),
          f"training: adapter up leaves unchanged: {[n_ for n_ in ups if n_ not in changed][:5]}")
    bg = [n_ for n_ in trainer.trainable if n_.startswith("background.")]
    check(len(bg) == 6 and all(n_ in changed for n_ in bg),
          f"training: background leaves unchanged: {[n_ for n_ in bg if n_ not in changed]}")
    fields = [n_ for n_ in trainer.trainable if n_.startswith("field.")]
    check(all(n_ in changed for n_ in fields),
          f"training: field leaves unchanged: {[n_ for n_ in fields if n_ not in changed]}")
    # trainable_variance: false detaches the variance in the render: a zero gradient, no move
    check("renderer.variance_inv_std" in trainer.trainable
          and "renderer.variance_inv_std" not in changed,
          "training: the untrained variance_inv_std changed")
    for n_, p in trainer.params_train.items():
        check(bool(torch.isfinite(p).all()), f"training: non-finite parameter {n_}")

    # one part through the trainer's staged loop (and the update) under the profiler:
    # device-busy ms by program, and the heaviest device ops
    text = seen["text"]
    gen = seen["generator"]
    batch_list = seen["batch_list"]
    batch = MultiviewMultipromptDataModule.to_device(
        {k: v for k, v in batch_list[0].items() if k != "noise"}, "cuda")
    latent = torch.from_numpy(batch_list[0]["noise"]).to("cuda")
    scalars = trainer.host_scalars()
    draws = trainer.draw_part(batch, latent.shape, gen)
    with profiler(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        trainer._train_step_staged([batch], [999], latent, text, scalars, [draws])
        torch.cuda.synchronize()
    busy_ms, stage_busy_ms, spanned, top = _profile_split(prof, TRAIN_STAGES, top=12)
    check(busy_ms > 0, "the profiler recorded no device time in the training part")
    check(spanned == sorted(TRAIN_STAGES), f"training stages with a device span: {spanned}")
    stage_share = sum(stage_busy_ms.values()) / busy_ms
    kernel_busy_ms = {name: sum(e.self_device_time_total for e in prof.key_averages()
                                if symbol in e.key) / 1e3
                      for name, symbol in (("flash_attn_fwd(+stats)", "flash_fwd_kernel"),
                                           ("flash_attn_bwd_dq", "flash_bwd_dq_kernel"),
                                           ("flash_attn_bwd_dkdv", "flash_bwd_dkdv_kernel"),
                                           ("field_grid", "field_grid_kernel"))}
    del prof
    step_ms = [st["ms"] for st in steps]
    timed_steps = step_ms[1:]
    median_step = sorted(timed_steps)[len(timed_steps) // 2]

    # the inputs of the guidance, rasterize and volume lines: one part's programs R and G
    _, space_cache, images, _ = trainer._stage_render(batch, latent, 999, text, scalars,
                                                      draws.noise, draws.volume)
    _, grad_images = trainer._stage_teacher(images, batch, text, scalars, draws.guidance)
    image_stats = {k: {"min": float(v.min()), "max": float(v.max()),
                       "mean": float(v.float().mean())} for k, v in images.items()}

    # what --validate costs a prompt: one validation prompt's turntable at full width
    data = MultiviewMultipromptDataModule(parse_structured(
        DataModuleConfig, load_config(str(REPO / TRAIN_CONFIG)).get("data", {})), seed=0)
    prompt = data.library["val"][0]
    vbatch = data.eval_views(prompt, split="val")
    vtext = seen["embeds_for"]([prompt])
    start, mid, end = (torch.cuda.Event(enable_timing=True) for _ in range(3))
    torch.cuda.synchronize()
    t_val = time.perf_counter()
    start.record()
    views = trainer.render_eval_views(vbatch, vtext)
    mid.record()
    paths = trainer.save_eval_artifacts(views, tmp.name, "it3-val-0")
    end.record()
    torch.cuda.synchronize()
    val_host_ms = (time.perf_counter() - t_val) * 1e3
    n_views = vbatch["mvp_mtx"].shape[0]
    check(views["rgb"].shape == (n_views, data.cfg.eval_height, data.cfg.eval_width, 3)
          and all(np.isfinite(v).all() for v in views.values()),
          f"validation: views {({k: v.shape for k, v in views.items()})}")
    check(len(paths) == 2 and all(os.path.getsize(p) > 0 for p in paths),
          f"validation: artifacts {paths}")
    validation = {"prompt": prompt, "views": n_views, "hw": list(views["rgb"].shape[1:3]),
                  "render_eval_views_ms": start.elapsed_time(mid),
                  "save_eval_artifacts_ms": mid.elapsed_time(end), "host_ms": val_host_ms,
                  "turntable_file": os.path.basename(paths[1]),
                  "turntable_bytes": os.path.getsize(paths[1]),
                  "rgb_mean": float(views["rgb"].mean()),
                  "opacity_mean": float(views["opacity"].mean())}
    del views

    emit({"phase": "training", "config": f"{TRAIN_CONFIG} through python3 -m "
          "triplaneturbo_torch.launch --train (launch.main), overrides "
          f"{TRAIN_OVERRIDES}: SD-2.1 student UNet + retrofit VAE (output_dim 64, bf16 frozen "
          "backbone, f32 trainables, gradient checkpointing) + field MLPs + hash-grid "
          "background (c_dim 1024), 2 prompts x 4 views from the port's data module (seed 0), "
          "R=160, 512² renders, 128² volume rays; teachers SD-2.1 base, MVDream 4-view and "
          "RichDreamer 768-d in bf16 on random weights (seed 1), the renderers one after the "
          "other; the dual prompt processor (OpenCLIP-H and SD-1.5 towers, f32)",
          "teacher_params": teacher_params,
          "trainable_leaves": len(trainer.trainable),
          "trainable_params": sum(p.numel() for p in trainer.params_train.values()),
          "launcher_s": launcher_s, "steps": TRAIN_STEPS, "parts_per_step": n,
          "warmup_step_ms": step_ms[0], "step_ms": timed_steps, "step_ms_all": step_ms,
          "step_ms_median": median_step, "loss": [st["loss"] for st in steps],
          "metrics_logged": logged,
          "part_device_busy_ms": busy_ms,
          "part_host_ms_from_step_median": median_step / n,
          "part_device_idle_share": max(0.0, 1.0 - busy_ms * n / median_step),
          "stage_device_busy_ms": stage_busy_ms, "stage_device_busy_share": stage_share,
          "kernel_device_busy_ms": kernel_busy_ms, "top_kernels": top,
          "launches_per_part": LAUNCHES_PER_PART, "launches_per_step": expected,
          "launches": totals, "images_one_part": image_stats,
          "total_notfinite": trainer.optimizer.total_notfinite, "changed_leaves": len(changed),
          "max_memory_allocated_bytes": peak_bytes, "validation": validation})
    check(stage_share >= 0.95, f"the stage ranges hold only {stage_share:.3f} of the device time")
    phase_guidance(trainer, batch, images, text, scalars, gen)
    phase_rasterize(trainer, batch, space_cache)
    phase_volume(trainer, batch, space_cache, text, scalars, gen, grad_images)
    del images, grad_images, space_cache
    # the FLOPs of a v1 step (a fourth step, taken under the count), against the timed
    # steps' median for the flops line
    torch.cuda.synchronize()
    reset_counts()
    t = time.perf_counter()
    count = trainer.step_cost_flops(batch_list, text,
                                    torch.Generator(device="cuda").manual_seed(4))
    torch.cuda.synchronize()
    step_flops = {"count": count, "counted_step_ms": (time.perf_counter() - t) * 1e3,
                  "step_ms_median": median_step, "part_device_busy_ms": busy_ms,
                  "parts": n, "stage_device_busy_ms": stage_busy_ms, "launches": read_counts()}
    check(step_flops["launches"] == expected, f"the counted step's launches "
          f"{step_flops['launches']}, expected {expected}")
    del trainer, seen
    tmp.cleanup()
    torch.cuda.empty_cache()
    return totals, step_flops


def _named_params(trainer):
    """Every parameter the trainer trains or could: the geometry's, the background's and
    the volume renderer's, under the trainable partition's names."""
    yield from trainer.geometry.named_parameters()
    for prefix, module in (("background", trainer.background),
                           ("renderer", trainer.volume_renderer)):
        for n, p in module.named_parameters():
            yield f"{prefix}.{n}", p


def glob_one(*parts) -> str:
    """The one path that matches the glob of ``parts``."""
    import glob

    found = glob.glob(os.path.join(*parts))
    check(len(found) == 1, f"expected one match of {os.path.join(*parts)}: {found}")
    return found[0]


def phase_volume(trainer, batch, space_cache, text, scalars, gen, grad_images):
    """CUDA-event ms of one full-width part's second branch: the proposal pass (both
    base renders' SDF-only density and the sampling), the field with normals at the
    fine samples as program R evaluates it, the whole ``render_2nd`` and
    ``render_backward_2nd`` (with program G's image gradients); then
    ``render_backward_2nd``'s time and peak memory at each ``field_chunk`` of the sweep."""
    from dataclasses import replace

    import torch
    from triplaneturbo_torch.models.renderers import volume_renderer as vr
    from triplaneturbo_torch.models.renderers.patch_renderer import resize
    from triplaneturbo_torch.ops.ray import importance_sampling, neus_density_from_sdf

    vol = trainer.volume_renderer
    cfg, pcfg = vol.cfg, trainer.patch_cfg
    draws = trainer.draw_volume(batch, gen)
    ro, rd = batch["rays_o"], batch["rays_d"]
    B, H, W, _ = ro.shape
    ps, gh = pcfg.patch_size, H // pcfg.global_downsample
    py, px = draws.patch_y, draws.patch_x
    renders = {"global": (resize(ro, gh, gh), resize(rd, gh, gh), draws.jitter_global),
               "patch": (ro[:, py:py + ps, px:px + ps], rd[:, py:py + ps, px:px + ps],
                         draws.jitter_patch)}
    field_fn = trainer._field_fn_2nd(space_cache, B // space_cache.shape[0])
    inv_std = torch.clamp(torch.exp(vol.variance_inv_std.detach() * 10.0), 1e-6, 1e6)
    P, F = cfg.num_samples_per_ray_importance, cfg.num_samples_per_ray

    def proposal():
        out = []
        for ro_, rd_, jitter in renders.values():
            o, d = ro_.reshape(-1, 3), rd_.reshape(-1, 3)

            def density(t0, t1):
                pts = o[:, None] + d[:, None] * ((t0 + t1) * 0.5)[..., None]
                sdf = field_fn(pts.reshape(B, -1, 3), "sdf")["sdf"].reshape(o.shape[0], -1)
                return neus_density_from_sdf(sdf, inv_std, vol.render_step_size)

            t0, t1 = importance_sampling(density, o.shape[0], P, F, cfg.near_plane,
                                         cfg.far_plane, jitter=jitter, device=ro.device)
            out.append(o[:, None] + d[:, None] * ((t0 + t1) * 0.5)[..., None])
        return out

    with torch.no_grad():
        positions = proposal()
        proposal_ms = cuda_ms(proposal, 3, warmup=1)
        field_ms = cuda_ms(lambda: [vr._field_with_normal(field_fn, p.reshape(B, -1, 3),
                                                           cfg.field_chunk, ())
                                    for p in positions], 3, warmup=1)
        render_ms = cuda_ms(lambda: trainer._render_branch(
            batch, space_cache, scalars, text["global_21"], "2nd", draws), 3, warmup=1)
    n_rays = {k: int(p.shape[0]) for k, p in zip(renders, positions)}
    intervals = int(positions[0].shape[1])
    def backward():
        return trainer._stage_student_render(batch, space_cache, text, scalars, grad_images,
                                             branch="2nd", draws=draws)

    sweep = []
    chosen = cfg.field_chunk
    try:
        for chunk in FIELD_CHUNK_SWEEP:
            trainer.volume_renderer.cfg = replace(cfg, field_chunk=chunk)
            torch.cuda.synchronize()
            base = torch.cuda.memory_allocated()
            torch.cuda.reset_peak_memory_stats()
            backward()
            torch.cuda.synchronize()
            peak = torch.cuda.max_memory_allocated()
            sweep.append({"field_chunk": chunk, "points_a_chunk": chunk * B,
                          "render_backward_2nd_ms": cuda_ms(backward, 2, warmup=0),
                          "peak_bytes": peak, "peak_above_start_bytes": peak - base})
    finally:
        trainer.volume_renderer.cfg = cfg
    row = {"phase": "volume", "what": "one full-width part's second branch: 2 prompts x 4 "
           f"views, {H}² rays, a {gh}² global render and one {ps}² patch, {P} proposal and "
           f"{F} fine samples a ray, field_chunk {chosen}",
           "rays": n_rays, "intervals_a_ray": intervals,
           "proposal_points": sum(n * P for n in n_rays.values()),
           "field_points_with_normals": sum(n * intervals for n in n_rays.values()),
           "proposal_ms": proposal_ms, "field_with_normals_no_grad_ms": field_ms,
           "render_2nd_ms": render_ms,
           "render_backward_2nd_ms": [r for r in sweep if r["field_chunk"] == chosen][0][
               "render_backward_2nd_ms"],
           "render_backward_2nd_peak_bytes": [r for r in sweep if r["field_chunk"] == chosen][0][
               "peak_bytes"],
           "field_chunk_sweep": sweep}
    emit(row)
    return row


# The launcher phase: configs/smoke_tiny.yaml widened to the small kernel-taking model of
# the reference phases (head dim 64, 64-channel planes; teachers of 64 and 128 channels,
# VAE encoders to 64), 2 parts of 2 prompts x 4 views at 64², 32² rays, a library of two
# prompts a split.
SMALL_LIBRARY = {"train": ["a red chair", "a blue teapot"],
                 "val": ["a green frog", "a white boat"],
                 "test": ["a ceramic lion", "a wooden crate"]}


def _small_launcher_overrides():
    sg = {k: list(v) if isinstance(v, tuple) else v for k, v in SMALL_SG.items()}
    teachers = {kind: {k: list(v) if isinstance(v, tuple) else v for k, v in d.items()}
                for kind, d in SMALL_TEACHERS.items()}
    out = {"data.batch_size": 8, "data.n_view": 4, "data.height": 64, "data.width": 64,
           "data.ray_height": 32, "data.ray_width": 32,
           "data.dim_gaussian": [6, 4, SMALL_KW["latent_resolution"], SMALL_KW["latent_resolution"]],
           "system.background.c_dim": SMALL_SG["cross_attention_dim"],
           "system.renderer": SMALL_RENDER, "system.renderer_2nd": SMALL_VOLUME,
           "system.patch": SMALL_PATCH, "system.guidance": SMALL_GUIDANCE,
           "system.teacher_sizes": teachers, "system.num_parts_training": 2,
           "system.num_steps_training": 2, "data.n_steps": 2, "trainer.checkpoint_every": 2,
           "trainer.val_check_interval": 0}
    out.update({f"system.geometry.space_generator_config.{k}": v for k, v in sg.items()})
    return [f"{k}={json.dumps(v)}" for k, v in out.items()]


def phase_launcher():
    """``python3 -m triplaneturbo_torch.launch`` (through ``main``) on the card at the small
    kernel-taking width: --train for 2 steps, --resume from its checkpoint for one more
    (the restored state held bit-equal to the saved one), --validate (4 views) with the
    trained geometry through ``system.weights``, --export from the step-2 checkpoint
    through --resume."""
    import torch
    from triplaneturbo_torch import launch
    from triplaneturbo_torch.utils import checkpoint

    reset_counts, read_counts = _count_launches()
    tmp = tempfile.TemporaryDirectory()
    lib = Path(tmp.name) / "lib"
    lib.mkdir()
    (lib / "small.json").write_text(json.dumps(SMALL_LIBRARY))
    trial = Path(tmp.name) / "trial"
    base = ["--config", str(REPO / "configs" / "smoke_tiny.yaml"), *_small_launcher_overrides(),
            f"trial_dir={trial}", f"exp_root_dir={tmp.name}", f"data.prompt_library_dir={lib}",
            "data.prompt_library=small"]

    def state(tr):
        opt = tr.optimizer
        return ({n: p.detach().cpu().clone() for n, p in tr.params_train.items()},
                {i: {k: v.detach().cpu().clone() for k, v in opt.adan.state[p].items()}
                 for i, p in enumerate(opt.params) if p in opt.adan.state},
                (opt.adan.count, opt.mini_step, opt.notfinite_count, opt.total_notfinite,
                 tr.global_step))

    def same(a, b):
        return (a[2] == b[2] and set(a[0]) == set(b[0]) and set(a[1]) == set(b[1])
                and all(torch.equal(a[0][k], b[0][k]) for k in a[0])
                and all(set(a[1][i]) == set(b[1][i])
                        and all(torch.equal(a[1][i][k], b[1][i][k]) for k in a[1][i])
                        for i in a[1]))

    row = {"phase": "launcher", "what": "python3 -m triplaneturbo_torch.launch on the card, "
           "configs/smoke_tiny.yaml at the small kernel-taking width (head dim 64, 64-channel "
           "planes, teachers of 64 and 128 channels), 2 parts of 2 prompts x 4 views at 64²"}
    t0 = time.perf_counter()
    reset_counts()
    trained = launch.main([*base, "--train", "--max-steps", "2"])
    torch.cuda.synchronize()
    row["train_s"], row["train_launches"] = time.perf_counter() - t0, read_counts()
    check(all(v > 0 for v in row["train_launches"].values()),
          f"launcher: a kernel was not launched in --train: {row['train_launches']}")
    check(trained.cfg.auto_grad is False and trained.global_step == 2,
          "launcher: the small config should train monolithically for 2 steps")
    with open(trial / "metrics.jsonl") as fh:
        logged = [json.loads(ln) for ln in fh]
    check(len(logged) == 2 and all(math.isfinite(ln["loss"]) for ln in logged),
          f"launcher: metrics {logged}")
    saved = state(trained)
    del trained
    restored = {}
    load = checkpoint.load_train_state

    def loading(path, tr, **kwargs):
        step = load(path, tr, **kwargs)
        restored["state"] = state(tr)
        return step

    checkpoint.load_train_state = loading
    try:
        t0 = time.perf_counter()
        resumed = launch.main([*base, "--train", "--max-steps", "3", "--resume",
                               str(trial / "ckpt_000002")])
        torch.cuda.synchronize()
        row["resume_s"] = time.perf_counter() - t0
    finally:
        checkpoint.load_train_state = load
    check(same(restored["state"], saved), "launcher: --resume did not restore the train state "
          "bit-equal")
    check(resumed.global_step == 3 and resumed.optimizer.adan.count == 3,
          f"launcher: after --resume global_step {resumed.global_step}")
    trained_geometry = {n: p.detach().cpu().clone()
                        for n, p in resumed.geometry.state_dict().items()}
    del resumed
    t0 = time.perf_counter()
    validated = launch.main([*base, "--validate", "data.n_val_views=4",
                             f"system.weights={trial / 'last' / 'geometry.pt'}"])
    torch.cuda.synchronize()
    row["validate_s"] = time.perf_counter() - t0
    check(all(torch.equal(trained_geometry[n], p.cpu())
              for n, p in validated.geometry.state_dict().items()),
          "launcher: --validate did not load the trained geometry from system.weights")
    del validated, trained_geometry
    saved_files = sorted(os.listdir(trial / "save"))
    for i in range(len(SMALL_LIBRARY["val"])):
        check(f"it0-val-{i}-grid.png" in saved_files
              and any(f.startswith(f"it0-val-{i}-rgb.") for f in saved_files),
              f"launcher: --validate wrote {saved_files}")
    check(all((trial / "save" / f).stat().st_size > 0 for f in saved_files),
          "launcher: an empty validation file")
    row["validate_files"] = saved_files
    reset_counts()
    t0 = time.perf_counter()
    exported = launch.main([*base, "--export", "--resume", str(trial / "ckpt_000002")])
    torch.cuda.synchronize()
    row["export_s"], row["export_launches"] = time.perf_counter() - t0, read_counts()
    check(same(state(exported), saved),
          "launcher: --export did not restore the step-2 train state through --resume")
    del exported
    objs = sorted((trial / "it2-export").glob("*/model.obj"))
    faces = []
    for path in objs:
        with open(path) as fh:
            lines = fh.read().splitlines()
        faces.append(sum(ln.startswith("f ") for ln in lines))
        check(sum(ln.startswith("v ") for ln in lines) > 0 and faces[-1] > 0,
              f"launcher: --export wrote an empty {path}")
    check(len(objs) == len(SMALL_LIBRARY["test"]), f"launcher: --export wrote {objs}")
    check(row["export_launches"]["field_grid"] == len(objs),
          f"launcher: --export launches {row['export_launches']}")
    row["export_faces"] = faces
    emit(row)
    tmp.cleanup()
    torch.cuda.empty_cache()


# -- this slice's paths: the per-plane LoCon, the evaluation harness, the demo and data
# -- parallelism; each phase sets the launch counts to 0 just before its path and reads
# -- them just after

def phase_locon(pipe):
    """``locon_type="hexa_v1"``: the small kernel-taking student (every plane's LoCon
    ``up`` drawn nonzero) on the card against the CPU under SMALL_REL_TOL; then the
    full-width student with ``hexa_v1``, its prompts timed against the shipped
    ``vanilla_v1`` pipeline's (``pipe``), alternating, in the same call, and one prompt
    of each profiled (device-busy ms)."""
    t_phase = time.perf_counter()
    import statistics

    import torch
    from torch.profiler import ProfilerActivity
    from torch.profiler import profile as profiler
    from triplaneturbo_torch.models.clip_text import CLIPTextConfig
    from triplaneturbo_torch.pipelines.triplaneturbo_text_to_3d import (
        TriplaneTurboTextTo3DPipeline,
    )

    reset_counts, read_counts = _count_launches()
    sg = {**SMALL_SG, "locon_type": "hexa_v1"}
    pipes = {dev: TriplaneTurboTextTo3DPipeline.from_pretrained(
        None, device=dev, seed=0, space_generator_overrides=sg,
        text_config=CLIPTextConfig(**SMALL_TEXT), **SMALL_KW) for dev in ("cpu", "cuda")}
    gen = torch.Generator().manual_seed(13)
    with torch.no_grad():
        for n, p in pipes["cpu"].geometry.named_parameters():
            if n.endswith("planes.up.weight"):
                p.copy_(torch.randn(p.shape, generator=gen) * 0.05)
    pipes["cuda"].geometry.load_state_dict(pipes["cpu"].geometry.state_dict())
    pipes["cuda"].text_encoder.load_state_dict(pipes["cpu"].text_encoder.state_dict())
    r = SMALL_KW["latent_resolution"]
    latents = torch.randn((1, 6, r, r, 4), generator=torch.Generator().manual_seed(1))
    reset_counts()
    outs = {dev: p("a photo of a hamburger", latents=latents) for dev, p in pipes.items()}
    torch.cuda.synchronize()
    small_launches = read_counts()
    check(small_launches["flash_attn_fwd"] > 0 and small_launches["field_grid"] == 1,
          f"locon: the small hexa_v1 student did not take both kernels: {small_launches}")
    row = {"phase": "locon", "what": "hexa_v1 small student, card (kernels) vs CPU (plain), f32",
           "rel_tol": SMALL_REL_TOL, "small_launches": small_launches,
           "hexa_leaves": sum(".locon.planes." in n for n, _ in
                              pipes["cuda"].geometry.named_parameters())}
    for name in ("latents", "space_cache"):
        a, b = outs["cuda"][name].float().cpu(), outs["cpu"][name]
        check(bool(torch.isfinite(a).all()), f"locon: non-finite {name} on the card")
        rel = ((a - b).abs().max() / b.abs().max().clamp_min(1e-12)).item()
        row[f"{name}_rel_err"] = rel
        check(rel <= SMALL_REL_TOL, f"locon: {name} rel err {rel} > {SMALL_REL_TOL}")
    del pipes, outs

    hexa = TriplaneTurboTextTo3DPipeline.from_pretrained(
        None, device="cuda", dtype_str="bfloat16", seed=0,
        space_generator_overrides={"locon_type": "hexa_v1"})
    row["hexa_params"] = sum(p.numel() for p in hexa.geometry.parameters())
    row["vanilla_params"] = sum(p.numel() for p in pipe.geometry.parameters())
    gen = torch.Generator(device="cuda").manual_seed(42)
    for p in (hexa, pipe):  # warm-up
        p("a delicious hamburger", generator=gen)
    ms = {"hexa_v1": [], "vanilla_v1": []}
    launches = {"flash_attn_fwd": 0, "field_grid": 0}
    faces = []
    for prompt in ("a wooden chair", "a red sports car", "a ceramic teapot"):
        for name, p in (("vanilla_v1", pipe), ("hexa_v1", hexa)):
            torch.cuda.synchronize()
            if name == "hexa_v1":
                reset_counts()
            t = time.perf_counter()
            out = p(prompt, generator=gen)
            torch.cuda.synchronize()
            ms[name].append((time.perf_counter() - t) * 1e3)
            if name == "hexa_v1":
                got = read_counts()
                for k in launches:
                    launches[k] += got[k]
                m = out["mesh"][0]
                check(bool(torch.isfinite(m.v_pos[m.v_mask]).all())
                      and bool(torch.isfinite(out["space_cache"]).all()),
                      "locon: non-finite hexa_v1 output")
                faces.append(int(m.t_mask.sum()))
    check(launches == {"flash_attn_fwd": 3 * K1_LAUNCHES_PER_PROMPT,
                       "field_grid": 3 * K2_LAUNCHES_PER_PROMPT},
          f"locon: hexa_v1 prompts launched {launches}")
    check(all(f > 0 for f in faces), f"locon: empty hexa_v1 mesh {faces}")
    # one more prompt each under the profiler: the device-busy ms, in all and of the UNet
    busy = {}
    for name, p in (("vanilla_v1", pipe), ("hexa_v1", hexa)):
        with profiler(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            p("a wooden chair", generator=gen)
            torch.cuda.synchronize()
        total, stages, _, _ = _profile_split(prof)
        busy[name] = {"prompt": total, "denoise": stages["denoise"]}
    row.update(prompt_ms=ms, prompt_ms_median={k: statistics.median(v) for k, v in ms.items()},
               device_busy_ms=busy, launches=launches, faces=faces,
               phase_s=time.perf_counter() - t_phase)
    emit(row)
    del hexa
    torch.cuda.empty_cache()


EVAL_PROMPTS = ["a delicious hamburger", "a wooden chair", "a ceramic teapot"]


def phase_eval(pipe):
    """The evaluation harness at full width: ``render_mesh_views`` of the full-width
    prompt's mesh at 4 x 512² (each view's ms and its rasterize share, the per-view
    overflow counts), ``CLIPScorer`` at ViT-B/32 and its 512-wide text tower on random
    towers (ms), its features, cosines and score held against the same towers on the
    CPU (SMALL_REL_TOL), then ``run_eval.main`` over 3 prompts into a temporary
    directory."""
    t_phase = time.perf_counter()
    import statistics

    import copy

    import torch
    from triplaneturbo_torch.evaluation import run_eval
    from triplaneturbo_torch.evaluation.clipscore import W as clip_W
    from triplaneturbo_torch.evaluation.clipscore import CLIPScorer
    from triplaneturbo_torch.evaluation.mesh_render import (
        kire_camera_rig,
        prepare_mesh,
        render_mesh_views,
        render_view,
    )
    from triplaneturbo_torch.ops.rasterize import rasterize

    reset_counts, read_counts = _count_launches()
    mesh = pipe(EVAL_PROMPTS[0], generator=torch.Generator(device="cuda").manual_seed(42))[
        "mesh"][0]
    views = render_mesh_views(mesh)
    imgs = views.images
    check(tuple(imgs.shape) == (4, 512, 512, 3) and bool(torch.isfinite(imgs).all())
          and float(imgs.min()) >= 0 and float(imgs.max()) <= 1, "eval: views")
    covered = (imgs < 0.99).any(-1).float().mean(dim=(1, 2)).tolist()
    check(all(c > 0 for c in covered), f"eval: a view shows nothing of the mesh {covered}")
    prep = prepare_mesh(mesh, 512, 512)
    rig = torch.from_numpy(kire_camera_rig(4)).cuda()
    view_ms = [cuda_ms(lambda m=m: render_view(mesh, prep, m), iters=3, warmup=1) for m in rig]
    raster_ms = [cuda_ms(lambda m=m: rasterize(prep.vh @ m.T, mesh.t_pos_idx, mesh.t_mask, 512,
                                                512, faces_per_tile=2048, max_span=4,
                                                big_face_cap=256), iters=3, warmup=1)
                 for m in rig]
    prepare_ms = cuda_ms(lambda: prepare_mesh(mesh, 512, 512), iters=3, warmup=1)

    t = time.perf_counter()
    scorer = CLIPScorer(device="cuda", seed=0)
    torch.cuda.synchronize()
    scorer_build_s = time.perf_counter() - t
    feats = scorer.image_features(imgs)
    check(tuple(feats.shape) == (4, 512) and bool(((feats.norm(dim=-1) - 1).abs() < 1e-4).all()),
          "eval: image features")
    image_ms = cuda_ms(lambda: scorer.image_features(imgs), iters=5)
    text_ms = cuda_ms(lambda: scorer.text_features(EVAL_PROMPTS), iters=5)
    score_ms = []
    for _ in range(4):
        torch.cuda.synchronize()
        t = time.perf_counter()
        scores = scorer.score({p: imgs for p in EVAL_PROMPTS})
        score_ms.append((time.perf_counter() - t) * 1e3)
    check(0.0 <= scores["clip_score"] <= 2.5 and 0.0 <= scores["recall_at_1"] <= 1.0,
          f"eval: scores {scores}")
    # the same towers on the CPU: features, the cosines before the clamp, and the score
    # recomputed from them as W * max(cos, 0) averaged over views and prompts (random
    # towers can give every cosine one sign, and a range check then holds nothing)
    cpu = CLIPScorer(vision=copy.deepcopy(scorer.vision).cpu(),
                     text=copy.deepcopy(scorer.text).cpu(),
                     text_projection=scorer.text_projection.cpu(), tokenizer=scorer.tokenizer,
                     device="cpu")
    tfeat = scorer.text_features(EVAL_PROMPTS)
    cpu_feats, cpu_tfeat = cpu.image_features(imgs.cpu()), cpu.text_features(EVAL_PROMPTS)
    cos, cpu_cos = (feats @ tfeat.T).cpu(), cpu_feats @ cpu_tfeat.T  # [view, prompt]
    feat_err = max(float((feats.cpu() - cpu_feats).abs().max()),
                   float((tfeat.cpu() - cpu_tfeat).abs().max()))
    cos_err = float((cos - cpu_cos).abs().max())
    # the text projection negated flips every cosine's sign, so one of the two scores
    # holds the clamp on cosines above 0 whatever sign the random towers give them
    flipped = CLIPScorer(vision=scorer.vision, text=scorer.text,
                         text_projection=-scorer.text_projection, tokenizer=scorer.tokenizer,
                         device="cuda").score({p: imgs for p in EVAL_PROMPTS})["clip_score"]
    want = [float(clip_W * (sign * cpu_cos).clamp_min(0).mean()) for sign in (1, -1)]
    got = [scores["clip_score"], flipped]
    check(feat_err <= SMALL_REL_TOL and cos_err <= SMALL_REL_TOL and max(want) > 0
          and all(abs(g - w) <= clip_W * SMALL_REL_TOL for g, w in zip(got, want)),
          f"eval: the card's scorer against the CPU's: features {feat_err}, cosines {cos_err}, "
          f"scores (as is, projection negated) {got} against {want}")

    tmp = tempfile.TemporaryDirectory()
    lib = Path(tmp.name) / "lib.json"
    lib.write_text(json.dumps({"train": EVAL_PROMPTS, "test": EVAL_PROMPTS}))
    out = Path(tmp.name) / "eval"
    reset_counts()
    t = time.perf_counter()
    metrics = run_eval.main(["--prompts", str(lib), "--out", str(out), "--limit", "3",
                             "--save-obj", "--save-grid", "--device", "cuda"], pipe=pipe,
                            scorer=scorer)
    run_eval_s = time.perf_counter() - t
    launches = read_counts()
    check(launches["flash_attn_fwd"] == 3 * K1_LAUNCHES_PER_PROMPT
          and launches["field_grid"] == 3 * K2_LAUNCHES_PER_PROMPT,
          f"eval: run_eval launched {launches}")
    on_disk = json.loads((out / "metrics_rank0.json").read_text())
    check(on_disk["prompts"] == 3 and set(on_disk["overflow"]) == set(EVAL_PROMPTS)
          and all(len(v["n_span_overflow"]) == 4 for v in on_disk["overflow"].values())
          and 0.0 <= on_disk["clip_score"] <= 2.5, f"eval: metrics file {on_disk}")
    for i, p in enumerate(EVAL_PROMPTS):
        slug = run_eval.prompt_slug(i, p)
        check((out / slug / "model.obj").stat().st_size > 0 and (out / f"{slug}.png").exists(),
              f"eval: files of {p}")
    tmp.cleanup()
    emit({"phase": "eval", "what": "render_mesh_views 4 x 512² of the full-width prompt's mesh; "
          "CLIPScorer ViT-B/32 + 512-wide text tower, random towers (seed 0); run_eval.main, "
          "3 prompts", "faces": int(mesh.t_mask.sum()), "covered_share": covered,
          "n_span_overflow": views.n_span_overflow.tolist(),
          "n_list_overflow": views.n_list_overflow.tolist(),
          "view_ms": view_ms, "rasterize_ms": raster_ms, "prepare_ms": prepare_ms,
          "rasterize_share": sum(raster_ms) / sum(view_ms),
          "scorer_build_s": scorer_build_s, "image_features_ms_4_views": image_ms,
          "text_features_ms_3_prompts": text_ms, "score_ms_3_prompts": score_ms,
          "score_ms_median": statistics.median(score_ms[1:]), "scores": scores,
          "card_vs_cpu": {"features": feat_err, "cosines": cos_err, "tol": SMALL_REL_TOL,
                          "scores_as_is_and_negated": got,
                          "from_cpu_cosines": want},
          "cosines_view_by_prompt": cos.tolist(),
          "run_eval_s": run_eval_s, "run_eval_mean_latency_s": metrics["mean_latency_s"],
          "run_eval_metrics": {k: metrics[k] for k in ("clip_score", "recall_at_1")},
          "launches": launches, "phase_s": time.perf_counter() - t_phase})
    torch.cuda.empty_cache()


def _http_get(port, path):
    import http.client

    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=300)
    try:
        conn.request("GET", path)
        r = conn.getresponse()
        return r.status, r.read()
    finally:
        conn.close()


def phase_demo(pipe):
    """``python3 -m triplaneturbo_torch.demo``'s server around the full-width pipeline, in a
    thread on a free localhost port: three ``/generate`` requests over ``http.client``,
    each answered with a 4-view 256² PNG strip and an OBJ with faces (fetched through
    ``/file``), the median request ms; ``/file`` refuses a sibling of its root and a path
    outside it."""
    t_phase = time.perf_counter()
    import re
    import statistics
    import threading
    import urllib.parse

    from triplaneturbo_torch import demo

    reset_counts, read_counts = _count_launches()
    tmp = tempfile.TemporaryDirectory()
    root = Path(tmp.name) / "outputs" / "demo"
    srv = demo.serve(pipe, str(root), port=0, host="127.0.0.1")
    port = srv.server_address[1]
    thread = threading.Thread(target=srv.serve_forever, daemon=True)
    thread.start()
    row = {"phase": "demo", "request_ms": [], "png_bytes": [], "obj_faces": []}
    try:
        reset_counts()
        for i, prompt in enumerate(EVAL_PROMPTS):
            t = time.perf_counter()
            status, body = _http_get(port, "/generate?" + urllib.parse.urlencode(
                {"prompt": prompt, "seed": i}))
            row["request_ms"].append((time.perf_counter() - t) * 1e3)
            check(status == 200, f"demo: /generate answered {status}")
            links = [urllib.parse.unquote(p)
                     for p in re.findall(r"/file\?p=([^']+)'", body.decode())]
            png = [p for p in links if p.endswith(".png")]
            obj = [p for p in links if p.endswith(".obj")]
            check(len(png) == 1 and len(obj) == 1, f"demo: links {links}")
            status, data = _http_get(port, "/file?p=" + urllib.parse.quote(png[0]))
            check(status == 200 and data.startswith(b"\x89PNG\r\n\x1a\n"), "demo: the strip")
            row["png_bytes"].append(len(data))
            status, data = _http_get(port, "/file?p=" + urllib.parse.quote(obj[0]))
            nf = sum(ln.startswith(b"f ") for ln in data.splitlines())
            check(status == 200 and nf > 0, "demo: the OBJ")
            row["obj_faces"].append(nf)
        launches = read_counts()
        check(launches["flash_attn_fwd"] == 3 * K1_LAUNCHES_PER_PROMPT
              and launches["field_grid"] == 3 * K2_LAUNCHES_PER_PROMPT,
              f"demo: launches {launches}")
        sibling = Path(tmp.name) / "outputs" / "demo2" / "x"
        sibling.parent.mkdir(parents=True)
        sibling.write_text("not served")
        refused = {p: _http_get(port, "/file?p=" + urllib.parse.quote(p))[0]
                   for p in (str(sibling), "/etc/hostname", str(root / ".." / "demo2" / "x"))}
        check(all(s == 404 for s in refused.values()), f"demo: /file served {refused}")
    finally:
        srv.shutdown()
        srv.server_close()
        thread.join(timeout=30)
        tmp.cleanup()
    row.update(request_ms_median=statistics.median(row["request_ms"]), refused=refused,
               launches=launches, phase_s=time.perf_counter() - t_phase)
    emit(row)


DP_ENV = ("MASTER_ADDR", "MASTER_PORT", "RANK", "WORLD_SIZE", "LOCAL_RANK")


def _free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _dp_small_step(replay=None):
    """One staged ``train_step`` of the small kernel-taking model on the card (2 parts of
    2 prompts x 4 views at 64², 32² rays, the small teachers, the v1 loss: the second
    branch's sparsity and eikonal terms, the variance not trained) from seed 0 and the
    generator seeded 42, under whatever process group is up. Returns the parameters, the
    gradients the update took and the metrics (on the host), the step's host ms, the
    learning rate, and each part's program-R generator output (denoised latent, space
    cache). ``replay`` (one such pair a part) replaces program R's generator output, as
    the whole-step check replays the card's space caches on the CPU: the renderers'
    marching cubes, sample boundaries and thin faces turn the generator's last bits,
    which depend on the batch size, into jumps of the gradients."""
    import torch
    from triplaneturbo_torch.data.multiview_multiprompt import (
        DataModuleConfig,
        MultiviewMultipromptDataModule,
    )
    from triplaneturbo_torch.models.background.hashgrid_env_map import (
        HashgridBackgroundConfig,
        HyperNetConfig,
    )
    from triplaneturbo_torch.models.guidance.asd_guidance import ASDConfig
    from triplaneturbo_torch.models.renderers.patch_renderer import PatchRendererConfig
    from triplaneturbo_torch.models.renderers.rasterize_renderer import RasterizeRendererConfig
    from triplaneturbo_torch.models.renderers.volume_renderer import VolumeRendererConfig
    from triplaneturbo_torch.systems.trainer import LossConfig, TrainerConfig, TriplaneTurboTrainer

    trainer = TriplaneTurboTrainer.build(
        TrainerConfig(auto_grad=True, num_parts_training=2, num_steps_training=2,
                      loss=LossConfig(lambda_sparsity_2nd=0.1, lambda_eikonal_2nd=0.1)),
        seed=0, device="cuda", space_generator_overrides=SMALL_SG,
        background_cfg=HashgridBackgroundConfig(
            hypernet=HyperNetConfig(c_dim=SMALL_SG["cross_attention_dim"])),
        renderer_cfg=RasterizeRendererConfig(**SMALL_RENDER),
        volume_cfg=VolumeRendererConfig(**SMALL_VOLUME, trainable_variance=False),
        patch_cfg=PatchRendererConfig(**SMALL_PATCH), teacher_sizes=SMALL_TEACHERS,
        teacher_dtype="float32", guidance_cfg=ASDConfig(**SMALL_GUIDANCE))
    gen = torch.Generator().manual_seed(12)
    with torch.no_grad():
        for n, p in trainer.geometry.named_parameters():
            if n.endswith(".up") or ".up." in n:
                p.copy_(torch.randn(p.shape, generator=gen) * 0.05)
    hw1, hw2 = SMALL_G_HW
    r = SMALL_KW["latent_resolution"]
    dm = MultiviewMultipromptDataModule(DataModuleConfig(
        batch_size=8, n_view=4, height=hw1, width=hw1, ray_height=hw2, ray_width=hw2,
        n_steps=2, dim_gaussian=(6, 4, r, r)), seed=0)
    batch_list = dm.sample_train_batch()
    gen = torch.Generator().manual_seed(11)
    text = {k: torch.randn((2, 77, SMALL_TEACHER["cross_attention_dim"]), generator=gen)
            for k in ("cond_local", "cond_21", "uncond_21", "cond_15", "uncond_15")}
    text["global_21"] = torch.randn((2, SMALL_SG["cross_attention_dim"]), generator=gen)
    taken, seen = {}, []
    step, denoise_decode = trainer.optimizer.step, trainer._denoise_decode

    def record(grads):
        taken.update({n: g.detach().cpu().clone() for n, g in zip(trainer.trainable, grads)})
        return step(grads)

    def generator_output(latent, t, text_embeds, noise):
        out = denoise_decode(latent, t, text_embeds, noise)
        if torch.is_grad_enabled():  # program B-G differentiates its own forward
            return out
        seen.append(tuple(x.detach().cpu() for x in out))
        if replay is not None:
            out = tuple(x.to(o.device) for x, o in zip(replay[len(seen) - 1], out))
        return out

    trainer.optimizer.step = record
    trainer._denoise_decode = generator_output
    torch.cuda.synchronize()
    t = time.perf_counter()
    metrics = trainer.train_step(batch_list, {k: v.cuda() for k, v in text.items()},
                                 torch.Generator(device="cuda").manual_seed(42))
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t) * 1e3
    return {"params": {n: p.detach().cpu().clone() for n, p in trainer.params_train.items()},
            "grads": taken, "metrics": {k: float(v) for k, v in metrics.items()}, "ms": ms,
            "lr": trainer.cfg.learning_rate, "generated": seen}


def _bit_equal(a, b) -> bool:
    """Two ``_dp_small_step`` results with the same parameters and gradients, bit for bit."""
    import torch

    return all(torch.equal(a[k][n], b[k][n]) for k in ("params", "grads") for n in a[k])


def _dp_errors(got, ref):
    """Worst relative errors of ``got`` against ``ref`` (each a ``_dp_small_step``): the
    metrics; each leaf's gradient, of its largest; each parameter, of its leaf's largest,
    four learning rates looser where the reference's gradient is under 1e-2 of its
    leaf's largest (Adan's first step moves an element by the learning rate times the
    sign of its gradient)."""
    lr = ref["lr"]
    metrics = max(abs(got["metrics"][k] - v) / max(abs(v), 1e-12)
                  for k, v in ref["metrics"].items())
    grads, params = {}, {}
    for n, g in ref["grads"].items():
        grads[n] = float((got["grads"][n] - g).abs().max() / g.abs().max().clamp_min(1e-12))
        loose = g.abs() < 1e-2 * g.abs().max()
        p = ref["params"][n]
        diff = (got["params"][n] - p).abs() - 4 * lr * loose
        params[n] = float(diff.max().clamp_min(0) / p.abs().max().clamp_min(lr))
    worst_p = max(params, key=params.get)
    worst_g = sorted(grads, key=grads.get, reverse=True)[:5]
    return {"metrics": metrics, "grads": grads[worst_g[0]], "params": params[worst_p],
            "worst_param_leaf": worst_p,
            "worst_grad_leaves": {n: [grads[n], float(ref["grads"][n].abs().max())]
                                  for n in worst_g}}


def _parallel_worker(rank: int, port: int, out: str) -> int:
    """One rank of the two-rank gloo run on one card (``chip_smoke.py --parallel-worker
    RANK PORT OUT``): the small step under the group, and one reduction of its gradients
    timed; the result saved to ``OUT``."""
    sys.path.insert(0, str(REPO))
    os.environ.update(MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port), RANK=str(rank),
                      WORLD_SIZE="2", LOCAL_RANK="0")
    import torch
    import torch.distributed as dist
    from triplaneturbo_torch.parallel import all_reduce_mean

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t = time.perf_counter()
    torch.cuda.set_device(0)
    dist.init_process_group("gloo")  # NCCL would refuse two ranks on one card
    init_s = time.perf_counter() - t
    res = _dp_small_step()
    grads = [g.cuda() for g in res["grads"].values()]
    torch.cuda.synchronize()
    t = time.perf_counter()
    all_reduce_mean(grads)
    torch.cuda.synchronize()
    res.update(reduce_ms=(time.perf_counter() - t) * 1e3, init_s=init_s,
               elements=sum(g.numel() for g in grads))
    dist.destroy_process_group()
    torch.save(res, out)
    return 0


def phase_parallel():
    """Data parallelism (``triplaneturbo_torch/parallel``) on the one card. (a) NCCL at
    world size 1: the small model's step through the reduced-gradient path against the
    same step with no process group, bit for bit where two steps with no group agree bit
    for bit (the card's atomic adds can make them differ in the last bit; then the
    world-1 step is held within the whole-step tolerances), and a gradient replayed
    through the reduction, which must come back bit for bit. (b) Two gloo ranks spawned
    on the card, each holding one prompt of the 2-prompt batch: after the step both hold
    the same parameters bit for bit, and those equal the one-process step on the whole
    batch within WHOLE_STEP_TOL (metrics, parameters) and WHOLE_STEP_GRAD_TOL
    (gradients), that step's program R taking the ranks' generator output (a batch of
    one prompt runs the UNet and VAE in other orders than a batch of two; the renderers
    turn those last bits into jumps, as they do the card's against the CPU's). The
    ranks' generator output itself (latent, space cache) is held against the one-process
    step's under SMALL_REL_TOL, which a rank with another prompt's latent, noise or text
    misses by orders of magnitude; the comparison without the replay is reported.
    A run across several cards waits for a machine with more than one."""
    t_phase = time.perf_counter()
    import torch
    import torch.distributed as dist
    from triplaneturbo_torch.parallel import all_reduce_mean, init_data_parallel

    reset_counts, read_counts = _count_launches()
    one = _dp_small_step()
    os.environ.update(MASTER_ADDR="127.0.0.1", MASTER_PORT=str(_free_port()), RANK="0",
                      WORLD_SIZE="1", LOCAL_RANK="0")
    try:
        t = time.perf_counter()
        init_data_parallel("cuda")
        nccl_init_s = time.perf_counter() - t
        reset_counts()
        world1 = _dp_small_step()
        launches = read_counts()
        check(all(v > 0 for v in launches.values()),
              f"parallel: the world-1 step did not take every kernel: {launches}")
        replay = {n: g.cuda() for n, g in one["grads"].items()}
        torch.cuda.synchronize()
        t = time.perf_counter()
        all_reduce_mean(replay)
        torch.cuda.synchronize()
        nccl_reduce_ms = (time.perf_counter() - t) * 1e3
        check(all(torch.equal(replay[n].cpu(), g) for n, g in one["grads"].items()),
              "parallel: NCCL's world-1 reduction changed a gradient")
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()
        for k in DP_ENV:
            os.environ.pop(k, None)
    row = {"phase": "parallel", "what": "small model, 2 parts x 2 prompts x 4 views at 64², "
           "staged, the v1 loss", "world1_launches": launches, "nccl_init_s": nccl_init_s,
           "nccl_reduce_ms": nccl_reduce_ms, "step_ms_no_group": one["ms"],
           "step_ms_nccl_world1": world1["ms"], "world1_bit_equal": _bit_equal(world1, one)}
    if not row["world1_bit_equal"]:
        again = _dp_small_step()
        row["no_group_run_to_run_bit_equal"] = _bit_equal(again, one)
        check(not row["no_group_run_to_run_bit_equal"],
              "parallel: the world-1 step differs from the step with no group, which "
              "repeats bit for bit")
        row["world1_rel_err"] = err = _dp_errors(world1, one)
        check(err["metrics"] <= WHOLE_STEP_TOL and err["params"] <= WHOLE_STEP_TOL
              and err["grads"] <= WHOLE_STEP_GRAD_TOL, f"parallel: world-1 step {err}")

    tmp = tempfile.TemporaryDirectory()
    port = _free_port()
    outs = [str(Path(tmp.name) / f"rank{r}.pt") for r in range(2)]
    t = time.perf_counter()
    procs = [subprocess.Popen([sys.executable, str(REPO / "chip_smoke.py"), "--parallel-worker",
                               str(r), str(port), outs[r]], cwd=str(REPO),
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
             for r in range(2)]
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=400)[0].decode(errors="replace"))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    gloo_wall_s = time.perf_counter() - t
    for r, p in enumerate(procs):
        check(p.returncode == 0, f"parallel: gloo rank {r} failed:\n{logs[r][-3000:]}")
    ranks = [torch.load(o, weights_only=False) for o in outs]
    tmp.cleanup()
    check(all(torch.equal(ranks[0]["params"][n], ranks[1]["params"][n]) for n in one["params"]),
          "parallel: the gloo ranks hold different parameters after the step")
    # the one-process step on the whole batch, its program R taking the ranks' generator
    # output (the prompts' halves put back together)
    whole = _dp_small_step(replay=[tuple(torch.cat(xs) for xs in zip(*parts))
                                   for parts in zip(*(r["generated"] for r in ranks))])
    gen_err = max(float((torch.cat(xs) - y).abs().max() / y.abs().max())
                  for parts, mine in zip(zip(*(r["generated"] for r in ranks)),
                                         one["generated"])
                  for xs, y in zip(zip(*parts), mine))
    err = _dp_errors(ranks[0], whole)
    row.update(gloo_rel_err=err, generator_output_rel_err=gen_err,
               gloo_rel_err_without_replay=_dp_errors(ranks[0], one),
               gloo_step_ms=[r["ms"] for r in ranks],
               gloo_reduce_ms=[r["reduce_ms"] for r in ranks],
               gloo_init_s=[r["init_s"] for r in ranks], gloo_wall_s=gloo_wall_s,
               reduced_elements=ranks[0]["elements"], gloo_ranks_bit_equal=True,
               several_cards="waits for a machine with more than one card",
               phase_s=time.perf_counter() - t_phase)
    check(gen_err <= SMALL_REL_TOL, f"parallel: the ranks' program R output is {gen_err} "
          f"from the one-process step's (> {SMALL_REL_TOL}): a rank took another prompt's "
          "latent, noise or text")
    check(err["metrics"] <= WHOLE_STEP_TOL and err["params"] <= WHOLE_STEP_TOL
          and err["grads"] <= WHOLE_STEP_GRAD_TOL, f"parallel: two gloo ranks {err}")
    emit(row)


def kernels_line(rows, serving, training):
    """One entry per kernel, with the numbers of its heaviest main-path shape (bf16, the
    joint self-attention; R = 160 for the field grid). ``launches`` is the count from
    the kernel's own main path: serving for the forward and the field grid, training
    for the stats forward and the backward kernels; ``launches_by_path`` has both."""
    csrc = "triplaneturbo_torch/csrc/"
    pallas = "triplaneturbo_tpu/ops/"
    meta = {
        "flash_attn_fwd": (csrc + "flash_attn_fwd.cu", pallas + "attention_pallas.py:34", "serving"),
        "flash_attn_fwd_stats": (csrc + "flash_attn_fwd.cu", pallas + "attention_pallas.py:73",
                                 "training"),
        "flash_attn_bwd_dq": (csrc + "flash_attn_bwd.cu", pallas + "attention_pallas.py:148",
                              "training"),
        "flash_attn_bwd_dkdv": (csrc + "flash_attn_bwd.cu", pallas + "attention_pallas.py:180",
                                "training"),
        "field_grid": (csrc + "field_grid.cu", pallas + "field_grid_pallas.py:48", "serving"),
    }
    out = []
    for name, (source, replaces, path) in meta.items():
        mine = [r for r in rows if r["kernel"] == name]
        if name == "field_grid":
            r = [x for x in mine if x["R"] == 160 and "v1" in x["site"]][0]
        else:
            r = [x for x in mine if x["dtype"] == "bfloat16" and x["L"] == 6144][0]
        by_path = {"serving": serving.get(name, 0), "training": training.get(name, 0)}
        out.append({
            "name": name, "route": "cuda", "source": source, "replaces": replaces,
            "launches": by_path[path], "launches_by_path": by_path,
            "max_abs_err": max(x["max_abs_err"] for x in mine),
            "ms": r["ms"], "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
            "bound_by": r["bound_by"], "library_ms": r["library_ms"], "shape": r["site"],
        })
        if name == "field_grid":
            out[-1].update(bound_f32_ms=r["bound_f32_ms"], kernel_ms=r["kernel_ms"])
    return {"kernels": out}


def main() -> int:
    if not (REPO / "triplaneturbo_torch").is_dir():
        print("chip_smoke: triplaneturbo_torch/ is missing; run from a checkout of the repo",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(REPO))
    import torch

    info = phase_device()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    phase_build()
    rows = phase_kernels()
    phase_reference()
    phase_train_reference()
    serving, pipe, prompt_timing = phase_pipeline()
    prompt_flops = phase_flops_prompt(pipe)
    phase_locon(pipe)
    phase_eval(pipe)
    phase_demo(pipe)
    phase_msgpack(pipe)
    loaded, out = phase_checkpoint(pipe)
    del pipe
    phase_export(loaded, out)
    del loaded, out
    import gc

    gc.collect()
    torch.cuda.empty_cache()
    phase_launcher()
    training, step_flops = phase_training()
    emit(flops_line(prompt_flops, prompt_timing, step_flops))
    gc.collect()
    torch.cuda.empty_cache()
    phase_parallel()
    for name, count in {**training, **{k: serving[k] for k in ("flash_attn_fwd", "field_grid")}}.items():
        check(count > 0, f"{name} was launched no time on its main path")
    emit(kernels_line(rows, serving, training))
    print(info["nvidia_smi"], flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": info["kind"],
                                 "count": info["count"]}})
    return 0


if __name__ == "__main__":
    try:
        if sys.argv[1:2] == ["--parallel-worker"]:
            sys.exit(_parallel_worker(int(sys.argv[2]), int(sys.argv[3]), sys.argv[4]))
        sys.exit(main())
    except SmokeFailure as e:
        print(f"chip_smoke: FAILED: {e}", file=sys.stderr)
        sys.exit(1)
