"""Smoke run of the PyTorch/CUDA port (``triplaneturbo_torch``) on one GPU.

    python3 chip_smoke.py

Phases, each printing one JSON line; any failure exits non-zero:

1. device   -- ``nvidia-smi`` name and power limit, the torch device name and count;
               exits 2 when CUDA is unavailable.
2. build    -- builds every kernel from ``triplaneturbo_torch/csrc`` with nvcc and
               prints each one's ``-Xptxas -v`` lines.
3. kernels  -- holds each kernel against its plain PyTorch version at every shape its
               main path gives it, and times kernel, plain version and the library
               call: the flash forward at the serving shapes (one prompt) and the
               field grid at R=160; the flash forward with stats, the dq and the
               dk/dv kernels at the training shapes (two prompts), in bf16 at all six
               sites and in f32 at the joint and VAE sites, plus ragged lengths
               (700/700, 300/1200); the field-grid slab backward against autograd of
               the plain field at R=160 (v1) and R=40 (v2).
               Tolerances: f32 1e-4 absolute (sums run in another order than the
               plain version's); bf16 1e-2 of the largest reference value at the
               site, for each output (a bf16 result's own rounding is at most 2^-9
               of it, and the backward also takes delta from the bf16-rounded
               forward output); field grid 1e-4 absolute, its backward
               1e-4 of the largest reference gradient of each input.
4. reference -- a small model (head dim 64, so every attention and the field grid
               take the kernels) on the card against the same weights on the CPU
               (plain versions), in f32, one prompt: latents, space cache and SDF.
5. train_reference -- the same small model's training slice: the generator backward
               (program B-G) and the guarded Adan update on the card (kernels), with
               and without gradient checkpointing, against the CPU (plain versions)
               from the same weights, latent, noise, timestep, text states and
               space-cache cotangent.
6. pipeline -- prompt -> textured mesh at full width (SD-2.1 student UNet, OpenCLIP-H
               text tower, retrofitted VAE, R=160 marching cubes) in bf16 on random
               weights from a seed: one warm-up prompt and three timed prompts through
               ``__call__`` with every launch count reset just before and read just
               after, an exported OBJ, then one more ``__call__`` prompt under
               ``torch.profiler``: device-busy ms of each stage (the pipeline's
               ``record_function`` ranges), the idle share and the heaviest kernels.
7. training -- the student's training backward at full width, two prompts, bf16,
               R=160: steps of four parts, each part the no-grad generator forward,
               the mesh branch (field grid -> grad shrink -> empty-field fallback ->
               marching cubes) differentiated from a seeded vertex cotangent back to
               the space cache and the field MLPs, and program B-G; then the update.
               The seeded cotangents stand in for the rasterizer, the volume renderer
               and the teachers, which are not ported yet, and seeded text states for
               the prompt processor. Launch counts of all five kernels are asserted
               for every part; one more part runs under ``torch.profiler``.

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

# H100 SXM peaks (NVIDIA data sheet, dense): bf16 tensor cores, f32 CUDA cores, HBM3.
PEAK_FLOPS = {"bfloat16": 989e12, "float32": 67e12}
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
FLASH_PER_PASS = sum(s[-1] for s in TRAIN_ATTN_SHAPES)  # 26: one UNet pass and one VAE decode
# absolute, except flash attention in bf16: a fraction of max |reference|
TOL = {("flash_attn_fwd", "float32"): 1e-4, ("flash_attn_fwd", "bfloat16"): 1e-2,
       ("flash_attn_fwd_stats", "float32"): 1e-4, ("flash_attn_fwd_stats", "bfloat16"): 1e-2,
       ("flash_attn_bwd", "float32"): 1e-4, ("flash_attn_bwd", "bfloat16"): 1e-2,
       ("field_grid", "float32"): 1e-4, ("field_grid_bwd", "float32"): 1e-4}
TIMED_PROMPTS = 3
STAGES = ("text_encoder", "denoise", "vae_decode", "field_grid", "marching_cubes", "colorize")
TRAIN_STAGES = ("generator_forward", "mesh_branch", "generator_backward")
TRAIN_STEPS = 3  # one warm-up step and two timed ones, four parts each


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


class SmokeFailure(RuntimeError):
    pass


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise SmokeFailure(msg)


def cuda_ms(fn, iters: int, warmup: int = 2) -> float:
    """Mean device time of ``fn()`` from CUDA events over ``iters`` calls."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
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


def phase_build():
    from triplaneturbo_torch.ops import _build

    t0 = time.perf_counter()
    _build.build_all()
    seconds = time.perf_counter() - t0
    report = {}
    for name in _build.sources():
        lines = [ln.strip() for ln in _build.ptxas_report(name).splitlines()
                 if "ptxas info" in ln and ("Used" in ln or "spill" in ln or "Compiling" in ln)]
        report[name] = lines
    emit({"phase": "build", "seconds": seconds, "ptxas": report})


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
    ms = cuda_ms(lambda: fg.fused_field_grid(*args), 10)
    plain_ms = cuda_ms(lambda: fg.field_grid_reference(*args), 3, warmup=1)
    H, HB = 128, 64
    # layer-1 fold (three [R^2, C] x [C, H] products), then per grid point the plane sum,
    # the two diagonal [HB, HB] blocks of the block-diagonal W2 and the four heads
    # (the sdf head reads the first HB columns, the three deformation heads the rest)
    flops = 3 * R * R * C * H * 2 + R ** 3 * (2 * H + 2 * 2 * HB * HB + 2 * 4 * HB)
    nbytes = 3 * R * R * C * 4 + sum(w.numel() for w in ws) * 4 + 4 * R ** 3 * 4
    bound_ms, bound_by = bound(flops, nbytes, "float32")
    row = {"phase": "kernel_case", "kernel": "field_grid", "site": name, "dtype": "float32",
           "R": R, "max_abs_err": err, "tol": tol, "ms": ms, "plain_ms": plain_ms,
           "library_ms": None, "bound_ms": bound_ms, "bound_by": bound_by}
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
    for site, BH, L, Lk, D, _ in TRAIN_ATTN_SHAPES + RAGGED_SHAPES:
        rows += training_attention_case(site, BH, L, Lk, D, "bfloat16", gen)
        if "joint 6 planes" in site and L == 6144 or D == 512 or site.startswith("ragged"):
            rows += training_attention_case(site, BH, L, Lk, D, "float32", gen)
        torch.cuda.empty_cache()
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

    pipes = {dev: TriplaneTurboTextTo3DPipeline.from_pretrained(
        None, device=dev, seed=0, space_generator_overrides=SMALL_SG,
        text_config=CLIPTextConfig(**SMALL_TEXT), **SMALL_KW) for dev in ("cpu", "cuda")}
    pipes["cuda"].geometry.load_state_dict(pipes["cpu"].geometry.state_dict())
    pipes["cuda"].text_encoder.load_state_dict(pipes["cpu"].text_encoder.state_dict())
    r = SMALL_KW["latent_resolution"]
    latents = torch.randn((1, 6, r, r, 4), generator=torch.Generator().manual_seed(1))
    k1, k2 = fa.LAUNCHES, fg.LAUNCHES
    outs = {dev: p("a photo of a hamburger", latents=latents) for dev, p in pipes.items()}
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

    # the main path: one warm-up prompt and the timed prompts, through __call__
    torch.cuda.reset_peak_memory_stats()
    fa.LAUNCHES = 0
    fg.LAUNCHES = 0
    outs, prompt_ms = [], []
    for p in prompts:
        torch.cuda.synchronize()
        t = time.perf_counter()
        outs.append(pipe(p, generator=gen))
        torch.cuda.synchronize()
        prompt_ms.append((time.perf_counter() - t) * 1e3)
    launches = {"flash_attn_fwd": fa.LAUNCHES, "field_grid": fg.LAUNCHES}
    peak_bytes = torch.cuda.max_memory_allocated()

    n = len(prompts)
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
    return launches


def phase_train_reference():
    """The small model's generator backward and update: card (kernels, with and
    without gradient checkpointing) against the CPU (plain versions), f32."""
    import torch
    from triplaneturbo_torch.ops import field_grid as fg
    from triplaneturbo_torch.ops import flash_attention as fa
    from triplaneturbo_torch.systems.trainer import TrainerConfig, TriplaneTurboTrainer

    def build(device, checkpoint):
        return TriplaneTurboTrainer.build(
            TrainerConfig(), seed=0, device=device,
            space_generator_overrides=dict(SMALL_SG, gradient_checkpoint=checkpoint))

    trainers = {"cpu": build("cpu", False), "cuda": build("cuda", False),
                "cuda_checkpoint": build("cuda", True)}
    # adapter ``up`` leaves start at zero; make them nonzero so that every adapter leaf
    # gets a gradient, then give all three trainers the same weights
    gen = torch.Generator().manual_seed(2)
    with torch.no_grad():
        for n, p in trainers["cpu"].geometry.named_parameters():
            if n.endswith(".up") or ".up." in n:
                p.copy_(torch.randn(p.shape, generator=gen) * 0.05)
    state = trainers["cpu"].geometry.state_dict()
    for name in ("cuda", "cuda_checkpoint"):
        trainers[name].geometry.load_state_dict(state)
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

    row = {"phase": "train_reference", "what": "small model, program B-G + guarded Adan update, "
           "card (kernels) vs CPU (plain), f32", "rel_tol": SMALL_REL_TOL, "launches": launches,
           "leaves": len(grads["cpu"])}
    lr = trainers["cpu"].cfg.learning_rate
    for name in ("cuda", "cuda_checkpoint"):
        worst_g = worst_p = 0.0
        skipped = total = 0
        for n, ref in grads["cpu"].items():
            got = grads[name][n]
            check(bool(torch.isfinite(got).all()), f"train_reference: non-finite gradient {n}")
            scale = ref.abs().max().clamp_min(1e-12)
            if n.startswith("field."):
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


def _training_part(trainer, latent, t, text, scalars, gen, R, counts_expected=None):
    """One denoise part of the staged step, as far as it is ported.

    The no-grad generator forward (program R's first half), the mesh branch's
    isosurface differentiated from a seeded vertex cotangent (the stand-in for the
    rasterizer and the teachers), and program B-G with that cotangent plus a seeded
    one in place of the volume branch's. Returns the next latent and the part's
    gradients for every trainable leaf.
    """
    import torch
    from torch.profiler import record_function
    from triplaneturbo_torch.systems.trainer import mesh_branch_isosurface

    noise = torch.randn(latent.shape, generator=gen, device=latent.device)
    with record_function("generator_forward"), torch.no_grad():
        denoised, space_cache = trainer._denoise_decode(latent, t, text, noise)
    with record_function("mesh_branch"):
        sc = space_cache.detach().requires_grad_()
        meshes = mesh_branch_isosurface(trainer.geometry, sc, R, scalars["sdf_grad_shrink"],
                                        scalars["def_grad_shrink"])
        verts = torch.stack([m.verts for m in meshes])
        mask = torch.stack([m.vert_mask for m in meshes])
        cot = torch.randn(verts.shape, generator=gen, device=verts.device) * mask[..., None]
        field = {n: p for n, p in trainer.params_train.items() if n.startswith("field.")}
        g = torch.autograd.grad(verts, [sc, *field.values()], cot, allow_unused=True)
        g_space_1st = g[0]
        n_verts = [int(m.n_verts) for m in meshes]
    with record_function("generator_backward"):
        g_space_2nd = torch.randn(sc.shape, generator=gen, device=sc.device) * 1e-3
        grads = trainer._stage_student_space(latent, t, text, g_space_1st, g_space_2nd, noise)
    for (n, p), gf in zip(field.items(), g[1:]):
        if gf is not None:
            grads[n] = grads[n] + gf
    return denoised.detach(), grads, n_verts


def phase_training():
    """The student's training backward at full width: 2 prompts, bf16, R = 160."""
    import torch
    from torch.profiler import ProfilerActivity
    from torch.profiler import profile as profiler
    from triplaneturbo_torch.ops import field_grid as fg
    from triplaneturbo_torch.ops import flash_attention as fa
    from triplaneturbo_torch.systems.trainer import (
        TrainerConfig,
        TriplaneTurboTrainer,
        sample_timesteps,
    )

    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    trainer = TriplaneTurboTrainer.build(
        TrainerConfig(), seed=0, device="cuda",
        space_generator_overrides=dict(dtype_str="bfloat16"))
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    cfg = trainer.cfg
    R = 160
    gen = torch.Generator(device="cuda").manual_seed(7)
    # seeded text states stand in for the prompt processor (OpenCLIP-H states, 77 x 1024)
    text = {"cond_local": torch.randn((TRAIN_PROMPTS, 77, 1024), generator=gen, device="cuda")}
    # kept on the host, so that the copy does not count in the peak device memory
    before = {n: p.detach().cpu() for n, p in trainer.geometry.named_parameters()}

    # launches a part: the no-grad forward takes the plain forward kernel once per site;
    # B-G takes the stats forward and both backward kernels once per site; the mesh
    # branch takes the field-grid kernel once per prompt
    expected = {"flash_attn_fwd": FLASH_PER_PASS, "flash_attn_fwd_stats": FLASH_PER_PASS,
                "flash_attn_bwd_dq": FLASH_PER_PASS, "flash_attn_bwd_dkdv": FLASH_PER_PASS,
                "field_grid": TRAIN_PROMPTS}

    def reset_counts():
        fa.LAUNCHES = fa.LAUNCHES_STATS = fa.LAUNCHES_BWD_DQ = fa.LAUNCHES_BWD_DKDV = 0
        fg.LAUNCHES = 0

    def read_counts():
        return {"flash_attn_fwd": fa.LAUNCHES, "flash_attn_fwd_stats": fa.LAUNCHES_STATS,
                "flash_attn_bwd_dq": fa.LAUNCHES_BWD_DQ, "flash_attn_bwd_dkdv": fa.LAUNCHES_BWD_DKDV,
                "field_grid": fg.LAUNCHES}

    totals = dict.fromkeys(expected, 0)
    part_ms, step_ms, verts_seen = [], [], []
    for step in range(TRAIN_STEPS):
        timesteps = sample_timesteps(trainer.all_timesteps, cfg.num_parts_training, trainer.rng)
        scalars = trainer.host_scalars()
        latent = torch.randn((TRAIN_PROMPTS, 6, 32, 32, 4), generator=gen, device="cuda")
        acc = None
        torch.cuda.synchronize()
        t_step = time.perf_counter()
        for t in timesteps:
            reset_counts()
            t_part = time.perf_counter()
            latent, grads, n_verts = _training_part(trainer, latent, int(t), text, scalars, gen, R)
            torch.cuda.synchronize()
            part_ms.append((time.perf_counter() - t_part) * 1e3)
            counts = read_counts()
            check(counts == expected, f"training step {step} t={t}: launches {counts}, "
                  f"expected {expected}")
            for k_, v_ in counts.items():
                totals[k_] += v_
            for n, g in grads.items():
                check(bool(torch.isfinite(g).all()), f"training: non-finite gradient {n}")
            verts_seen.append(n_verts)
            acc = trainer.accumulate(acc, grads)
            del grads
        check(trainer._stage_update(acc), f"training step {step}: the update was skipped")
        trainer.global_step += 1
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t_step) * 1e3)
    peak_bytes = torch.cuda.max_memory_allocated()

    check(trainer.optimizer.total_notfinite == 0, "training: a gradient batch was not finite")
    changed = {n for n, p in trainer.geometry.named_parameters()
               if not torch.equal(p.detach().cpu(), before[n])}
    check(changed <= set(trainer.trainable), "training: a frozen leaf changed: "
          f"{sorted(changed - set(trainer.trainable))[:5]}")
    ups = [n for n in trainer.trainable if n.endswith(".up") or n.endswith(".up.weight")]
    check(len(ups) > 100 and all(n in changed for n in ups),
          f"training: adapter up leaves unchanged: {[n for n in ups if n not in changed][:5]}")
    for n, p in trainer.params_train.items():
        check(bool(torch.isfinite(p).all()), f"training: non-finite parameter {n}")
    del before

    # one more part under the profiler: device-busy ms by stage, and the heaviest device ops
    scalars = trainer.host_scalars()
    latent = torch.randn((TRAIN_PROMPTS, 6, 32, 32, 4), generator=gen, device="cuda")
    with profiler(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        _training_part(trainer, latent, 999, text, scalars, gen, R)
        torch.cuda.synchronize()
    busy_ms, stage_busy_ms, spanned, top = _profile_split(prof, TRAIN_STAGES, top=12)
    check(busy_ms > 0, "the profiler recorded no device time in the training part")
    check(spanned == sorted(TRAIN_STAGES), f"training stages with a device span: {spanned}")
    kernel_busy_ms = {name: sum(e.self_device_time_total for e in prof.key_averages()
                                if symbol in e.key) / 1e3
                      for name, symbol in (("flash_attn_fwd(+stats)", "flash_fwd_kernel"),
                                           ("flash_attn_bwd_dq", "flash_bwd_dq_kernel"),
                                           ("flash_attn_bwd_dkdv", "flash_bwd_dkdv_kernel"),
                                           ("field_grid", "field_grid_kernel"))}
    timed_parts = part_ms[cfg.num_parts_training:]
    timed_steps = step_ms[1:]
    median_part = sorted(timed_parts)[len(timed_parts) // 2]
    emit({"phase": "training", "config": "SD-2.1 student UNet + retrofit VAE (output_dim 64) + "
          "field MLPs, 2 prompts, latents 2x6x32x32x4, R=160, bf16 frozen backbone, f32 "
          "adapters, random weights seed 0, no gradient checkpointing",
          "stand_ins": "seeded vertex cotangent for the rasterizer and teachers, seeded "
          "space-cache cotangent (x1e-3) for the volume branch, seeded text states for the "
          "prompt processor",
          "trainable_leaves": len(trainer.trainable),
          "trainable_params": sum(p.numel() for p in trainer.params_train.values()),
          "build_s": build_s, "steps": TRAIN_STEPS, "parts_per_step": cfg.num_parts_training,
          "warmup_step_ms": step_ms[0], "step_ms": timed_steps, "part_ms": timed_parts,
          "part_ms_median": median_part,
          "part_device_busy_ms": busy_ms,
          "part_device_idle_share": max(0.0, 1.0 - busy_ms / median_part),
          "stage_device_busy_ms": stage_busy_ms, "kernel_device_busy_ms": kernel_busy_ms,
          "top_kernels": top, "launches_per_part": expected, "launches": totals,
          "verts_per_item": verts_seen[-1], "total_notfinite": trainer.optimizer.total_notfinite,
          "changed_leaves": len(changed), "max_memory_allocated_bytes": peak_bytes})
    return totals


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
            r = [x for x in mine if "v1" in x["site"]][0]
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
    serving = phase_pipeline()
    training = phase_training()
    for name, count in {**training, **{k: serving[k] for k in ("flash_attn_fwd", "field_grid")}}.items():
        check(count > 0, f"{name} was launched no time on its main path")
    emit(kernels_line(rows, serving, training))
    print(info["nvidia_smi"], flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": info["kind"],
                                 "count": info["count"]}})
    return 0


if __name__ == "__main__":
    try:
        sys.exit(main())
    except SmokeFailure as e:
        print(f"chip_smoke: FAILED: {e}", file=sys.stderr)
        sys.exit(1)
