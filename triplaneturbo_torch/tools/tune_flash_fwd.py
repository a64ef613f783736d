"""Time tilings of the bf16 flash-attention forward (``csrc/flash_attn_fwd.cu``) on one GPU.

    python3 triplaneturbo_torch/tools/tune_flash_fwd.py [--baseline OTHER/flash_attn_fwd.cu]

Builds the source once per tiling of its D = 64 tensor-core kernel (the
``FLASH_D64_*`` macros: warpgroups a CTA, keys a tile, CTAs an SM the register
budget is set for), all ``nvcc`` processes at once, once as it is (it picks
the CTA size by the grid), and with ``--baseline`` one more library from
another version of the source. Every library is held against
the plain PyTorch version and timed at the main path's attention shapes with
CUDA events around direct calls of its C entry point into preallocated outputs,
so that the wrapper's Python is not in the time. One JSON line a (library,
shape); the last line names the fastest tiling per shape. The tiling the source
defaults to was chosen from this output.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import subprocess
import sys
import tempfile
from pathlib import Path

REPO = Path(__file__).resolve().parents[2]
ITERS = 50  # timed calls a (library, shape)
sys.path.insert(0, str(REPO))

# (warpgroups a CTA, keys a tile, CTAs an SM for the register budget)
TILINGS = [(2, 128, 1), (2, 128, 2), (2, 64, 2), (2, 64, 3), (1, 128, 2), (1, 128, 3), (1, 64, 4)]
# (BH, L, Lk, D): serving sites at one prompt, the joint site at two, the VAE site
SHAPES = [(5, 6144, 6144, 64), (10, 6144, 6144, 64), (10, 1536, 1536, 64), (20, 384, 384, 64),
          (30, 1024, 77, 64), (60, 256, 77, 64), (6, 1024, 1024, 512)]


def build(variants, out_dir):
    """variants: name -> (source, extra nvcc flags). Returns name -> CDLL."""
    from triplaneturbo_torch.ops import _build

    procs = {}
    for name, (src, flags) in variants.items():
        target = Path(out_dir) / f"{name}.so"
        cmd = [_build._nvcc(), *_build.NVCC_FLAGS, *flags, "-o", str(target), str(src)]
        procs[name] = (target, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                                stderr=subprocess.STDOUT, text=True))
    libs, reports = {}, {}
    for name, (target, proc) in procs.items():
        out, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"{name}: nvcc exited {proc.returncode}\n{out}")
        reports[name] = [ln.strip() for ln in out.splitlines()
                         if "Used" in ln or "spill" in ln or "wgmma_d64" in ln and "Compiling" in ln]
        libs[name] = ctypes.CDLL(str(target))
    return libs, reports


def main() -> int:
    import torch
    from triplaneturbo_torch.ops import flash_attention as fa

    ap = argparse.ArgumentParser()
    ap.add_argument("--baseline", default=None, help="another version of flash_attn_fwd.cu")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("tune_flash_fwd: needs one NVIDIA GPU", file=sys.stderr)
        return 2
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    src = REPO / "triplaneturbo_torch" / "csrc" / "flash_attn_fwd.cu"
    # one tiling at every grid size, and the source as it is (it picks by grid size)
    variants = {f"nwg{n}_bk{b}_min{m}": (src, [f"-DFLASH_D64_NWG={n}", f"-DFLASH_D64_BK={b}",
                                              f"-DFLASH_D64_MIN_CTAS={m}",
                                              f"-DFLASH_D64_SMALL_GRID_NWG={n}"])
                for n, b, m in TILINGS}
    variants["default"] = (src, [])
    if args.baseline:
        variants["baseline"] = (Path(args.baseline), [])
    with tempfile.TemporaryDirectory() as tmp:
        libs, reports = build(variants, tmp)
        print(json.dumps({"card": smi, "ptxas": reports}), flush=True)
        stream = torch.cuda.current_stream().cuda_stream
        gen = torch.Generator(device="cuda").manual_seed(0)
        best = {}
        for BH, L, Lk, D in SHAPES:
            q, k, v = (torch.randn(BH, n, D, device="cuda", generator=gen).bfloat16()
                       for n in (L, Lk, Lk))
            ref, lse_ref = fa.flash_attention_reference(q.float(), k.float(), v.float(),
                                                        return_stats=True)
            out = torch.empty_like(q)
            lse = torch.empty(BH, L, device="cuda")
            for name, lib in libs.items():
                fn = lib.flash_attn_fwd_stats
                fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 5 + [ctypes.c_void_p]
                fn.restype = ctypes.c_int
                call_args = (q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                             lse.data_ptr(), BH, L, Lk, D, 1, stream)
                out.zero_()
                err = fn(*call_args)
                torch.cuda.synchronize()
                if err:
                    raise RuntimeError(f"{name}: CUDA error {err}")
                o_err = (out.float() - ref).abs().max().item()
                lse_err = (lse - lse_ref).abs().max().item()
                ok = o_err <= 1e-2 * ref.abs().max().item() and lse_err <= 1e-4
                for _ in range(3):
                    fn(*call_args)
                start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
                start.record()
                for _ in range(ITERS):
                    fn(*call_args)
                end.record()
                torch.cuda.synchronize()
                ms = start.elapsed_time(end) / ITERS
                print(json.dumps({"lib": name, "shape": [BH, L, Lk, D], "ms": ms, "ok": ok,
                                  "o_err": o_err, "lse_err": lse_err}), flush=True)
                if not ok:
                    return 1
                key = f"{BH}x{L}x{Lk}x{D}"
                if name not in ("baseline", "default") and (key not in best or ms < best[key][1]):
                    best[key] = (name, ms)
        print(json.dumps({"best": best, "card": smi}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
