"""Time tilings of the bf16 flash-attention backward (``csrc/flash_attn_bwd.cu``) on one GPU.

    python3 triplaneturbo_torch/tools/tune_flash_bwd.py [--baseline OTHER/flash_attn_bwd.cu]

Builds the source once per tiling of its D = 64 tensor-core kernels (the
``FLASH_BWD_DQ_*`` and ``FLASH_BWD_DKDV_*`` macros: warpgroups a CTA, rows of
the streamed side a tile, CTAs an SM the register budget is set for), all
``nvcc`` processes at once, once as it is, and with ``--baseline`` one more
library from another version of the source. Every library's dq and dk/dv are
held against the plain PyTorch backward and timed at the training attention
shapes (two prompts; the D = 512 site takes no tiling macro and shows the
build's spread) with CUDA events around direct calls of the C entry points
into preallocated outputs, so that the wrapper's Python is not in the time.
One JSON line a (library, shape); the last line names the fastest tiling of
each kernel per shape. The tiling the source defaults to was chosen from this
output.
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
ITERS = 20  # timed calls a (library, shape, kernel)
sys.path.insert(0, str(REPO))

# dq (warpgroups a CTA, keys a tile, CTAs an SM) x dk/dv (warpgroups a CTA, queries a
# tile, CTAs an SM), built into one library each
TILINGS = [((1, 64, 3), (1, 64, 2)), ((1, 64, 4), (1, 64, 3)), ((1, 64, 2), (1, 64, 1)),
           ((2, 64, 1), (2, 64, 1)), ((2, 64, 2), (2, 64, 2)), ((1, 128, 2), (1, 128, 1)),
           ((2, 128, 1), (2, 128, 1))]
# (BH, L, Lk, D): the training sites at two prompts
SHAPES = [(10, 6144, 6144, 64), (20, 1536, 1536, 64), (40, 384, 384, 64), (60, 1024, 77, 64),
          (120, 256, 77, 64), (12, 1024, 1024, 512)]


def _flags(dq, dkdv):
    (qn, qb, qm), (kn, kb, km) = dq, dkdv
    return [f"-DFLASH_BWD_DQ_NWG={qn}", f"-DFLASH_BWD_DQ_BK={qb}", f"-DFLASH_BWD_DQ_MIN_CTAS={qm}",
            f"-DFLASH_BWD_DKDV_NWG={kn}", f"-DFLASH_BWD_DKDV_BQ={kb}",
            f"-DFLASH_BWD_DKDV_MIN_CTAS={km}"]


def _time(fn, call_args):
    import torch

    for _ in range(3):
        fn(*call_args)
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    for _ in range(ITERS):
        fn(*call_args)
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / ITERS


def main() -> int:
    import torch
    from triplaneturbo_torch.ops import flash_attention as fa
    from triplaneturbo_torch.tools.tune_flash_fwd import build

    ap = argparse.ArgumentParser()
    ap.add_argument("--baseline", default=None, help="another version of flash_attn_bwd.cu")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("tune_flash_bwd: needs one NVIDIA GPU", file=sys.stderr)
        return 2
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    src = REPO / "triplaneturbo_torch" / "csrc" / "flash_attn_bwd.cu"
    variants = {"dq{}x{}min{}_dkdv{}x{}min{}".format(*dq, *dkdv): (src, _flags(dq, dkdv))
                for dq, dkdv in TILINGS}
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
            q, k, v, g = (torch.randn(BH, n, D, device="cuda", generator=gen).bfloat16()
                          for n in (L, Lk, Lk, L))
            o, lse = fa._launch(q, k, v, return_stats=True)
            delta = fa.flash_delta(o, g)
            qf, kf, vf = q.float(), k.float(), v.float()
            o_ref, lse_ref = fa.flash_attention_reference(qf, kf, vf, return_stats=True)
            refs = fa.flash_attention_bwd_reference(qf, kf, vf, o_ref, lse_ref, g.float())
            del qf, kf, vf, o_ref, lse_ref
            dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
            ptrs = [t.data_ptr() for t in (q, k, v, g, lse, delta)]
            ints = [BH, L, Lk, D, 1]
            for name, lib in libs.items():
                fq, fkv = lib.flash_attn_bwd_dq, lib.flash_attn_bwd_dkdv
                fq.argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 5 + [ctypes.c_void_p]
                fkv.argtypes = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 5 + [ctypes.c_void_p]
                fq.restype = fkv.restype = ctypes.c_int
                dq_args = (*ptrs, dq.data_ptr(), *ints, stream)
                dkdv_args = (*ptrs, dk.data_ptr(), dv.data_ptr(), *ints, stream)
                for t in (dq, dk, dv):
                    t.zero_()
                err = fq(*dq_args) or fkv(*dkdv_args)
                torch.cuda.synchronize()
                if err:
                    raise RuntimeError(f"{name}: CUDA error {err}")
                errs = {n: (got.float() - ref).abs().max().item() / ref.abs().max().item()
                        for n, got, ref in zip(("dq", "dk", "dv"), (dq, dk, dv), refs)}
                ok = all(e <= 1e-2 for e in errs.values())
                ms = {"dq": _time(fq, dq_args), "dkdv": _time(fkv, dkdv_args)}
                print(json.dumps({"lib": name, "shape": [BH, L, Lk, D], "ms": ms, "ok": ok,
                                  "rel_err": errs}), flush=True)
                if not ok:
                    return 1
                key = f"{BH}x{L}x{Lk}x{D}"
                if name in ("baseline", "default"):
                    continue
                for kernel, t in ms.items():
                    if t < best.get((key, kernel), ("", float("inf")))[1]:
                        best[(key, kernel)] = (name, t)
            del refs
            torch.cuda.empty_cache()
        print(json.dumps({"best": {f"{k} {kern}": v for (k, kern), v in best.items()},
                          "card": smi}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
