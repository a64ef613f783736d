"""Time the field-grid kernel (``csrc/field_grid.cu``) against another version of it on one GPU.

    python3 triplaneturbo_torch/tools/compare_field_grid.py --baseline OTHER/field_grid.cu [--rounds 3]

Builds the source as it is and the baseline, both ``nvcc`` processes at once,
and prints each one's ``-Xptxas -v`` lines. Each library is held against the
plain PyTorch field (1e-4 absolute) and the split-TF32 emulation (2e-6) at
R = 160 (C = 32, v1 and v2), then timed with CUDA events around direct calls of
its C entry point, in the order current, baseline, baseline, current every
round, so that a drift of the card's clock weighs on both alike. One JSON line
a (library, case, round); the last line has each library's mean and spread
(largest less smallest round) per case.
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
ITERS = 20  # timed calls a (library, case, round)
R, C = 160, 32
sys.path.insert(0, str(REPO))


def build(variants, out_dir):
    """variants: name -> source. Returns (name -> CDLL, name -> ptxas lines)."""
    from triplaneturbo_torch.ops import _build

    procs = {}
    for name, src in variants.items():
        target = Path(out_dir) / f"{name}.so"
        cmd = [_build._nvcc(), *_build.NVCC_FLAGS, "-I", str(_build.CSRC_DIR), "-o", str(target),
               str(src)]
        procs[name] = (target, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                                stderr=subprocess.STDOUT, text=True))
    libs, reports = {}, {}
    for name, (target, proc) in procs.items():
        out, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"{name}: nvcc exited {proc.returncode}\n{out}")
        reports[name] = [ln.strip() for ln in out.splitlines() if "Used" in ln or "spill" in ln]
        fn = ctypes.CDLL(str(target)).field_grid_fwd
        fn.argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_int, ctypes.c_float, ctypes.c_float,
                                               ctypes.c_void_p]
        fn.restype = ctypes.c_int
        libs[name] = fn
    return libs, reports


def main() -> int:
    import torch
    from triplaneturbo_torch.ops import field_grid as fg

    ap = argparse.ArgumentParser()
    ap.add_argument("--baseline", required=True, help="another version of field_grid.cu")
    ap.add_argument("--rounds", type=int, default=3)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("compare_field_grid: needs one NVIDIA GPU", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    src = REPO / "triplaneturbo_torch" / "csrc" / "field_grid.cu"
    with tempfile.TemporaryDirectory() as tmp:
        libs, reports = build({"current": src, "baseline": Path(args.baseline)}, tmp)
        print(json.dumps({"card": smi, "ptxas": reports}), flush=True)
        stream = torch.cuda.current_stream().cuda_stream
        gen = torch.Generator(device="cuda").manual_seed(0)
        times = {}
        for concat in (False, True):
            case = "v2 concat" if concat else "v1 sum"
            cin = 3 * C if concat else C
            m = [torch.randn(R, R, C, device="cuda", generator=gen) * 0.3 for _ in range(3)]
            ws = [torch.randn(*s, device="cuda", generator=gen) * 0.1
                  for s in ((cin, 64), (64, 64), (64, 1), (cin, 64), (64, 64), (64, 3))]
            ref = fg.field_grid_reference(*m, *ws, 1.0, 0.5, concat)
            prepped = fg._prep(m[0], m[1], m[2], ws[0], ws[3], ws[1], ws[4], ws[2], ws[5], concat)
            emu = fg.field_grid_split_tf32_reference(*prepped, 1.0, 0.5)
            sdf = torch.empty(R, R, R, device="cuda")
            deform = torch.empty(3, R, R, R, device="cuda")
            call_args = (*(t.data_ptr() for t in prepped), sdf.data_ptr(), deform.data_ptr(), R,
                         1.0, 0.5, stream)
            for name, fn in libs.items():
                sdf.zero_()
                deform.zero_()
                if fn(*call_args):
                    raise RuntimeError(f"{name}: launch failed")
                torch.cuda.synchronize()
                err = max((sdf - ref[0]).abs().max().item(), (deform - ref[1]).abs().max().item())
                emu_err = max((sdf - emu[0]).abs().max().item(),
                              (deform - emu[1]).abs().max().item())
                print(json.dumps({"lib": name, "case": case, "max_abs_err": err,
                                  "split_emulation_err": emu_err}), flush=True)
                if not (err <= 1e-4 and emu_err <= 2e-6):
                    return 1
            for rnd in range(args.rounds):
                for name in ("current", "baseline", "baseline", "current"):
                    fn = libs[name]
                    for _ in range(3):
                        fn(*call_args)
                    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
                    start.record()
                    for _ in range(ITERS):
                        fn(*call_args)
                    end.record()
                    torch.cuda.synchronize()
                    ms = start.elapsed_time(end) / ITERS
                    times.setdefault((name, case), {}).setdefault(rnd, []).append(ms)
                    print(json.dumps({"lib": name, "case": case, "round": rnd, "ms": ms}),
                          flush=True)
        summary = {}
        for (name, case), by_round in times.items():
            means = [sum(v) / len(v) for v in by_round.values()]
            summary.setdefault(case, {})[name] = {"ms": sum(means) / len(means),
                                                  "spread_ms": max(means) - min(means)}
        print(json.dumps({"summary": summary, "R": R, "C": C, "card": smi}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
