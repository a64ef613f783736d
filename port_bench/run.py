"""One run of one cell of the benchmark of ``triplaneturbo_torch`` on NVIDIA GPUs.

    python3 port_bench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Set-up (the program and the benchmark's weights from the seed, the cell's own shapes
warmed up), a window of ``--seconds``, then the check of what the window produced
against the plain reference (``port_bench/reference``). The last line of standard
output is the result, one JSON object; the numbers compared, each beside its limit,
are the last lines of standard error and the last key of the result. Without a CUDA
device, with fewer devices than the cell asks for, without the program, or with any
module of JAX or of the JAX package loaded, it prints no result and exits non-zero.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import importlib  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
# kernel caches at fixed places inside the checkout: only a checkout's first run builds
os.environ["TRITON_CACHE_DIR"] = os.path.join(HERE, ".cache", "triton")
os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(HERE, ".cache", "torch_extensions")
os.environ.setdefault("USE_FLAX", "0")
os.environ.setdefault("USE_JAX", "0")
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)


def run_cell(workload: str, seed: int, seconds: float, trace: bool, device_name: str = "cuda",
             root: str = ROOT, cell=None, limits=None):
    """The result dict of one run (``checks`` still a :class:`~lib.compare.Checks`)."""
    import torch

    from port_bench.lib import cells

    cell = cell or cells.load(root, workload)
    runner = importlib.import_module(f"port_bench.lib.{cell.runner}")
    device = torch.device(device_name)
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    return runner.run(cell, seed, seconds, trace, device, T_START, limits=limits)


def finish(result) -> str:
    """The result line: the keys every result carries, ``device`` with the trace's two numbers, and
    the numbers compared as the last key."""
    checks = result.pop("checks")
    device = dict(result["device"])
    device.update(result.pop("device_extra", {}))
    line = {"correct": bool(result["correct"]), "attempted": int(result["attempted"]),
            "failed": int(result["failed"]), "metrics": result["metrics"], "device": device}
    if "breakdown" in result:
        line["breakdown"] = result["breakdown"]
    line["checks"] = checks.table()
    return json.dumps(line)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    if importlib.util.find_spec("triplaneturbo_torch") is None:
        print("port_bench: the program (triplaneturbo_torch) is not in this checkout",
              file=sys.stderr)
        return 5
    import torch

    from port_bench.lib import cells
    from port_bench.lib.guard import forbidden_modules

    cell = cells.load(ROOT, args.workload)
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        print(f"port_bench: {args.workload} needs {cell.chips} CUDA device(s); "
              f"torch.cuda.is_available()={torch.cuda.is_available()}, "
              f"device_count={torch.cuda.device_count()}", file=sys.stderr)
        return 3
    from port_bench.lib.common import power_limit

    print(f"port_bench: card {power_limit()}", file=sys.stderr, flush=True)
    result = run_cell(args.workload, args.seed, args.seconds, bool(args.trace), "cuda",
                      cell=cell)
    found = forbidden_modules()
    if found:
        print(f"port_bench: the process holds modules of JAX or of the JAX package: {found}",
              file=sys.stderr)
        return 4
    result["checks"].print_lines()
    print(finish(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
