"""A cell of ``BENCHMARK.json`` and the files it names.

Everything that belongs to one configuration, one traffic mix or one per-layer metric
is a file of its own, found by the name ``BENCHMARK.json`` gives it:

* ``configs``: the entry's ``file`` (a JSON object: the sizes as they are run);
* ``traffic/<traffic>.json``: the mix's parameters, whose ``runner`` names the general
  generator that reads them (``serve`` or ``train``, ``lib/<runner>.py``);
* ``metrics/<metric>.py``: the reader of one per-layer metric (``read(ctx)``, None
  where it finds nothing to read; ``RANGES``, the program ranges it reads);
* ``limits/<workload>.json``: the limits of the cell's correctness check;
* ``held_out/<workload>.json``: the entries of a cell kept out of ``BENCHMARK.json``.
"""

from __future__ import annotations

import importlib.util
import json
import os
from dataclasses import dataclass, field
from typing import Any, Dict, List

BENCH_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@dataclass
class Cell:
    name: str
    config_name: str
    traffic_name: str
    chips: int
    config: Dict[str, Any]
    traffic: Dict[str, Any]
    end_to_end: List[Dict[str, Any]]
    per_layer: List[Dict[str, Any]]
    readers: Dict[str, Any] = field(default_factory=dict)

    @property
    def runner(self) -> str:
        return self.traffic["runner"]


def _applies(metric: Dict[str, Any], cell: str, reported: List[str]) -> bool:
    if "workloads" in metric:
        return cell in metric["workloads"]
    return metric.get("moves") is None or metric["moves"] in reported


def load_reader(name: str):
    path = os.path.join(BENCH_DIR, "metrics", f"{name}.py")
    spec = importlib.util.spec_from_file_location(f"port_bench_metric_{len(name)}_{abs(hash(name))}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def load(root: str, workload: str) -> Cell:
    """The cell ``workload`` of ``BENCHMARK.json``, or of ``held_out/<workload>.json`` (a
    cell's entries kept out of ``BENCHMARK.json`` until the program is fixed; PERF.md)."""
    with open(os.path.join(root, "BENCHMARK.json")) as f:
        bench = json.load(f)
    held = os.path.join(BENCH_DIR, "held_out", f"{workload}.json")
    if workload not in {w["name"] for w in bench["workloads"]} and os.path.exists(held):
        with open(held) as f:
            extra = json.load(f)
        bench = {k: bench[k] + extra.get(k, []) if isinstance(bench[k], list) else bench[k]
                 for k in bench}
    cells = {w["name"]: w for w in bench["workloads"]}
    if workload not in cells:
        raise KeyError(f"no workload {workload!r} in BENCHMARK.json (have {sorted(cells)})")
    w = cells[workload]
    cfg_entry = {c["name"]: c for c in bench["configs"]}[w["config"]]
    with open(os.path.join(root, cfg_entry["file"])) as f:
        config = json.load(f)
    with open(os.path.join(BENCH_DIR, "traffic", f"{w['traffic']}.json")) as f:
        traffic = json.load(f)
    e2e = [m for m in bench["end_to_end"] if _applies(m, workload, [])]
    reported = [m["name"] for m in e2e]
    per_layer = [m for m in bench["per_layer"] if _applies(m, workload, reported)]
    return Cell(name=workload, config_name=w["config"], traffic_name=w["traffic"],
                chips=int(w["chips"]), config=config, traffic=traffic, end_to_end=e2e,
                per_layer=per_layer,
                readers={m["name"]: load_reader(m["name"]) for m in per_layer})
