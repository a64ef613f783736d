"""BENCHMARK.json against the contract the harness is built to, and every file it names."""

import json
import os
import re

import pytest

from port_bench.lib import cells

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")


@pytest.fixture(scope="module", params=["benchmark", "with_held_out"])
def bench(request):
    """BENCHMARK.json, and BENCHMARK.json with the held-out cells' entries added, which
    have to meet the same rules."""
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        b = json.load(f)
    if request.param == "with_held_out":
        held = os.path.join(cells.BENCH_DIR, "held_out")
        for name in sorted(os.listdir(held)):
            with open(os.path.join(held, name)) as f:
                extra = json.load(f)
            b = {k: b[k] + extra.get(k, []) if isinstance(b[k], list) else b[k] for k in b}
    return b


def test_keys_and_sizes(bench):
    assert set(bench) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert os.path.getsize(os.path.join(ROOT, "BENCHMARK.json")) <= 64 * 1024
    assert 1 <= bench["run_seconds"] <= 51
    cells_max = 24
    total = (2 + 14 * cells_max) * (bench["run_seconds"] + 60) + cells_max * 180 + 1200
    assert total <= 43200
    assert bench["command"] == ["python3", "port_bench/run.py"]


def test_names_units_and_lines(bench):
    names = []
    for c in bench["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and c["file"].startswith("port_bench/")
        names.append(c["name"])
    for w in bench["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["name"]) and NAME.match(w["traffic"]) and w["chips"] in (1, 4)
        assert len(w["why"]) <= 200 and "\n" not in w["why"] and "\t" not in w["why"]
    for m in bench["end_to_end"] + bench["per_layer"]:
        assert NAME.match(m["name"]), m["name"]
        assert UNIT.match(m["unit"]), m["unit"]
        assert m["better"] in ("lower", "higher")
    for m in bench["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in bench["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer", "moves", "workloads"}
        assert m["moves"] in {e["name"] for e in bench["end_to_end"]}
        if "roofline" in m["name"] or "mfu" in m["name"]:
            assert m["unit"] == "%"
    all_names = [m["name"] for m in bench["end_to_end"] + bench["per_layer"]]
    assert len(set(all_names)) == len(all_names)
    assert len(set(names)) == len(names)


def test_lines_are_short_and_plain(bench):
    lines = [c["source"] for c in bench["configs"]] + [c["why"] for c in bench["configs"]]
    lines += [w["why"] for w in bench["workloads"]] + [m["layer"] for m in bench["per_layer"]]
    lines += bench["command"]
    for text in lines:
        assert 1 <= len(text) <= 200 and "\n" not in text and "\t" not in text, text
    for c in bench["configs"]:
        assert len(c["reduced"]) <= 16 and all(NAME.match(k) for k in c["reduced"])


def test_every_cell_resolves_its_files(bench):
    for w in bench["workloads"]:
        cell = cells.load(ROOT, w["name"])
        assert cell.runner in ("serve", "train")
        assert os.path.exists(os.path.join(cells.BENCH_DIR, "limits", f"{w['name']}.json"))
        e2e = {m["name"] for m in cell.end_to_end}
        assert "setup_s" in e2e and len(e2e) >= 2
        assert cell.per_layer
        for m in cell.per_layer:
            assert callable(cell.readers[m["name"]].read)
            assert m["moves"] in e2e


def test_configs_are_used_and_state_their_reductions(bench):
    used = {w["config"] for w in bench["workloads"]}
    for c in bench["configs"]:
        assert c["name"] in used
        with open(os.path.join(ROOT, c["file"])) as f:
            cfg = json.load(f)
        assert cfg["reduced"] == c["reduced"] and cfg["source"] == c["source"]
