"""Each cell's code path at a size the CPU holds: a well-formed result line, `correct`
true on a sound run, false with each fault the cell can have planted in the program,
and false for the control (the reference in fp8 products in the program's place).

These drive the rest of a run and skip only the look for a card; the limits are the
cells' own (``limits/<cell>.json``)."""

import json
import os

import pytest
import torch

from port_bench import calibrate
from port_bench import run as R
from port_bench.lib import cells, compare, serve, train
from port_bench.tests.conftest import tiny_serve, tiny_train

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
SEED = 2 ** 31 + 977
CPU = torch.device("cpu")


def _line(res):
    line = json.loads(R.finish(res))
    assert list(line)[:5] == ["correct", "attempted", "failed", "metrics", "device"]
    assert list(line)[-1] == "checks"
    for v in line["metrics"].values():
        assert set(v) == {"value", "unit"}
    assert line["device"]["count"] == 1
    return line


def _run(cell, trace=False, seconds=0.5):
    return R.run_cell(cell.name, SEED, seconds, trace, "cpu", cell=cell)


@pytest.mark.parametrize("workload", ["serve-b1", "serve-b8"])
def test_serving_run_is_well_formed_and_correct(workload):
    cell = tiny_serve(cells.load(ROOT, workload))
    line = _line(_run(cell))
    assert line["correct"] is True
    names = {m["name"] for m in cell.end_to_end}
    assert set(line["metrics"]) <= names and "setup_s" in line["metrics"]
    traced = _line(_run(cell, trace=True))
    assert "busy_s" in traced["device"] and "breakdown" in traced


def test_serving_answer_altered_where_produced(monkeypatch):
    from triplaneturbo_torch.pipelines.triplaneturbo_text_to_3d import (
        TriplaneTurboTextTo3DPipeline as P,
    )

    orig = P.colorize

    def colorize(self, verts, space_cache_i):
        c = orig(self, verts, space_cache_i).clone()
        c[0] = 1.0 - c[0]
        return c

    monkeypatch.setattr(P, "colorize", colorize)
    assert _line(_run(tiny_serve(cells.load(ROOT, "serve-b1"))))["correct"] is False


def test_serving_half_the_batch_left_out(monkeypatch):
    from triplaneturbo_torch.pipelines.triplaneturbo_text_to_3d import (
        TriplaneTurboTextTo3DPipeline as P,
    )

    orig = P.encode_prompt

    def encode_prompt(self, prompts):
        half = orig(self, prompts[:len(prompts) // 2])
        return torch.cat([half, half])

    monkeypatch.setattr(P, "encode_prompt", encode_prompt)
    assert _line(_run(tiny_serve(cells.load(ROOT, "serve-b8"))))["correct"] is False


def test_serving_control_is_not_correct():
    cell = tiny_serve(cells.load(ROOT, "serve-b1"))
    checks = compare.Checks(compare.load_limits(cells.BENCH_DIR, cell.name))
    serve.run_control(cell.config, serve.Traffic(cell, SEED, CPU), range(2), CPU, SEED, checks)
    assert set(checks.limits) <= set(checks.values) and not checks.correct()


def test_training_run_is_well_formed_and_correct():
    cell = tiny_train(cells.load(ROOT, "train-v1"))
    line = _line(_run(cell))
    assert line["correct"] is True
    assert set(line["metrics"]) == {"setup_s", "step_s"}


def test_training_state_returned_unchanged(monkeypatch):
    from triplaneturbo_torch.systems.trainer import TriplaneTurboTrainer as T

    monkeypatch.setattr(T, "_stage_update", lambda self, grads: False)
    assert _line(_run(tiny_train(cells.load(ROOT, "train-v1"))))["correct"] is False


def test_training_half_the_batch_left_out(monkeypatch):
    from triplaneturbo_torch.systems.trainer import TriplaneTurboTrainer as T

    orig = T._stage_teacher

    def stage_teacher(self, *a, **k):
        losses, grads = orig(self, *a, **k)
        return losses, calibrate.half_batch(grads, self.guidance.cfg.n_view)

    monkeypatch.setattr(T, "_stage_teacher", stage_teacher)
    assert _line(_run(tiny_train(cells.load(ROOT, "train-v1"))))["correct"] is False


def test_training_rgb_teacher_left_out(monkeypatch):
    from triplaneturbo_torch.models.guidance.asd_guidance import ASDGuidance as G

    orig = G.mv_branch

    def mv_branch(self, *a, **k):
        out = dict(orig(self, *a, **k))
        out["loss_asd"] = out["loss_asd"] * 0.0
        return out

    monkeypatch.setattr(G, "mv_branch", mv_branch)
    assert _line(_run(tiny_train(cells.load(ROOT, "train-v1"))))["correct"] is False


def test_training_rgb_images_left_out(monkeypatch):
    from triplaneturbo_torch.systems.trainer import TriplaneTurboTrainer as T

    orig = T._stage_render

    def stage_render(self, *a, **k):
        latent, space_cache, images, rest = orig(self, *a, **k)
        return latent, space_cache, calibrate.drop_first_views(
            images, self.guidance.cfg.n_view), rest

    monkeypatch.setattr(T, "_stage_render", stage_render)
    assert _line(_run(tiny_train(cells.load(ROOT, "train-v1"))))["correct"] is False


def test_training_learning_rate_scaled(monkeypatch):
    from triplaneturbo_torch.systems.optimizers import GuardedAdan

    orig = GuardedAdan.__init__

    def init(self, params, learning_rate=2e-4, *a, **k):
        orig(self, params, learning_rate * calibrate.LR_FAULT, *a, **k)

    monkeypatch.setattr(GuardedAdan, "__init__", init)
    assert _line(_run(tiny_train(cells.load(ROOT, "train-v1"))))["correct"] is False


def test_training_control_is_not_correct():
    cell = tiny_train(cells.load(ROOT, "train-v1"))
    ctl = train.run_reference(cell, SEED, CPU, 1, control=True)
    ref = train.run_reference(cell, SEED, CPU, 1, judge=[ctl.pop("stage")])
    checks = compare.Checks(compare.load_limits(cells.BENCH_DIR, cell.name))
    train.compare_steps(ctl, ref, checks)
    assert set(checks.limits) <= set(checks.values) and not checks.correct()
