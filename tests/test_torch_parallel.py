"""The port's data parallelism (``triplaneturbo_torch/parallel``) on the CPU, gloo backend.

Two ranks run as two processes on this host, each joined to a gloo process group
through the ``torchrun`` environment variables, over the tiny trainer config of
``tests/test_torch_train_step.py`` with a batch of two prompts x four views: every
rank calls ``train_step`` on the whole batch with the same generator and keeps one
prompt. After the step both ranks hold the same parameters bit for bit, and those
equal the one-process step on the whole batch; so does a step of
``python3 -m triplaneturbo_torch.launch --train`` (``launch.main``) under two ranks.
The one-process reference runs as a third process beside the ranks, and all three
are started once for the module. The sharding never splits a prompt's views.

Tolerances (f32, the same code on both sides; the ranks' halves of the batch run
convolutions and sums in other orders than the whole batch does): the metrics 1e-5
relative; the step's gradient of every trainable leaf within 1e-4 of its largest
value; every parameter after the update within 1e-4 of its leaf's largest value, and
where the gradient is under 1e-2 of its leaf's largest (Adan's first step moves an
element by the learning rate times the sign of its gradient, and a rounding-level
gradient's sign is noise) within four learning rates more, as
``tests/test_torch_train_step.py`` holds them.
"""

import os
import socket
import subprocess
import sys

import numpy as np
import pytest
import torch

from triplaneturbo_torch.data.multiview_multiprompt import (
    DataModuleConfig,
    MultiviewMultipromptDataModule,
)
from triplaneturbo_torch.parallel import prompt_block, shard_batch, shard_rows
from triplaneturbo_torch.systems.trainer import TrainerConfig

torch.set_num_threads(2)

TESTS = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(TESTS)
WORLD = 2
REL = 1e-5
LEAF_REL = 1e-4
DATA = dict(batch_size=8, n_view=4, n_steps=2, height=8, width=8, ray_height=8, ray_width=8,
            dim_gaussian=(6, 4, 8, 8))
PROMPTS = {"train": ["a red chair", "a blue teapot", "a green frog"],
           "val": ["a white boat", "a tin robot"], "test": ["a ceramic lion", "a wooden crate"]}


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def step_inputs(seed: int = 0):
    """The port's data module's step-batches of two prompts x four views, and text
    states for the two prompts (the unconditional ones repeated a prompt, as
    ``embeds_for`` gives them)."""
    dm = MultiviewMultipromptDataModule(DataModuleConfig(**DATA), seed=seed)
    batch_list = [{k: v for k, v in b.items() if isinstance(v, np.ndarray)}
                  for b in dm.sample_train_batch()]
    g = torch.Generator().manual_seed(seed)

    def r(*shape):
        return torch.randn(shape, generator=g)

    u21, u15 = r(1, 7, 32).repeat(2, 1, 1), r(1, 7, 32).repeat(2, 1, 1)
    cond = r(2, 7, 32)
    return batch_list, {"cond_local": cond, "cond_21": cond, "uncond_21": u21,
                        "cond_15": r(2, 7, 32), "uncond_15": u15, "global_21": r(2, 32)}


def one_step(cfg):
    """``build_system(cfg)`` and one ``train_step`` on :func:`step_inputs` with the
    generator seeded 42: (parameters, the gradients the update took, metrics)."""
    from triplaneturbo_torch.systems.builder import build_system

    trainer = build_system(cfg, seed=0, device="cpu")
    taken = {}
    step = trainer.optimizer.step

    def record(grads):
        taken.update({n: g.detach().clone() for n, g in zip(trainer.trainable, grads)})
        return step(grads)

    trainer.optimizer.step = record
    batch_list, embeds = step_inputs()
    metrics = trainer.train_step(batch_list, embeds, torch.Generator().manual_seed(42))
    params = {n: p.detach().clone() for n, p in trainer.params_train.items()}
    return params, taken, {k: float(v) for k, v in metrics.items()}


def _launch_params(argv):
    """``launch.main(argv)``: (parameters, the step's gradient: Adan's ``prev_grad``,
    the learning rate)."""
    from triplaneturbo_torch import launch

    trainer = launch.main(argv)
    adan = trainer.optimizer.adan
    return ({n: p.detach().clone() for n, p in trainer.params_train.items()},
            {n: adan.state[p]["prev_grad"].clone() for n, p in trainer.params_train.items()},
            trainer.cfg.learning_rate)


def _launch_argv(tmp_path, trial):
    return ["--config", os.path.join(REPO, "configs", "smoke_tiny.yaml"), "--train",
            "--device", "cpu", "--max-steps", "1", f"trial_dir={tmp_path / trial}",
            f"exp_root_dir={tmp_path / 'exp'}", f"data.prompt_library_dir={tmp_path / 'lib'}",
            "data.prompt_library=tiny", "data.batch_size=8", "trainer.checkpoint_every=1",
            "trainer.val_check_interval=0"]


def _worker(rank: int, spec_path: str) -> None:
    """One process: a rank of the gloo group (``rank`` >= 0), or the one-process
    reference (``rank`` -1, no group). Each runs ``train_step`` on both tiny configs,
    then ``launch.main`` for one step; the result is saved."""
    spec = torch.load(spec_path, weights_only=False)
    torch.set_num_threads(1)
    out = {}
    if rank >= 0:
        from triplaneturbo_torch.parallel import all_reduce_mean, init_data_parallel, replicate

        os.environ.update(RANK=str(rank), LOCAL_RANK=str(rank), WORLD_SIZE=str(WORLD),
                          MASTER_ADDR="127.0.0.1", MASTER_PORT=str(spec["port"]))
        assert init_data_parallel("cpu")[:2] == (rank, WORLD)
        mixed = torch.nn.Linear(2, 2)
        torch.nn.init.constant_(mixed.weight, float(rank))
        out["replicated"] = replicate(mixed).weight.detach().clone()
        out["mean"] = all_reduce_mean({"g": torch.full((3,), float(rank))})["g"]
    out.update({auto_grad: one_step(cfg) for auto_grad, cfg in spec["cfgs"].items()})
    # the launcher keeps a group it did not make
    out["launch"] = _launch_params(_launch_argv(spec["tmp"], "one" if rank < 0 else "two"))
    if rank >= 0:
        torch.distributed.destroy_process_group()
    torch.save(out, os.path.join(spec["tmp"], f"rank{rank}.pt"))


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The two ranks and the one-process reference, run side by side as three
    processes: (each rank's result, the reference's, the directory)."""
    import json

    from test_torch_train_step import tiny_config  # imports JAX: here, not in the workers

    tmp = tmp_path_factory.mktemp("parallel")
    (tmp / "lib").mkdir()
    (tmp / "lib" / "tiny.json").write_text(json.dumps(PROMPTS))
    spec_path = str(tmp / "spec.pt")
    torch.save({"port": _free_port(), "tmp": tmp,
                "cfgs": {auto_grad: tiny_config(auto_grad) for auto_grad in (True, False)}},
               spec_path)
    env = {**os.environ, "PYTHONPATH": os.pathsep.join([REPO, TESTS])}
    code = ("import sys; from test_torch_parallel import _worker; "
            "_worker(int(sys.argv[1]), sys.argv[2])")
    procs = [subprocess.Popen([sys.executable, "-c", code, str(r), spec_path], env=env,
                              cwd=REPO, stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
             for r in (*range(WORLD), -1)]
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=300)[0].decode(errors="replace"))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    for r, p, log in zip((*range(WORLD), -1), procs, logs):
        assert p.returncode == 0, f"process {r} failed:\n{log[-4000:]}"
    ranks = [torch.load(tmp / f"rank{r}.pt", weights_only=False) for r in range(WORLD)]
    return ranks, torch.load(tmp / "rank-1.pt", weights_only=False), tmp


def _assert_params_close(got, want, grads, lr, what):
    for n, w in want.items():
        scale = float(w.abs().max()) or 1.0
        loose = grads[n].abs() < 1e-2 * grads[n].abs().max()
        tol = torch.where(loose, LEAF_REL * scale + 4 * lr, LEAF_REL * scale)
        bad = (got[n] - w).abs() > tol
        assert not bad.any(), f"{what}: {n}, {int(bad.sum())} elements"


def test_without_a_process_group_nothing_is_reduced():
    from triplaneturbo_torch.parallel import all_reduce_mean, replicate

    g = {"a": torch.ones(2)}
    assert all_reduce_mean(g) is g and g["a"].tolist() == [1.0, 1.0]
    m = torch.nn.Linear(2, 2)
    assert replicate(m) is m


def test_shards_keep_whole_prompts():
    """Rank r of 2 takes prompts [r] of 2 with each prompt's four views, rays and draws;
    the shards put back together are the batch; stacked renderers shard each half; a
    tensor shared by the prompts stays whole; an uneven split raises."""
    batch_list, embeds = step_inputs()
    batch = MultiviewMultipromptDataModule.to_device(batch_list[0], "cpu")
    batch["prompt"] = ["a red chair", "a blue teapot"]
    views_of = torch.arange(8) // 4  # the prompt each view belongs to
    for rank in range(WORLD):
        s = shard_batch({**batch, "owner": views_of}, rank, WORLD, 2)
        assert s["prompt"] == [batch["prompt"][rank]]
        assert s["owner"].tolist() == [rank] * 4
        for k, v in batch.items():
            if isinstance(v, torch.Tensor) and v.shape[0] == 8:
                assert torch.equal(s[k], v[4 * rank:4 * rank + 4]), k
        assert torch.equal(shard_batch(embeds, rank, WORLD, 2)["cond_15"],
                           embeds["cond_15"][rank:rank + 1])
    rows = torch.arange(2 * 2 * 3).reshape(12, 1)  # [renderer][prompt][3 rows]
    assert shard_rows(rows, 1, WORLD, 2, halves=2)[:, 0].tolist() == [3, 4, 5, 9, 10, 11]
    shared = torch.ones(3, 5)
    assert shard_rows(shared, 1, WORLD, 2) is shared
    assert prompt_block(4, 1, 2) == slice(2, 4)
    with pytest.raises(ValueError, match="do not split"):
        shard_batch(batch, 0, 3, 2)


def test_two_gloo_ranks_take_the_one_process_step(runs):
    ranks, one, _ = runs
    for r in ranks:  # replicate broadcasts rank 0's; all_reduce_mean averages
        assert float(r["replicated"].abs().max()) == 0.0
        assert r["mean"].tolist() == [0.5] * 3
    for auto_grad in (True, False):
        params, grads, metrics = one[auto_grad]
        mine = [r[auto_grad] for r in ranks]
        for n in params:  # the ranks in lockstep
            assert torch.equal(mine[0][0][n], mine[1][0][n]), n
            assert torch.equal(mine[0][1][n], mine[1][1][n]), n
        assert mine[0][2] == mine[1][2]
        for k, v in metrics.items():
            np.testing.assert_allclose(mine[0][2][k], v, rtol=REL, atol=0,
                                       err_msg=f"auto_grad={auto_grad}: {k}")
        for n, g in grads.items():
            err = float((mine[0][1][n] - g).abs().max())
            assert err <= LEAF_REL * (float(g.abs().max()) or 1.0), (auto_grad, n, err)
        _assert_params_close(mine[0][0], params, grads, TrainerConfig.learning_rate,
                             f"auto_grad={auto_grad}")


def test_launcher_under_two_gloo_ranks(runs):
    import json

    ranks, one, tmp = runs
    params, grads, lr = one["launch"]
    two = [r["launch"][0] for r in ranks]
    for n in params:
        assert torch.equal(two[0][n], two[1][n]), n
    for n, g in grads.items():
        err = float((ranks[0]["launch"][1][n] - g).abs().max())
        assert err <= LEAF_REL * (float(g.abs().max()) or 1.0), (n, err)
    _assert_params_close(two[0], params, grads, lr, "launcher")
    assert (tmp / "two" / "ckpt_000001" / "geometry.pt").exists()
    with open(tmp / "two" / "metrics.jsonl") as f:
        two_metrics = [json.loads(ln) for ln in f]
    with open(tmp / "one" / "metrics.jsonl") as f:
        one_metrics = [json.loads(ln) for ln in f]
    assert len(two_metrics) == len(one_metrics) == 1
    np.testing.assert_allclose(two_metrics[0]["loss"], one_metrics[0]["loss"], rtol=REL)
