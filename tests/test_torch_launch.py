"""The port's launcher and system builder on the CPU (``configs/smoke_tiny.yaml``).

``python3 -m triplaneturbo_torch.launch`` is driven through ``main(argv)`` with
``--device cpu``, a temporary trial directory and a prompt library of two prompts a
split: ``--train`` writes the config snapshot, the metrics and the checkpoints;
``--resume`` restores the train state bit for bit, and a run of 2 steps resumed for a
third takes the steps of an uninterrupted run of 3; ``--validate`` and ``--export``
write their images and meshes from the trained weights (``system.weights`` or
``--resume``). Without a card and without ``--device`` it raises,
as it does with ``WORLD_SIZE`` > 1. ``build_system`` sizes every module from the
config.
"""

import glob
import json
import os

import numpy as np
import pytest
import torch

from triplaneturbo_torch import launch
from triplaneturbo_torch.systems.builder import build_system
from triplaneturbo_torch.utils.checkpoint import load_train_state, save_train_state
from triplaneturbo_torch.utils.config import load_config

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONFIG = os.path.join(REPO, "configs", "smoke_tiny.yaml")
PROMPTS = {"train": ["a red chair", "a blue teapot"], "val": ["a green frog", "a white boat"],
           "test": ["a ceramic lion", "a wooden crate"]}


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    """``main`` with the tiny config, the temporary trial directory and library."""
    root = tmp_path_factory.mktemp("launch")
    lib = root / "lib"
    lib.mkdir()
    (lib / "tiny.json").write_text(json.dumps(PROMPTS))
    trial = str(root / "trial")

    def main(*args, **overrides):
        extras = {"trial_dir": trial, "exp_root_dir": str(root / "exp"),
                  "data.prompt_library_dir": str(lib), "data.prompt_library": "tiny",
                  "trainer.checkpoint_every": 1, "trainer.val_check_interval": 0,
                  "system.exporter.isosurface_resolution": 24, "data.n_val_views": 3,
                  **overrides}
        return launch.main(["--config", CONFIG, "--device", "cpu", *args,
                            *[f"{k}={v}" for k, v in extras.items()]])

    trainer = main("--train", "--max-steps", "2")
    return main, trial, trainer


def _train_state(trainer):
    opt = trainer.optimizer
    return ({n: p.detach().clone() for n, p in trainer.params_train.items()},
            {i: {k: v.clone() for k, v in opt.adan.state[p].items()}
             for i, p in enumerate(opt.params) if p in opt.adan.state},
            (opt.adan.count, opt.mini_step, opt.notfinite_count, opt.total_notfinite,
             trainer.global_step))


def _assert_state_equal(a, b):
    assert a[2] == b[2]
    assert set(a[0]) == set(b[0]) and all(torch.equal(a[0][n], b[0][n]) for n in a[0])
    assert set(a[1]) == set(b[1])
    for i in a[1]:
        assert set(a[1][i]) == set(b[1][i]) == {"m", "v", "n", "prev_grad"}
        assert all(torch.equal(a[1][i][k], b[1][i][k]) for k in a[1][i])


def test_train_writes_snapshots_metrics_and_checkpoints(run):
    _, trial, trainer = run
    assert trainer.global_step == 2 and trainer.cfg.auto_grad is False
    for name in ("parsed.yaml", "raw.yaml", "cmd.txt"):
        assert os.path.getsize(os.path.join(trial, "configs", name)) > 0
    with open(os.path.join(trial, "configs", "cmd.txt")) as f:
        cmd = f.read()
    assert "triplaneturbo_torch.launch" in cmd and "--train" in cmd
    with open(os.path.join(trial, "configs", "parsed.yaml")) as f:
        parsed = json.load(f)
    assert parsed["trial_dir"] == trial and parsed["trainer"]["checkpoint_every"] == 1
    with open(os.path.join(trial, "metrics.jsonl")) as f:
        lines = [json.loads(ln) for ln in f]
    assert [ln["step"] for ln in lines] == [0, 1]
    for ln in lines:
        for k in ("loss", "fidelity", "regularization", "grad_norm", "fidelity_0",
                  "regularization_1", "grad_norm_1", "skipped_nonfinite"):
            assert np.isfinite(ln[k]), (k, ln)
    for step in (1, 2):
        ckpt = os.path.join(trial, f"ckpt_{step:06d}")
        assert os.path.getsize(os.path.join(ckpt, "geometry.pt")) > 0
        assert os.path.getsize(os.path.join(ckpt, "train_state.pt")) > 0
    assert os.path.exists(os.path.join(trial, "last", "geometry.pt"))
    assert os.path.exists(os.path.join(trial, "progress.txt"))
    geo = torch.load(os.path.join(trial, "last", "geometry.pt"), weights_only=True)
    assert all(torch.equal(geo[n], p) for n, p in trainer.geometry.state_dict().items())


def test_resume_restores_the_train_state_bit_equal(run, tmp_path):
    main, trial, trainer = run
    saved = _train_state(trainer)
    # the state of step 2 into a file and back into a fresh trainer: bit-equal
    path = save_train_state(str(tmp_path / "state"), trainer)
    fresh = build_system(load_config(CONFIG), seed=0, device="cpu")
    assert load_train_state(str(tmp_path / "state"), fresh) == 2 and path.endswith(".pt")
    _assert_state_equal(_train_state(fresh), saved)
    # --resume from the checkpoint directory, and no step left to take
    resumed = main("--train", "--max-steps", "2", "--resume",
                   os.path.join(trial, "ckpt_000002"))
    _assert_state_equal(_train_state(resumed), saved)
    # --resume from the newest checkpoint (found through LAST) and one more step
    resumed = main("--train", "--max-steps", "3", "--resume",
                   os.path.join(trial, "ckpt_LAST"), **{"trial_dir": str(tmp_path / "t2")})
    assert resumed.global_step == 3 and resumed.optimizer.adan.count == 3
    with pytest.raises(ValueError, match="does not match"):
        del fresh.params_train["renderer.variance_inv_std"]
        load_train_state(path, fresh)


def _metrics(trial):
    """Each logged step's metrics, without the wall-clock time."""
    with open(os.path.join(trial, "metrics.jsonl")) as f:
        return [{k: v for k, v in json.loads(ln).items() if k != "t"} for ln in f]


def test_resumed_run_takes_the_steps_of_an_uninterrupted_one(run, tmp_path):
    """2 steps, then --resume for a third: the same metrics and train state as 3 steps
    straight (each step's generator depends on the seed and the step; the checkpoint
    holds the batches' and timesteps' generators)."""
    main, trial, _ = run
    straight = main("--train", "--max-steps", "3", trial_dir=str(tmp_path / "straight"))
    resumed = main("--train", "--max-steps", "3", "--resume",
                   os.path.join(trial, "ckpt_000002"), trial_dir=str(tmp_path / "resumed"))
    assert _metrics(str(tmp_path / "straight")) == _metrics(trial) + _metrics(
        str(tmp_path / "resumed"))
    _assert_state_equal(_train_state(resumed), _train_state(straight))


def test_validate_and_export_write_their_files(run):
    main, trial, trainer = run
    # the trained geometry through system.weights; the reference's formats wait for A20
    validated = main("--validate", **{"system.weights": os.path.join(trial, "last",
                                                                     "geometry.pt")})
    trained = trainer.geometry.state_dict()
    assert all(torch.equal(trained[n], p) for n, p in validated.geometry.state_dict().items())
    saved = sorted(os.listdir(os.path.join(trial, "save")))
    for i in range(len(PROMPTS["val"])):
        assert f"it0-val-{i}-grid.png" in saved
        assert any(f.startswith(f"it0-val-{i}-rgb.") for f in saved), saved
    for f in saved:
        assert os.path.getsize(os.path.join(trial, "save", f)) > 0
    for weights in ("model.pth", "geometry.msgpack"):
        with pytest.raises(NotImplementedError, match="ROADMAP A20"):
            main("--validate", **{"system.weights": weights})
    # the train state of step 2 through --resume
    exported = main("--export", "--resume", os.path.join(trial, "ckpt_000002"))
    assert exported.global_step == 2
    _assert_state_equal(_train_state(exported), _train_state(trainer))
    objs = sorted(glob.glob(os.path.join(trial, "it2-export", "*", "model.obj")))
    assert len(objs) == len(PROMPTS["test"])
    for path in objs:
        with open(path) as f:
            lines = f.read().splitlines()
        assert sum(ln.startswith("v ") for ln in lines) > 0
        assert sum(ln.startswith("f ") for ln in lines) > 0


def test_launcher_needs_cuda_unless_told_and_one_process(monkeypatch):
    if torch.cuda.is_available():
        pytest.skip("this host has a CUDA device")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        launch.main(["--config", CONFIG, "--train"])
    monkeypatch.setenv("WORLD_SIZE", "2")
    with pytest.raises(NotImplementedError, match="ROADMAP A21"):
        launch.main(["--config", CONFIG, "--train", "--device", "cpu"])


def test_build_system_reads_the_config(monkeypatch):
    """``build_system`` sizes every module from the config (the JAX builder's trainable
    partition, name for name and shape for shape, is held in
    ``tests/test_torch_train_step.py``, which builds both systems anyway)."""
    monkeypatch.chdir(REPO)
    cfg = load_config("configs/smoke_tiny.yaml")
    trainer = build_system(cfg, seed=0, device="cpu")
    sg = trainer.geometry.cfg.space_generator
    assert sg.block_out_channels == (32, 64) and sg.cross_attention_dim == 32
    assert trainer.background.cfg.hypernet.c_dim == 32
    assert trainer.background.cfg.encoding.n_levels == 2
    assert trainer.rasterize_renderer.cfg.isosurface_resolution == 12
    assert trainer.rasterize_renderer.cfg.faces_per_tile == 128
    assert trainer.volume_renderer.cfg.num_samples_per_ray == 12
    assert trainer.patch_cfg.patch_size == 8 and trainer.guidance.cfg.rd_image_size == 8
    assert trainer.guidance.mv.unet.cfg.block_out_channels == (16, 32)
    assert all(p.dtype == torch.float32 for p in trainer.guidance.sd.unet.parameters())
    assert trainer.cfg.loss.lambda_sparsity_2nd == 0.1 and not trainer.cfg.auto_grad
    assert trainer.material_fn.cfg.color_activation == "sigmoid-mipnerf"
