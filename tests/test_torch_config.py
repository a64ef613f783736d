"""The port's config system against the JAX package's, on the CPU.

The port reads YAML with a reader of its own (the card has no PyYAML): it must
give ``yaml.safe_load``'s value on every file of ``configs/`` and on the YAML
forms a config may hold; ``load_config`` must give the JAX ``load_config``'s dict
(as primitives, without the timestamp and the trial names and directory, which
carry the clock) on each config with and without dotlist overrides, ``__base__``
included; ``parse_structured`` must build both packages' ``TrainerConfig`` the
same from each config, on the fields the port reads.
"""

import dataclasses
import glob
import os

import pytest
import yaml

from triplaneturbo_tpu.systems.trainer import (
    LossConfig as JaxLossConfig,
    TrainerConfig as JaxTrainerConfig,
)
from triplaneturbo_tpu.utils import config as jconfig
from triplaneturbo_torch.systems.trainer import LossConfig, TrainerConfig
from triplaneturbo_torch.utils import config as tconfig

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONFIGS = sorted(glob.glob(os.path.join(REPO, "configs", "*.yaml")))
CLOCK = ("timestamp", "trial_name", "trial_dir")
OVERRIDES = ["trainer.max_steps=3", "system.renderer_2nd.field_chunk=65536",
             "system.loss.lambda_sdf_abs=0.1", "system.adan_betas=[0.9, 0.8, 0.7]",
             "exp_root_dir=/tmp/some where", "system.guidance={eps: 0.2, n_view: 4}",
             "data.negative_prompt=\"a, b\"", "system.parallel_guidance=true",
             "system.adan_eps=1.0e-8", "tag=v1-${data.n_view}", "new.key=null"]


def test_configs_exist():
    assert len(CONFIGS) >= 4, CONFIGS


@pytest.mark.parametrize("path", CONFIGS, ids=os.path.basename)
def test_yaml_reader_matches_safe_load_on_every_config(path):
    with open(path) as f:
        text = f.read()
    assert tconfig.yaml_load(text) == yaml.safe_load(text)


YAML_CASES = [
    "a: 1\nb: 1.5\nc: 1.0e-15\nd: 1e-15\ne: -3\nf: +7\ng: 0x1F\nh: .5\ni: 1_000\n",
    "a: yes\nb: No\nc: on\nd: OFF\ne: true\nf: False\ng: ~\nh: null\ni:\nj: None\n",
    "a: 'it''s'\nb: \"tab\\there \\\"q\\\" \\u00e9\"\nc: plain text with spaces\nd: x:y\n",
    "# comment\na:   # trailing\n  b: [1, 2.0, [x, 'y'], {k: v}]\n  c: {p: [1, 2], q: \"s, t\"}\n"
    "  d: a # b\n  e: 'a # b'\n\nz: []\ny: {}\n",
    "outer:\n  mid:\n    inner: 1\n    other: [a, b]\n  back: 2\ntop: last\n",
    "a: .inf\nb: -.inf\nc: 010\nd: 0\ne: 0b101\nf: 1.\ng: -0.25e+3\n",
    "[1, 2, {a: b}]\n",
]


@pytest.mark.parametrize("text", YAML_CASES)
def test_yaml_reader_matches_safe_load_on_yaml_forms(text):
    assert tconfig.yaml_load(text) == yaml.safe_load(text)


def test_yaml_reader_reads_back_dump_config(tmp_path):
    cfg = tconfig.load_config(os.path.join(REPO, "configs", "triplaneturbo_v1.yaml"))
    path = str(tmp_path / "parsed.yaml")
    tconfig.dump_config(path, cfg)
    with open(path) as f:
        text = f.read()
    assert tconfig.yaml_load(text) == tconfig.config_to_primitive(cfg)


def _without_clock(cfg):
    return {k: v for k, v in jconfig.config_to_primitive(cfg).items() if k not in CLOCK}


@pytest.mark.parametrize("overrides", [False, True], ids=["plain", "dotlist"])
@pytest.mark.parametrize("path", CONFIGS, ids=os.path.basename)
def test_load_config_matches_jax(path, overrides, monkeypatch):
    monkeypatch.chdir(REPO)  # ``__base__`` names a path from the repository's root
    rel = os.path.relpath(path, REPO)
    cli = OVERRIDES if overrides else None
    got = tconfig.load_config(rel, cli_args=cli, n_devices=1)
    want = jconfig.load_config(rel, cli_args=cli, n_devices=1)
    assert isinstance(got, tconfig.DotDict)
    assert _without_clock(got) == _without_clock(want)
    assert got.trial_dir.startswith(os.path.join(got.exp_root_dir, got.name, got.tag))
    if overrides:
        assert got.tag == "v1-4" and got.system.adan_betas == [0.9, 0.8, 0.7]
        assert got.new.key is None and got.data.negative_prompt == "a, b"


@pytest.mark.parametrize("path", CONFIGS, ids=os.path.basename)
def test_parse_structured_matches_jax_trainer_config(path, monkeypatch):
    monkeypatch.chdir(REPO)
    rel = os.path.relpath(path, REPO)
    sys_cfg = dict(tconfig.load_config(rel).get("system", {}))
    got = tconfig.parse_structured(TrainerConfig, sys_cfg)
    got.loss = tconfig.parse_structured(LossConfig, sys_cfg.get("loss", {}))
    want = jconfig.parse_structured(JaxTrainerConfig, sys_cfg)
    want.loss = jconfig.parse_structured(JaxLossConfig, sys_cfg.get("loss", {}))
    # the JAX-only fields: ``sync_per_part`` bounds the TPU's per-program output
    # allocation, and the JAX trainer reads neither ``n_view`` nor ``rasterize_hw``; the
    # port has none of them, and ``parse_structured`` drops their keys
    ours = {f.name for f in dataclasses.fields(TrainerConfig)}
    theirs = {f.name for f in dataclasses.fields(JaxTrainerConfig)}
    assert theirs - ours == {"sync_per_part", "n_view", "rasterize_hw"} and ours <= theirs
    want = dataclasses.asdict(want)
    assert dataclasses.asdict(got) == {k: want[k] for k in ours}
    assert isinstance(got.adan_betas, tuple)
    with pytest.raises(ValueError, match="Unknown config keys"):
        tconfig.parse_structured(TrainerConfig, {"no_such_key": 1}, strict=True)


def test_resolvers_and_dotlist_errors():
    cfg = tconfig.load_config({"name": "n", "a": 3, "b": "${mul:a,2}", "c": "${rmspace:x y z}",
                               "d": "${cmaxgt0:a}", "e": "pre-${a}", "f": "${basename:/p/q.yaml}"})
    want = jconfig.load_config({"name": "n", "a": 3, "b": "${mul:a,2}", "c": "${rmspace:x y z}",
                                "d": "${cmaxgt0:a}", "e": "pre-${a}", "f": "${basename:/p/q.yaml}"})
    assert _without_clock(cfg) == _without_clock(want)
    assert (cfg.b, cfg.c, cfg.d, cfg.e, cfg.f) == (6.0, "x-y-z", True, "pre-3", "q")
    with pytest.raises(ValueError, match="key.path=value"):
        tconfig.apply_dotlist({}, ["novalue"])
    with pytest.raises(ValueError, match="non-dict"):
        tconfig.apply_dotlist({"a": 1}, ["a.b=2"])
    with pytest.raises(tconfig.YAMLError):
        tconfig.yaml_load("a:\n  - 1\n  - 2\n")
