"""The port's config system against the JAX package's, on the CPU.

``load_config`` must give the JAX ``load_config``'s dict (as primitives, without
the timestamp and the trial names and directory, which carry the clock) on each
config with and without dotlist overrides, ``__base__`` included, and on each YAML
form a config may hold; ``dump_config``'s file must load back to the same dict;
``parse_structured`` must build both packages' ``TrainerConfig`` the same from each
config, on the fields the port reads.
"""

import dataclasses
import glob
import os

import pytest

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


def _without_clock(cfg):
    return {k: v for k, v in jconfig.config_to_primitive(cfg).items() if k not in CLOCK}


@pytest.mark.parametrize("text", YAML_CASES)
def test_load_config_reads_each_yaml_form_as_jax_does(text, tmp_path):
    """Each form as the value of a key in a config file, through both packages'
    ``load_config``."""
    path = tmp_path / "form.yaml"
    path.write_text("form:\n" + "".join(f"  {line}\n" for line in text.splitlines()))
    got = tconfig.load_config(str(path))
    assert _without_clock(got) == _without_clock(jconfig.load_config(str(path)))
    assert got.form is not None


@pytest.mark.parametrize("path", CONFIGS, ids=os.path.basename)
def test_dump_config_reads_back_through_load_config(path, tmp_path, monkeypatch):
    monkeypatch.chdir(REPO)  # ``__base__`` names a path from the repository's root
    cfg = tconfig.load_config(os.path.relpath(path, REPO))
    dumped = str(tmp_path / "parsed.yaml")
    tconfig.dump_config(dumped, cfg)
    assert _without_clock(tconfig.load_config(dumped)) == _without_clock(cfg)


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


def test_port_drops_only_the_keys_it_does_not_carry_over(monkeypatch):
    """ROADMAP C4: ``parse_structured`` drops unknown keys without a word. Over every
    ``configs/*.yaml``, each section ``build_system`` and the launcher parse is held against
    the JAX package's dataclass of the same module and name: beyond the keys the JAX
    package drops, the port drops exactly ``n_view`` and ``rasterize_hw`` (which the JAX
    trainer does not read either) and ``vae_attn_type`` (a JAX ``SpaceGeneratorConfig``
    field nothing reads). A key the port lacks then fails this test, not silently."""
    import importlib

    from triplaneturbo_torch.data.multiview_multiprompt import DataModuleConfig
    from triplaneturbo_torch.models.exporters.mesh_exporter import MeshExporterConfig
    from triplaneturbo_torch.systems import builder
    from triplaneturbo_torch.systems.trainer import TriplaneTurboTrainer

    monkeypatch.chdir(REPO)
    calls = []

    def recording(cls, cfg=None, strict=False):
        calls.append((cls, dict(cfg or {})))
        return tconfig.parse_structured(cls, cfg, strict)

    monkeypatch.setattr(builder, "parse_structured", recording)
    monkeypatch.setattr(TriplaneTurboTrainer, "build", classmethod(lambda cls, *a, **k: None))
    extra, parsed = {}, set()
    for path in CONFIGS:
        cfg = tconfig.load_config(os.path.relpath(path, REPO))
        calls.clear()
        builder.build_system(cfg, device="cpu")
        # the launcher's own sections
        calls += [(DataModuleConfig, dict(cfg.get("data", {}))),
                  (MeshExporterConfig, dict(cfg.get("system", {}).get("exporter", {}) or {}))]
        for cls, section in calls:
            theirs = getattr(importlib.import_module(
                cls.__module__.replace("triplaneturbo_torch", "triplaneturbo_tpu")), cls.__name__)
            dropped = set(section) - {f.name for f in dataclasses.fields(cls)}
            jax_dropped = set(section) - {f.name for f in dataclasses.fields(theirs)}
            for key in dropped - jax_dropped:
                extra.setdefault(key, set()).add(f"{os.path.basename(path)}: {cls.__name__}")
            parsed.add(cls.__name__)
    assert {"SpaceGeneratorConfig", "HashGridConfig", "VolumeRendererConfig",
            "RasterizeRendererConfig", "PatchRendererConfig", "ASDConfig", "TrainerConfig",
            "LossConfig", "DataModuleConfig", "MeshExporterConfig"} <= parsed
    assert set(extra) == {"n_view", "rasterize_hw", "vae_attn_type"}, extra
