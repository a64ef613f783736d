"""Naming of the port's built kernel libraries, on the CPU (nothing is compiled).

A library is named by a hash of its source, every shared header
(``csrc/*.cuh``) and the compiler flags, so that an edited header cannot load
a library built from the old one.
"""

import pytest

from triplaneturbo_torch.ops import _build


@pytest.fixture
def csrc(tmp_path, monkeypatch):
    src = tmp_path / "csrc"
    src.mkdir()
    (src / "a.cu").write_text('#include "shared.cuh"\nint a;\n')
    (src / "b.cu").write_text('#include "shared.cuh"\nint b;\n')
    (src / "shared.cuh").write_text("#pragma once\n")
    monkeypatch.setattr(_build, "CSRC_DIR", src)
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "_build")
    return src


def _names():
    return {name: _build._artifact(path).name for name, path in _build.sources().items()}


def test_an_edited_header_renames_every_library(csrc):
    before = _names()
    assert set(before) == {"a", "b"}
    (csrc / "shared.cuh").write_text("#pragma once\n#define X 1\n")
    after = _names()
    assert all(after[n] != before[n] for n in before)
    assert all(after[n].startswith(n + "-") for n in after)


def test_an_edited_source_renames_only_its_library(csrc):
    before = _names()
    (csrc / "a.cu").write_text('#include "shared.cuh"\nint a2;\n')
    after = _names()
    assert after["a"] != before["a"] and after["b"] == before["b"]


def test_a_new_header_renames_every_library(csrc):
    before = _names()
    (csrc / "other.cuh").write_text("#pragma once\n")
    assert all(v != before[k] for k, v in _names().items())


def test_the_port_sources_include_the_shared_header():
    headers = {p.name for p in _build.CSRC_DIR.glob("*.cuh")}
    assert "hopper_mma.cuh" in headers
    for name in ("flash_attn_fwd", "flash_attn_bwd"):
        assert '#include "hopper_mma.cuh"' in _build.sources()[name].read_text()
