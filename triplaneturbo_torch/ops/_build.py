"""Build the port's CUDA kernels with ``nvcc`` and load them with ``ctypes``.

Every ``csrc/*.cu`` file has a plain C interface and becomes its own shared
library under ``triplaneturbo_torch/_build/``, named by a hash of its source,
the shared headers (``csrc/*.cuh``) and the compiler flags, so an edited source
or header is rebuilt and an unchanged one is loaded as it is. The first use
builds all sources at once, one ``nvcc`` process each. The ``-Xptxas -v``
report (registers, shared memory, spills) is kept beside each library for
``chip_smoke.py`` to print.

Nothing here runs at import: the CPU tests import every module of the port,
and the CPU has no ``nvcc``.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Dict

PKG_DIR = Path(__file__).resolve().parent.parent
CSRC_DIR = PKG_DIR / "csrc"
BUILD_DIR = PKG_DIR / "_build"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_lock = threading.Lock()
_libs: Dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = "/usr/local/cuda/bin/nvcc"
    if os.path.exists(default):
        return default
    raise RuntimeError("nvcc not found: the port's CUDA kernels are built on first use")


def _artifact(src: Path) -> Path:
    """The library of one source, named by a hash of the source, every shared
    header (``csrc/*.cuh``, which any source may include) and the flags."""
    h = hashlib.sha256(src.read_bytes())
    for header in sorted(CSRC_DIR.glob("*.cuh")):
        h.update(header.name.encode() + header.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"{src.stem}-{h.hexdigest()[:16]}.so"


def sources() -> Dict[str, Path]:
    return {p.stem: p for p in sorted(CSRC_DIR.glob("*.cu"))}


def build_all() -> Dict[str, Path]:
    """Compile every source that has no up-to-date library; all in parallel."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    targets = {name: _artifact(src) for name, src in sources().items()}
    todo = {n: t for n, t in targets.items() if not t.exists()}
    if not todo:
        return targets
    nvcc = _nvcc()
    procs = {}
    for name, target in todo.items():
        tmp = target.with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(sources()[name])]
        procs[name] = (tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    failures = []
    for name, (tmp, proc) in procs.items():
        out, _ = proc.communicate()
        target = todo[name]
        if proc.returncode != 0:
            failures.append(f"{name}: nvcc exited {proc.returncode}\n{out}")
            continue
        target.with_suffix(".ptxas.txt").write_text(out)
        os.replace(tmp, target)
    if failures:
        raise RuntimeError("kernel build failed:\n" + "\n".join(failures))
    return targets


def ptxas_report(name: str) -> str:
    """The ``-Xptxas -v`` lines nvcc printed for one source."""
    path = _artifact(sources()[name]).with_suffix(".ptxas.txt")
    return path.read_text() if path.exists() else ""


def load(name: str) -> ctypes.CDLL:
    """The shared library of ``csrc/<name>.cu``, built on first use."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            lib = ctypes.CDLL(str(build_all()[name]))
            _libs[name] = lib
        return lib
