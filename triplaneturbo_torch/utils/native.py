"""The port's binding of the native OBJ writer (``native/objwriter.cpp``).

The C++ writer compacts a masked fixed-capacity mesh (drops invalid vertices,
remaps the faces) and streams the OBJ with its own float formatting, about a
hundred times faster than Python string formatting at 100k elements. At first use
``g++`` builds the source into ``triplaneturbo_torch/_build/`` under a name hashed
from the source and the flags, as ``ops/_build.py`` does for the CUDA sources,
and ``ctypes`` binds ``write_obj``, after ``triplaneturbo_tpu/utils/native.py``.
The committed ``native/libobjwriter.so`` is never loaded, and a failed build
raises: there is no quiet fall back to the Python writer.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Optional

import numpy as np

SOURCE = Path(__file__).resolve().parents[2] / "native" / "objwriter.cpp"
BUILD_DIR = Path(__file__).resolve().parents[1] / "_build"
CXX_FLAGS = ("-O3", "-fPIC", "-shared", "-std=c++17", "-Wall")

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None


def _artifact() -> Path:
    h = hashlib.sha256(SOURCE.read_bytes())
    h.update(" ".join(CXX_FLAGS).encode())
    return BUILD_DIR / f"objwriter-{h.hexdigest()[:16]}.so"


def library() -> ctypes.CDLL:
    """The writer's library, built on first use; raises if it cannot be built."""
    global _lib
    with _lock:
        if _lib is not None:
            return _lib
        target = _artifact()
        if not target.exists():
            cxx = os.environ.get("CXX") or shutil.which("g++")
            if cxx is None:
                raise RuntimeError("g++ not found: the native OBJ writer is built on first use")
            BUILD_DIR.mkdir(parents=True, exist_ok=True)
            tmp = target.with_suffix(f".{os.getpid()}.tmp")
            proc = subprocess.run([cxx, *CXX_FLAGS, "-o", str(tmp), str(SOURCE)],
                                  capture_output=True, text=True, timeout=300)
            if proc.returncode != 0:
                raise RuntimeError(f"building {SOURCE.name} failed:\n{proc.stderr}")
            os.replace(tmp, target)
        lib = ctypes.CDLL(str(target))
        lib.write_obj.restype = ctypes.c_int
        lib.write_obj.argtypes = [
            ctypes.c_char_p,
            ctypes.POINTER(ctypes.c_float), ctypes.POINTER(ctypes.c_float),
            ctypes.POINTER(ctypes.c_int32),
            ctypes.POINTER(ctypes.c_uint8), ctypes.POINTER(ctypes.c_uint8),
            ctypes.c_int64, ctypes.c_int64,
        ]
        _lib = lib
        return lib


def _ptr(a: Optional[np.ndarray], ctype):
    if a is None:
        return ctypes.POINTER(ctype)()
    return a.ctypes.data_as(ctypes.POINTER(ctype))


def write_obj_native(path: str, verts: np.ndarray, faces: np.ndarray,
                     colors: Optional[np.ndarray] = None, v_mask: Optional[np.ndarray] = None,
                     t_mask: Optional[np.ndarray] = None) -> str:
    """Write a masked, optionally vertex-colored OBJ with the C++ writer: vertices
    ``%.6f``, colors clipped to [0, 1] and ``%.6f``, the faces of ``t_mask`` whose
    vertices are all in ``v_mask``, reindexed. Raises if the writer fails."""
    verts = np.ascontiguousarray(verts, np.float32)
    faces = np.ascontiguousarray(faces, np.int32)
    colors = None if colors is None else np.ascontiguousarray(np.clip(colors, 0, 1), np.float32)
    vm = None if v_mask is None else np.ascontiguousarray(v_mask, np.uint8)
    fm = None if t_mask is None else np.ascontiguousarray(t_mask, np.uint8)
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    rc = library().write_obj(
        path.encode(),
        _ptr(verts, ctypes.c_float), _ptr(colors, ctypes.c_float),
        _ptr(faces, ctypes.c_int32),
        _ptr(vm, ctypes.c_uint8), _ptr(fm, ctypes.c_uint8),
        verts.shape[0], faces.shape[0],
    )
    if rc != 0:
        raise OSError(f"the native OBJ writer could not write {path} (code {rc})")
    return path
