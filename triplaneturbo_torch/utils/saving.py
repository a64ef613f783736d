"""Artifacts on the host: vertex-colored OBJ meshes, image grids, turntables.

Counterpart of ``triplaneturbo_tpu/utils/saving.py``. ``save_obj`` has the
Python writer only (the native C++ writer is not ported yet); masked
fixed-capacity buffers are compacted here: invalid vertices are dropped and the
faces reindexed. ``save_image_grid`` writes a PNG with a writer of its own
(``zlib`` + ``struct``); ``save_video`` writes through imageio where it imports,
as the JAX package does, and otherwise an animated PNG with the same writer.
"""

from __future__ import annotations

import os
import struct
import zlib
from typing import List, Optional, Sequence

import numpy as np
import torch


def _to_numpy(x):
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def save_obj(path: str, v_pos, t_pos_idx, v_rgb=None, v_mask=None, t_mask=None) -> str:
    v = _to_numpy(v_pos).astype(np.float32)
    f = _to_numpy(t_pos_idx).astype(np.int64)
    rgb = None if v_rgb is None else np.clip(_to_numpy(v_rgb).astype(np.float32), 0.0, 1.0)
    if v_mask is not None:
        vm = _to_numpy(v_mask).astype(bool)
        remap = -np.ones(len(v), np.int64)
        remap[vm] = np.arange(vm.sum())
        v = v[vm]
        rgb = rgb[vm] if rgb is not None else None
        if t_mask is not None:
            f = f[_to_numpy(t_mask).astype(bool)]
        f = remap[f]
        f = f[(f >= 0).all(axis=1)]
    elif t_mask is not None:
        f = f[_to_numpy(t_mask).astype(bool)]

    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    lines: List[str] = []
    if rgb is not None:
        for p, c in zip(v, rgb):
            lines.append(f"v {p[0]:.6f} {p[1]:.6f} {p[2]:.6f} {c[0]:.4f} {c[1]:.4f} {c[2]:.4f}")
    else:
        for p in v:
            lines.append(f"v {p[0]:.6f} {p[1]:.6f} {p[2]:.6f}")
    for tri in f:
        lines.append(f"f {tri[0]+1} {tri[1]+1} {tri[2]+1}")
    with open(path, "w") as fh:
        fh.write("\n".join(lines) + "\n")
    return path


def _to_uint8(x) -> np.ndarray:
    a = _to_numpy(x)
    if a.dtype != np.uint8:
        a = (np.clip(a.astype(np.float32), 0, 1) * 255).astype(np.uint8)
    if a.ndim == 2:
        a = np.stack([a] * 3, axis=-1)
    return np.ascontiguousarray(a[..., :3])


def _chunk(kind: bytes, data: bytes) -> bytes:
    return (struct.pack(">I", len(data)) + kind + data
            + struct.pack(">I", zlib.crc32(kind + data) & 0xFFFFFFFF))


def _png_rows(rgb: np.ndarray) -> bytes:
    """zlib stream of the image's rows, each behind filter byte 0 (none)."""
    h = rgb.shape[0]
    raw = np.concatenate([np.zeros((h, 1), np.uint8), rgb.reshape(h, -1)], axis=1)
    return zlib.compress(raw.tobytes(), 6)


def write_png(path: str, frames: Sequence[np.ndarray], fps: Optional[int] = None) -> str:
    """An 8-bit RGB PNG of one [H, W, 3] uint8 frame, or an animated PNG (APNG: every
    frame shown 1 / ``fps`` s, looping) of several of the same size."""
    h, w = frames[0].shape[:2]
    out = [b"\x89PNG\r\n\x1a\n", _chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0))]
    if len(frames) > 1:
        out.append(_chunk(b"acTL", struct.pack(">II", len(frames), 0)))
    seq = 0
    for i, frame in enumerate(frames):
        if frame.shape[:2] != (h, w):
            raise ValueError(f"frame {i} is {frame.shape[:2]}, the first {(h, w)}")
        data = _png_rows(frame)
        if len(frames) > 1:
            # fcTL: sequence, size, offset, delay 1/fps s, dispose none, blend source
            out.append(_chunk(b"fcTL", struct.pack(">IIIIIHHBB", seq, w, h, 0, 0, 1,
                                                   fps or 30, 0, 0)))
            seq += 1
        if i == 0:
            out.append(_chunk(b"IDAT", data))
        else:
            out.append(_chunk(b"fdAT", struct.pack(">I", seq) + data))
            seq += 1
    out.append(_chunk(b"IEND", b""))
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with open(path, "wb") as fh:
        fh.write(b"".join(out))
    return path


def save_image_grid(path: str, images: Sequence, nrow: Optional[int] = None) -> str:
    """Images ([H, W, 3] or [H, W], float in [0, 1] or uint8) side by side, ``nrow``
    a row, into one PNG."""
    arrs = [_to_uint8(im) for im in images]
    n = len(arrs)
    nrow = nrow or n
    ncol = (n + nrow - 1) // nrow
    H, W = arrs[0].shape[:2]
    grid = np.zeros((ncol * H, nrow * W, 3), np.uint8)
    for i, a in enumerate(arrs):
        r, c = divmod(i, nrow)
        grid[r * H:(r + 1) * H, c * W:(c + 1) * W] = a
    return write_png(path, [grid])


def save_video(path: str, frames: Sequence, fps: int = 30) -> str:
    """A turntable of ``frames``: through imageio (mp4, or gif without an ffmpeg
    backend) where imageio imports; otherwise an animated PNG beside ``path``
    (``.apng``). Returns the path written."""
    arrs = [_to_uint8(f) for f in frames]
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    try:
        import imageio.v2 as imageio
    except ImportError:
        return write_png(os.path.splitext(path)[0] + ".apng", arrs, fps=fps)
    try:
        imageio.mimwrite(path, arrs, fps=fps)
    except Exception:
        alt = os.path.splitext(path)[0] + ".gif"
        imageio.mimwrite(alt, arrs, duration=1.0 / fps)
        return alt
    return path
