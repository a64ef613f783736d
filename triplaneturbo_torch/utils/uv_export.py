"""UV-atlas OBJ+MTL export (``fmt: "obj-mtl"``) without xatlas, vectorised in torch.

Counterpart of ``triplaneturbo_tpu/utils/uv_export.py``: a per-face grid atlas
(each triangle takes half of a square cell, inset by one texel) and a texture
baked by evaluating a color function at the 3-D surface point under each covered
texel center. The JAX version loops over the faces in Python; this one finds every
face's texels at once on the mesh's device, in the same arithmetic (the barycentric
weights in float64 from float32 texel-space corners, as numpy promotes them), so the
texture is the JAX loop's.

Texels that faces share: the -0.25 barycentric margin makes neighbouring charts
overlap, and the JAX loop's numpy assignment lets the later face win. A scatter
with repeated indices has no fixed winner on CUDA, so the winner is chosen
explicitly: the largest face index that covers a texel (``scatter_reduce`` with
``amax``), and the color is evaluated at that face's point only. ``color_fn``
must therefore be pointwise, as a field query is.
"""

from __future__ import annotations

import math
import os
from typing import Callable, Tuple

import numpy as np
import torch

from .saving import write_png

MARGIN = -0.25  # barycentric margin: fills the chart's one-texel inset
_CANDIDATES = 1 << 22  # (face, texel) candidates a batch of faces
_COLOR_CHUNK = 1 << 18  # points a call of ``color_fn``


def per_face_uv_atlas(n_faces: int, tex_size: int,
                      device: torch.device = "cpu") -> Tuple[torch.Tensor, float]:
    """UV coordinates [n_faces, 3, 2] float32 for a per-face grid atlas, and the
    cell edge in texels: face ``i`` takes the lower-left (even ``i``) or upper-right
    half of cell ``i // 2``, the cells tiling the texture row by row."""
    cells = int(math.ceil(math.sqrt(n_faces / 2)))
    cell = tex_size / cells
    pad = 1.0 / tex_size
    i = torch.arange(n_faces, device=device)
    cy, cx = (i // 2).div(cells, rounding_mode="floor"), (i // 2) % cells
    x0, y0 = cx.double() / cells + pad, cy.double() / cells + pad
    x1, y1 = (cx + 1).double() / cells - pad, (cy + 1).double() / cells - pad
    lower = torch.stack([torch.stack([x0, y0], -1), torch.stack([x1, y0], -1),
                         torch.stack([x0, y1], -1)], 1)
    upper = torch.stack([torch.stack([x1, y1], -1), torch.stack([x0, y1], -1),
                         torch.stack([x1, y0], -1)], 1)
    uvs = torch.where((i % 2 == 0)[:, None, None], lower, upper)
    return uvs.to(torch.float32), cell


def _candidates(uv: torch.Tensor, tex_size: int, f0: int, kx: int, ky: int):
    """For faces ``f0 ..`` with texel-space corners ``uv`` [Fc, 3, 2] (float32): the
    covered texels' flat index, the face index and the barycentric weights
    (float64, clipped and normalised), over each face's bounding box of at most
    ``kx`` x ``ky`` texels."""
    dev = uv.device
    lo = torch.floor(uv.amin(1)).long()
    hi = torch.ceil(uv.amax(1)).long()
    nx = torch.clamp(hi[:, 0] + 1, max=tex_size) - lo[:, 0]
    ny = torch.clamp(hi[:, 1] + 1, max=tex_size) - lo[:, 1]
    a, b, c = uv[:, 0], uv[:, 1], uv[:, 2]
    d = (b[:, 1] - c[:, 1]) * (a[:, 0] - c[:, 0]) + (c[:, 0] - b[:, 0]) * (a[:, 1] - c[:, 1])
    ix = torch.arange(kx, device=dev)
    iy = torch.arange(ky, device=dev)
    X = lo[:, 0, None] + ix  # [Fc, kx]
    Y = lo[:, 1, None] + iy  # [Fc, ky]
    px = (X.double() + 0.5 - c[:, 0, None].double())[:, None, :]  # [Fc, 1, kx]
    py = (Y.double() + 0.5 - c[:, 1, None].double())[:, :, None]  # [Fc, ky, 1]
    # the coefficients round in float32, as numpy's float32 scalars do; the rest is float64
    k0, k1, k2, k3, dd = (t.double()[:, None, None] for t in (
        b[:, 1] - c[:, 1], c[:, 0] - b[:, 0], c[:, 1] - a[:, 1], a[:, 0] - c[:, 0], d))
    w0 = (k0 * px + k1 * py) / dd
    w1 = (k2 * px + k3 * py) / dd
    w2 = 1 - w0 - w1
    inside = ((w0 >= MARGIN) & (w1 >= MARGIN) & (w2 >= MARGIN)
              & (ix < nx[:, None])[:, None, :] & (iy < ny[:, None])[:, :, None]
              & (d.abs() >= 1e-12)[:, None, None])
    fi, yi, xi = inside.nonzero(as_tuple=True)
    W = torch.stack([w0[fi, yi, xi], w1[fi, yi, xi], w2[fi, yi, xi]], -1).clamp_min(0)
    W = W / ((W[:, 0] + W[:, 1]) + W[:, 2])[:, None]
    tx = torch.clamp(X[fi, xi], 0, tex_size - 1)
    ty = torch.clamp(Y[fi, yi], 0, tex_size - 1)
    return ty * tex_size + tx, fi + f0, W


def bake_texture(verts: torch.Tensor, faces: torch.Tensor, uvs: torch.Tensor,
                 color_fn: Callable[[torch.Tensor], torch.Tensor],
                 tex_size: int = 1024) -> torch.Tensor:
    """Texture [tex_size, tex_size, 3] float32 on ``verts``' device: every face's UV
    chart rasterised at texel centers (within the barycentric margin), each covered
    texel colored by ``color_fn`` (float64 points [N, 3] -> colors [N, 3], pointwise;
    called in chunks of ``_COLOR_CHUNK``) at its winning face's surface point, clipped to
    [0, 1]; uncovered texels stay 0. ``faces`` [F, 3] are compacted (all valid)."""
    dev = verts.device
    tex = torch.zeros((tex_size * tex_size, 3), dtype=torch.float32, device=dev)
    if faces.shape[0] == 0:
        return tex.view(tex_size, tex_size, 3)
    uv = uvs.to(device=dev, dtype=torch.float32) * tex_size
    span = torch.ceil(uv.amax(1)) - torch.floor(uv.amin(1)) + 1  # [F, 2]
    kx, ky = (int(k) for k in span.amax(0).clamp_min(1).tolist())
    step = max(1, _CANDIDATES // (kx * ky))
    parts = [_candidates(uv[f0:f0 + step], tex_size, f0, kx, ky)
             for f0 in range(0, faces.shape[0], step)]
    texel, face, W = (torch.cat(x) for x in zip(*parts))
    if texel.numel() == 0:
        return tex.view(tex_size, tex_size, 3)
    winner = torch.full((tex_size * tex_size,), -1, dtype=face.dtype, device=dev)
    winner = winner.scatter_reduce(0, texel, face, "amax")
    won = face == winner[texel]
    texel, face, W = texel[won], face[won], W[won]
    tri = verts.double()[faces[face].long()]  # [N, 3 corners, 3]
    pos = (W[:, 0, None] * tri[:, 0] + W[:, 1, None] * tri[:, 1]) + W[:, 2, None] * tri[:, 2]
    colors = torch.cat([torch.as_tensor(color_fn(pos[i:i + _COLOR_CHUNK]))
                        for i in range(0, pos.shape[0], _COLOR_CHUNK)])
    tex[texel] = colors.clamp(0, 1).to(device=dev, dtype=torch.float32)
    return tex.view(tex_size, tex_size, 3)


def export_obj_mtl(save_dir: str, name: str, verts: torch.Tensor, faces: torch.Tensor,
                   color_fn: Callable[[torch.Tensor], torch.Tensor],
                   tex_size: int = 1024) -> Tuple[str, str, str]:
    """``<name>.obj`` (a ``vt`` a face corner), ``<name>.mtl`` and ``texture_kd.png``
    (the baked texture, v flipped) under ``save_dir``; returns the three paths."""
    os.makedirs(save_dir, exist_ok=True)
    uvs, _ = per_face_uv_atlas(faces.shape[0], tex_size, device=verts.device)
    tex = bake_texture(verts, faces, uvs, color_fn, tex_size)

    obj_path = os.path.join(save_dir, f"{name}.obj")
    mtl_path = os.path.join(save_dir, f"{name}.mtl")
    tex_path = os.path.join(save_dir, "texture_kd.png")
    write_png(tex_path, [(tex.cpu().numpy()[::-1] * 255).astype(np.uint8)])

    v = verts.detach().cpu().numpy().astype(np.float32)
    f = faces.detach().cpu().numpy().astype(np.int64)
    # float32 -> Python float is exact, so each line reads as the JAX writer's
    lines = [f"mtllib {name}.mtl", "usemtl defaultMat"]
    lines += [f"v {p[0]:.6f} {p[1]:.6f} {p[2]:.6f}" for p in v.tolist()]
    lines += [f"vt {u:.6f} {w:.6f}" for u, w in uvs.cpu().numpy().reshape(-1, 2).tolist()]
    lines += [f"f {a + 1}/{3 * i + 1} {b + 1}/{3 * i + 2} {c + 1}/{3 * i + 3}"
              for i, (a, b, c) in enumerate(f.tolist())]
    with open(obj_path, "w") as fh:
        fh.write("\n".join(lines) + "\n")
    with open(mtl_path, "w") as fh:
        fh.write("newmtl defaultMat\nKa 1 1 1\nKd 1 1 1\nKs 0 0 0\nmap_Kd texture_kd.png\n")
    return obj_path, mtl_path, tex_path
