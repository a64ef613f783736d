"""Tile-binned triangle rasterizer in plain PyTorch.

Counterpart of ``triplaneturbo_tpu/ops/rasterize.py``, which is XLA there
(no Pallas kernel), and plain PyTorch here:

1. **bin** (no grad): each valid face's screen bounding box is mapped to the
   tile grid; (tile, face) pairs are ranked with a stable sort by tile and
   scattered into a fixed-capacity face list a tile. Faces spanning more than
   ``max_span`` tiles on an axis go, when ``big_face_cap > 0``, to one global
   list appended to every tile's;
2. **select** (no grad): all tiles at once, over the face lists in chunks of
   ``select_chunk``, a running per-pixel (z, slot) minimum. The winner is
   piecewise constant in the vertices, so this pass runs under
   ``torch.no_grad()`` and keeps its ``[tiles, chunk, tile²]`` temporaries out
   of autograd;
3. **recompute** (differentiable, per pixel): the winning face's vertices are
   gathered and the edge functions, barycentrics, depth and signed edge
   distance recomputed at the pixel centre;
4. **interpolate**: perspective-correct attribute interpolation;
5. **antialias**: a screen-space blend over silhouette pixels driven by the
   signed edge distance, which carries the coverage gradient to the vertices.

Ties go where the JAX package sends them: the first minimum within a chunk
(``torch.min`` returns the first index, as ``jnp.argmin`` does) and the
earlier chunk across chunks (strict ``<``). Zero-area faces are culled and
the edge lengths keep eps inside the sqrt, which keeps the backward finite on
padded and collapsed faces. The overflow counts are returned, never dropped.

Conventions: clip-space vertices from an OpenGL MVP with its y row negated,
so NDC y maps to image rows; pixel centres at +0.5; no backface culling.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch
import torch.nn.functional as F


def _take(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """x[idx] along dim 0 through ``index_select``, whose backward is an
    ``index_add`` (atomic adds); the backward of ``x[idx]`` sorts the indices
    and walks each run of duplicates serially, seconds a step on the card for
    gathers like these, where each face is read by many pixels."""
    return x.index_select(0, idx.reshape(-1)).reshape(*idx.shape, *x.shape[1:])


class RasterOut(NamedTuple):
    face_id: torch.Tensor  # [H, W] int64, -1 for background
    bary: torch.Tensor  # [H, W, 3] perspective-correct barycentrics
    depth: torch.Tensor  # [H, W] NDC depth of the hit (1e10 for background)
    mask: torch.Tensor  # [H, W] bool coverage
    edge_dist: torch.Tensor  # [H, W] signed px distance to the hit face's nearest edge
    n_span_overflow: torch.Tensor  # [] faces spanning more tiles than listed
    n_list_overflow: torch.Tensor  # [] (tile, face) entries dropped at capacity


@torch.no_grad()
def _bin_faces(xy: torch.Tensor, valid: torch.Tensor, H: int, W: int, tile: int, cap: int,
               max_span: int = 4, big_cap: int = 0
               ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Fixed-capacity face lists, [n_tiles, cap (+ big_cap)] int64 (-1 empty),
    and the (n_span_overflow, n_list_overflow) counts.

    xy: [F, 3, 2] screen coordinates; valid: [F] bool. With ``big_cap > 0``
    faces whose box spans ``max_span`` or more tiles on an axis go to a global
    list of up to ``big_cap`` faces broadcast to every tile, and the span
    count holds only the big faces beyond it."""
    th, tw = H // tile, W // tile
    n_tiles = th * tw
    Fn = xy.shape[0]
    dev = xy.device
    limit = torch.tensor([tw - 1, th - 1], dtype=xy.dtype, device=dev)

    def tile_of(v):
        v = torch.nan_to_num(torch.floor(v / tile), nan=0.0)
        return torch.minimum(v.clamp_min(0), limit).long()

    lo = tile_of(xy.amin(dim=1))  # [F, 2]
    hi = tile_of(xy.amax(dim=1))
    S = max_span
    is_big = valid & ((hi[:, 0] - lo[:, 0] >= S) | (hi[:, 1] - lo[:, 1] >= S))
    ds = torch.arange(S, device=dev)
    tx = lo[:, 0:1] + ds[None]  # [F, S]
    ty = lo[:, 1:2] + ds[None]
    ok = (tx <= hi[:, 0:1])[:, :, None] & (ty <= hi[:, 1:2])[:, None, :] & valid[:, None, None]
    if big_cap > 0:
        ok = ok & ~is_big[:, None, None]
    tid = torch.where(ok, ty[:, None, :] * tw + tx[:, :, None], n_tiles)  # [F, S(x), S(y)]

    # rank the entries within their tile: stable sort by tile, rank = position
    # minus the tile's first position (a running max over the first flags)
    tid_sorted, perm = torch.sort(tid.reshape(-1), stable=True)
    fid_sorted = perm // (S * S)
    idx = torch.arange(tid_sorted.shape[0], device=dev)
    is_first = torch.ones_like(tid_sorted, dtype=torch.bool)
    is_first[1:] = tid_sorted[1:] != tid_sorted[:-1]
    first_pos = torch.cummax(torch.where(is_first, idx, 0), dim=0).values
    rank = idx - first_pos
    listed = tid_sorted < n_tiles
    keep = listed & (rank < cap)
    # kept entries have unique destinations; the dropped ones share the extra last slot
    dest = torch.where(keep, tid_sorted * cap + rank, n_tiles * cap)
    bins = torch.full((n_tiles * cap + 1,), -1, dtype=torch.long, device=dev)
    bins[dest] = fid_sorted
    bins = bins[:-1].reshape(n_tiles, cap)
    n_list_overflow = (listed & (rank >= cap)).sum()
    n_big = is_big.sum()
    if big_cap > 0:
        bc = min(big_cap, Fn)
        ids = torch.arange(Fn, device=dev)
        big_list = torch.sort(torch.where(is_big, ids, Fn)).values[:bc]
        big_list = torch.where(big_list < Fn, big_list, -1)
        bins = torch.cat([bins, big_list[None].expand(n_tiles, bc)], dim=1)
        n_span_overflow = torch.clamp_min(n_big - bc, 0)
    else:
        n_span_overflow = n_big
    return bins, n_span_overflow, n_list_overflow


@torch.no_grad()
def _select(tri_xy: torch.Tensor, tri_z: torch.Tensor, bins: torch.Tensor, H: int, W: int,
            tile: int, select_chunk: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """The winning face a pixel: (face_id [H, W], -1 where nothing covers it;
    hit [H, W] bool)."""
    th, tw = H // tile, W // tile
    T, p = th * tw, tile * tile
    dev = tri_xy.device
    cap = bins.shape[1]
    ch = min(select_chunk, cap)
    n_chunks = -(-cap // ch)
    bins_p = F.pad(bins, (0, n_chunks * ch - cap), value=-1)
    fb = bins_p.clamp_min(0)
    pxy = _take(tri_xy, fb)  # [T, capp, 3, 2]
    pz = _take(tri_z, fb)  # [T, capp, 3]
    pok = bins_p >= 0

    # pixel centres of every tile; pixel i of a tile = (y in tile) * tile + x
    t_idx = torch.arange(T, device=dev)
    ty_idx, tx_idx = t_idx // tw, t_idx % tw
    off = torch.arange(tile, device=dev, dtype=torch.float32) + 0.5
    zeros = torch.zeros((1, tile, tile), device=dev)
    PX = ((tx_idx[:, None, None] * tile + off[None, None, :]) + zeros).reshape(T, 1, p)
    PY = ((ty_idx[:, None, None] * tile + off[None, :, None]) + zeros).reshape(T, 1, p)

    def edge(p0, p1):  # [T, ch, 2] each -> [T, ch, p]
        d = p1 - p0
        return d[..., 0:1] * (PY - p0[..., 1:2]) - d[..., 1:2] * (PX - p0[..., 0:1])

    zbest = torch.full((T, p), 1e10, device=dev)
    sbest = torch.zeros((T, p), dtype=torch.long, device=dev)
    for c in range(n_chunks):
        sl = slice(c * ch, (c + 1) * ch)
        axy, az, aok = pxy[:, sl], pz[:, sl], pok[:, sl]
        a, b, cc = axy[:, :, 0], axy[:, :, 1], axy[:, :, 2]
        e0, e1, e2 = edge(b, cc), edge(cc, a), edge(a, b)
        area = e0 + e1 + e2
        denom = torch.where(area.abs() < 1e-12, 1e-12, area)
        w0, w1, w2 = e0 / denom, e1 / denom, e2 / denom
        inside = (w0 >= 0) & (w1 >= 0) & (w2 >= 0) & aok[:, :, None]
        z = w0 * az[..., 0:1] + w1 * az[..., 1:2] + w2 * az[..., 2:3]
        z = torch.where(inside, z, 1e10)
        zl, il = torch.min(z, dim=1)
        better = zl < zbest
        zbest = torch.minimum(zbest, zl)
        sbest = torch.where(better, c * ch + il, sbest)
    hit_t = zbest < 1e9
    fid_t = torch.where(hit_t, torch.gather(bins_p, 1, sbest), -1)

    def untile(x):  # [T, p] -> [H, W]
        return x.reshape(th, tw, tile, tile).permute(0, 2, 1, 3).reshape(H, W)

    return untile(fid_t), untile(hit_t)


def rasterize(verts_clip: torch.Tensor, faces: torch.Tensor, face_valid: Optional[torch.Tensor],
              H: int, W: int, tile: int = 16, faces_per_tile: int = 512, max_span: int = 4,
              select_chunk: int = 128, big_face_cap: int = 0) -> RasterOut:
    """Rasterize one view of clip-space vertices [V, 4] and faces [F, 3].

    Differentiable in the vertices through ``bary``, ``depth`` and
    ``edge_dist``. ``select_chunk`` bounds the select pass's temporaries and
    does not change the result; ``big_face_cap`` turns on the global list of
    faces that span many tiles."""
    tri_xy, tri_z, tri_w = _screen(verts_clip, faces, H, W)
    won = _winners(tri_xy, tri_z, tri_w, face_valid, H, W, tile, faces_per_tile, max_span,
                   select_chunk, big_face_cap)
    return _recompute(tri_xy, tri_z, tri_w, *won)


def _screen(verts_clip: torch.Tensor, faces: torch.Tensor, H: int, W: int
            ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Per face, its corners' pixel coordinates [F, 3, 2], NDC depth [F, 3]
    and clip w [F, 3]."""
    faces = faces.long()
    w = verts_clip[:, 3:4]
    safe_w = torch.where(w.abs() < 1e-8, 1e-8, w)
    ndc = verts_clip[:, :3] / safe_w
    xy = torch.stack([(ndc[:, 0] * 0.5 + 0.5) * W, (ndc[:, 1] * 0.5 + 0.5) * H], dim=-1)
    return _take(xy, faces), _take(ndc[:, 2], faces), _take(safe_w[:, 0], faces)


@torch.no_grad()
def _winners(tri_xy: torch.Tensor, tri_z: torch.Tensor, tri_w: torch.Tensor,
             face_valid: Optional[torch.Tensor], H: int, W: int, tile: int, faces_per_tile: int,
             max_span: int, select_chunk: int, big_face_cap: int):
    """The non-differentiable half: culling, binning and the select pass.
    Returns (face_id, hit, n_span_overflow, n_list_overflow)."""
    if face_valid is None:
        face_valid = torch.ones(tri_xy.shape[0], dtype=torch.bool, device=tri_xy.device)
    # cull faces behind the camera, and zero-area faces: a collapsed face has
    # e0 = e1 = e2 = 0 everywhere, would pass the inside test on its whole tile
    # at z = 0, and its barycentric backward would overflow through the 1e-12
    # denominator clamp
    front = (tri_w > 0).all(dim=-1)
    e01 = tri_xy[:, 1] - tri_xy[:, 0]
    e02 = tri_xy[:, 2] - tri_xy[:, 0]
    area_f = e01[:, 0] * e02[:, 1] - e01[:, 1] * e02[:, 0]
    valid = face_valid & front & (area_f.abs() > 1e-6)
    bins, n_span, n_list = _bin_faces(tri_xy, valid, H, W, tile, faces_per_tile, max_span,
                                      big_cap=big_face_cap)
    fid, hit = _select(tri_xy, tri_z, bins, H, W, tile, select_chunk)
    return fid, hit, n_span, n_list


def _recompute(tri_xy: torch.Tensor, tri_z: torch.Tensor, tri_w: torch.Tensor, fid: torch.Tensor,
               hit: torch.Tensor, n_span: torch.Tensor, n_list: torch.Tensor) -> RasterOut:
    """The differentiable pass: each pixel's winning face's edge functions,
    perspective-correct barycentrics, depth and signed edge distance,
    recomputed at the pixel centre from the screen-space vertices."""
    H, W = fid.shape
    f = fid.clamp_min(0)
    axy, az, aw = _take(tri_xy, f), _take(tri_z, f), _take(tri_w, f)  # [H, W, 3(, 2)]
    a, b, c = axy[..., 0, :], axy[..., 1, :], axy[..., 2, :]
    dev = tri_xy.device
    Qx = (torch.arange(W, device=dev) + 0.5)[None, :].expand(H, W)
    Qy = (torch.arange(H, device=dev) + 0.5)[:, None].expand(H, W)

    def edge_px(p0, p1):
        d = p1 - p0
        return d[..., 0] * (Qy - p0[..., 1]) - d[..., 1] * (Qx - p0[..., 0])

    e0, e1, e2 = edge_px(b, c), edge_px(c, a), edge_px(a, b)
    area = e0 + e1 + e2
    denom = torch.where(area.abs() < 1e-12, 1e-12, area)
    w0, w1, w2 = e0 / denom, e1 / denom, e2 / denom
    z = w0 * az[..., 0] + w1 * az[..., 1] + w2 * az[..., 2]
    bary = torch.stack([w0, w1, w2], dim=-1)

    def elen(p0, p1):  # eps inside the sqrt: finite gradient at p0 == p1 (padding faces)
        return torch.sqrt(((p1 - p0) ** 2).sum(-1) + 1e-12)

    d = torch.minimum(e0 / elen(b, c), torch.minimum(e1 / elen(c, a), e2 / elen(a, b)))
    d = d * torch.sign(area)
    edge_d = torch.where(hit, d, 0.0)
    # perspective correction: (w_i / w_clip_i) / sum
    bw = bary / aw
    bary_pc = bw / torch.clamp_min(bw.sum(-1, keepdim=True), 1e-12)
    bary_pc = torch.where(hit[..., None], bary_pc, 0.0)
    return RasterOut(face_id=fid, bary=bary_pc, depth=torch.where(hit, z, 1e10), mask=hit,
                     edge_dist=edge_d, n_span_overflow=n_span, n_list_overflow=n_list)


def interpolate(attr: torch.Tensor, out: RasterOut, faces: torch.Tensor,
                bg_value: float = 0.0) -> torch.Tensor:
    """Perspective-correct interpolation of per-vertex ``attr`` [V, C] -> [H, W, C]."""
    tri = _take(attr, _take(faces.long(), out.face_id.clamp_min(0)))  # [H, W, 3, C]
    val = torch.einsum("hwk,hwkc->hwc", out.bary, tri)
    return torch.where(out.mask[..., None], val, bg_value)


_SQRT2 = 1.4142135623730951


def _shifts(x: torch.Tensor):
    """The 8 neighbours of every pixel of a padded [H+2, W+2, ...] tensor, with
    the centre-to-centre distance of each."""
    return [(x[:-2, 1:-1], 1.0), (x[2:, 1:-1], 1.0), (x[1:-1, :-2], 1.0), (x[1:-1, 2:], 1.0),
            (x[:-2, :-2], _SQRT2), (x[:-2, 2:], _SQRT2), (x[2:, :-2], _SQRT2),
            (x[2:, 2:], _SQRT2)]


def antialias(img: torch.Tensor, out: RasterOut, background: torch.Tensor) -> torch.Tensor:
    """Silhouette-edge antialias [H, W, C], with gradients to the vertices
    through the signed edge distance ``d``.

    A covered pixel has coverage clamp(0.5 + d, 0, 1); an uncovered pixel next
    to covered ones (8-neighbourhood) takes the largest overhang
    clamp(d_nb - (offset - 0.5), 0, 1) over them, offset 1 for axis and √2 for
    diagonal neighbours, and their mean colour. ``d`` is the distance to the
    hit face's own nearest edge, so interior occlusion edges blend too (the
    JAX package's documented approximation of nvdiffrast's antialias).
    """
    m = out.mask.to(img.dtype)
    d = out.edge_dist
    alpha_in = torch.clamp(0.5 + d, 0.0, 1.0)
    dn = torch.where(out.mask, d, -torch.inf)
    dp = F.pad(dn, (1, 1, 1, 1), value=-torch.inf)
    alpha_out = torch.zeros_like(d)
    for nb, off in _shifts(dp):
        cov = torch.clamp(torch.where(torch.isfinite(nb), nb, 0.0) - (off - 0.5), 0.0, 1.0)
        alpha_out = torch.maximum(alpha_out, cov)
    alpha = torch.where(out.mask, alpha_in, alpha_out)[..., None]
    ip = F.pad(img * m[..., None], (0, 0, 1, 1, 1, 1))
    mp = F.pad(m, (1, 1, 1, 1))
    nb_sum = sum(x for x, _ in _shifts(ip))
    nb_cnt = sum(x for x, _ in _shifts(mp))[..., None]
    nb_color = nb_sum / torch.clamp_min(nb_cnt, 1.0)
    fg = torch.where(out.mask[..., None], img, nb_color)
    return fg * alpha + background * (1.0 - alpha)
