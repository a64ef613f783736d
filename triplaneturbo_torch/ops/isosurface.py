"""Isosurface extraction into fixed-capacity buffers: marching cubes and tets.

Counterpart of ``triplaneturbo_tpu/ops/isosurface.py``. The case tables are
the port's own copy of the JAX package's table builders (derived from first
principles at import time; a test holds them against the JAX tables element
for element). Extraction keeps the JAX algorithm and its compaction order --
ascending global index, through a cumulative sum and ``searchsorted`` -- so a
mesh matches the JAX one index for index: vertex slots follow the global edge
index, face slots the cell index. Capacities are static: ``max_verts`` /
``max_faces`` buffers with validity masks; overflow is dropped.
"""

from __future__ import annotations

import functools
import itertools
from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

# ---------------------------------------------------------------------------
# static table construction (numpy, import time)
# ---------------------------------------------------------------------------

EDGE_CLASS_DIRS = np.array(
    [
        [1, 0, 0],  # 0: +x
        [0, 1, 0],  # 1: +y
        [0, 0, 1],  # 2: +z
        [1, 1, 0],  # 3: xy face diagonal
        [0, 1, 1],  # 4: yz face diagonal
        [1, 0, 1],  # 5: xz face diagonal
        [1, 1, 1],  # 6: body diagonal
    ],
    dtype=np.int32,
)
_DIR_TO_CLASS = {tuple(d): i for i, d in enumerate(EDGE_CLASS_DIRS)}

_AXIS_VECS = {0: (1, 0, 0), 1: (0, 1, 0), 2: (0, 0, 1)}
_TET_CORNERS = []
for perm in itertools.permutations((0, 1, 2)):
    p0 = np.zeros(3, np.int32)
    p1 = p0 + _AXIS_VECS[perm[0]]
    p2 = p1 + _AXIS_VECS[perm[1]]
    p3 = np.ones(3, np.int32)
    _TET_CORNERS.append(np.stack([p0, p1, p2, p3]))
_TET_CORNERS = np.stack(_TET_CORNERS)  # [6, 4, 3]

_TET_EDGE_PAIRS = [(0, 1), (0, 2), (0, 3), (1, 2), (1, 3), (2, 3)]

TET_EDGE_CLASS = np.zeros((6, 6), np.int32)
TET_EDGE_BASE = np.zeros((6, 6, 3), np.int32)
for t in range(6):
    for e, (a, b) in enumerate(_TET_EDGE_PAIRS):
        qa, qb = _TET_CORNERS[t, a], _TET_CORNERS[t, b]
        TET_EDGE_CLASS[t, e] = _DIR_TO_CLASS[tuple(qb - qa)]
        TET_EDGE_BASE[t, e] = qa


def _build_tet_tri_table() -> Tuple[np.ndarray, np.ndarray]:
    """Derive marching-tetrahedra triangulations for all 6 tets x 16 cases.

    Returns (tri_edges [6,16,2,3], tri_count [6,16]); triangle normals point
    from inside (sdf<iso) to outside, fixed by a geometric check on the
    canonical tet.
    """
    tri_edges = np.zeros((6, 16, 2, 3), np.int32)
    tri_count = np.zeros((6, 16), np.int32)
    edge_of = {pair: i for i, pair in enumerate(_TET_EDGE_PAIRS)}

    def edge_idx(a, b):
        return edge_of[(min(a, b), max(a, b))]

    for t in range(6):
        corners = _TET_CORNERS[t].astype(np.float64)
        midpoints = {
            edge_of[p]: 0.5 * (corners[p[0]] + corners[p[1]]) for p in _TET_EDGE_PAIRS
        }
        for case in range(16):
            inside = [i for i in range(4) if case >> i & 1]
            outside = [i for i in range(4) if not (case >> i & 1)]
            tris = []
            if len(inside) == 1:
                a = inside[0]
                tris = [[edge_idx(a, b) for b in outside]]
            elif len(inside) == 3:
                a = outside[0]
                tris = [[edge_idx(a, b) for b in inside]]
            elif len(inside) == 2:
                a, b = inside
                c, d = outside
                e_ac, e_ad, e_bd, e_bc = (
                    edge_idx(a, c), edge_idx(a, d), edge_idx(b, d), edge_idx(b, c)
                )
                tris = [[e_ac, e_ad, e_bd], [e_ac, e_bd, e_bc]]
            if not tris:
                continue
            want = corners[outside].mean(axis=0) - corners[inside].mean(axis=0)
            fixed = []
            for tri in tris:
                p0, p1, p2 = (midpoints[e] for e in tri)
                if np.dot(np.cross(p1 - p0, p2 - p0), want) < 0:
                    tri = [tri[0], tri[2], tri[1]]
                fixed.append(tri)
            tri_count[t, case] = len(fixed)
            for k2, tri in enumerate(fixed):
                tri_edges[t, case, k2] = tri
    return tri_edges, tri_count


TET_TRI_EDGES, TET_TRI_COUNT = _build_tet_tri_table()

# flattened per-cell candidate tables indexed by a 8-bit cube case:
# cube case bit i = occupancy of cube corner i, corners ordered by
# (x, y, z) bits -> index x*4 + y*2 + z
_CUBE_CORNER_IDX = {(x, y, z): x * 4 + y * 2 + z for x in (0, 1) for y in (0, 1) for z in (0, 1)}

# per cube-case [256]: candidate triangles [12] -> (valid, 3 x (class, base_corner))
CELL_TRI_VALID = np.zeros((256, 12), np.int32)
CELL_TRI_CLASS = np.zeros((256, 12, 3), np.int32)
CELL_TRI_BASE = np.zeros((256, 12, 3), np.int32)  # cube corner index of edge base
for cube_case in range(256):
    occ8 = [(cube_case >> i) & 1 for i in range(8)]
    slot = 0
    for t in range(6):
        tet_case = 0
        for ci in range(4):
            corner = tuple(_TET_CORNERS[t, ci])
            if occ8[_CUBE_CORNER_IDX[corner]]:
                tet_case |= 1 << ci
        cnt = TET_TRI_COUNT[t, tet_case]
        for k in range(2):
            if k < cnt:
                CELL_TRI_VALID[cube_case, slot] = 1
                for v in range(3):
                    e = TET_TRI_EDGES[t, tet_case, k, v]
                    CELL_TRI_CLASS[cube_case, slot, v] = TET_EDGE_CLASS[t, e]
                    b = TET_EDGE_BASE[t, e]
                    CELL_TRI_BASE[cube_case, slot, v] = _CUBE_CORNER_IDX[tuple(b)]
            slot += 1
CELL_TRI_COUNT = CELL_TRI_VALID.sum(axis=1).astype(np.int32)

# cube corner offsets by corner index
CUBE_CORNER_OFFSETS = np.zeros((8, 3), np.int32)
for (x, y, z), i in _CUBE_CORNER_IDX.items():
    CUBE_CORNER_OFFSETS[i] = (x, y, z)

# packed per-case triangle table: the k-th VALID triangle of each cube case
# (contiguous, k < CELL_TRI_COUNT[case]) with all three vertices' (edge
# class, base corner) packed into one int32 — 6 bits per vertex
# (class << 3 | corner), vertex v at bit 6v. One gather per face instead of
# three table gathers + an offset-row gather (gathers cost ~8 ns/element on
# TPU, so table-lookup count dominates the face stage).
CELL_TRI_CODE = np.zeros((256, 12), np.int32)
for cube_case in range(256):
    k = 0
    for slot in range(12):
        if not CELL_TRI_VALID[cube_case, slot]:
            continue
        code = 0
        for v in range(3):
            six = (CELL_TRI_CLASS[cube_case, slot, v] << 3) | CELL_TRI_BASE[cube_case, slot, v]
            code |= int(six) << (6 * v)
        CELL_TRI_CODE[cube_case, k] = code
        k += 1

# edge-class direction vectors bit-packed (x<<2 | y<<1 | z) at 3 bits/class,
# decoded arithmetically instead of a row gather from EDGE_CLASS_DIRS
EDGE_CLASS_DIR_BITS = 0
for _i, (_dx, _dy, _dz) in enumerate(EDGE_CLASS_DIRS):
    EDGE_CLASS_DIR_BITS |= int(_dx << 2 | _dy << 1 | _dz) << (3 * _i)


def _build_mc_tables() -> Tuple[np.ndarray, np.ndarray]:
    """Derive MARCHING CUBES triangulations for all 256 cases from first
    principles (no copied Lorensen tables).

    Method: per cube face, marching-squares segments connect the cut edges
    bounding each maximal run of INSIDE perimeter corners (on ambiguous faces
    this is the fixed "separate the inside corners" rule — a function of the
    face's own corners only, so the two cells sharing a face derive the same
    pairing and the mesh stays watertight). Each active cube edge lies on two
    faces and receives exactly two segment endpoints; the segments therefore
    form disjoint closed cycles, which are fan-triangulated. Cycle winding is
    fixed by Newell's normal against the inside->outside direction, matching
    the marching-tets convention above.

    Returns (tri_code [256, MAX] int32 packed like CELL_TRI_CODE,
    tri_count [256]); vertices sit ONLY on the 3 axis edge classes.
    """
    axis_edges = []  # (cls, base_corner)
    for cls in range(3):
        off = EDGE_CLASS_DIRS[cls]
        for b in range(8):
            if CUBE_CORNER_OFFSETS[b][cls] == 0:
                axis_edges.append((cls, b))

    def corner_at(coords):
        return _CUBE_CORNER_IDX[tuple(int(c) for c in coords)]

    def edge_between(a, b):
        oa = CUBE_CORNER_OFFSETS[a]
        ob = CUBE_CORNER_OFFSETS[b]
        diff = [i for i in range(3) if oa[i] != ob[i]]
        assert len(diff) == 1
        cls = diff[0]
        base = a if oa[cls] == 0 else b
        return (cls, base)

    # the 6 faces as perimeter corner cycles
    faces = []
    for d in range(3):
        u, v = [a for a in range(3) if a != d]
        for s in (0, 1):
            cyc = []
            for uu, vv in ((0, 0), (1, 0), (1, 1), (0, 1)):
                c = [0, 0, 0]
                c[d], c[u], c[v] = s, uu, vv
                cyc.append(corner_at(c))
            faces.append(cyc)

    max_tris = 0
    all_tris = {}
    for case in range(256):
        occ = [(case >> i) & 1 for i in range(8)]
        # ---- marching-squares segments per face ----
        conn = {}  # edge -> list of connected edges

        def link(e1, e2):
            conn.setdefault(e1, []).append(e2)
            conn.setdefault(e2, []).append(e1)

        for cyc in faces:
            ins = [occ[c] for c in cyc]
            if all(ins) or not any(ins):
                continue
            for i in range(4):
                if ins[i] and not ins[i - 1]:
                    start = edge_between(cyc[i - 1], cyc[i])
                    j = i
                    while ins[(j + 1) % 4]:
                        j += 1
                    end = edge_between(cyc[j % 4], cyc[(j + 1) % 4])
                    link(start, end)

        # ---- walk cycles ----
        tris = []
        visited = set()
        for e0 in list(conn):
            if e0 in visited:
                continue
            cycle = [e0]
            visited.add(e0)
            prev, cur = None, e0
            while True:
                nxts = [e for e in conn[cur] if e != prev]
                nxt = nxts[0] if nxts else conn[cur][0]
                if nxt == e0:
                    break
                cycle.append(nxt)
                visited.add(nxt)
                prev, cur = cur, nxt
            # orientation: Newell normal vs inside->outside direction
            mids, want = [], np.zeros(3)
            for cls, b in cycle:
                p_in = CUBE_CORNER_OFFSETS[b].astype(np.float64)
                p_out = p_in + EDGE_CLASS_DIRS[cls]
                if not occ[b]:
                    p_in, p_out = p_out, p_in
                mids.append(0.5 * (p_in + p_out))
                want += p_out - p_in
            n = np.zeros(3)
            for i in range(len(mids)):
                n += np.cross(mids[i], mids[(i + 1) % len(mids)])
            if np.dot(n, want) < 0:
                cycle = cycle[::-1]
            for i in range(1, len(cycle) - 1):
                tris.append((cycle[0], cycle[i], cycle[i + 1]))
        all_tris[case] = tris
        max_tris = max(max_tris, len(tris))

    tri_code = np.zeros((256, max_tris), np.int32)
    tri_count = np.zeros((256,), np.int32)
    for case, tris in all_tris.items():
        tri_count[case] = len(tris)
        for k, tri in enumerate(tris):
            code = 0
            for v, (cls, b) in enumerate(tri):
                code |= int((cls << 3) | b) << (6 * v)
            tri_code[case, k] = code
    return tri_code, tri_count


MC_TRI_CODE, MC_TRI_COUNT = _build_mc_tables()
MC_MAX_TRIS = MC_TRI_CODE.shape[1]

_TRI_TABLES = {"mc": (MC_TRI_CODE, MC_TRI_COUNT), "mt": (CELL_TRI_CODE, CELL_TRI_COUNT)}


@functools.lru_cache(maxsize=None)
def tri_tables(method: str, device: torch.device) -> Tuple[torch.Tensor, torch.Tensor]:
    """The packed triangle codes and counts of ``method`` (``"mc"``: ``MC_TRI_CODE``,
    ``MC_TRI_COUNT``; ``"mt"``: ``CELL_TRI_CODE``, ``CELL_TRI_COUNT``) as int64 tensors on
    ``device``, uploaded at the first call there: an extraction after it uploads nothing
    from the host, so it never waits for the device to drain its queue. Every caller
    shares the tensors: they are read, never written."""
    code, count = _TRI_TABLES[method]
    return (torch.as_tensor(code, dtype=torch.long, device=device),
            torch.as_tensor(count, dtype=torch.long, device=device))


class ExtractedMesh(NamedTuple):
    """Fixed-capacity mesh: only entries with mask True are real."""

    verts: torch.Tensor  # [max_verts, 3] normalized grid coords in [0, 1]
    faces: torch.Tensor  # [max_faces, 3] int64 (invalid faces point at vert 0)
    vert_mask: torch.Tensor  # [max_verts] bool
    face_mask: torch.Tensor  # [max_faces] bool
    n_verts: torch.Tensor  # [] (clamped to capacity)
    n_faces: torch.Tensor  # []


def _inverse_compact(csum: torch.Tensor, capacity: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """For each output slot s < capacity, the index of the s-th active element
    of the 0/1 mask whose inclusive cumsum is ``csum``, and whether it exists."""
    slots = torch.arange(1, capacity + 1, dtype=csum.dtype, device=csum.device)
    ids = torch.searchsorted(csum, slots, side="left")
    valid = slots <= csum[-1]
    return torch.where(valid, ids, torch.zeros_like(ids)), valid


def _shifted_neq(occ: torch.Tensor, d) -> torch.Tensor:
    """occ[p] != occ[p + d] where p + d is inside the grid, else False."""
    R = occ.shape[0]
    dx, dy, dz = (int(v) for v in d)
    out = torch.zeros_like(occ)
    out[: R - dx, : R - dy, : R - dz] = occ[: R - dx, : R - dy, : R - dz] ^ occ[dx:, dy:, dz:]
    return out


def _extract_isosurface(sdf: torch.Tensor, deformation: Optional[torch.Tensor],
                        isovalue: float, max_verts: int, max_faces: int,
                        max_cells: Optional[int], deform_scale: float, n_classes: int,
                        method: str) -> ExtractedMesh:
    """Shared capacity-bounded extraction core for marching cubes / tets."""
    R = sdf.shape[0]
    if tuple(sdf.shape) != (R, R, R):
        raise ValueError(f"sdf must be [R, R, R], got {tuple(sdf.shape)}")
    if max_cells is None:
        max_cells = max(max_faces // 4, 1024)
    dev = sdf.device
    nv = R * R * R
    code_tbl, count_tbl = tri_tables(method, dev)
    max_k = code_tbl.shape[1]
    # topology is decided by sdf < isovalue
    occ = (sdf < isovalue).detach()
    sdf_flat = sdf.reshape(-1)

    # ---- edge activity and vertex slots ------------------------------------
    edge_active = torch.stack([_shifted_neq(occ, d) for d in EDGE_CLASS_DIRS[:n_classes]])
    vcsum = torch.cumsum(edge_active.reshape(-1).long(), dim=0)  # [n_classes * nv]
    edge_slot = vcsum - 1  # vertex slot of each active edge

    edge_ids, vert_valid = _inverse_compact(vcsum, max_verts)
    cls = edge_ids // nv
    base = edge_ids % nv
    bi = base // (R * R)
    bj = (base // R) % R
    bk = base % R
    dbits = (EDGE_CLASS_DIR_BITS >> (3 * cls)) & 7
    ei = bi + ((dbits >> 2) & 1)
    ej = bj + ((dbits >> 1) & 1)
    ek = bk + (dbits & 1)
    end = (ei.clamp(0, R - 1) * R + ej.clamp(0, R - 1)) * R + ek.clamp(0, R - 1)

    s0 = sdf_flat[base]
    s1 = sdf_flat[end]
    denom = s1 - s0
    small = torch.where(denom < 0, torch.full_like(denom, -1e-12), torch.full_like(denom, 1e-12))
    safe = torch.where(denom.abs() < 1e-12, small, denom)
    tval = ((isovalue - s0) / safe).clamp(0.0, 1.0)

    p0 = torch.stack([bi, bj, bk], dim=-1).to(sdf.dtype)
    p1 = torch.stack([ei, ej, ek], dim=-1).to(sdf.dtype)
    if deformation is not None:
        dflat = deform_scale * torch.tanh(deformation.reshape(-1, 3))
        p0 = p0 + dflat[base]
        p1 = p1 + dflat[end]
    vpos = (p0 + tval[:, None] * (p1 - p0)) / (R - 1)
    vpos = torch.where(vert_valid[:, None], vpos, torch.zeros_like(vpos))

    # ---- active cells ------------------------------------------------------
    Rc = R - 1
    case = torch.zeros((Rc, Rc, Rc), dtype=torch.long, device=dev)
    for idx in range(8):
        ox, oy, oz = (int(v) for v in CUBE_CORNER_OFFSETS[idx])
        case = case + (occ[ox: ox + Rc, oy: oy + Rc, oz: oz + Rc].long() << idx)
    case_flat = case.reshape(-1)
    cell_active = (case_flat != 0) & (case_flat != 255)
    ccsum = torch.cumsum(cell_active.long(), dim=0)
    cell_ids, cell_valid = _inverse_compact(ccsum, max_cells)
    ccase = case_flat[cell_ids]

    # ---- faces: the k-th triangle of each active cell, in cell order -------
    cellcnt = count_tbl[ccase] * cell_valid.long()
    ccum = torch.cumsum(cellcnt, dim=0)
    fslots = torch.arange(1, max_faces + 1, dtype=torch.long, device=dev)
    f_cell = torch.searchsorted(ccum, fslots, side="left")
    face_valid = fslots <= ccum[-1]
    f_cell = torch.where(face_valid, f_cell.clamp(max=max_cells - 1), torch.zeros_like(f_cell))
    prev = torch.where(f_cell > 0, ccum[(f_cell - 1).clamp(min=0)], torch.zeros_like(f_cell))
    k = (fslots - 1 - prev).clamp(0, max_k - 1)

    code = code_tbl[ccase[f_cell], k]
    f_cellid = cell_ids[f_cell]
    f_ci = f_cellid // (Rc * Rc)
    f_cj = (f_cellid // Rc) % Rc
    f_ck = f_cellid % Rc
    six = torch.stack([code & 63, (code >> 6) & 63, (code >> 12) & 63], dim=-1)
    tri_cls = six >> 3
    basec = six & 7
    gi = f_ci[:, None] + ((basec >> 2) & 1)
    gj = f_cj[:, None] + ((basec >> 1) & 1)
    gk = f_ck[:, None] + (basec & 1)
    gedge = tri_cls * nv + (gi * R + gj) * R + gk
    slots = edge_slot[gedge]
    # drop faces that reference vertices past the capacity
    face_valid = face_valid & (slots < max_verts).all(dim=-1)
    faces = torch.where(face_valid[:, None], slots.clamp(max=max_verts - 1),
                        torch.zeros_like(slots))

    return ExtractedMesh(
        verts=vpos, faces=faces, vert_mask=vert_valid, face_mask=face_valid,
        n_verts=vcsum[-1].clamp(max=max_verts), n_faces=ccum[-1].clamp(max=max_faces),
    )


def marching_tets(sdf: torch.Tensor, deformation: Optional[torch.Tensor] = None,
                  isovalue: float = 0.0, max_verts: int = 65536, max_faces: int = 131072,
                  max_cells: Optional[int] = None, deform_scale: float = 0.5) -> ExtractedMesh:
    """Welded mesh by marching tetrahedra (6 tets a cell).

    sdf [R, R, R] (axis order x, y, z); deformation [R, R, R, 3] raw
    (tanh-bounded). Vertices come in normalized [0, 1] grid coordinates.
    """
    return _extract_isosurface(sdf, deformation, isovalue, max_verts, max_faces, max_cells,
                               deform_scale, 7, "mt")


def marching_cubes(sdf: torch.Tensor, deformation: Optional[torch.Tensor] = None,
                   isovalue: float = 0.0, max_verts: int = 65536, max_faces: int = 131072,
                   max_cells: Optional[int] = None, deform_scale: float = 0.5) -> ExtractedMesh:
    """Welded mesh by marching cubes (derived tables); same contract as
    :func:`marching_tets`, with vertices only on the three axis edge classes."""
    if max_cells is None:
        # about 2 triangles per active cell, so cells are a larger share of the faces
        max_cells = max(max_faces // 2, 1024)
    return _extract_isosurface(sdf, deformation, isovalue, max_verts, max_faces, max_cells,
                               deform_scale, 3, "mc")


def extract_isosurface(sdf: torch.Tensor, deformation: Optional[torch.Tensor] = None,
                       method: str = "mc", **kw) -> ExtractedMesh:
    """Dispatch to :func:`marching_cubes` (``"mc"``, the default) or
    :func:`marching_tets` (``"mt"``)."""
    if method == "mc":
        return marching_cubes(sdf, deformation, **kw)
    if method == "mt":
        import warnings

        warnings.warn(
            "isosurface method 'mt' emits ~2x more vertices/faces than 'mc'; the default "
            "capacities are sized for 'mc' -- double max_verts/max_faces for 'mt' or "
            "overflow is silently mask-dropped", stacklevel=2)
        return marching_tets(sdf, deformation, **kw)
    raise ValueError(f"Unknown isosurface method {method}")


def force_field_crossing(sdf: torch.Tensor, resolution: int) -> torch.Tensor:
    """Branchless empty-field fallback: when the field has no sign change, push
    a centre cube below zero and the border above it. ``sdf`` holds R³ values in
    any shape; gradients flow as in the JAX version (through ``max`` / ``min``
    when the fallback applies)."""
    R = resolution
    flat = sdf.reshape(-1)
    has_crossing = (flat > 0).any() & (flat < 0).any()
    ar = torch.arange(R, device=sdf.device)
    ijk = torch.stack(torch.meshgrid(ar, ar, ar, indexing="ij"), dim=-1).reshape(-1, 3)
    c = (R - 1) / 2.0
    dist2center = (ijk - c).abs().amax(dim=-1)
    center_mask = dist2center <= (R // 8)
    border_mask = (ijk.amin(dim=-1) == 0) | (ijk.amax(dim=-1) == R - 1)
    update = (center_mask.to(flat.dtype) * (-1.0 - flat.max())
              + border_mask.to(flat.dtype) * (1.0 - flat.min()))
    return torch.where(has_crossing, flat, flat + update).reshape(sdf.shape)
