"""Classic 256-case marching cubes (the reference's PyMCubes role).

The port's own copy of ``lbm_ferrofluid_tpu/render/mcubes.py``.

The reference extracts isosurfaces with ``mcubes.marching_cubes``
(src/LBM/utils/io.py:59-61); this repo's default extractor is marching
tetrahedra (render/mesh.py, same isosurface, different triangulation).
This module closes that last behavioral deviation with a true 256-case
cell-edge marching-cubes extractor — WITHOUT transcribing the classic
triangle table (a single mistyped entry of the 256x16 table silently
punches holes): the table is GENERATED at import time from first
principles, and is watertight BY CONSTRUCTION:

* on every cube face the isoline segments connect the crossed face edges
  by the marching-squares rule (walk the face's corner cycle as seen from
  OUTSIDE the cube; pair each inside->outside crossing with the next
  outside->inside crossing), with the ambiguous 4-crossing face resolved
  by the FIXED topological choice this rule implies (the diagonal inside
  corners join).  The rule depends only on the face's 4 corner signs, and
  the two cells sharing a face see the same signs — so their boundaries
  agree edge-for-edge: no cracks, ever.
* each crossed cube edge is a segment START on exactly one of its two
  faces and an END on the other (the shared edge is traversed in opposite
  directions by the two faces' outside-view cycles), so the segments of a
  cell close into disjoint oriented polygons,
* polygons with >= 4 vertices are triangulated around their CENTROID (a
  per-cell vertex) instead of a fan: a fan diagonal connects two edge
  crossings, and when both lie on an ambiguous (4-crossing) face the
  neighboring cell's fan can pick the SAME diagonal — four triangles
  meeting at one edge, a non-manifold pinch (observed on noisy fields).
  Centroid edges are private to their cell, so every interior edge is
  matched exactly once in each direction: the mesh is watertight AND
  manifold.

The triangulation is therefore canonical classic MC (Lorensen-Cline cell
topology with a fixed ambiguity resolution, like the standard published
tables; PyMCubes additionally implements Lewiner's value-based MC33
disambiguation — a documented difference in the ambiguous cases only).
Verified in tests/test_mcubes.py: closed surfaces are watertight (every
undirected edge shared by exactly 2 faces with opposite orientation) and
Hausdorff-close to both the analytic surface and the MT mesh.

Vertex/convention parity with render/mesh.py: corner index = di*4+dj*2+dk,
inside = value < level, canonical (min node id) edge interpolation,
vertices in array-index coordinates.
"""

from __future__ import annotations

import numpy as np

from .mesh import _CORNERS

__all__ = ["marching_cubes_classic", "MC_TRI_TABLE",
           "MC_POLY_TABLE", "MC_EDGES"]

# 12 cube edges as canonical (corner_a < corner_b) pairs
MC_EDGES = np.array(
    [
        (a, b)
        for a in range(8)
        for b in range(a + 1, 8)
        if bin(a ^ b).count("1") == 1
    ],
    dtype=np.int64,
)
_EDGE_ID = {(int(a), int(b)): i for i, (a, b) in enumerate(MC_EDGES)}


def _faces_ccw_outside():
    """6 faces as corner cycles, counterclockwise viewed from OUTSIDE."""
    axes = np.eye(3, dtype=int)
    faces = []
    for a in range(3):
        u, v = (a + 1) % 3, (a + 2) % 3
        for s in (0, 1):
            normal = axes[a] * (1 if s else -1)
            # order (u, v) so u_dir x v_dir == outward normal
            ud, vd = axes[u], axes[v]
            if np.cross(ud, vd) @ normal < 0:
                ud, vd = vd, ud
            cyc = []
            for du, dv in ((0, 0), (1, 0), (1, 1), (0, 1)):
                coord = axes[a] * s + ud * du + vd * dv
                # corner index convention: (di, dj, dk) -> di*4 + dj*2 + dk
                cyc.append(coord[0] * 4 + coord[1] * 2 + coord[2])
            faces.append(cyc)
    return faces


_FACES = _faces_ccw_outside()


def _case_triangles(case):
    """Oriented triangles (as cube-edge-id triples) for one sign case."""
    inside = [(case >> c) & 1 == 1 for c in range(8)]
    # directed segments start_edge -> end_edge per face
    nxt = {}
    for cyc in _FACES:
        crossings = []  # (position, edge_id, is_start) in cycle order
        for i in range(4):
            pa, pb = cyc[i], cyc[(i + 1) % 4]
            if inside[pa] != inside[pb]:
                eid = _EDGE_ID[(min(pa, pb), max(pa, pb))]
                crossings.append((i, eid, inside[pa]))
        for i, (pos, eid, is_start) in enumerate(crossings):
            if not is_start:
                continue
            # next end in cyclic crossing order
            for di in range(1, len(crossings) + 1):
                pos2, eid2, st2 = crossings[(i + di) % len(crossings)]
                if not st2:
                    nxt[eid] = eid2
                    break
    tris = []
    polys = []  # >=4-gons, triangulated via centroid vertex 12 + index
    seen = set()
    for start in list(nxt):
        if start in seen:
            continue
        cycle = [start]
        seen.add(start)
        cur = nxt[start]
        while cur != start:
            cycle.append(cur)
            seen.add(cur)
            cur = nxt[cur]
        if len(cycle) == 3:
            tris.append(tuple(cycle))
        else:
            cid = 12 + len(polys)
            polys.append(list(cycle))
            for i in range(len(cycle)):
                tris.append(
                    (cycle[i], cycle[(i + 1) % len(cycle)], cid)
                )
    return tris, polys


def _build_table():
    per_case = [_case_triangles(c) for c in range(256)]
    maxt = max(len(t) for t, _ in per_case)
    maxp = max((len(p) for _, ps in per_case for p in ps), default=0)
    maxn = max((len(ps) for _, ps in per_case), default=0)
    tab = np.full((256, maxt, 3), -1, np.int64)
    ptab = np.full((256, maxn, maxp), -1, np.int64)
    for c, (tris, polys) in enumerate(per_case):
        for i, t in enumerate(tris):
            tab[c, i] = t
        for p, cyc in enumerate(polys):
            ptab[c, p, : len(cyc)] = cyc
    return tab, ptab


#: MC_TRI_TABLE [256, max_tris, 3]: cube-edge ids (or 12+p = centroid of
#: polygon p) per sign case, -1 rows invalid.  MC_POLY_TABLE
#: [256, max_polys, max_len]: the edge ids of each >=4-gon (for centroid
#: computation), -1 padded.
MC_TRI_TABLE, MC_POLY_TABLE = _build_table()


def marching_cubes_classic(volume: np.ndarray, level: float = 0.0):
    """Classic marching cubes of the ``volume == level`` isosurface.

    Same signature/conventions as :func:`render.mesh.marching_tetrahedra`
    (vertices in index coords, deduped on canonical edge keys).
    """
    volume = np.asarray(volume, dtype=np.float64)
    D, H, W = volume.shape
    if min(D, H, W) < 2:
        return np.zeros((0, 3), np.float32), np.zeros((0, 3), np.int64)

    oi, oj, ok = np.meshgrid(
        np.arange(D - 1), np.arange(H - 1), np.arange(W - 1), indexing="ij"
    )
    origins = np.stack([oi.ravel(), oj.ravel(), ok.ravel()], axis=1)
    node_id = lambda idx: (idx[:, 0] * H + idx[:, 1]) * W + idx[:, 2]  # noqa: E731
    corner_ids = np.stack(
        [node_id(origins + _CORNERS[c]) for c in range(8)], axis=1
    )
    vflat = volume.ravel()
    corner_vals = vflat[corner_ids]

    inside = corner_vals < level
    case = (inside << np.arange(8)[None, :]).sum(axis=1)
    active = (case > 0) & (case < 255)
    if not active.any():
        return np.zeros((0, 3), np.float32), np.zeros((0, 3), np.int64)
    corner_ids = corner_ids[active]
    corner_vals = corner_vals[active]
    case = case[active]

    NN = D * H * W

    def node_pos(nid):
        k = nid % W
        j = (nid // W) % H
        i = nid // (W * H)
        return np.stack([i, j, k], axis=-1).astype(np.float64)

    # crossing point of every cube edge of every active cell, in the
    # canonical (min node id) interpolation order — the same arithmetic
    # the deduped edge vertices use, so centroids are exact means of
    # their polygon's vertices
    na12 = np.take_along_axis(corner_ids, MC_EDGES[None, :, 0], axis=1)
    nb12 = np.take_along_axis(corner_ids, MC_EDGES[None, :, 1], axis=1)
    lo12 = np.minimum(na12, nb12)
    hi12 = np.maximum(na12, nb12)
    va12 = vflat[lo12]
    vb12 = vflat[hi12]
    t12 = np.clip(
        (level - va12) / np.where(vb12 == va12, 1.0, vb12 - va12), 0.0, 1.0
    )
    pts12 = node_pos(lo12) + t12[..., None] * (
        node_pos(hi12) - node_pos(lo12)
    )                                                # [Nact, 12, 3]

    maxp = MC_POLY_TABLE.shape[1]
    polys = MC_POLY_TABLE[case]                      # [Nact, P, L]
    pmask = polys >= 0
    psel = np.clip(polys, 0, 11)
    gath = pts12[np.arange(len(case))[:, None, None], psel]  # [N,P,L,3]
    cnt = pmask.sum(axis=2, keepdims=True)
    cent = (gath * pmask[..., None]).sum(axis=2) / np.maximum(
        cnt, 1
    )                                                # [Nact, P, 3]

    tris = MC_TRI_TABLE[case]                        # [Nact, T, 3]
    valid = tris[..., 0] >= 0
    n_idx, t_idx = np.nonzero(valid)
    tri_e = tris[n_idx, t_idx]                       # [M, 3]
    is_cent = tri_e >= 12

    esel = np.clip(tri_e, 0, 11)
    ca = MC_EDGES[esel][..., 0]
    cb = MC_EDGES[esel][..., 1]
    ids = corner_ids[n_idx]
    na = np.take_along_axis(ids, ca, axis=1)
    nb = np.take_along_axis(ids, cb, axis=1)
    e_lo = np.minimum(na, nb)
    e_hi = np.maximum(na, nb)
    edge_keys = e_lo.astype(np.int64) * NN + e_hi
    # centroid keys: unique per (cell, polygon), negative range
    cent_keys = -(n_idx[:, None] * np.int64(maxp) + (tri_e - 12) + 1)
    keys = np.where(is_cent, cent_keys, edge_keys)
    uniq, inv = np.unique(keys.ravel(), return_inverse=True)
    faces = inv.reshape(-1, 3)

    verts = np.empty((len(uniq), 3), np.float64)
    pos_keys = uniq >= 0
    ua = (uniq[pos_keys] // NN).astype(np.int64)
    ub = (uniq[pos_keys] % NN).astype(np.int64)
    va = vflat[ua]
    vb = vflat[ub]
    t = np.clip((level - va) / np.where(vb == va, 1.0, vb - va), 0.0, 1.0)
    verts[pos_keys] = node_pos(ua) + t[:, None] * (
        node_pos(ub) - node_pos(ua)
    )
    ck = -uniq[~pos_keys] - 1
    verts[~pos_keys] = cent[ck // maxp, ck % maxp]

    good = (
        (faces[:, 0] != faces[:, 1])
        & (faces[:, 1] != faces[:, 2])
        & (faces[:, 0] != faces[:, 2])
    )
    return verts.astype(np.float32), faces[good].astype(np.int64)
