"""Isosurface extraction on the host: marching tetrahedra (native C++ or numpy).

The port's own copy of ``lbm_ferrofluid_tpu/render/mesh.py``: the native
C++ extractor (``native/``, built at first use) where a C++ compiler
exists, as the JAX package takes its native twin where it is built, and
the numpy path (:func:`marching_tetrahedra_numpy`, the plain version the
native one is held against; the same triangle set, in another order, with
vertices rounded through float32 volumes).  It plays the role
of PyMCubes in the reference render path (src/LBM/utils/io.py:59-61):
extract a triangle mesh of ``volume == level``.  Marching tetrahedra (each
cell split into 6 tets around the main diagonal) gives a watertight
surface with simple, table-free case logic that vectorizes cleanly;
triangulation differs from classic marching cubes but the surface is the
same isosurface, which is what the renderer and OBJ export consume.

Vertices are returned in array-index coordinates ``(i, j, k)`` for a volume
indexed ``volume[i, j, k]`` — the same convention as ``mcubes``.
"""

from __future__ import annotations

import numpy as np

from .. import native

__all__ = ["marching_tetrahedra", "marching_tetrahedra_numpy", "marching_cubes"]

# cube corners as (di, dj, dk), index = di*4 + dj*2 + dk
_CORNERS = np.array(
    [[i >> 2 & 1, i >> 1 & 1, i & 1] for i in range(8)], dtype=np.int64
)

# 6 tetrahedra sharing the main diagonal corner0 -> corner7
_TETS = np.array(
    [
        [0, 1, 3, 7],
        [0, 3, 2, 7],
        [0, 2, 6, 7],
        [0, 6, 4, 7],
        [0, 4, 5, 7],
        [0, 5, 1, 7],
    ],
    dtype=np.int64,
)

# triangle emission per 4-bit inside-pattern: list of triangles, each triangle
# a triple of edges, each edge a (corner_a, corner_b) pair within the tet.
# orientation is made consistent per case (inside -> outside); the renderer
# shades double-sided (fill_back) regardless.
def _case_table():
    table = {}
    for case in range(16):
        inside = [i for i in range(4) if case >> i & 1]
        outside = [i for i in range(4) if not case >> i & 1]
        tris = []
        if len(inside) == 1:
            a = inside[0]
            b, c, d = outside
            tris = [((a, b), (a, c), (a, d))]
        elif len(inside) == 3:
            a = outside[0]
            b, c, d = inside
            tris = [((a, b), (a, d), (a, c))]
        elif len(inside) == 2:
            a, b = inside
            c, d = outside
            tris = [
                ((a, c), (a, d), (b, d)),
                ((a, c), (b, d), (b, c)),
            ]
        table[case] = tris
    return table


_TABLE = _case_table()


def marching_tetrahedra(volume: np.ndarray, level: float = 0.0):
    """Extract the ``volume == level`` isosurface: the native extractor
    where it builds (``native.available()``), else
    :func:`marching_tetrahedra_numpy`.  Returns (verts ``[N, 3]`` float32
    in index coords, faces ``[M, 3]`` int64)."""
    if native.available():
        return native.marching_tetrahedra_native(np.asarray(volume), level)
    return marching_tetrahedra_numpy(volume, level)


def marching_tetrahedra_numpy(volume: np.ndarray, level: float = 0.0):
    """Extract the ``volume == level`` isosurface, vectorized in numpy.

    Args:
        volume: ``[D, H, W]`` scalar field.
        level: iso value.

    Returns:
        (verts ``[N, 3]`` float32 in index coords, faces ``[M, 3]`` int64)
    """
    volume = np.asarray(volume, dtype=np.float64)
    D, H, W = volume.shape
    if min(D, H, W) < 2:
        return np.zeros((0, 3), np.float32), np.zeros((0, 3), np.int64)

    # cell origins
    oi, oj, ok = np.meshgrid(
        np.arange(D - 1), np.arange(H - 1), np.arange(W - 1), indexing="ij"
    )
    origins = np.stack([oi.ravel(), oj.ravel(), ok.ravel()], axis=1)  # [N, 3]

    # global node ids + values at the 8 corners of each cell
    node_id = lambda idx: (idx[:, 0] * H + idx[:, 1]) * W + idx[:, 2]  # noqa: E731
    corner_ids = np.stack(
        [node_id(origins + _CORNERS[c]) for c in range(8)], axis=1
    )  # [N, 8]
    vflat = volume.ravel()
    corner_vals = vflat[corner_ids]  # [N, 8]

    # discard cells with no crossing early
    lo = corner_vals.min(axis=1)
    hi = corner_vals.max(axis=1)
    active = (lo < level) & (hi >= level)
    if not active.any():
        return np.zeros((0, 3), np.float32), np.zeros((0, 3), np.int64)
    corner_ids = corner_ids[active]
    corner_vals = corner_vals[active]

    # collect triangles as [n_tri, 3, 2] edge-endpoint node ids
    tri_edges = []
    for tet in _TETS:
        tvals = corner_vals[:, tet]
        tids = corner_ids[:, tet]
        inside = tvals < level
        case = (
            inside[:, 0] * 1 + inside[:, 1] * 2 + inside[:, 2] * 4 + inside[:, 3] * 8
        )
        for c in range(1, 15):
            sel = np.nonzero(case == c)[0]
            if sel.size == 0:
                continue
            for tri in _TABLE[c]:
                e = np.stack(
                    [
                        np.stack([tids[sel, a], tids[sel, b]], axis=1)
                        for (a, b) in tri
                    ],
                    axis=1,
                )  # [n, 3, 2]
                tri_edges.append(e)
    if not tri_edges:
        return np.zeros((0, 3), np.float32), np.zeros((0, 3), np.int64)
    tri_edges = np.concatenate(tri_edges, axis=0)  # [M, 3, 2]

    # canonical edge keys for dedup
    e_lo = np.minimum(tri_edges[..., 0], tri_edges[..., 1])
    e_hi = np.maximum(tri_edges[..., 0], tri_edges[..., 1])
    keys = e_lo.astype(np.int64) * (D * H * W) + e_hi
    uniq, inv = np.unique(keys.ravel(), return_inverse=True)
    faces = inv.reshape(-1, 3)

    # interpolate unique vertex positions
    ua = (uniq // (D * H * W)).astype(np.int64)
    ub = (uniq % (D * H * W)).astype(np.int64)
    va = vflat[ua]
    vb = vflat[ub]
    t = np.clip((level - va) / np.where(vb == va, 1.0, vb - va), 0.0, 1.0)

    def node_pos(nid):
        k = nid % W
        j = (nid // W) % H
        i = nid // (W * H)
        return np.stack([i, j, k], axis=1).astype(np.float64)

    verts = node_pos(ua) + t[:, None] * (node_pos(ub) - node_pos(ua))

    # drop degenerate triangles (repeated vertex indices)
    good = (
        (faces[:, 0] != faces[:, 1])
        & (faces[:, 1] != faces[:, 2])
        & (faces[:, 0] != faces[:, 2])
    )
    return verts.astype(np.float32), faces[good].astype(np.int64)


def marching_cubes(volume, level: float = 0.0):
    """API twin of the reference's ``mcubes.marching_cubes``
    (src/LBM/utils/io.py:59-61): true 256-case cell-edge marching cubes
    (render/mcubes.py, table generated at import, watertight by
    construction).  Marching tetrahedra stays the default extractor of the
    render path (it has an on-device twin, render/mesh_torch.py); pass
    method="mc" to phi_to_mesh/render_phi_frame to use this one there."""
    from .mcubes import marching_cubes_classic

    return marching_cubes_classic(volume, level)
