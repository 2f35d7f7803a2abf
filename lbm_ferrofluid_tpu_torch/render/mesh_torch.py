"""On-device isosurface extraction: marching tetrahedra in PyTorch.

Port of ``lbm_ferrofluid_tpu/render/mesh_jax.py``, the fixed-topology twin
of the host extractor ``render/mesh.py``: ``volume -> (verts, faces,
count)`` on the volume's device, whose output shapes are set by a
triangle budget, so that phi -> mesh -> image runs on the card and only
the image is read back (reference path: src/LBM/utils/io.py:50-84,
mcubes.marching_cubes at :59-61).

* the same 6-tet main-diagonal cell split and per-case triangle tables as
  ``render/mesh.py`` (as dense [6, 16, 2-slot] tables with a valid mask),
  and the same canonical (min node id) edge-interpolation order, so the
  emitted triangle set is the host extractor's (vertices are per
  triangle here, not shared, which is what the rasterizer consumes; OBJ
  export keeps the host path's shared vertices);
* cell layers are taken a group at a time (a bounded candidate tensor),
  and the active triangles are compacted in the JAX module's order (layer,
  tet, slot, cell) into a ``budget``-row buffer by a prefix sum;
* unused rows hold far-away degenerate triangles that the renderer's z
  clip rejects; ``count`` is the true triangle count, and a count above
  ``budget`` means the surface overflowed the buffer.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F_

from .mesh import _CORNERS, _TABLE, _TETS

__all__ = ["marching_tetrahedra_torch", "phi_to_mesh_torch", "MT_FAR"]

MT_FAR = 1e6

#: candidate triangles a group of cell layers may hold
GROUP_CANDIDATES = 1 << 21


def _dense_tables():
    """[6, 16, 2, 3, 2] cube-corner edge table + [6, 16, 2] valid mask."""
    tri = np.zeros((6, 16, 2, 3, 2), np.int64)
    valid = np.zeros((6, 16, 2), bool)
    for t, tet in enumerate(_TETS):
        for case in range(16):
            for s, edges in enumerate(_TABLE[case]):
                for e, (a, b) in enumerate(edges):
                    tri[t, case, s, e, 0] = tet[a]
                    tri[t, case, s, e, 1] = tet[b]
                valid[t, case, s] = True
    return tri, valid


_TRI_D, _VALID_D = _dense_tables()


def marching_tetrahedra_torch(volume, level: float = 0.0, budget: int = 1 << 16,
                              pad_vertex: tuple | None = None):
    """Extract the ``volume == level`` isosurface on the volume's device.

    Args:
        volume: ``[D, H, W]`` scalar tensor (any float type; computed in
            float32).
        level: iso value.
        budget: triangle budget.
        pad_vertex: the point of the unused rows (default (MT_FAR,) * 3).
            A caller feeding a renderer should pick a point its camera
            clips cheaply (z beyond far, as :func:`phi_to_mesh_torch`
            does): a point behind the camera projects to screen
            coordinates that overflow the tiled rasterizer's residual
            capacity and send it to the dense pass.

    Returns:
        verts ``[budget * 3, 3]`` float32 in index coords (i, j, k), 3 a
        triangle; faces ``[budget, 3]`` int64, ``arange`` (static
        topology); count, a 0-d int64 tensor: the triangles found.
    """
    dev = volume.device
    D, H, W = volume.shape
    vol = volume.to(torch.float32)
    Hc, Wc = H - 1, W - 1
    tri_t = torch.as_tensor(_TRI_D, device=dev)
    valid_t = torch.as_tensor(_VALID_D, device=dev)
    corners = torch.as_tensor(_CORNERS, device=dev)  # [8, 3] (di, dj, dk)
    tets = torch.as_tensor(_TETS, device=dev)  # [6, 4]
    bit = torch.tensor([1, 2, 4, 8], device=dev)
    jj = torch.arange(Hc, device=dev).view(Hc, 1)
    kk = torch.arange(Wc, device=dev).view(1, Wc)

    if pad_vertex is None:
        pad_vertex = (MT_FAR,) * 3
    buf = torch.tensor(pad_vertex, dtype=torch.float32, device=dev).expand(
        budget + 1, 3, 3).clone()
    count = torch.zeros((), dtype=torch.int64, device=dev)
    per_layer = 12 * max(Hc * Wc, 1)
    group = max(1, GROUP_CANDIDATES // per_layer)
    for l0 in range(0, D - 1, group):
        nl = min(group, D - 1 - l0)
        # corner values [nl, Hc, Wc, 8] (corner index = di*4 + dj*2 + dk)
        c8 = torch.stack([vol[l0 + int(c[0]):l0 + int(c[0]) + nl,
                              int(c[1]):int(c[1]) + Hc, int(c[2]):int(c[2]) + Wc]
                          for c in _CORNERS], dim=-1)
        inside = (c8 < level).to(torch.int64)
        case = (inside[..., tets] * bit).sum(-1)  # [nl, Hc, Wc, 6]
        case = case.permute(0, 3, 1, 2)  # [nl, 6, Hc, Wc]
        t_idx = torch.arange(6, device=dev).view(1, 6, 1, 1)
        act = valid_t[t_idx, case].permute(0, 1, 4, 2, 3)  # [nl, 6, 2, Hc, Wc]
        edges = tri_t[t_idx, case].permute(0, 1, 4, 2, 3, 5, 6)  # [nl,6,2,Hc,Wc,3,2]
        off = corners[edges]  # [nl,6,2,Hc,Wc,3,2,3]
        layer = (l0 + torch.arange(nl, device=dev)).view(nl, 1, 1, 1, 1, 1, 1)
        nid = ((layer + off[..., 0]) * H + (jj.view(1, 1, 1, Hc, 1, 1, 1) + off[..., 1])) * W + (
            kk.view(1, 1, 1, 1, Wc, 1, 1) + off[..., 2])  # [nl,6,2,Hc,Wc,3,2]
        # canonical (min node id) endpoint order: the host extractor
        # interpolates from the lower node id
        swap = nid[..., 0] > nid[..., 1]
        ea = torch.where(swap, edges[..., 1], edges[..., 0])  # [nl,6,2,Hc,Wc,3]
        eb = torch.where(swap, edges[..., 0], edges[..., 1])
        c8e = c8[:, None, None].expand(nl, 6, 2, Hc, Wc, 8)
        va = torch.gather(c8e, -1, ea)
        vb = torch.gather(c8e, -1, eb)
        pa = corners[ea].to(torch.float32)  # [nl,6,2,Hc,Wc,3,3]
        pb = corners[eb].to(torch.float32)
        tt = torch.clamp((level - va) / torch.where(vb == va, 1.0, vb - va), 0.0, 1.0)[..., None]
        origin = torch.stack(torch.broadcast_tensors(
            layer[..., 0, 0].to(torch.float32), jj.view(1, 1, 1, Hc, 1).to(torch.float32),
            kk.view(1, 1, 1, 1, Wc).to(torch.float32)), dim=-1)[..., None, :]
        p = origin + pa + tt * (pb - pa)  # [nl,6,2,Hc,Wc,3,3]
        act = act.reshape(-1)
        pos = torch.cumsum(act.to(torch.int64), 0) - 1 + count
        dst = torch.where(act & (pos < budget), pos, budget)
        buf[dst] = p.reshape(-1, 3, 3)
        count = count + act.sum()
    verts = buf[:budget].reshape(budget * 3, 3)
    faces = torch.arange(budget * 3, device=dev).reshape(budget, 3)
    return verts, faces, count


def phi_to_mesh_torch(phi, res, dx: float = 1.0, budget: int = 1 << 16):
    """Device twin of ``render.phi_to_mesh`` (reference utils/io.py:50-64):
    close the surface by padding the interior with phi.max, extract the
    -phi isosurface at 0, normalize vertices to [-1, 1]; all on phi's
    device."""
    p = phi[0, 0] if phi.ndim == 5 else phi
    p = p.to(torch.float32)
    closed = F_.pad(p[1:-1, 1:-1, 1:-1], (1, 1) * 3, value=0.0)
    edge = F_.pad(torch.zeros_like(p[1:-1, 1:-1, 1:-1]), (1, 1) * 3, value=1.0)
    closed = closed + edge * torch.max(p)
    volume = -closed * (2.0 / max(res) / dx)
    # the pad vertex normalizes to (0, 0, MT_FAR), beyond the renderer's
    # far plane (see marching_tetrahedra_torch)
    m = max(res)
    pad = (res[0] / 2.0, res[1] / 2.0, MT_FAR * m / 2.0 + res[2] / 2.0)
    verts, faces, count = marching_tetrahedra_torch(volume, 0.0, budget, pad_vertex=pad)
    verts = (verts - torch.tensor(res, dtype=torch.float32, device=verts.device) / 2.0) * (
        2.0 / max(res))
    return verts, faces, count
