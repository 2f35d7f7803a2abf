"""Mesh voxelization: surface rasterization and interior flood fill.

Port of ``lbm_ferrofluid_tpu/render/voxelize.py``, which reimplements the
reference's CUDA extension (renderutils/cuda/voxelization_cuda_kernel.cu):

* ``voxelize_surface`` <- voxelize_sub1 (:29-86): for each (y, x) column a
  ray-triangle barycentric test stamps the voxel at the face's depth and
  its (y-1, x), (y, x-1) and (y-1, x-1) neighbours;
* ``voxelize_vertices`` <- voxelize_sub2 (:89-118): stamp vertex cells;
* ``fill_interior`` <- voxelize_sub3/4 (:119-190): visibility flooded in
  from the boundary by dilation until nothing changes; solid = not
  visible.

The coordinate convention is the reference's: face vertex components are
(y, x, z) and the voxel grid is indexed [y, x, z].  The JAX module has no
Pallas kernel; this is its plain PyTorch counterpart on the faces' device.
A chunk's hits are scattered into the grid instead of the JAX module's
one-hot stamp over z (the same union of cells), and each chunk tests only
the columns near its faces.
"""

from __future__ import annotations

import torch

__all__ = ["voxelize_surface", "voxelize_vertices", "fill_interior", "voxelize"]


def voxelize_surface(faces, voxel_size: int, voxels=None, face_chunk: int = 64):
    """Surface voxelization (sub1) of ``faces`` [B, F, 3, 3] with (y, x, z)
    components -> int32 [B, vs, vs, vs] (ORed into ``voxels`` if given).
    Each chunk of faces tests only the columns of its (y, x) box widened
    by a column a side (the JAX module tests every column: a column
    further out is no hit)."""
    B, F = faces.shape[:2]
    vs, dev = voxel_size, faces.device
    vox = (torch.zeros((B, vs, vs, vs), dtype=torch.bool, device=dev) if voxels is None
           else voxels != 0)
    if F == 0:
        return vox.to(torch.int32)
    n_chunks = -(-F // face_chunk)
    pad = n_chunks * face_chunk - F
    yx = faces[..., :2].detach().transpose(0, 1).reshape(F, -1, 2)  # [F, B*3, 2]
    yx = torch.cat([yx, yx[-1:].expand(pad, -1, -1)]).reshape(n_chunks, -1, 2)
    lo = (torch.floor(yx.amin(dim=1)) - 1).clamp(0, vs).long().tolist()
    hi = (torch.ceil(yx.amax(dim=1)) + 2).clamp(0, vs).long().tolist()
    for c, ((y0, x0), (y1, x1)) in enumerate(zip(lo, hi)):
        if y1 <= y0 or x1 <= x0:
            continue
        fb = faces[:, c * face_chunk:(c + 1) * face_chunk, :, :, None, None]
        Y = torch.arange(y0, y1, dtype=faces.dtype, device=dev)[:, None]
        X = torch.arange(x0, x1, dtype=faces.dtype, device=dev)[None, :]
        v0 = fb[:, :, 0]  # [B, C, 3, 1, 1]
        y1d, x1d, z1d = (fb[:, :, 1, i] - v0[:, :, i] for i in range(3))
        y2d, x2d, z2d = (fb[:, :, 2, i] - v0[:, :, i] for i in range(3))
        ypd = Y - v0[:, :, 0]
        xpd = X - v0[:, :, 1]
        det = x1d * y2d - x2d * y1d
        safe_det = torch.where(det == 0, 1.0, det)
        t1 = (y2d * xpd - x2d * ypd) / safe_det
        t2 = (-y1d * xpd + x1d * ypd) / safe_det
        z = torch.floor(t1 * z1d + t2 * z2d + v0[:, :, 2]).to(torch.int32)
        hit = (det != 0) & (t1 >= 0) & (t2 >= 0) & (t1 + t2 <= 1) & (z >= 0) & (z < vs)
        b, _, y, x = hit.nonzero(as_tuple=True)
        zz = z[hit].long()
        y, x = y + y0, x + x0
        # the hit cell and its (y-1, x), (y, x-1), (y-1, x-1) neighbours
        for dy, dx in ((0, 0), (1, 0), (0, 1), (1, 1)):
            keep = (y >= dy) & (x >= dx)
            vox[b[keep], y[keep] - dy, x[keep] - dx, zz[keep]] = True
    return vox.to(torch.int32)


def voxelize_vertices(faces, voxel_size: int, voxels=None):
    """Stamp the floor(vertex) cells (sub2) -> int32 [B, vs, vs, vs]."""
    B, F = faces.shape[:2]
    vs = voxel_size
    vox = (torch.zeros((B, vs, vs, vs), dtype=torch.int32, device=faces.device)
           if voxels is None else voxels.to(torch.int32).clone())
    v = torch.floor(faces.reshape(B, F * 3, 3)).long()
    ok = ((v >= 0) & (v < vs)).all(dim=-1)
    b = torch.arange(B, device=faces.device)[:, None].expand(B, F * 3)[ok]
    vv = v[ok]
    vox[b, vv[:, 0], vv[:, 1], vv[:, 2]] = 1
    return vox


def fill_interior(voxels):
    """Flood exterior visibility in from the boundary and solidify the rest
    (sub3, then sub4 iterated until nothing changes) -> int32."""
    vs = voxels.shape[1]
    empty = voxels == 0
    boundary = torch.zeros((vs, vs, vs), dtype=torch.bool, device=voxels.device)
    for axis in range(3):
        boundary.index_fill_(axis, torch.tensor([0, vs - 1], device=voxels.device), True)
    visible = empty & boundary
    while True:
        grown = visible.clone()
        for axis in (1, 2, 3):
            lo = [slice(None)] * 4
            hi = [slice(None)] * 4
            lo[axis], hi[axis] = slice(0, vs - 1), slice(1, vs)
            grown[tuple(hi)] |= visible[tuple(lo)]
            grown[tuple(lo)] |= visible[tuple(hi)]
        grown &= empty
        if torch.equal(grown, visible):
            return (~visible).to(torch.int32)
        visible = grown


def voxelize(faces, voxel_size: int, *, normalize: bool = False):
    """Surface, vertices and interior fill.  With ``normalize`` the faces
    (in [0, 1]) are scaled to the grid, as the reference's wrapper does."""
    if normalize:
        faces = faces * (voxel_size - 1)
    vox = voxelize_surface(faces, voxel_size)
    return fill_interior(voxelize_vertices(faces, voxel_size, vox))
