"""Mesh and transform utilities for the DIB-R stack.

The port's own copy of ``lbm_ferrofluid_tpu/render/meshutils.py`` (numpy
in both packages), the numpy ports of renderutils/dibr/utils/{mesh,
transformations,sphericalcoord}.py: OBJ IO (plain, vertex-color,
textured), mesh topology helpers, rotation and rigid-transform algebra,
spherical texture coordinates, and camera parameters from (azimuth,
elevation, distance).  The textured OBJ's PNG is written by the port's own
encoder (``utils/io.py:write_png``), so no imaging package is needed.
"""

from __future__ import annotations

import math
import os

import numpy as np

from ..utils.io import write_png

__all__ = [
    "load_obj",
    "load_obj_tex",
    "save_mesh",
    "save_mesh_color",
    "save_mesh_tex",
    "face2edge",
    "face2edge2",
    "edge2face",
    "face2pfmtx",
    "face2pneimtx",
    "mesh_resample",
    "rotx",
    "roty",
    "rotz",
    "homogenize_points",
    "unhomogenize_points",
    "transform3d",
    "invert_rigid_transform_3d",
    "compose_transforms_3d",
    "compute_camera_params",
    "get_spherical_coords_x",
    "get_spherical_coords_z",
]


# ----------------------------------------------------------------------
# OBJ IO (reference: dibr/utils/mesh.py:172-360)
# ----------------------------------------------------------------------
def load_obj(path):
    """Load vertices and triangle faces from an OBJ file -> (verts, faces)."""
    verts, faces = [], []
    with open(path) as fh:
        for line in fh:
            parts = line.split()
            if not parts:
                continue
            if parts[0] == "v":
                verts.append([float(x) for x in parts[1:4]])
            elif parts[0] == "f":
                idx = [int(p.split("/")[0]) - 1 for p in parts[1:4]]
                faces.append(idx)
    return np.asarray(verts, np.float32), np.asarray(faces, np.int64)


def load_obj_tex(path):
    """Load an OBJ with texture coordinates -> (verts, faces, uvs, face_uvs)."""
    verts, faces, uvs, fuv = [], [], [], []
    with open(path) as fh:
        for line in fh:
            parts = line.split()
            if not parts:
                continue
            if parts[0] == "v":
                verts.append([float(x) for x in parts[1:4]])
            elif parts[0] == "vt":
                uvs.append([float(x) for x in parts[1:3]])
            elif parts[0] == "f":
                vi, ti = [], []
                for p in parts[1:4]:
                    comps = p.split("/")
                    vi.append(int(comps[0]) - 1)
                    if len(comps) > 1 and comps[1]:
                        ti.append(int(comps[1]) - 1)
                faces.append(vi)
                if ti:
                    fuv.append(ti)
    return (
        np.asarray(verts, np.float32),
        np.asarray(faces, np.int64),
        np.asarray(uvs, np.float32) if uvs else None,
        np.asarray(fuv, np.int64) if fuv else None,
    )


def save_mesh(verts, faces, path):
    with open(path, "w") as fh:
        for v in np.asarray(verts).reshape(-1, 3):
            fh.write(f"v {v[0]} {v[1]} {v[2]}\n")
        for f in np.asarray(faces).reshape(-1, 3) + 1:
            fh.write(f"f {f[0]} {f[1]} {f[2]}\n")


def save_mesh_color(verts, faces, path, colors=None):
    with open(path, "w") as fh:
        verts = np.asarray(verts).reshape(-1, 3)
        if colors is None:
            colors = np.full_like(verts, 0.5)
        colors = np.asarray(colors).reshape(-1, 3)
        for v, c in zip(verts, colors):
            fh.write(f"v {v[0]} {v[1]} {v[2]} {c[0]} {c[1]} {c[2]}\n")
        for f in np.asarray(faces).reshape(-1, 3) + 1:
            fh.write(f"f {f[0]} {f[1]} {f[2]}\n")


def save_mesh_tex(verts, uvs, faces, path, texture_image=None):
    """OBJ + MTL + texture PNG, as the reference's savemeshtes."""
    base, _ = os.path.splitext(path)
    mtl = base + ".mtl"
    with open(path, "w") as fh:
        fh.write(f"mtllib {os.path.basename(mtl)}\n")
        for v in np.asarray(verts).reshape(-1, 3):
            fh.write(f"v {v[0]} {v[1]} {v[2]}\n")
        for t in np.asarray(uvs).reshape(-1, 2):
            fh.write(f"vt {t[0]} {t[1]}\n")
        fh.write("usemtl material_0\n")
        for f in np.asarray(faces).reshape(-1, 3) + 1:
            fh.write(f"f {f[0]}/{f[0]} {f[1]}/{f[1]} {f[2]}/{f[2]}\n")
    with open(mtl, "w") as fh:
        fh.write("newmtl material_0\n")
        if texture_image is not None:
            tex_path = base + ".png"
            write_png(tex_path, (np.clip(np.asarray(texture_image), 0, 1) * 255).astype(np.uint8))
            fh.write(f"map_Kd {os.path.basename(tex_path)}\n")


# ----------------------------------------------------------------------
# topology helpers (mesh.py:29-158)
# ----------------------------------------------------------------------
def face2edge(faces):
    """Unique undirected edges of a triangle mesh -> [E, 2]."""
    faces = np.asarray(faces)
    e = np.concatenate([faces[:, [0, 1]], faces[:, [1, 2]], faces[:, [2, 0]]])
    e = np.sort(e, axis=1)
    return np.unique(e, axis=0)


def face2edge2(faces, edges):
    """Per-face edge indices [F, 3] given the unique edge list
    (mesh.py:46-67)."""
    faces = np.asarray(faces)
    edge_id = {tuple(e): i for i, e in enumerate(np.asarray(edges))}
    out = np.empty((len(faces), 3), np.int64)
    for fi, (a, b, c) in enumerate(faces):
        out[fi, 0] = edge_id[tuple(sorted((a, b)))]
        out[fi, 1] = edge_id[tuple(sorted((b, c)))]
        out[fi, 2] = edge_id[tuple(sorted((c, a)))]
    return out


def edge2face(faces, edges):
    """The (up to 2) faces adjacent to each edge [E, 2] (mesh.py:69-95)."""
    faces = np.asarray(faces)
    edges = np.asarray(edges)
    edge_id = {tuple(e): i for i, e in enumerate(edges)}
    out = np.full((len(edges), 2), -1, np.int64)
    for fi, (a, b, c) in enumerate(faces):
        for pair in ((a, b), (b, c), (c, a)):
            ei = edge_id[tuple(sorted(pair))]
            out[ei, 1 if out[ei, 0] >= 0 else 0] = fi
    return out


def face2pfmtx(faces):
    """Point-to-face averaging matrix [P, F] (mesh.py:120-134)."""
    faces = np.asarray(faces)
    P = faces.max() + 1
    A = np.zeros((P, len(faces)), np.float32)
    for fi, tri in enumerate(faces):
        for v in tri:
            A[v, fi] = 1.0
    deg = A.sum(axis=1, keepdims=True)
    deg[deg == 0] = 1
    return A / deg


def face2pneimtx(faces):
    """Vertex adjacency (averaging) matrix as a dense [P, P] numpy array."""
    faces = np.asarray(faces)
    P = faces.max() + 1
    A = np.zeros((P, P), np.float32)
    for a, b in face2edge(faces):
        A[a, b] = 1.0
        A[b, a] = 1.0
    deg = A.sum(axis=1, keepdims=True)
    deg[deg == 0] = 1
    return A / deg


def mesh_resample(verts, faces):
    """Midpoint subdivision: each triangle -> 4 (mesh.py:136-158)."""
    verts = np.asarray(verts, np.float64)
    faces = np.asarray(faces)
    edges = face2edge(faces)
    edge_id = {tuple(e): i for i, e in enumerate(edges)}
    mid = 0.5 * (verts[edges[:, 0]] + verts[edges[:, 1]])
    new_verts = np.concatenate([verts, mid])
    P = len(verts)

    def eid(a, b):
        return P + edge_id[tuple(sorted((a, b)))]

    out = []
    for a, b, c in faces:
        ab, bc, ca = eid(a, b), eid(b, c), eid(c, a)
        out += [[a, ab, ca], [ab, b, bc], [ca, bc, c], [ab, bc, ca]]
    return new_verts.astype(np.float32), np.asarray(out, np.int64)


# ----------------------------------------------------------------------
# transforms (transformations.py:26-556)
# ----------------------------------------------------------------------
def _rot(theta, enc, axis):
    if enc == "deg":
        theta = math.radians(theta)
    c, s = math.cos(theta), math.sin(theta)
    m = np.eye(3)
    i, j = [(1, 2), (0, 2), (0, 1)][axis]
    m[i, i] = c
    m[j, j] = c
    m[i, j] = -s
    m[j, i] = s
    return m


def rotx(theta, enc="rad"):
    return _rot(theta, enc, 0)


def roty(theta, enc="rad"):
    return _rot(theta, enc, 1)


def rotz(theta, enc="rad"):
    return _rot(theta, enc, 2)


def homogenize_points(pts):
    pts = np.asarray(pts)
    return np.concatenate([pts, np.ones((*pts.shape[:-1], 1), pts.dtype)], axis=-1)


def unhomogenize_points(pts):
    pts = np.asarray(pts)
    w = pts[..., -1:]
    w = np.where(w == 0, 1.0, w)
    return pts[..., :-1] / w


def transform3d(pts, tform):
    """Apply a 4x4 rigid transform to [..., 3] points."""
    return unhomogenize_points(homogenize_points(pts) @ np.asarray(tform).T)


def invert_rigid_transform_3d(tform):
    tform = np.asarray(tform)
    R = tform[:3, :3]
    t = tform[:3, 3]
    out = np.eye(4)
    out[:3, :3] = R.T
    out[:3, 3] = -R.T @ t
    return out


def compose_transforms_3d(tforms):
    out = np.eye(4)
    for t in tforms:
        out = np.asarray(t) @ out
    return out


def compute_camera_params(azimuth: float, elevation: float, distance: float):
    """Camera (rot [3,3], pos [3]) from spherical placement
    (transformations.py:557-578); same convention as dibr.lookat_camera."""
    theta = np.deg2rad(azimuth)
    phi = np.deg2rad(elevation)
    cam_pos = np.array(
        [
            distance * np.cos(phi) * np.cos(theta),
            distance * np.sin(phi),
            distance * np.cos(phi) * np.sin(theta),
        ]
    )
    axis_z = cam_pos.copy()
    axis_y = np.array([0.0, 1.0, 0.0])
    axis_x = np.cross(axis_y, axis_z)
    axis_y = np.cross(axis_z, axis_x)
    cam_mat = np.array([axis_x, axis_y, axis_z])
    l2 = np.linalg.norm(cam_mat, 2, axis=1, keepdims=True)
    l2[l2 == 0] = 1
    return (cam_mat / l2).astype(np.float32), cam_pos.astype(np.float32)


# ----------------------------------------------------------------------
# spherical texture coordinates (sphericalcoord.py:26-60)
# ----------------------------------------------------------------------
def get_spherical_coords_z(X):
    X = np.asarray(X)
    rad = np.linalg.norm(X, axis=1)
    theta = np.arccos(np.clip(X[:, 2] / rad, -1, 1))
    phi = np.arctan2(X[:, 1], X[:, 0])
    vv = (theta / np.pi) * 2 - 1
    uu = ((phi + np.pi) / (2 * np.pi)) * 2 - 1
    return np.stack([uu, vv], 1)


def get_spherical_coords_x(X):
    X = np.asarray(X)
    rad = np.linalg.norm(X, axis=1)
    theta = np.arccos(np.clip(X[:, 0] / rad, -1, 1))
    phi = np.arctan2(X[:, 2], X[:, 1])
    uu = (theta / np.pi) * 2 - 1
    vv = ((phi + np.pi) / (2 * np.pi)) * 2 - 1
    return np.stack([uu, vv], 1)
