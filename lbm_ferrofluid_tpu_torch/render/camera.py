"""Camera transforms: look_at / look / perspective distortion.

PyTorch twins of ``lbm_ferrofluid_tpu/render/camera.py``, which ports the
reference SoftRenderer's camera math (renderutils/softrenderer.py:469-645):
pure functions over ``[B, V, 3]`` vertex tensors.  Every constant is made
on the vertices' device and in their type; ``eye``, ``at``, ``up`` and
``direction`` may be tensors, numpy arrays or sequences.
"""

from __future__ import annotations

import math

import torch

__all__ = [
    "look_at",
    "look",
    "perspective_distortion",
    "vertices_to_faces",
    "eye_from_angles",
]

_EPS = 1e-5


def _like(x, ref):
    """``x`` as a tensor of ``ref``'s type on ``ref``'s device."""
    return torch.as_tensor(x, dtype=ref.dtype, device=ref.device)


def _rows(x, ref, B):
    """``x`` as ``[B, 3]``: a 3-vector broadcast over the batch."""
    return torch.broadcast_to(torch.atleast_2d(_like(x, ref)), (B, 3))


def _normalize(v, eps=_EPS):
    norm = torch.linalg.vector_norm(v, dim=-1, keepdim=True)
    return v / torch.clamp(norm, min=eps)


def _camera_rotation(z_axis, up):
    x_axis = _normalize(torch.linalg.cross(up, z_axis, dim=-1))
    y_axis = _normalize(torch.linalg.cross(z_axis, x_axis, dim=-1))
    return torch.stack([x_axis, y_axis, z_axis], dim=-2)  # [B, 3, 3]


def look_at(vertices, eye, at=None, up=None):
    """Transform vertices into the frame of a camera at ``eye`` looking at
    ``at`` (default origin) with ``up`` (default +y)
    (reference: softrenderer.py:469-538)."""
    B = vertices.shape[0]
    eye = _rows(eye, vertices, B)
    at = _rows([0.0, 0.0, 0.0] if at is None else at, vertices, B)
    up = _rows([0.0, 1.0, 0.0] if up is None else up, vertices, B)
    R = _camera_rotation(_normalize(at - eye), up)
    return torch.einsum("bvj,bij->bvi", vertices - eye[:, None], R)


def look(vertices, eye, direction=None, up=None):
    """Camera at ``eye`` looking along ``direction``
    (reference: softrenderer.py:540-600)."""
    B = vertices.shape[0]
    eye = _rows(eye, vertices, B)
    direction = _rows([0.0, 1.0, 0.0] if direction is None else direction, vertices, B)
    up = _rows([0.0, 1.0, 0.0] if up is None else up, vertices, B)
    R = _camera_rotation(_normalize(direction), up)
    return torch.einsum("bvj,bij->bvi", vertices - eye[:, None], R)


def perspective_distortion(vertices, angle: float = 30.0):
    """Divide (x, y) by z*tan(angle) (reference: softrenderer.py:602-623)."""
    width = math.tan(angle / 180.0 * math.pi)
    z = vertices[..., 2:3]
    xy = vertices[..., :2] / (z * width)
    return torch.cat([xy, z], dim=-1)


def vertices_to_faces(vertices, faces):
    """Gather per-face vertex triplets: [B,V,3],[B,F,3] -> [B,F,3,3]
    (reference: softrenderer.py:625-645)."""
    faces = torch.as_tensor(faces, device=vertices.device).long()
    B, F = faces.shape[:2]
    idx = faces.reshape(B, F * 3, 1).expand(B, F * 3, 3)
    return torch.gather(vertices, 1, idx).reshape(B, F, 3, 3)


def eye_from_angles(distance, elevation, azimuth, degrees=True, *, device=None):
    """Spherical camera placement (reference: softrenderer.py:665-700), as
    a float32 tensor on ``device`` (the CPU when None)."""
    if degrees:
        elevation = math.radians(elevation)
        azimuth = math.radians(azimuth)
    return torch.tensor(
        [
            distance * math.cos(elevation) * math.sin(azimuth),
            distance * math.sin(elevation),
            -distance * math.cos(elevation) * math.cos(azimuth),
        ],
        device=device,
    )
