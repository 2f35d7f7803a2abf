"""Ambient and Lambertian directional lighting.

PyTorch twins of ``lbm_ferrofluid_tpu/render/lighting.py`` (reference:
renderutils/lighting.py:19-321): per-face light factors that multiply
into textures, on the face vertices' device.
"""

from __future__ import annotations

import torch

__all__ = [
    "compute_ambient_light",
    "compute_directional_light",
    "apply_ambient_light",
    "apply_directional_light",
]


def _rows(x, ref, B):
    x = torch.as_tensor(x, dtype=ref.dtype, device=ref.device)
    return torch.broadcast_to(torch.atleast_2d(x), (B, 3))


def compute_ambient_light(face_vertices, textures, intensity=1.0, color=None):
    """I = I_a * K_a, constant per face -> [B, F, 1, 3]
    (reference: lighting.py:19-117)."""
    B, F = face_vertices.shape[:2]
    color = _rows([1.0, 1.0, 1.0] if color is None else color, face_vertices, B)
    intensity = min(max(float(intensity), 0.0), 1.0)
    light = intensity * color[:, None]
    return torch.broadcast_to(light, (B, F, 3))[:, :, None, :]


def compute_directional_light(
    face_vertices, textures, intensity=1.0, color=None, direction=None
):
    """Lambertian: cos = relu(n . l) per face -> [B, F, 1, 3]
    (reference: lighting.py:155-281)."""
    B, F = face_vertices.shape[:2]
    color = _rows([1.0, 1.0, 1.0] if color is None else color, face_vertices, B)
    direction = _rows([0.0, 1.0, 0.0] if direction is None else direction, face_vertices, B)
    intensity = min(max(float(intensity), 0.0), 1.0)

    fv = face_vertices.reshape(B, F, 3, 3)
    v10 = fv[:, :, 0] - fv[:, :, 1]
    v12 = fv[:, :, 2] - fv[:, :, 1]
    n = torch.linalg.cross(v12, v10, dim=-1)
    n = n / torch.clamp(torch.linalg.vector_norm(n, dim=-1, keepdim=True), min=1e-6)

    cos = torch.clamp(torch.sum(n * direction[:, None], dim=-1), min=0.0)  # [B, F]
    light = intensity * color[:, None] * cos[:, :, None]
    return light[:, :, None, :]


def apply_ambient_light(face_vertices, textures, intensity=1.0, color=None):
    return textures * compute_ambient_light(face_vertices, textures, intensity, color)


def apply_directional_light(
    face_vertices, textures, intensity=1.0, color=None, direction=None
):
    return textures * compute_directional_light(
        face_vertices, textures, intensity, color, direction
    )
