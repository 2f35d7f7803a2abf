"""Texture atlases: per-texel barycentric UV -> bilinear image sample.

Port of ``lbm_ferrofluid_tpu/render/texture.py``, which reimplements the
reference's CUDA extension (renderutils/cuda/load_textures_cuda_kernel.cu:
20-81): for each face and each texel of its R x R atlas, the texel's
barycentric position on the face's UVs, and a bilinear sample of the
source image there.  The JAX module has no Pallas kernel; this is its
plain PyTorch counterpart on the image's device.
"""

from __future__ import annotations

import numpy as np
import torch

__all__ = ["load_textures"]


def load_textures(image, faces_uv, texture_res: int, is_update=None):
    """Per-face texture atlases.

    ``image`` ``[H, W, 3]``, ``faces_uv`` ``[F, 3, 2]`` UVs in [0, 1],
    ``texture_res`` the atlas side R, ``is_update`` an optional ``[F]``
    bool (faces with False get zeros).  Returns ``[F, R*R, 3]``."""
    H, W = image.shape[:2]
    R = texture_res
    F = faces_uv.shape[0]
    dtype, dev = image.dtype, image.device

    # texel barycentric coordinates (kernel :39-49)
    tex_i = np.arange(R * R)
    w_y = (tex_i // R).astype(np.float64)
    w_x = (tex_i % R).astype(np.float64)
    lower = w_x + w_y < R
    w0 = np.where(lower, (w_x + 1.0 / 3.0) / R, ((R - 1.0 - w_x) + 2.0 / 3.0) / R)
    w1 = np.where(lower, (w_y + 1.0 / 3.0) / R, ((R - 1.0 - w_y) + 2.0 / 3.0) / R)
    w = torch.as_tensor(np.stack([w0, w1, 1.0 - w0 - w1], axis=1), dtype=dtype, device=dev)

    uv = torch.einsum("tk,fkc->ftc", w, faces_uv.to(dtype))  # [F, R*R, 2]
    pos_x = uv[..., 0] * (W - 1)
    pos_y = uv[..., 1] * (H - 1)
    x0 = torch.floor(pos_x).long().clamp(0, W - 1)
    y0 = torch.floor(pos_y).long().clamp(0, H - 1)
    x1 = (x0 + 1).clamp(0, W - 1)
    y1 = (y0 + 1).clamp(0, H - 1)
    wx1 = pos_x - torch.floor(pos_x)
    wx0 = 1.0 - wx1
    wy1 = pos_y - torch.floor(pos_y)
    wy0 = 1.0 - wy1
    tex = (image[y0, x0] * (wx0 * wy0)[..., None] + image[y1, x0] * (wx0 * wy1)[..., None]
           + image[y0, x1] * (wx1 * wy0)[..., None] + image[y1, x1] * (wx1 * wy1)[..., None])
    if is_update is not None:
        keep = torch.as_tensor(is_update, dtype=torch.bool, device=dev)[:, None, None]
        tex = torch.where(keep, tex, 0.0)
    return tex
