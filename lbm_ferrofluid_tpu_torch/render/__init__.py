"""Rendering: the soft rasterizer and isosurface extraction.

Port of ``lbm_ferrofluid_tpu/render/``: host marching tetrahedra (the
native C++ extractor where it builds, else numpy) and classic marching
cubes, on-device marching tetrahedra (``mesh_torch``), the camera and
lighting, the soft rasterizer and ``SoftRenderer``, the phi -> mesh ->
frame helpers, and the second (DIB-R) render stack: ``dibr``,
``load_textures``, ``voxelize`` and ``meshutils``.
The renderer's entry points run on the card unless given
``device="cpu"``; ``render_phi_frame`` runs on its phi's device.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from ..utils.device import resolve_device
from ..utils.io import as_numpy, write_png
from . import dibr
from .camera import eye_from_angles, look, look_at, perspective_distortion, vertices_to_faces
from .lighting import (
    apply_ambient_light,
    apply_directional_light,
    compute_ambient_light,
    compute_directional_light,
)
from .mesh import marching_cubes, marching_tetrahedra
from .mesh_torch import marching_tetrahedra_torch, phi_to_mesh_torch
from .renderer import SoftRenderer
from .softras import soft_rasterize
from .texture import load_textures
from .voxelize import voxelize

__all__ = [
    "SoftRenderer",
    "soft_rasterize",
    "look_at",
    "look",
    "perspective_distortion",
    "vertices_to_faces",
    "eye_from_angles",
    "compute_ambient_light",
    "compute_directional_light",
    "apply_ambient_light",
    "apply_directional_light",
    "marching_cubes",
    "marching_tetrahedra",
    "marching_tetrahedra_torch",
    "dibr",
    "load_textures",
    "voxelize",
    "phi_to_mesh_torch",
    "phi_to_mesh",
    "render_phi_frame",
    "make_render_pipeline",
    "default_renderer",
]


def default_renderer(image_size: int = 256, *, device=None) -> SoftRenderer:
    """The camera of the reference 3D demos
    (demo_3d_LBM_Rosensweig_instability.py:102-113), on ``device`` (the
    card unless ``device="cpu"``)."""
    return SoftRenderer(
        image_size=image_size,
        camera_mode="look_at",
        eye=[1.6, 0.8, 1.6],
        camera_direction=[-1.0 / math.sqrt(2.0), 0.0, -1.0 / math.sqrt(2.0)],
        near=1.0,
        bg_color=[1.0, 1.0, 1.0],
        device=device,
    )


def phi_to_mesh(phi, res, dx: float = 1.0, method: str = "mt"):
    """Order parameter -> normalized triangle mesh on the host, as the
    reference's save_rendered_image preamble (utils/io.py:50-64): pad the
    interior with phi.max to close the surface, extract the -phi
    isosurface at 0, map vertices to [-1, 1].  ``method``: "mt" marching
    tetrahedra (default) or "mc" classic 256-case marching cubes.  Returns
    numpy (verts [V, 3] float32, faces [F, 3] int64)."""
    phi = as_numpy(phi)
    interior = phi[..., 1:-1, 1:-1, 1:-1]
    pad = [(0, 0)] * (phi.ndim - 3) + [(1, 1)] * 3
    closed = np.pad(interior, pad, constant_values=float(phi.max()))
    volume = -closed[0, 0] * (2.0 / max(res) / dx)
    extract = marching_cubes if method == "mc" else marching_tetrahedra
    verts, faces = extract(volume, 0.0)
    verts = (verts - np.asarray(res, np.float32) / 2.0) * (2.0 / max(res))
    return verts, faces


def _bucket_mesh(verts, faces, far_z: float = 1e6):
    """Pad the mesh with degenerate far-away faces (all three corners on
    one distant point, rejected by the z clip) up to a power-of-2 face
    count of at least 1024: the buffers of consecutive frames then share
    their sizes, as in the JAX module (where it keeps the compiled shape)."""
    n = len(faces)
    bucket = 1 << max(10, (n - 1).bit_length())
    if n == bucket:
        return verts, faces
    pad_v = np.asarray([[0.0, 0.0, far_z]], np.float32)
    verts_p = np.concatenate([verts, pad_v])
    pad_f = np.full((bucket - n, 3), len(verts_p) - 1, np.int64)
    return verts_p, np.concatenate([faces, pad_f])


def _image(renderer, verts, faces, gray):
    """[S, S, 3] float image in [0, 1] of one mesh (tensors on the
    renderer's device)."""
    textures = torch.full((1, faces.shape[0], 2, 3), gray, dtype=torch.float32,
                          device=verts.device)
    out = renderer.forward(verts[None], faces[None], textures)
    return torch.clamp(out[0, :3], 0.0, 1.0).permute(1, 2, 0)


def make_render_pipeline(res, dx: float = 1.0, renderer=None, gray: float = 0.68,
                         budget: int = 1 << 16, *, device=None):
    """phi -> marching tetrahedra -> soft rasterization, all on the card.

    The returned function maps the ``[B, 1, *res]`` phi (or the raw
    ``[D, H, W]`` volume) on ``device`` to an (``[S, S, 3]`` float32 image,
    triangle count) pair of tensors there; only the image needs to come
    back to the host for the PNG.  The triangle budget is static (unused
    face slots are far-away degenerates the z clip rejects,
    render/mesh_torch.py): a count above ``budget`` means the surface
    overflowed and the caller must rebuild with a larger one
    (:func:`render_phi_frame` raises).  Runs on the card unless
    ``device="cpu"``; ``renderer`` defaults to :func:`default_renderer`
    on that device."""
    dev = resolve_device(device)
    if renderer is None:
        renderer = default_renderer(device=dev)

    def run(phi):
        verts, faces, count = phi_to_mesh_torch(torch.as_tensor(phi, device=dev), res, dx,
                                                budget)
        return _image(renderer, verts, faces, gray), count

    run.budget = budget
    run.device = dev
    return run


def render_phi_frame(phi, filename, res, dx: float = 1.0, renderer=None,
                     gray: float = 0.68, pipeline=None, method: str = "mt"):
    """save_rendered_image equivalent (utils/io.py:50-84): extract the
    interface mesh from phi, render with constant-gray textures, write the
    PNG.  Returns (verts, faces), numpy.

    The host path (default) extracts the mesh on the host and rasterizes
    on phi's device (a tensor's, or the CPU for a numpy phi) with
    ``renderer`` (default :func:`default_renderer` there).  With
    ``pipeline`` (from :func:`make_render_pipeline`) extraction and
    rasterization run on the pipeline's device and only the image is read
    back; it raises if the surface overflowed the pipeline's triangle
    budget (the JAX function drops the triangles over the budget without a
    word), and returns (None, None): use the host path when the mesh
    itself is needed (OBJ export)."""
    if pipeline is not None:
        img, count = pipeline(phi)
        count = int(count)
        if count > pipeline.budget:
            raise RuntimeError(
                f"render_phi_frame: the surface has {count} triangles, over the "
                f"pipeline's budget of {pipeline.budget}; build the pipeline with "
                "a larger budget (make_render_pipeline(..., budget=...))")
        write_png(filename, (as_numpy(img) * 255).astype(np.uint8))
        return None, None
    dev = phi.device if torch.is_tensor(phi) else torch.device("cpu")
    if renderer is None:
        renderer = default_renderer(device=dev)
    verts, faces = phi_to_mesh(phi, res, dx, method=method)
    if len(faces) == 0:
        img = np.full((renderer.image_size, renderer.image_size, 3), 255, np.uint8)
    else:
        verts_b, faces_b = _bucket_mesh(verts, faces)
        img = _image(renderer, torch.as_tensor(verts_b, device=renderer.device),
                     torch.as_tensor(faces_b, device=renderer.device), gray)
        img = (as_numpy(img) * 255).astype(np.uint8)
    write_png(filename, img)
    return verts, faces
