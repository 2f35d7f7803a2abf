"""Artifact IO: field PNGs, OBJ export, Tecplot dumps.

Port of ``lbm_ferrofluid_tpu/utils/io.py``, whose outputs match the
reference's (src/LBM/utils/io.py:11-152): min-max-normalized PNGs with a
vertical flip and a z-mean projection for 3D fields, 1-indexed OBJ meshes,
Tecplot POINT-format .plt files.  Inputs are tensors (on any device, in
any float type; bfloat16 is widened exactly to float32) or numpy arrays.
PNGs are written by :func:`write_png`, a small encoder on ``zlib`` and
``struct``, so no imaging package is needed.  The Tecplot writers take the
native C++ writers (``native/``, built at first use) where a C++ compiler
exists, as the JAX package's take its native twin where it is built, else
their Python loops (values as Python prints them; the native ones print
``%g``).
"""

from __future__ import annotations

import pathlib
import struct
import zlib

import numpy as np
import torch

from .. import native

__all__ = ["save_img", "export_obj", "dump_2d_plt", "dump_3d_plt", "mkdir",
           "write_png", "read_png", "as_numpy"]


def mkdir(path: str) -> None:
    pathlib.Path(path).mkdir(parents=True, exist_ok=True)


def as_numpy(x) -> np.ndarray:
    """A numpy array of ``x``: a tensor is moved to the host, bfloat16
    widened to float32 (numpy has no bfloat16), other types kept."""
    if torch.is_tensor(x):
        x = x.detach()
        if x.dtype == torch.bfloat16:
            x = x.float()
        return x.cpu().numpy()
    return np.asarray(x)


def write_png(filename, img: np.ndarray) -> None:
    """Write an ``[H, W, 3]`` uint8 RGB image as an 8-bit PNG (filter type
    0 on every row, one IDAT chunk)."""
    img = np.ascontiguousarray(img, dtype=np.uint8)
    if img.ndim != 3 or img.shape[-1] != 3:
        raise ValueError(f"write_png expects [H, W, 3] uint8, got {img.shape}")
    h, w, _ = img.shape
    raw = np.concatenate([np.zeros((h, 1), np.uint8), img.reshape(h, 3 * w)], axis=1)

    def chunk(tag: bytes, data: bytes) -> bytes:
        return (struct.pack(">I", len(data)) + tag + data
                + struct.pack(">I", zlib.crc32(tag + data) & 0xFFFFFFFF))

    ihdr = struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0)
    with open(filename, "wb") as fh:
        fh.write(b"\x89PNG\r\n\x1a\n" + chunk(b"IHDR", ihdr)
                 + chunk(b"IDAT", zlib.compress(raw.tobytes(), 6)) + chunk(b"IEND", b""))


def read_png(filename) -> np.ndarray:
    """The ``[H, W, 3]`` uint8 pixels of a PNG as :func:`write_png` writes
    it (8-bit RGB, not interlaced, row filter type 0)."""
    data = pathlib.Path(filename).read_bytes()
    if data[:8] != b"\x89PNG\r\n\x1a\n":
        raise ValueError(f"{filename}: not a PNG")
    pos, idat, header = 8, [], None
    while pos < len(data):
        (length,) = struct.unpack(">I", data[pos:pos + 4])
        tag, body = data[pos + 4:pos + 8], data[pos + 8:pos + 8 + length]
        pos += 12 + length
        if tag == b"IHDR":
            header = struct.unpack(">IIBBBBB", body)
        elif tag == b"IDAT":
            idat.append(body)
    w, h, depth, color, _, _, interlace = header
    raw = np.frombuffer(zlib.decompress(b"".join(idat)), np.uint8).reshape(h, 1 + 3 * w)
    if (depth, color, interlace) != (8, 2, 0) or raw[:, 0].any():
        raise ValueError(f"{filename}: not an 8-bit RGB PNG with unfiltered rows")
    return raw[:, 1:].reshape(h, w, 3).copy()


def _to_uint8_2d(arr: np.ndarray) -> np.ndarray:
    """[B, C, H, W] -> min-max normalized uint8 [H, W, C] of batch 0."""
    arr = np.asarray(arr, dtype=np.float64)
    lo, hi = arr.min(), arr.max()
    arr = (arr - lo) / (hi - lo) if hi > lo else np.zeros_like(arr)
    img = np.transpose(arr[0], (1, 2, 0)) * 255.0
    return img.astype(np.uint8)


def save_img(field, filename: str) -> None:
    """Save a field as a normalized PNG; 3D fields are z-mean projected and
    the image is vertically flipped (y up), as the reference (io.py:34-42)."""
    field = as_numpy(field)
    if field.ndim == 5:
        field = field.mean(axis=2)
    elif field.ndim != 4:
        raise ValueError("save_img expects [B, C, (D,) H, W]")
    img = _to_uint8_2d(field)[::-1]  # flip vertically
    if img.shape[-1] == 1:
        img = np.repeat(img, 3, axis=-1)
    elif img.shape[-1] == 2:
        img = np.concatenate([img, np.zeros_like(img[..., :1])], axis=-1)
    write_png(filename, img[..., :3])


def export_obj(save_path: str, vertices, faces) -> None:
    """Write a triangle mesh as OBJ (1-indexed faces), as io.py:87-104."""
    np_faces = as_numpy(faces).reshape(-1, 3).astype(np.int64)
    np_vertices = as_numpy(vertices).reshape(-1, 3)
    if np_faces.size and np_faces.min() == 0:
        np_faces = np_faces + 1
    with open(save_path, "w") as fh:
        fh.write("# OBJ file\n")
        for v in np_vertices:
            fh.write(f"v {v[0]} {v[1]} {v[2]}\n")
        for f in np_faces:
            fh.write(f"f {f[0]} {f[1]} {f[2]}\n")


def dump_2d_plt(filename: str, density, uv, batch: int = 0) -> None:
    """Tecplot ASCII dump, matching io.py:107-121 field for field."""
    density = as_numpy(density)
    uv = as_numpy(uv)
    if native.available():
        native.dump_2d_plt_native(filename, density[batch, 0], uv[batch, 0], uv[batch, 1])
        return
    H, W = density.shape[-2:]
    with open(filename, "w") as fo:
        fo.write('TITLE ="Magnetic internal force"\n')
        fo.write('VARIABLES = "X" "Y" "RHO" "U" "V" \n')
        fo.write(f"ZONE I={W}, J={H}\n")
        fo.write("F=POINT\n")
        for j in range(H):
            for i in range(W):
                fo.write(
                    f"{i} {j} {density[batch, 0, j, i]} "
                    f"{uv[batch, 0, j, i]} {uv[batch, 1, j, i]}\n"
                )


def dump_3d_plt(filename: str, density, u, v, w, batch: int = 0, chan: int = 0) -> None:
    """Tecplot ASCII dump for 3D MAC-staggered velocities (io.py:124-152)."""
    density = as_numpy(density)
    u, v, w = as_numpy(u), as_numpy(v), as_numpy(w)
    D, H, W = density.shape[-3:]
    u = 0.5 * (u[..., 1:] + u[..., :-1])
    v = 0.5 * (v[..., 1:, :] + v[..., :-1, :])
    w = 0.5 * (w[..., 1:, :, :] + w[..., :-1, :, :])
    if native.available():
        native.dump_3d_plt_native(filename, density[batch, chan], u[batch, chan],
                                  v[batch, chan], w[batch, chan])
        return
    with open(filename, "w") as fo:
        fo.write('TITLE ="Magnetic internal force"\n')
        fo.write('VARIABLES = "X" "Y" "Z" "RHO" "U" "V" "W" \n')
        fo.write(f"ZONE I={W}, J={H}, K={D}\n")
        fo.write("F=POINT\n")
        for k in range(D):
            for j in range(H):
                for i in range(W):
                    fo.write(
                        f"{i} {j} {k} {density[batch, chan, k, j, i]} "
                        f"{u[batch, chan, k, j, i]} {v[batch, chan, k, j, i]} "
                        f"{w[batch, chan, k, j, i]}\n"
                    )
