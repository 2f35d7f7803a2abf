"""The psi-refreshed ghost bands of the meshed channel-form solve (ROADMAP
B-8, the JAX package's ``params.poisson_psi_halo``).

Replaces jnp glue, not a Pallas kernel: the reconstruction and splice of
``lbm_ferrofluid_tpu/parallel/step3d.py:_psi_ghost_bands`` (``recon`` and
``splice`` :959-1011; :872-930 in the extended flow's
``_psi_refresh_ghosts``).  At tau == 1 the h a swept non-obstacle cell
stores is w_q (psi + rhs), minus psi at q = 0: a function of the cell's
psi and source alone.  So after the first round of the meshed solve
(``parallel/step3d.py:poisson_sweeps_sharded``) a rank sends, for each
G-plane band its neighbour reads, one buffer of bytes (:func:`pack`): the
psi of the G - 1 outer planes (float32), the innermost plane of h (the one
plane that can be a z-edge plane of the domain when G < Zl) and the two
x-edge columns of h of the outer planes (where the magnetic obstacles of
the declared ``mag_flags_shell`` geometry sit, whose bounced populations
psi cannot give).  The receiver builds the band in h's storage type with
:func:`psi_ghost_band` (``csrc/psi_halo.cu``), each rebuilt value rounded
as B11b rounds its store (``common.cuh:lbm_poisson_out``), so the band
equals the planes the neighbour holds bit for bit; the JAX package's
reconstruction is 1-2 ulp off its full-h exchange (XLA contracts the
kernel's arithmetic into FMAs).  :func:`psi_ghost_band_plain` is the same
in PyTorch, float32 operations in the same order; it runs on the CPU and in
the tests, never on the card's main path.

Bound on an H100: bytes (:func:`cost`).
"""

from __future__ import annotations

import ctypes

import torch

from ...lattice import D3Q19
from ._lib import call, check_cuda, check_no_grad, count_launch, ptr, stream_of

__all__ = ["BANDS", "layout", "pack", "psi_ghost_band", "psi_ghost_band_plain", "cost"]

TPU_KERNEL = ("lbm_ferrofluid_tpu/parallel/step3d.py:959-1011 (_psi_ghost_bands: recon + "
              "splice, jnp glue inside shard_map, not a Pallas kernel; :872-930 in "
              "_psi_refresh_ghosts)")
CUDA_SOURCE = "lbm_ferrofluid_tpu_torch/csrc/psi_halo.cu"
#: the two bands of a slab: ``lo`` from the rank below (its top planes,
#: the innermost last), ``hi`` from the rank above (its bottom planes, the
#: innermost first)
BANDS = ("lo", "hi")


def _psi_dtype(dtype):
    """psi's type beside an h of ``dtype``: float32, float64 for a float64 h
    (the plain versions only)."""
    return torch.float64 if dtype == torch.float64 else torch.float32


def layout(G: int, Y: int, X: int, dtype) -> tuple:
    """(dtype, shape, byte offset) of the three parts of a packed band of G
    planes of Y x X with h in ``dtype``: psi of the G - 1 outer planes, the
    innermost plane of h (19 channels) and the outer planes' x-edge
    columns of h (x = 0, X - 1); then the buffer's bytes."""
    pd = _psi_dtype(dtype)
    parts, at = [], 0
    for dt, shape in ((pd, (1, 1, G - 1, Y, X)), (dtype, (1, 19, Y, X)),
                      (dtype, (1, 19, G - 1, Y, 2))):
        parts.append((dt, shape, at))
        at += torch.Size(shape).numel() * dt.itemsize
    return tuple(parts), at


def pack(h, psi, G: int, band: str):
    """The bytes a rank sends for its neighbour's ``band`` of G planes
    (``lo``: the rank above's, from this slab's top planes; ``hi``: the rank
    below's, from its bottom planes): psi of the outer planes, the innermost
    plane of ``h`` and the outer planes' x-edge columns of ``h``, in
    :func:`layout`'s order.  ``h`` [1, 19, Zl, Y, X] and ``psi`` [1, 1, Zl,
    Y, X] are the slab's after a round."""
    Zl, X = h.shape[2], h.shape[4]
    inner, outer = (Zl - 1, slice(Zl - G, Zl - 1)) if band == "lo" else (0, slice(1, G))
    parts = (psi[:, :, outer], h[:, :, inner], h[:, :, outer][..., [0, X - 1]])
    return torch.cat([p.contiguous().reshape(-1).view(torch.uint8) for p in parts])


def _parts(packed, G, Y, X, dtype):
    """The three parts of a packed band as tensors (views of ``packed``)."""
    (parts, nbytes) = layout(G, Y, X, dtype)
    if packed.dtype != torch.uint8 or packed.shape != (nbytes,):
        raise ValueError(f"a packed band of {G} planes of {Y}x{X} ({dtype}) is {nbytes} bytes "
                         f"of uint8, got {tuple(packed.shape)} {packed.dtype}")
    return [packed[at:at + torch.Size(shape).numel() * dt.itemsize].view(dt).view(shape)
            for dt, shape, at in parts]


def _check(band, G):
    if band not in BANDS or G < 2:
        raise ValueError(f"psi_ghost_band: band in {BANDS} of G >= 2 planes, got {band!r}, {G}")


def psi_ghost_band_plain(packed, rhs, *, band, G, Y, X, dtype):
    """Plain PyTorch version of :func:`psi_ghost_band`: the outer planes'
    h rebuilt from psi in psi's type (t = psi, u = t + rhs, w_q u, minus t at
    q = 0, each rounded on its own as ``poisson.sweep_cell`` rounds it),
    cast to ``dtype``, their x-edge columns taken from the packed columns,
    and the innermost plane added on the band's inner side."""
    _check(band, G)
    psi, inner, cols = _parts(packed, G, Y, X, dtype)
    w = torch.as_tensor(D3Q19.weights, dtype=psi.dtype, device=psi.device).reshape(1, 19, 1, 1, 1)
    u = psi + rhs
    rec = w * u
    rec = torch.cat([rec[:, :1] - psi, rec[:, 1:]], dim=1).to(dtype)
    rec[..., 0], rec[..., X - 1] = cols[..., 0], cols[..., 1]
    inner = inner.unsqueeze(2)
    return torch.cat([rec, inner] if band == "lo" else [inner, rec], dim=2)


def psi_ghost_band(packed, rhs, *, band, G, Y, X, dtype):
    """A slab's ghost band of G planes [1, 19, G, Y, X] in ``dtype`` (h's
    storage type) from the neighbour's packed buffer (:func:`pack`, uint8)
    and ``rhs`` [1, 1, G - 1, Y, X], the extended source's planes of the
    band's outer planes.  CPU tensors take the plain version; CUDA tensors
    launch the kernel (one launch), float32 or bfloat16 h; anything else
    raises."""
    if packed.device.type == "cpu":
        return psi_ghost_band_plain(packed, rhs, band=band, G=G, Y=Y, X=X, dtype=dtype)
    _check(band, G)
    check_no_grad("psi_ghost_band", rhs)
    psi, inner, cols = _parts(packed, G, Y, X, dtype)
    check_cuda("packed", packed, torch.uint8, packed.shape)
    check_cuda("rhs", rhs, torch.float32, (1, 1, G - 1, Y, X))
    if dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"psi_ghost_band: h in float32 or bfloat16, got {dtype}")
    out = torch.empty((1, 19, G, Y, X), dtype=dtype, device=packed.device)
    bf16 = dtype == torch.bfloat16
    call("lbm_psi_ghost_band", ptr(psi), ptr(rhs), ptr(inner), ptr(cols), ptr(out),
         ctypes.c_int(G), ctypes.c_int(Y), ctypes.c_int(X), ctypes.c_int(band == "hi"),
         ctypes.c_int(bf16), stream_of(packed))
    count_launch(psi_ghost_band, bf16)
    return out


def cost(packed, rhs, *, G, Y, X, dtype, **_) -> tuple[int, int]:
    """(bytes, flops) of a call: the packed buffer and the source's G - 1
    planes read once, the band written once; at each rebuilt cell (the
    outer planes but their x-edge columns) an add, 19 multiplies and the
    subtraction at q = 0."""
    e = 2 if dtype == torch.bfloat16 else 4
    return (packed.numel() + rhs.numel() * 4 + 19 * G * Y * X * e,
            21 * (G - 1) * Y * max(X - 2, 0))


psi_ghost_band.launches = 0
psi_ghost_band.launches_bf16 = 0
