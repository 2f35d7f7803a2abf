"""Ring halo exchange between the neighbours of a mesh along one axis.

Port of ``lbm_ferrofluid_tpu/parallel/halo.py``.  The JAX package runs
``ppermute`` over a mesh axis inside ``shard_map`` (and GSPMD inserts the
same collective-permutes for its y/x-sharded 2D paths); here each rank is a
process and :func:`ring_halo` is one ``torch.distributed.batch_isend_irecv``
of a send to the ring neighbour ``shift`` steps up the named axis (``z``,
``y`` or ``x``) and a receive from the one ``shift`` steps down;
``ring_halo.sent_bytes`` counts what it sends and ``ring_halo.exchanges``
the exchanges.  With one rank along the axis it is the wrap of the rank's
own part, as ``ppermute`` over a one-device axis is: a send to the rank
itself through NCCL, else a copy on the device (gloo has no connection
from a rank to itself, and without a group there is nothing to send
through).  The transport is the mesh's backend: NCCL moves CUDA tensors
between cards; gloo moves CPU tensors, and stages CUDA tensors through
pinned host buffers (several ranks sharing one card, which NCCL refuses).
bfloat16 travels as its 16-bit patterns.

:func:`sharded_poisson_sweeps` is the JAX module's demonstration of the
pattern on the channel-form Poisson loop, in plain PyTorch: one plane of
the z-moving channels exchanged a side a sweep.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from ..lattice import D3Q19
from ..ops.equilibrium import heq
from ..ops.stream import bounce_back
from ..utils.types import CellType
from .mesh import Mesh

__all__ = ["ring_halo", "sharded_poisson_sweeps"]


def ring_halo(x: torch.Tensor, mesh: Mesh, shift: int, axis: str = "z") -> torch.Tensor:
    """Send ``x`` to the neighbour ``shift`` steps up the ring of mesh axis
    ``axis`` and return what the neighbour ``shift`` steps down sent (a
    contiguous tensor of ``x``'s shape, type and device)."""
    x = x.contiguous()
    size, idx = mesh.sizes.get(axis, 1), mesh.coords.get(axis, 0)
    if size == 1 and mesh.backend != "nccl":
        return x.clone()
    ring_halo.sent_bytes += x.nbytes
    dst, src = mesh.rank_at(**{axis: idx + shift}), mesh.rank_at(**{axis: idx - shift})
    # gloo has no bfloat16 reduction ops and needs none here: send the bits
    wire = x.view(torch.int16) if x.dtype == torch.bfloat16 else x
    staged = x.device.type == "cuda" and mesh.backend == "gloo"
    if staged:
        send = torch.empty(wire.shape, dtype=wire.dtype, pin_memory=True)
        send.copy_(wire)
        recv = torch.empty(wire.shape, dtype=wire.dtype, pin_memory=True)
    else:
        send, recv = wire, torch.empty_like(wire)
    # every rank makes the same exchanges in the same order, so a count of
    # them tags each one alike on both sides: a message can only meet the
    # receive of its own exchange
    ring_halo.exchanges += 1
    tag = ring_halo.exchanges % (1 << 30)
    for req in dist.batch_isend_irecv([dist.P2POp(dist.isend, send, dst, tag=tag),
                                       dist.P2POp(dist.irecv, recv, src, tag=tag)]):
        req.wait()
    out = recv.to(x.device) if staged else recv
    return out.view(x.dtype)


#: bytes this rank has sent through :func:`ring_halo` (a copy sends
#: nothing); a run resets and reads it
ring_halo.sent_bytes = 0
#: exchanges this process has made (the tag of the next)
ring_halo.exchanges = 0


def sharded_poisson_sweeps(h, magnetic_flags, rhs_scaled, mesh: Mesh, *, tau: float,
                           n_iters: int):
    """The channel-form Poisson loop on this rank's z-slab: ``n_iters``
    sweeps, each exchanging the up-moving channels' (9-13) last plane and
    the down-moving channels' (14-18) first plane with the ring neighbours.
    ``h`` [1, 19, Zl, Y, X], ``magnetic_flags`` and ``rhs_scaled`` [1, 1,
    Zl, Y, X] are the slab's; returns (h', psi of the last sweep).  The
    sweeps equal the whole domain's at the slab's planes."""
    lat = D3Q19
    w = torch.as_tensor(lat.w_bcast(), dtype=h.dtype, device=h.device)
    w0 = float(lat.weights[0])
    is_obs = magnetic_flags == int(CellType.OBSTACLE)
    add_h = w * rhs_scaled
    shifts = lat.shifts()
    psi = torch.zeros_like(rhs_scaled)
    for _ in range(n_iters):
        up, dn = h[:, 9:14], h[:, 14:19]
        up_ghost = ring_halo(up[:, :, -1:], mesh, +1)  # from the rank below
        dn_ghost = ring_halo(dn[:, :, :1], mesh, -1)  # from the rank above
        # the z shift of the z-moving channels is their ghost-substituted slab
        up_in = torch.cat([up_ghost, up[:, :, :-1]], dim=2)
        dn_in = torch.cat([dn[:, :, 1:], dn_ghost], dim=2)
        h_sub = torch.cat([h[:, :9], up_in, dn_in], dim=1)
        parts = []
        for q in range(19):
            sz, sy, sx = shifts[q]
            v = h_sub[:, q]
            if sy or sx:
                v = torch.roll(v, (sy, sx), dims=(-2, -1))
            parts.append(v)
        hs = bounce_back(lat, torch.stack(parts, dim=1), magnetic_flags)
        psi = torch.sum(hs[:, 1:], dim=1, keepdim=True) / (1.0 - w0)
        coll = (1.0 - 1.0 / tau) * hs + heq(lat, psi) / tau + add_h
        h = torch.where(is_obs, hs, coll)
    return h, psi
