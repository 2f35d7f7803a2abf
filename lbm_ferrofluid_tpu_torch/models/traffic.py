"""HBM traffic model for the port's ferrofluid step.

The denominator of a benchmark's ``pct_roofline``: the least device-memory
bytes one outer step moves per cell on the kernel route, counting every
kernel's operand reads and writes at their storage widths and ignoring
reuse on the chip inside a launch (shared memory, registers), as the JAX
package's ``models/traffic.py`` counts them for its Pallas route.  Every
per-term formula is the JAX module's, term for term and in its order, so
the two models agree wherever they describe the same route.

What differs is the choice of branch.  The JAX module picks it from TPU
VMEM gates; this one from the port's own dispatch
(``models/ferrofluid.py:ferrofluid_step``):

- the step's route, by the premac the state carries (``premac``): 6
  leaves, the capillogue steady state (B3 with its emitted source); 5
  leaves, the epilogue steady state (B6, then B5 with ``emit_mac``);
  ``None``, the un-carried step (the prologue B4 first, B5 without
  ``emit_mac``).  ``prime_premac`` leaves 6 for a single-element state
  with an in-plane field, the default here; a batch (B > 1) stays
  un-carried and steps with ``premac=None``.  The model counts one cell,
  whatever the batch.  (An out-of-plane field's 5-leaf premac takes B3's
  box form, which this model does not describe.)
- the magnetic solve, by ``scalar`` (the scalar carry's physics gates:
  tau == 1, the shell obstacles, an axis-aligned field, which are the
  caller's statement, as in JAX): B1's passes
  (``ops/kernels/scalar_poisson.py:passes``) on any grid whose axes all
  have 3 cells or more; else the channel form, B11b's passes
  (``ops/kernels/poisson.py:passes``) with B7's trailing stage emitting H2
  in the last, and on a grid with under 3 cells in y or x
  (``poisson.emit_ok``) the psi route (B11b emitting psi, then B10a),
  which the JAX module counts as its wavefront-less branch.  Each pass is
  counted with its own depth k, a remainder pass too; where k divides
  ``n_iters`` this is JAX's ``n_iters / k`` passes.

The halo terms (``k / Z``) are JAX's formula, kept as the yardstick: they
are not the port's z chunks (``plan(...).lz``), so a kernel that is
re-tiled does not move the denominator.  A change to a pass schedule or a
route gate of the step updates the matching branch here in the same
change.
"""

from __future__ import annotations

from collections import Counter

from ..ops.kernels.poisson import emit_ok
from ..ops.kernels.poisson import passes as channel_passes
from ..ops.kernels.scalar_poisson import passes as scalar_passes

__all__ = ["B4", "PREMAC_LEAVES", "model_bytes_per_cell"]

B4 = 4  # f32 bytes

#: the premacs the step tells apart, by leaves (None: un-carried)
PREMAC_LEAVES = (6, 5, None)


def model_bytes_per_cell(n_iters: int = 30, b_fg: int = 4, b_h: int = 4,
                         res=(256,) * 3, scalar: bool = True, *, premac=6) -> float:
    """Least device-memory bytes per cell of one outer step on the kernel
    route: f and g stored in ``b_fg`` bytes, the channel-form h in ``b_h``
    (the scalar carry is float32 in every storage), on a grid of ``res``
    (Z, Y, X), with ``n_iters`` Poisson sweeps, on the route that a state
    carrying ``premac`` (6, 5 or None leaves) takes.  ``scalar``: the solve
    runs on the scalar carry (its physics gates hold)."""
    if premac not in PREMAC_LEAVES:
        raise ValueError(f"premac={premac!r}: the step tells apart {PREMAC_LEAVES} leaves")
    if n_iters < 1:
        raise ValueError("the solve needs n_iters >= 1")
    Z = res[0]
    total = 0.0
    mac_carry = premac is not None
    capillogue = premac == 6
    if mac_carry:
        # the previous step's B5 or B3 wrote the 9 f32 macro channels; this
        # step only reads them (the capillogue term below counts them in its
        # own 12-channel read)
        if not capillogue:
            total += 9 * B4
    else:
        # B4, the prologue: r 19f + 19g + flags + rho + 3 vel; w 9 f32 macros
        total += (38 * b_fg + 4 + 4 * B4) + 9 * B4

    if scalar:
        # B1: k sweeps a pass over the fused 2-channel f32 (s, s_prev) pair:
        # s2 r+w (+ wrap re-reads and the k-plane seam), cmask and rhs
        # streamed; the last pass's H2 launch writes the 1-channel H2
        if min(res) < 3:
            raise ValueError(f"grid {tuple(res)}: the scalar sweeps need Z, Y, X >= 3")
        total += sum(n * (
            2 * B4 * (2 + 3 * k / Z)        # s2 r+w + wrap re-read + seam w
            + (1 + 2 * k / Z) * 2 * B4      # cmask + rhs streams
        ) for k, n in Counter(scalar_passes(n_iters)).items()) + 1 * B4
    elif emit_ok(res):
        # B11b: per pass r 19h * (1 + 2k/Z) + flags + rhs; w 19h; B7's
        # trailing stage writes the 1-channel H2 in the last pass (psi, the
        # substitution and the gradient stay on the chip)
        total += sum(n * (
            19 * b_h * (2 + 2 * k / Z) + (1 + 2 * k / Z) * (B4 + 4)
        ) for k, n in Counter(channel_passes(n_iters)).items()) + 1 * B4
    else:
        # the psi route: JAX's one-sweep form, then psi r1 + H_int w3 (B10a)
        total += n_iters * ((19 * b_h + B4 + 4) + (19 * b_h + B4))
        total += 4 * B4

    if capillogue:
        # B3: capillary stage + collide + emission in one pass.
        # r: 19f + 19g + flags + 12 f32 capillary channels (premac 9 +
        #    pres_old + rho_ca + H2) + mflags;
        # w: 19f + 19g + 5 f32 state channels (vel/pres/density) +
        #    10 f32 emission channels (9 macros + next step's rhs)
        total += (38 * b_fg + 2 * 4 + 12 * B4) + 38 * b_fg + 15 * B4
        # B2, the contact angle: r rho + flags; w rho_ca
        total += 2 * B4 + 4
    else:
        # the Poisson source: ~r 2 + w 1 f32
        total += 3 * B4
        # phi + contact-angle glue: ~r 2 w 2
        total += 4 * B4
        # B6, the capillary stage (the Laplacian folded in): r 13 f32
        # channels + flags; w 13 f32 channels
        total += (13 * B4 + 4) + 13 * B4
        # B5, the epilogue: r 19f + 19g + flags + 15 f32 macro channels;
        # w 19f + 19g (+ 9 f32 next-step macros with emit_mac)
        total += (38 * b_fg + 4 + 15 * B4) + 38 * b_fg
        if mac_carry:
            total += 9 * B4
    return total
