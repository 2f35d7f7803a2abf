#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's main paths on one GPU and check every kernel.

Run from the repository root with one CUDA card and the CUDA toolkit::

    python3 chip_smoke.py
    python3 chip_smoke.py --scalar-plans   # only B1's plan sweeps, single-device and slab
                                           # rounds (256^3, 130x66x130)
    python3 chip_smoke.py --poisson-plans  # only B11b's plan sweep (256^3, 130x66x130; f32, bf16),
                                           # then its slab rounds at every k
    python3 chip_smoke.py --channel-slab-plans  # only B11b's slab rounds at every k
    python3 chip_smoke.py --scalar-slab-plans  # only B1's slab rounds at every k
    python3 chip_smoke.py --capillary-plans  # only B6's plan sweep (256^3, 130^3)
    python3 chip_smoke.py --stencil-plans  # only B10a's and B10b's (256^3, 130x66x130)
    python3 chip_smoke.py --epilogue-plans  # only B5's (256^3, 130x66x130; f32, bf16)
    python3 chip_smoke.py --spikes         # only the spike-pattern golden (64x33x64)
    python3 chip_smoke.py --demo           # only the demo drivers (phases 5c demo, demos)
    python3 chip_smoke.py --compat         # only the grad guard and the compat facade
    python3 chip_smoke.py --dibr --native --inverse  # only those phases (any subset)
    python3 chip_smoke.py --padded         # only the padded transposed layout (66x136x256)
    python3 chip_smoke.py --2d             # only the 2D scenes, their timed steps, rosensweig_2d
    python3 chip_smoke.py --sharded        # only the z-slab paths over ranks (phase sharded)
    python3 chip_smoke.py --step-time [ROOT]  # ms a step at 130x66x130 of the
                                           # package at ROOT (default: this checkout)
    python3 chip_smoke.py --batch          # only batched states on one device (phase batch)
    python3 chip_smoke.py --route-time [ROOT]  # ms a step of routes U and H at 256^3,
                                           # B = 1, of the package at ROOT
    python3 chip_smoke.py --trail-time [ROOT]  # B7's trailing pass alone in each instance
                                           # at 256^3, then --route-time, of the package at ROOT
    python3 chip_smoke.py --slab-time [ROOT]   # B1's slab solve and route Z slab-forced,
                                           # B11b's slab solve (f32, bf16) and routes C and
                                           # U19 slab-forced, at 256^3 and 130x66x130, of
                                           # the package at ROOT
    python3 chip_smoke.py --mesh2d         # only the 2D models on y/x meshes (phase mesh2d)
    python3 chip_smoke.py --mesh3d         # only 3D states on the block route (phase mesh3d)

Phases, each printing one JSON line; any failed check exits non-zero:

1. device: the card's name, count and power limit (``nvidia-smi``);
2. build: one nvcc process per CUDA source, all started together, link the
   kernel library from ``csrc/`` (the default run first starts phase 5b's
   2D processes, which launch none of its kernels, and builds beside them);
3. kernels: each kernel against its plain PyTorch version on seeded inputs
   with an interior obstacle block.  Ferrofluid kernels (B1 scalar Poisson
   sweeps + H2 at 30 sweeps and at 7, which its pass depth does not divide,
   B2 contact angle, B3 capillogue chain at the magnetic tau 1
   and 0.8, B4 prologue, B11b channel-form Poisson sweeps at tau 1 and 0.8
   and at 30 and 7 sweeps, with an interior magnetic obstacle block and one
   across a tile edge and a z seam of its plan, its chosen plan also held
   bit for bit to the one-sweep plan; the same with B7's trailing stage in
   its last pass (``emit="hint"`` and ``"h2"``, float32 and bfloat16 h),
   bit for bit to its plain version, with blocks across the trailing
   pass's first tile edges and seam and on the grid's last row and column
   (``b11b_emit_checks``); B10a gradients of 1, 3, 4 and 5
   fields with the launches ``launches_per_call`` states, B5 epilogue
   with and without ``emit_mac`` on B6's outputs, B10b Laplacian) at
   34x66x130 and 130x66x130, B11b, B10a and B10b as above at 50x50x193,
   which no tile divides, and B10a and B10b at 4x66x130 (the z clamp at
   both ends of every strip); B10a's batch form at B = 2 on psi at
   130x66x130 (``b10a_batch_row``: bit for bit to two B = 1 calls, against
   its plain version, ms beside those calls and its bound at B); HCZ
   kernels (B8b/B8a
   stream + bounce, B2 at 0.75 pi, B6 capillary stage with and without H2,
   B9 collide, each fed with what the kernels before it produced, then the
   capillary stage's stencil route B10b + B10a against its plain version
   and against B6), with an obstacle block across B6's first tile edge and
   z strip seam, at 34x66x130, 130^3 and 50x50x193; then B5 in both modes
   on those HCZ inputs (``b5_hcz_inputs``: the chain's rho_ca and capillary
   fields, with an obstacle block across the first block edge and strip
   seam of B5's plan) at 34x66x130, 130x66x130, 50x50x193 and 4x66x130,
   under the step's plan and the stage form in strips of 4 planes, each
   held bit for bit to the cell plan (one thread a cell), and against its plain
   version.  Bar rel <= 5e-5 per field
   (max|a-b| / max|b|), velocities also pass at abs <= 5e-6
   (docs/PARITY.md:78-93: FMA contraction and reassociation);
3b. grad guard: each kernel wrapper of ``KERNELS``, given a CUDA input
   that requires grad with grad enabled, raises and launches nothing
   (``ops/kernels/_lib.py:check_no_grad``);
4. golden: ``tests/golden/ferro3d.npz`` (8 steps; the capillogue steady
   state with the scalar carry and with the channel-form solve,
   ``scalar_carry=False``, and the un-carried step) and ``hcz3d.npz``
   (10 steps), reference solver, through the port with kernels, at
   tests/test_parity.py's bars; then a grid with an axis of 3 cells, which
   the kernel route refuses on the card (naming ``plain=True``) and the
   plain versions step;
5. main paths, each with the launch counters zeroed just before it and read
   just after it:
   - Rosensweig at the demo's native 130x66x130, primed and stepped 30
     times with the kernels against 30 plain steps on the card (phase 3's
     bars), then 200 more kernel steps (timed, MLUPS), fields finite, drift
     of sum(rho) over fluid cells; every path below checks its exact launch
     counts a step too (B2 and B6 one launch a call);
   - HCZ ``multiphase_3d`` at 130^3 the same way (30 against 30, 200 timed),
     then ``droplet_spread_3d`` at 130^3 (30 against 30);
   - ``two_droplets_3d`` at 50x50x193 on the ferrofluid path (30 against 30);
   - Rosensweig 130x66x130 on the channel-form solve: with
     ``scalar_carry=False`` 30 kernel steps against 30 plain steps and
     against 30 scalar-carry kernel steps (``compare_views``), then 200
     timed; with tau = 0.8 30 against 30.  B11b launches
     ``launches_per_call`` times (one a pass of its plan), the last with
     B7's trailing stage emitting H2 (``launches_emit``, once a step; no
     B10a);
   - the un-carried step (Rosensweig 130x66x130 never primed: B4, B11b
     with the trailing stage, B2, B6, B5) and the epilogue steady state (5-leaf premac with
     the scalar carry: B1, B2, B6, B5 with ``emit_mac``), each 30 kernel
     against 30 plain steps with exact launch counts, the latter also
     against 30 capillogue steady-state steps;
   - the stencil route in the HCZ step (``multiphase_3d`` 130^3: B8b, B8a,
     B2, B10b, B10a, B9), 30 against 30 plain HCZ steps;
   - padded: the padded transposed layout (``scenes.rosensweig_3d_tpu``,
     130x66x130 physical in a 66x136x256 array): B1's psi form, its H2
     launch on the box and B3's box form against their plain versions
     (float32, and B3 in bfloat16), timed beside their bounds; 30 padded
     kernel steps against 30 ``plain=True`` steps through ``phys_view``,
     then against the native layout after 30 steps; ms a step and MLUPS in
     array and physical cells; the un-carried padded step (10 against 10);
     turbo (30 against 30 plain and against float32, as phase 7); and the
     demo with ``--tpu_layout 1``, 20 steps and a frame (:func:`phase_padded`);
   - sharded: the z-slab paths (:func:`phase_sharded`) on each route: Z, the
     capillogue steady state (B1, B2, B3 in slab form), and the epilogue
     routes E (5-leaf premac), O (an out-of-plane field) and U (un-carried,
     B4 each step), through B1, B2, B10b, B6 and B5 in slab form; C and
     U19, the capillogue steady state and the un-carried step with the
     channel-form solve (tau 0.8, 19-channel h: B11b's slab rounds, the
     last emitting H2 with the clamp at true edges only; B10a's slab form
     on the psi route, three solves without a static field; on C a round
     of B11b's slab form with the flags and rhs as the slab's planes
     beside their bands and as the extended pair, bit for bit to each
     other and to the plain version, ``b11b_flag_forms``); H, the HCZ
     step (B8b, B8a, B2, B10b, B6 in slab
     form, B9 local); one rank with ``slab=True`` at 256^3 and 130x66x130
     (HCZ at 256^3 and 130^3), float32 (30 steps) and turbo (10), exact
     launches a step, against single-device kernel steps, each slab form
     against its plain version and its single-device form, timed beside it
     and its bound; gloo ranks sharing the card (route Z on 4 ranks at
     256^3, a batch mesh; O on 2 ranks at 256^3; C on 2 at 130x66x130; H
     on 2 at 256^3) and NCCL to the rank itself;
   - compat: the reference's driver API (``compat.py``) op by op on
     ``multiphase_3d`` 130^3, the loop of tests/test_compat.py in 3D: 10
     steps against 10 stencil-route steps (phase 3's bars), 100 more with
     B2, B10b, B10a and B9 once a step, finite, summed rho's drift, ms a
     step at 130^3 and 256^3, and ``capillary_process`` with H2/phi (B10a
     over 4 fields) against the plain ops;
6. flagships at 256^3: the Rosensweig scene that bench.py times (scalar
   carry, then the channel-form solve, then the un-carried step and the
   epilogue steady state) and the HCZ ``multiphase_3d`` (with the stencil
   route on its inputs), warm steps, MLUPS, peak memory, and per-kernel
   times with CUDA events (kernel, plain version) beside each kernel's
   bound, and kernel-vs-plain errors at that size; B3's four launches,
   B1's pass launches apart from its H2 launch and B11b's passes are timed
   one by one, with B1's and B11b's plans and the resident blocks an SM of
   B1's pass, B11b's pass and B3's collide; B2 and B6 are timed launch by
   launch, B6 also with H2, with its plan, resident blocks and ptxas line,
   and B2, B6 and the stencil route are held to their plain versions again
   with B6's seam block.  B5's plans (the step's, a strip of 4 planes,
   the cell plan) are held bit for bit to each other in both modes, with
   each instance's resident blocks and ptxas line, and ``emit_mac`` timed
   launch by launch (``b5_flagship_plans``).  B10a is timed on one field (the channel form's
   psi) and on the stencil route's stacks of 3 and 4 fields, B10b on
   density(rho_ca), each with its plan, resident blocks and ptxas line,
   and beside a yardstick that is on no path: cuDNN's ``conv3d`` of the
   interior then ``F.pad``, 2 calls, in full float32 (``conv3d_pad``).
   B11b with B7's trailing stage on the channel flagship's inputs
   (``trail_report``): h2 and hint bit for bit to the plain version,
   launch by launch, the trailing pass's plan, resident blocks and ptxas
   line; the trailing pass alone in each instance (``trail_instances``:
   tau 1 and 0.8, h2 and hint, B = 2, a slab at a true edge and between
   neighbours) bit for bit to its plain version with a hash of its bits,
   beside a regular pass and its bound; the h2 call timed in turns against the psi route (B11b's psi,
   the substitution, B10a, the H2 ops); C and U ms a step at 256^3 on
   both routes in turns, with their launches a step (``route_turns``).
   Each timed route of phases 6 and 8 (R, C, E and U; turbo, the
   bfloat16 channel form, bfloat16 E and U) carries ``traffic``
   (:func:`traffic_row`): the bytes a cell of the port's traffic model
   (``models/traffic.py``), the rate they make at its MLUPS and its share
   of 3.35 TB/s, and beside them the bytes a cell of the step's kernel
   calls by their ``cost``;
5c. the north star and the demos (demo and dibr after phase 5; spikes,
   demos, native and inverse before phase 3, while phase 5b's 2D
   processes run), each with the counters zeroed just before it and read
   just after:
   - spikes: the spike-pattern golden (tests/golden/
     rosensweig3d_spikes_ref.npz, the reference solver's perturbed
     64x33x64 Rosensweig pool) from its initial fields, 4000 steps of the
     capillogue steady state in float32 and in turbo (bfloat16 f, g, h),
     the density every 500 steps held to the reference's through
     tools/spike_metric.py at tests/test_spike_parity.py's bars
     (``spike_failures``), ms a step;
   - demo: the port's Rosensweig driver at 130x66x130, 100 steps with a
     frame every 50 (frames rendered, the OBJ's face count that of host
     ``phi_to_mesh``), the final phi through ``make_render_pipeline``
     against the host path, the on-card triangle set against the host's,
     ``soft_rasterize`` on the card against the CPU, ms a frame of each
     path and ms a step;
   - demos: the other eleven drivers, 20 steps each at their default
     grids (frames written and not constant), and the 2D two-droplets
     driver's step-400 Tecplot dump;
   - dibr: the DIB-R stack on the card against the same calls on the CPU:
     the ``multiphase_3d`` droplet's interface (32^3) at 256 pixels in all
     four modes (float64 within 1e-9), the vertex gradient of an image
     loss (float64 within 1e-8), ms a frame and peak bytes, a frame of the
     130^3 droplet, ``voxelize`` of the Rosensweig interface at 128^3
     (grids equal), ``load_textures``;
   - native: the port's C++ library's build time, and marching tetrahedra
     at 130x66x130, native against numpy (triangle sets within 1e-5), ms
     of each;
   - inverse: the inverse-design driver at 24x24 and 130x130 (loss curve,
     ms an iteration, a fall of at least 2x, no kernel launched);
5b. the 2D and single-phase models (after phase 5): the six 2D and
   single-phase goldens of tests/test_parity.py (``singlephase_bgk``,
   ``singlephase_kbc_a``, ``sc``, ``hcz``, ``hcz_kbc_wetting``, ``ferro2d``
   in channel form and in the scalar carry) at that file's bars; 3D
   single-phase BGK at 256^3 on a seeded Taylor-Green-like field (tau 0.8),
   30 steps through B8a against 30 ``plain=True`` steps at phase 3's bars,
   50 timed steps, B8a once a step, B8a timed beside its bound; each 2D
   scene at its demo's default resolution (130x130, ``two_droplets_2d``
   98x384) for 250 steps through the runner, finite, summed rho within
   ``SCENE_DRIFT``, no kernel launched, and 2000 steps of ``rosensweig_2d``
   at 64x64 in bfloat16 against float32 with tests/test_bf16_physics.py's
   assertions, these ten runs in three concurrent processes of this script
   on the card (``--2d-job``: host-bound runs, each process checking that
   it launches no kernel), started before the build in the default run,
   while this process builds the kernels and runs phase 7's first two
   parts and its long horizon, phase 5c's spikes, demos, native and
   inverse and the 2D goldens, before phase 3 (their lines, and the
   build's, say ``beside_2d_jobs``: their times were taken on a card and
   host those processes share); then, in this process alone,
   the single-phase BGK and KBC,
   HCZ and ferrofluid (scalar carry, channel form) 2D steps timed at
   native size and at 2048^2 with their CUDA kernel launches a step from
   ``torch.profiler``;
7. bfloat16 storage of f, g and h (the JAX package's turbo mode; it runs
   before phase 3, while phase 5b's 2D processes do): each bfloat16 form (B3 at the magnetic tau 1
   and 0.8, B4, B5 with and without ``emit_mac``, B11b at tau 1 and 0.8
   and 30 and 7 sweeps at 34x66x130 and 130x66x130, with and without the
   trailing stage; B8b, B8a, B9 in the
   HCZ chain at 34x66x130 and 130^3) against its plain version on phase
   3's inputs rounded to bfloat16: B8a's and B8b's streamed values and
   B11b bit for bit (B11b also under its chosen plan against the
   one-sweep plan, and under every plan of ``--poisson-plans`` at
   34x66x130), bfloat16 collide outputs equal or one ulp apart in at most
   ``BF16_SHARE`` of the elements (further only within the float32 bar),
   float32 outputs at phase 3's bars, B3's and B5's emission on the
   kernel's own f'/g'; B5's plans bit for bit to the cell plan at phase 3's
   four grids.  Then the five routes in bfloat16 (Rosensweig
   130x66x130 in the capillogue steady state with the scalar carry, the
   channel form with bfloat16 h, un-carried and in the epilogue steady
   state; HCZ ``multiphase_3d`` 130^3): 30 kernel steps with exact
   launch counts (those of float32, every f/g/h kernel in its bfloat16
   form) against 30 plain steps (within ``BF16_DENSITY`` of max|density|)
   and 30 float32 kernel steps (the dense phase's mean level within
   ``BF16_LEVEL`` cells), fluid mass at ``BF16_MASS`` against both; and
   2000 steps of Rosensweig 130x66x130 in float32 and in bfloat16 (mass,
   mean interface level, corrugation, as tests/test_bf16_physics.py);
8. the 256^3 flagships in bfloat16 (after phase 6): Rosensweig in turbo
   mode, on the channel form, un-carried and in the epilogue steady
   state, and HCZ, MLUPS and ms a step, then each bfloat16 form timed
   beside its plain version and its bfloat16 bound, B3 launch by launch,
   B5 with its plans as in phase 6;
9. batch (after phase 8; ``--batch`` alone): batched states on one device
   (:func:`phase_batch`), each element moved by its own seeded noise.
   Each cell of ``BATCH_CELLS`` (route U, the un-carried Rosensweig step
   on the 19-channel h, at 130x66x130 with B = 4 and 256^3 with B = 2 in
   float32 and turbo; HCZ ``multiphase_3d`` at 130^3 with B = 4 and 256^3
   with B = 2; 3D single phase at 130^3 with B = 2) steps its batch 30
   times (5 at 256^3) with the counters zeroed just before and read just
   after: every kernel of the route once a step, each launch for the whole
   batch (U 14, H 5, P 1); every element then bit for bit to as many B = 1
   kernel steps of it alone; the peak memory; ms a step and MLUPS against
   B sequential B = 1 steps, in turns.  At 256^3 B = 2 (float32) each
   kernel of routes U and H on the batched state, in the step's order:
   bit for bit to its elements' B = 1 calls, against its plain version,
   timed beside those B = 1 calls and its bound at B.  ``rosensweig_2d``
   at 130x130 with B = 16 against B = 1 (plain ops, ms a step in turns,
   element 0 against the B = 1 run);
10. mesh2d (``--mesh2d`` alone): the 2D models on y/x meshes as gloo ranks
   sharing the card, bit for bit to one device (:func:`phase_mesh2d`);
11. mesh3d (``--mesh3d`` alone): 3D states on the block route as 4 gloo
   ranks sharing the card (:data:`MESH3D_RUNS`: Rosensweig 130x66x130 on
   (z, y) = (2, 2) in float32 and turbo and 256^3, the channel form on
   (y, x) = (2, 2), HCZ 130^3 on (z, y, x) = (2, 2, 1), single phase 128^3,
   HCZ on 2-plane z-slabs; at two batch elements a rank, ROADMAP A12 slice
   7: Rosensweig 130x66x130 B = 2 on (z, y) = (2, 2) in float32 and
   turbo, HCZ 128^3 B = 2 on 4 z ranks, single phase 128^3 B = 2 on
   (y, x) = (2, 2); and the float32 B = 2 Rosensweig state on (batch, z)
   = (2, 2), one element a rank on the slab route U19, beside its block
   run; the padded layout, ROADMAP A12 slice 4c: the demo's 66x136x256
   arrays on (z, y) = (2, 2) in float32 and turbo and on (y, x) = (2, 2),
   and 64x136x256 on 4 z ranks, the slab route, held to a one-rank
   ``slab=True`` mesh), every run bit for bit to one device's steps of the
   whole batch on the same route by hashes of each rank's blocks (a
   premac's leaves too), the kernels' launches a
   step checked (at two elements a rank every launch a batch's), ms a step
   beside one device's, exchanges and bytes a step, ms inside the
   exchanges.

The build phase reports each kernel's registers, static shared memory and
spills as ptxas gives them.

Then it prints the ``nvidia-smi`` line, one ``{"kernels": [...]}`` line (a
row for every kernel, one for each bfloat16 form with its launches on
phase 7's paths, one for B11b's last pass with B7's trailing stage in
float32 and bfloat16 with its launches on the channel-form paths, one for
each of B1's psi and B3's box forms with its launches on the padded
paths, the slab forms' rows, and the batch forms' rows with their
launches on phase 9's paths, B10a's on phase 11's runs at two elements a
rank) and, last, ``{"ok": true, "device":
{...}}``.  Bounds use the H100 SXM peaks of NVIDIA's data sheet: 3.35
TB/s and 67 TFLOP/s float32 (non-tensor), and each kernel's ``cost``: the
bytes and flops that the call's own inputs need (an input read only at
some cells counts only there).
"""

from __future__ import annotations

import concurrent.futures
import contextlib
import hashlib
import json
import math
import os
import pathlib
import re
import subprocess
import sys
import time
import types

import numpy as np

HBM_BYTES_PER_S = 3.35e12
F32_FLOPS_PER_S = 67e12
BAR_REL, BAR_VEL_ABS = 5e-5, 5e-6
ROOT = pathlib.Path(__file__).resolve().parent


class CheckFailed(Exception):
    pass


_T0 = time.monotonic()


#: set while phase 5b's 2D processes share the card with this one
#: (:func:`run_2d_jobs`): a phase line emitted then says so
_BESIDE_2D_JOBS = []


def emit(obj) -> None:
    """One JSON line; a phase's line with the seconds since the start, and
    ``beside_2d_jobs`` where its times were taken with phase 5b's 2D
    processes on the card."""
    if "phase" in obj:
        obj = dict(obj, clock_s=time.monotonic() - _T0)
        if _BESIDE_2D_JOBS:
            obj["beside_2d_jobs"] = True
    print(json.dumps(obj), flush=True)


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise CheckFailed(msg)


#: output names of each kernel's wrapper, in return order
OUTPUTS = {
    "B1": ["s2", "H2"],
    "B2": ["rho_ca"],
    "B3": ["f", "g", "vel", "pressure", "density", "mac_rho", "mac_vel",
           "mac_density", "mac_m0g", "mac_m1g", "mac_rhs"],
    "B4": ["rho", "vel", "density", "m0g", "m1g"],
    "B5": ["f", "g", "mac_rho", "mac_vel", "mac_density", "mac_m0g", "mac_m1g"],
    "B6": ["vel", "pressure", "force", "dfai", "dprho"],
    "B8a": ["f_post", "m0", "m1"],
    "B8b": ["f_post", "rho", "vel", "density"],
    "B9": ["f", "g"],
    "B10a": ["grad"],
    "B10b": ["lap"],
    "B11b": ["h", "psi"],
    "B11b emit": ["h", "H2"],
}
VEL_FIELDS = ("vel", "mac_vel")


def flat(out):
    if not isinstance(out, (tuple, list)):
        return [out]
    res = []
    for x in out:
        res.extend(flat(x))
    return res


def compare(what, names, got, want):
    """Per-field errors of ``got`` against ``want``; raises unless each
    field meets the bar (rel, or abs for velocities)."""
    import torch

    rows = {}
    for field, a, b in zip(names, flat(got), flat(want), strict=True):
        a, b = a.double(), b.double()
        check(bool(torch.isfinite(a).all()), f"{what} {field}: non-finite values")
        err = float((a - b).abs().max())
        r = err / max(float(b.abs().max()), 1e-30)
        rows[field] = {"max_abs_err": err, "rel": r}
        check(r <= BAR_REL or (field in VEL_FIELDS and err <= BAR_VEL_ABS),
              f"{what} {field}: rel {r:.3e}, abs {err:.3e} over the bar")
    return rows


def nvidia_smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return out.stdout.strip().splitlines()[0]


def ptxas_summary(log: str) -> dict:
    """Registers, static shared memory (bytes) and spills per kernel from
    nvcc's ``-Xptxas -v`` output."""
    res, cur = {}, None
    for line in log.splitlines():
        m = re.search(r"(?:Compiling entry function|Function properties for) '?(_Z(\d+)\w+)", line)
        if m:
            mangled, n = m.group(1), int(m.group(2))
            start = 2 + len(m.group(2))
            cur = mangled[start:start + n]
            targs = re.match(r"I((?:L[a-z]+\d+E|f|13__nv_bfloat16)+)E", mangled[start + n:])
            if targs:  # a template's instance: <1,13> for <float, true, 13>,
                # <bf16,1,13> for <__nv_bfloat16, true, 13>
                args = ["bf16" if t else v for v, t in re.findall(
                    r"L[a-z]+(\d+)E|(13__nv_bfloat16)", targs.group(1))]
                if args:
                    cur += "<" + ",".join(args) + ">"
            res.setdefault(cur, {})
        elif cur and "registers" in line:
            res[cur]["regs"] = int(re.search(r"Used (\d+) registers", line).group(1))
            smem = re.search(r"(\d+) bytes smem", line)
            res[cur]["smem"] = int(smem.group(1)) if smem else 0
        elif cur and "spill stores" in line:
            nums = [int(v) for v in re.findall(r"(\d+) bytes", line)]
            res[cur]["stack"], res[cur]["spill_st"], res[cur]["spill_ld"] = nums[:3]
    return res


# ---------------------------------------------------------------- inputs
def seeded_inputs(res, seed, dev):
    """Inputs on the card from a numpy seed: the scene's macros with small
    perturbations, f = feq and g = geq of them with 0.1 % noise per
    channel, and this step's carried macros from the plain prologue, so
    that every kernel sees fields the main path could give it."""
    import torch

    from lbm_ferrofluid_tpu_torch.models import rosensweig_3d
    from lbm_ferrofluid_tpu_torch.ops.equilibrium import feq, geq
    from lbm_ferrofluid_tpu_torch.ops.kernels.fused_step import lbm_prologue_plain
    from lbm_ferrofluid_tpu_torch.ops.moments import eos_pressure, rho_to_density
    from lbm_ferrofluid_tpu_torch.ops.scalar_poisson import make_cmask

    params, st = rosensweig_3d(res=res, device=dev)
    rng = np.random.default_rng(seed)
    Z, Y, X = res

    def t(a):
        return torch.as_tensor(np.asarray(a, np.float32), device=dev)

    flags = st.flags.clone()
    flags[..., Z // 2, Y // 2, 2:4] = 2  # an interior obstacle block
    fluid = (flags != 2).float()
    mfluid = (st.magnetic_flags != 2).float()
    mflags_block = st.magnetic_flags.clone()
    mflags_block[..., Z // 2 - 1:Z // 2 + 1, Y // 2 - 1:Y // 2 + 1, 5:7] = 2
    gas = dict(rho_gas=params.rho_gas, rho_fluid=params.rho_fluid,
               density_gas=params.density_gas, density_fluid=params.density_fluid)
    rho = st.rho + t(1e-3 * rng.uniform(-1, 1, (1, 1, *res)))
    den = rho_to_density(rho, **gas)
    vel = t(0.01 * rng.uniform(-1, 1, (1, 3, *res))) * fluid
    pres = eos_pressure(den)
    f_eq = feq(params.lattice, den, vel)
    f = f_eq * (1 + t(1e-3 * rng.standard_normal((1, 19, *res))))
    g = geq(params.lattice, rho, den, pres, f_eq) * (
        1 + t(1e-3 * rng.standard_normal((1, 19, *res))))
    rho_pre, vel_pre, den_pre, gsum, gmom = lbm_prologue_plain(
        f, g, flags, rho, vel, c=params.dx / params.dt, **gas)
    return params, dict(
        flags=flags, mflags=st.magnetic_flags, rho_old=rho, vel_old=vel, pres=pres,
        f=f, g=g, rho_pre=rho_pre, vel_pre=vel_pre, den_pre=den_pre, gsum=gsum,
        gmom=gmom,
        H2=params.mag_strength ** 2 * (1 + t(0.1 * rng.uniform(-1, 1, (1, 1, *res)))),
        s2=torch.cat([t(rng.standard_normal((1, 1, *res))),
                      t(rng.standard_normal((1, 1, *res)))], dim=1) * mfluid,
        cmask=make_cmask(st.magnetic_flags),
        rhs=t(1e-3 * rng.standard_normal((1, 1, *res))) * mfluid,
        h=t(0.1 * rng.uniform(-1, 1, (1, 19, *res))) * mfluid,
        mflags_block=mflags_block,
        fields4=t(rng.standard_normal((1, 4, *res))),
    )


#: B11b's tile heights for each pass depth k that ``--poisson-plans`` times
POISSON_PLAN_HEIGHTS = {1: (8, 12), 2: (8, 12, 16), 3: (5, 7, 9, 11), 4: (3, 5)}


def poisson_seam_block(mflags, sms, n_iters):
    """``mflags`` with magnetic obstacles straddling B11b's first tile edge
    in x and in y and its first z seam, under the plan it takes for
    ``n_iters`` sweeps on a card of ``sms`` SMs."""
    from lbm_ferrofluid_tpu_torch.ops.kernels import poisson as pp

    pl = pp.plan(*mflags.shape[2:], n_iters, sms)
    tx = pp.tile_width(pl.k)
    out = mflags.clone()
    out[..., pl.lz - 1:pl.lz + 1, pl.ty - 1:pl.ty + 1, tx - 1:tx + 1] = 2
    return out


def b11b_plan_against_one_sweep(args, kw, sms):
    """B11b under the plan it chooses against the k = 1 plan (one launch a
    sweep, the chosen tiles and chunks) on the same inputs: the same bits,
    or the check fails."""
    import torch

    from lbm_ferrofluid_tpu_torch.ops.kernels import poisson as pp
    from lbm_ferrofluid_tpu_torch.ops.kernels._lib import elem_bytes

    real = pp.plan
    chosen = real(*args[0].shape[2:], kw["n_iters"], sms, elem_bytes(args[0]))
    one = pp.PoissonPlan(1, chosen.ty, chosen.lz, pp.passes(kw["n_iters"], 1))
    got = pp.poisson_sweeps(*args, **kw)
    pp.plan = lambda *a, **_: one
    try:
        want = pp.poisson_sweeps(*args, **kw)
    finally:
        pp.plan = real
    torch.cuda.synchronize()
    check(all(torch.equal(a, b) for a, b in zip(got, want)),
          f"B11b under {chosen} differs from the one-sweep plan {one}")
    return {"chosen": [chosen.k, chosen.ty, chosen.lz], "one_sweep": [one.k, one.ty, one.lz],
            "bit_for_bit": True}


def b2_cells_differing(got, want):
    """Cells where B2 and its plain version differ, and how many of them
    are not among the 8 corners (where PyTorch's CUDA division by a Python
    scalar multiplies by its reciprocal, and the kernel divides)."""
    import torch

    differ = got[0, 0] != want[0, 0]
    n = int(differ.sum())
    differ[::differ.shape[0] - 1, ::differ.shape[1] - 1, ::differ.shape[2] - 1] = False
    torch.cuda.synchronize()
    return {"cells_differing": n, "outside_the_corners": int(differ.sum())}


def kernel_calls(params, d):
    """Per kernel id: (wrapper args, kwargs) at the inputs ``d``, which hold
    the capillogue's ``rho_ca`` and ``H2`` once B2 and B1 have run."""
    gas = dict(rho_gas=params.rho_gas, rho_fluid=params.rho_fluid,
               density_gas=params.density_gas, density_fluid=params.density_fluid)
    h_ext = tuple(params.mag_strength if a == params.h_ext_axis else 0.0 for a in range(3))
    cap_kw = dict(
        kappa=params.kappa, gravity=tuple(float(v) for v in params.gravity_vec().reshape(-1)),
        tau_f=params.tau_f, tau_g=params.tau_g, dx=params.dx, dt=params.dt,
        emit_rhs=(params.h_ext_axis, params.mag_strength, params.tau), **gas,
    )
    return {
        "B1": ((d["s2"], d["cmask"], d["rhs"]),
               dict(n_iters=params.poisson_iters, dx=params.dx, h_ext=h_ext)),
        "B2": ((d["rho_pre"], d["flags"], params.contact_angle), {}),
        "B3": ((d["f"], d["g"], d["flags"], d["rho_pre"], d["den_pre"], d["pres"],
                d["rho_ca"], d["H2"], d["gsum"], d["gmom"], d["vel_pre"], d["mflags"]),
               cap_kw),
        "B4": ((d["f"], d["g"], d["flags"], d["rho_old"], d["vel_old"]),
               dict(c=params.dx / params.dt, **gas)),
    }


def epilogue_call(K, params, d, emit_mac):
    """B5's (args, kwargs) at the inputs ``d`` as the 5-leaf and the
    un-carried routes give them: the capillary stage (B6) with H2 and phi
    from the streamed density, then density(rho_ca)."""
    from lbm_ferrofluid_tpu_torch.ops.moments import phi_from_density, rho_to_density

    gas = dict(rho_gas=params.rho_gas, rho_fluid=params.rho_fluid,
               density_gas=params.density_gas, density_fluid=params.density_fluid)
    phi = phi_from_density(d["den_pre"], params.density_gas, params.density_fluid)
    vel, pres, force, dfai, dprho = K["B6"].wrapper(
        d["rho_pre"], d["den_pre"], d["pres"], d["rho_ca"], d["H2"], phi, d["flags"], d["gsum"],
        d["gmom"], d["vel_pre"], kappa=params.kappa, dx=params.dx, dt=params.dt,
        gravity=tuple(float(v) for v in params.gravity_vec().reshape(-1)), **gas)
    args = (d["f"], d["g"], d["flags"], d["rho_ca"], vel, rho_to_density(d["rho_ca"], **gas),
            pres, force, dfai, dprho)
    return args, dict(tau_f=params.tau_f, tau_g=params.tau_g, dx=params.dx, dt=params.dt,
                      emit_mac=emit_mac, mac_consts=(params.dx / params.dt, *gas.values()))


def with_epilogue_plan(pl, fn):
    """``fn()`` with B5's ``plan`` fixed to ``pl`` (the sweep's and the
    checks' way to select a plan the step does not take)."""
    from lbm_ferrofluid_tpu_torch.ops.kernels import fused_step

    real = fused_step.plan
    fused_step.plan = lambda *a, **_: pl
    try:
        return fn()
    finally:
        fused_step.plan = real


def epilogue_plans(res, bf16):
    """B5's plans at ``res`` that the checks hold to the cell plan: the
    step's, and the stage form in strips of 4 planes where the step's
    strip is another."""
    import torch

    from lbm_ferrofluid_tpu_torch.ops.kernels import fused_step

    sms = torch.cuda.get_device_properties(0).multi_processor_count
    step = fused_step.plan(*res, sms, bf16)
    strip = fused_step.EpiloguePlan("stage", 4)
    return {"step": step, **({"strip 4": strip} if step != strip else {})}


def epilogue_seam_block(flags, pl):
    """``flags`` with obstacles across the first z strip seam of B5's plan
    ``pl`` and its first block edge (its first block's last cell and the
    next block's first, in row-major order of a plane)."""
    from lbm_ferrofluid_tpu_torch.ops.kernels import fused_step

    Z, Y, X = flags.shape[2:]
    out = flags.clone()
    zs = slice(max(pl.zb - 1, 0), pl.zb + 1)
    for cell in (fused_step.NT - 1, fused_step.NT):
        if cell < Y * X:
            out[..., zs, cell // X, cell % X] = 2
    return out


def b5_hcz_inputs(K, res, seed, dev, bf16):
    """B5's (args, kwargs) on ``hcz_seeded_inputs`` (an interior obstacle
    block and one across B6's first tile edge and strip seam), with
    obstacles across the first block edge and strip seam of B5's step plan
    added, f and g in bfloat16 with ``bf16``:
    the HCZ chain's B8b, B8a, B2 and B6 give rho_ca and the capillary
    stage's fields."""
    import torch

    from lbm_ferrofluid_tpu_torch.ops.kernels import fused_step
    from lbm_ferrofluid_tpu_torch.ops.moments import rho_to_density

    params, d = hcz_seeded_inputs(res, seed, dev)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    d["flags"] = epilogue_seam_block(d["flags"], fused_step.plan(*res, sms, bf16))
    if bf16:
        d = dict(d, f=d["f"].to(torch.bfloat16), g=d["g"].to(torch.bfloat16))
    ctx = hcz_chain(K, params, d, lambda label, kid, a, kw: K[kid].wrapper(*a, **kw))
    gas = dict(rho_gas=params.rho_gas, rho_fluid=params.rho_fluid,
               density_gas=params.density_gas, density_fluid=params.density_fluid)
    vel, pres, force, dfai, dprho = ctx["b6"]
    args = (d["f"], d["g"], d["flags"], ctx["rho_ca"], vel,
            rho_to_density(ctx["rho_ca"], **gas), pres, force, dfai, dprho)
    return args, dict(tau_f=params.tau_f, tau_g=params.tau_g, dx=params.dx, dt=params.dt,
                      mac_consts=(params.dx / params.dt, *gas.values()))


def b5_plan_rows(K, args, kw, what, rows=None):
    """B5 in both modes at ``args``: under the step's plan and a strip of 4
    planes (``epilogue_plans``), each held bit for bit to the cell plan (PR
    10's kernel, the same per-cell code), and the step's plan to its plain
    version (phase 3's bars, or ``rows``: ``bf16_rows``).  Returns the
    errors of both modes and the plans held."""
    import torch

    from lbm_ferrofluid_tpu_torch.ops.kernels import fused_step

    res = tuple(args[0].shape[2:])
    out, held = {}, {}
    for emit_mac in (False, True):
        kwm = dict(kw, emit_mac=emit_mac)
        cell = with_epilogue_plan(fused_step.CELL, lambda: K["B5"].wrapper(*args, **kwm))
        for name, pl in epilogue_plans(res, args[0].dtype == torch.bfloat16).items():
            got = with_epilogue_plan(pl, lambda: K["B5"].wrapper(*args, **kwm))
            torch.cuda.synchronize()
            check(all(torch.equal(a, b) for a, b in zip(flat(got), flat(cell), strict=True)),
                  f"B5 {what} emit_mac={emit_mac} under the {name} plan {tuple(pl)} differs "
                  "from the cell plan")
            held[f"{name} emit_mac={emit_mac}"] = list(pl)
        r = (rows or (lambda *a: run_and_compare(*a)[1]))(K, "B5", args, kwm,
                                                          f"B5 {what} emit_mac={emit_mac}")
        out.update({f"{k} emit_mac={emit_mac}": v for k, v in r.items()})
    return out, held


#: the grids at which phases 3 and 7 hold B5's plans to the cell plan: the
#: native Rosensweig slab and grid, two_droplets' grid (which no tile
#: divides) and Z = 4
B5_GRIDS = ((34, 66, 130), (130, 66, 130), (50, 50, 193), (4, 66, 130))


def run_and_compare(K, kid, args, kw, what):
    """Call kernel ``kid`` and its plain version on the same inputs."""
    import torch

    got = K[kid].wrapper(*args, **kw)
    want = K[kid].plain(*args, **kw)
    torch.cuda.synchronize()
    return got, compare(what, OUTPUTS[kid][:len(flat(got))], got, want)


def capillary_seam_block(flags):
    """``flags`` with an obstacle block across B6's first tile edge in x
    and in y and its first z strip seam, under the plan it takes on this
    grid (where the grid has them)."""
    from lbm_ferrofluid_tpu_torch.ops.kernels import capmac

    import torch

    Z, Y, X = flags.shape[2:]
    pl = capmac.plan(Z, Y, X, torch.cuda.get_device_properties(0).multi_processor_count)
    out = flags.clone()
    out[..., max(pl.zb - 1, 1):pl.zb + 1, pl.ty - 1:pl.ty + 1, pl.tx - 1:pl.tx + 1] = 2
    return out


def hcz_seeded_inputs(res, seed, dev):
    """HCZ inputs on the card from a numpy seed: the ``multiphase_3d``
    scene's macros with small perturbations, an interior obstacle block and
    one across B6's first tile edge and z strip seam, f = feq and g = geq
    with 0.1 % noise per channel, and an H2 for B6's Kelvin variant."""
    import torch

    from lbm_ferrofluid_tpu_torch.models import multiphase_3d
    from lbm_ferrofluid_tpu_torch.ops.equilibrium import feq, geq
    from lbm_ferrofluid_tpu_torch.ops.moments import eos_pressure, rho_to_density

    params, st = multiphase_3d(res=res, device=dev)
    rng = np.random.default_rng(seed)
    Z, Y, X = res

    def t(a):
        return torch.as_tensor(np.asarray(a, np.float32), device=dev)

    flags = capillary_seam_block(st.flags)
    flags[..., Z // 2, Y // 2, 2:4] = 2  # an interior obstacle block
    fluid = (flags != 2).float()
    rho = st.rho + t(1e-3 * rng.uniform(-1, 1, (1, 1, *res)))
    den = rho_to_density(rho, rho_gas=params.rho_gas, rho_fluid=params.rho_fluid,
                         density_gas=params.density_gas, density_fluid=params.density_fluid)
    vel = t(0.01 * rng.uniform(-1, 1, (1, 3, *res))) * fluid
    pres = eos_pressure(den)
    f_eq = feq(params.lattice, den, vel)
    return params, dict(
        flags=flags, rho_old=rho, vel_old=vel, pres=pres,
        f=f_eq * (1 + t(1e-3 * rng.standard_normal((1, 19, *res)))),
        g=geq(params.lattice, rho, den, pres, f_eq) * (
            1 + t(1e-3 * rng.standard_normal((1, 19, *res)))),
        H2=1e4 * (1 + t(0.1 * rng.uniform(-1, 1, (1, 1, *res)))),
    )


def hcz_chain(K, params, d, record):
    """The HCZ step's kernels in its order, each fed with what the kernels
    before it produced: B8b on f, B8a on g, B2, B6 (and B6 with H2 and phi
    from the streamed density), B9.  ``record(label, kid, args, kw)`` runs
    one call and returns the kernel's output."""
    from lbm_ferrofluid_tpu_torch.ops.moments import phi_from_density, rho_to_density

    gas = dict(rho_gas=params.rho_gas, rho_fluid=params.rho_fluid,
               density_gas=params.density_gas, density_fluid=params.density_fluid)
    fl = d["flags"]
    f_post, rho, vel, den = record("B8b", "B8b", (d["f"], fl, d["rho_old"], d["vel_old"]),
                                   dict(c=params.dx / params.dt, **gas))
    g_post, m0g, m1g = record("B8a", "B8a", (d["g"], fl), {})
    rho_ca = record("B2", "B2", (rho, fl, params.contact_angle), {})
    cap_kw = dict(kappa=params.kappa, dx=params.dx, dt=params.dt,
                  gravity=tuple(float(v) for v in params.gravity_vec().reshape(-1)), **gas)
    vel2, pres, force, dfai, dprho = record(
        "B6", "B6", (rho, den, d["pres"], rho_ca, None, None, fl, m0g, m1g, vel), cap_kw)
    phi = phi_from_density(den, params.density_gas, params.density_fluid)
    kelvin = record("B6 with H2", "B6",
                    (rho, den, d["pres"], rho_ca, d["H2"], phi, fl, m0g, m1g, vel), cap_kw)
    record("B9", "B9", (f_post, g_post, rho_ca, vel2, rho_to_density(rho_ca, **gas), pres, fl,
                        force, dfai, dprho),
           dict(tau_f=params.tau_f, tau_g=params.tau_g, dx=params.dx, dt=params.dt))
    return dict(g_post=g_post, rho=rho, vel=vel, den=den, rho_ca=rho_ca, phi=phi,
                b6=(vel2, pres, force, dfai, dprho), b6_kelvin=kelvin)


def stencil_route_rows(params, d, ctx, what):
    """The capillary stage's stencil route (B10b + B10a, moments from the
    post-stream g), without and with H2/phi, on the HCZ chain's
    intermediates ``ctx``: against its plain version (``hcz_capillary`` on
    the card) and against B6's kernel outputs (the fused route)."""
    import torch

    from lbm_ferrofluid_tpu_torch.ops.collide import hcz_capillary
    from lbm_ferrofluid_tpu_torch.ops.kernels import hcz_capillary_stencils

    gas = dict(rho_gas=params.rho_gas, rho_fluid=params.rho_fluid,
               density_gas=params.density_gas, density_fluid=params.density_fluid)
    kw = dict(kappa=params.kappa, dx=params.dx, dt=params.dt, g=ctx["g_post"], **gas,
              gravity=torch.tensor(params.gravity_vec(), dtype=torch.float32,
                                   device=ctx["rho"].device).reshape(1, 3, 1, 1, 1))
    names = ["vel", "pressure", "force", "dfai", "dprho"]
    rows = {}
    for label, H2, phi, b6 in (("without H2", None, None, ctx["b6"]),
                               ("with H2", d["H2"], ctx["phi"], ctx["b6_kelvin"])):
        args = (ctx["rho"], ctx["vel"], d["flags"], ctx["den"], d["pres"], ctx["rho_ca"], H2,
                phi)
        got = hcz_capillary_stencils(*args, **kw)
        want = hcz_capillary(*args, **kw)
        torch.cuda.synchronize()
        got = got[1:2] + got[3:]
        rows[label] = {
            "against_plain": compare(f"stencil route {label} {what}", names, got,
                                     want[1:2] + want[3:]),
            "against_B6": compare(f"stencil route {label} vs B6 {what}", names, got, b6),
        }
    return rows


def static_field(params):
    """The ferrofluid step's static external field (x, y, z)."""
    return tuple(params.mag_strength if a == params.h_ext_axis else 0.0 for a in range(3))


def emit_kw(params, emit, tau, n_iters):
    """Keywords of a B11b call whose last pass's trailing stage (B7's)
    emits ``emit`` ("hint" or "h2", the scene's static field)."""
    return dict(tau=tau, n_iters=n_iters, emit=emit, dx=params.dx,
                h_ext=static_field(params) if emit == "h2" else None)


def trail_seam_block(mflags, sms, n_iters):
    """``mflags`` with magnetic obstacles straddling the trailing pass's
    first tile edge in x and y and its first z seam, and on the grid's last
    row and column beside a tile edge (the output ring whose source lies in
    the tile before), under the plans B11b takes for ``n_iters`` sweeps."""
    from lbm_ferrofluid_tpu_torch.ops.kernels import poisson as pp

    Z, Y, X = mflags.shape[2:]
    tp = pp.trail_pass(Z, Y, X, pp.plan(Z, Y, X, n_iters, sms).passes[-1], sms)
    tx = pp.tile_width(tp.k + 1)
    out = mflags.clone()
    out[..., tp.lz - 1:tp.lz + 1, tp.ty - 1:tp.ty + 1, tx - 1:tx + 1] = 2
    out[..., Z // 2, Y - 1, tx - 1:tx + 1] = 2
    out[..., Z // 2, tp.ty - 1:tp.ty + 1, X - 1] = 2
    return out


def b11b_emit_checks(K, params, h, mflags, rhs, sms, what):
    """B11b with the trailing stage (hint and h2) at tau 1 and 0.8 and at
    30 and 7 sweeps (a remainder pass ends the call), with the seam blocks
    of its passes and of the trailing pass: bit for bit to its plain
    version, and its chosen plan bit for bit to the one-sweep plan.  Rows
    with max_abs_err 0 (the check fails otherwise)."""
    import torch

    mfl = trail_seam_block(poisson_seam_block(mflags, sms, params.poisson_iters), sms,
                           params.poisson_iters)
    rows = []
    for emit in ("hint", "h2"):
        for tau in (1.0, 0.8):
            for n in (params.poisson_iters, 7):
                args, kw = (h, mfl, rhs), emit_kw(params, emit, tau, n)
                got = K["B11b"].wrapper(*args, **kw)
                want = K["B11b"].plain(*args, **kw)
                torch.cuda.synchronize()
                check(all(torch.equal(a, b) for a, b in zip(got, want)),
                      f"B11b emit={emit} tau={tau} n_iters={n} {what}: differs from its plain "
                      f"version by {float((got[1] - want[1]).abs().max()):.3e}")
                rows.append({"kernel": f"B11b emit={emit}", "tau": tau, "n_iters": n,
                             "storage": str(h.dtype), "max_abs_err": 0.0,
                             "against_one_sweep_plan": b11b_plan_against_one_sweep(args, kw,
                                                                                   sms)})
    return rows


def psi_band_checks(dev, card):
    """``lbm_psi_ghost_band`` (ROADMAP B-8; ``ops/kernels/psi_halo.py``) at
    the bands of phase ``mesh3d``'s B = 2 slab run (130x66x130 on 2 z
    ranks: slabs of 65 planes, G = 3, and G_f = 4 in the h2 round), on the
    shell's magnetic obstacles: B11b's kernel sweeps a slab at tau 1 and
    both bands of both depths, packed from its h' and psi, are rebuilt by
    the kernel, bit for bit to its plain version on the same inputs and to
    the planes B11b stored, in float32 and bfloat16; ms a launch (G = 3,
    the lo band; CUDA events around the launch), ms a wrapper call back to
    back, the plain version's and the bound.  Returns the float32 row
    of the ``kernels`` line without ``launches``."""
    import torch

    from lbm_ferrofluid_tpu_torch.ops.kernels import poisson, psi_halo

    Zl, Y, X = 65, 66, 130
    rng = np.random.default_rng(43)
    mf = np.full((1, 1, Zl, Y, X), 1, np.uint8)
    mf[..., 0] = mf[..., X - 1] = mf[:, :, 0] = 2  # x-edge columns, a z-edge plane
    mf = torch.from_numpy(mf).to(dev)
    rhs = torch.from_numpy(rng.uniform(-1e-2, 1e-2, (1, 1, Zl, Y, X)).astype(np.float32))
    rhs = (rhs.to(dev) * (mf == 1))
    h0 = torch.from_numpy(rng.uniform(-0.1, 0.1, (1, 19, Zl, Y, X)).astype(np.float32)).to(dev)
    rows, timed, worst = [], {}, {}
    for dtype in (torch.float32, torch.bfloat16):
        h, psi = poisson.poisson_sweeps(h0.to(dtype), mf, rhs, tau=1.0, n_iters=3)
        for G in (3, 4):
            for band, planes, outer in (("lo", slice(Zl - G, Zl), slice(Zl - G, Zl - 1)),
                                        ("hi", slice(0, G), slice(1, G))):
                packed = psi_halo.pack(h, psi, G, band)
                r = rhs[:, :, outer].contiguous()
                kw = dict(band=band, G=G, Y=Y, X=X, dtype=dtype)
                got = psi_halo.psi_ghost_band(packed, r, **kw)
                torch.cuda.synchronize()
                plain = psi_halo.psi_ghost_band_plain(packed, r, **kw)
                stored = h[:, :, planes]
                same = (torch.equal(got, plain), torch.equal(got, stored))
                err = float((got.double() - plain.double()).abs().max())
                worst[dtype] = max(worst.get(dtype, 0.0), err)
                rows.append({"storage": str(dtype), "G": G, "band": band, "max_abs_err": err,
                             "bit_for_bit_to_plain": same[0],
                             "bit_for_bit_to_stored_planes": same[1]})
                check(all(same), f"lbm_psi_ghost_band {dtype} G={G} {band}: plain, stored "
                                 f"planes equal: {same}")
                if G == 3 and band == "lo":
                    moved, flops = psi_halo.cost(packed, r, **kw)
                    t_bytes = moved / HBM_BYTES_PER_S * 1e3
                    t_ops = flops / F32_FLOPS_PER_S * 1e3
                    def call():
                        return psi_halo.psi_ghost_band(packed, r, **kw)

                    timed[dtype] = {
                        # the launch alone (events around it), and the
                        # wrapper's calls back to back, which the host's
                        # Python bounds
                        "ms": launch_split([psi_halo], call, 50)["lbm_psi_ghost_band"][
                            "ms_per_call"],
                        "ms_wrapper_calls": time_cuda(call, 50),
                        "plain_ms": time_cuda(lambda: psi_halo.psi_ghost_band_plain(
                            packed, r, **kw), 10),
                        "bound_ms": max(t_bytes, t_ops),
                        "bound_by": "bytes" if t_bytes >= t_ops else "operations",
                        "bytes": moved, "flops": flops}
    emit({"phase": "psi_band", "checks": rows,
          "timed": {str(k): v for k, v in timed.items()}, "card": card, "ok": True})
    row = timed[torch.float32]
    return {"name": "psi_band lbm_psi_ghost_band", "route": "cuda",
            "source": psi_halo.CUDA_SOURCE, "replaces": psi_halo.TPU_KERNEL,
            "max_abs_err": worst[torch.float32],
            **{k: row[k] for k in ("ms", "plain_ms", "bound_ms", "bound_by")},
            "library_ms": None, "bf16": dict(max_abs_err=worst[torch.bfloat16], **{
                k: timed[torch.bfloat16][k] for k in ("ms", "plain_ms", "bound_ms", "bound_by")}),
            "what": "the psi-refreshed ghost band of the meshed channel-form solve (jnp glue "
                    "in the JAX package), at G = 3 planes of 66x130; launches: phase mesh3d's "
                    "B = 2 slab run and phase sharded's C1 job"}


def phase_kernels(dev, K):
    import torch

    from lbm_ferrofluid_tpu_torch.ops.stencils import substitute_obstacles

    worst = {kid: 0.0 for kid in K}
    rows = []

    def log(kid, label, res, r, **extra):
        err = max(v["max_abs_err"] for v in r.values())
        worst[kid] = max(worst[kid], err)
        rows.append({"kernel": label, "res": list(res), **extra,
                     "max_rel": max(v["rel"] for v in r.values()), "max_abs_err": err})

    sms = torch.cuda.get_device_properties(0).multi_processor_count

    def stencil_checks(one, four, res):
        """B10a on N = 1 (``one``), 3 and 4 (``four``) and 5 fields (both),
        B10b on ``one`` and on the first of ``four``: against their plain
        versions."""
        for fields in (one, four[:, :3].contiguous(), four, torch.cat([four, one], dim=1)):
            n = fields.shape[1]
            before = K["B10a"].wrapper.launches
            _, r = run_and_compare(K, "B10a", (fields,), dict(dx=1.0), f"B10a N={n} at {res}")
            launches = K["B10a"].wrapper.launches - before
            check(launches == K["B10a"].module.launches_per_call(n),
                  f"B10a N={n} at {res}: {launches} launches")
            log("B10a", "B10a", res, r, n_fields=n, launches=launches)
        for field in (one, four[:, :1].contiguous()):
            _, r = run_and_compare(K, "B10b", (field,), dict(dx=1.0), f"B10b at {res}")
            log("B10b", "B10b", res, r)

    def b11b_checks(params, d, res):
        """B11b at tau 1 and 0.8 and at 30 sweeps and 7 (a remainder pass),
        with interior magnetic obstacles and a block across a tile edge and
        a z seam: against its plain version, and its chosen plan against
        the one-sweep plan bit for bit.  Returns psi at tau 0.8, 30 sweeps."""
        mfl = poisson_seam_block(d["mflags_block"], sms, params.poisson_iters)
        psi = None
        for tau in (1.0, 0.8):
            for n in (params.poisson_iters, 7):
                args, kw = (d["h"], mfl, d["rhs"]), dict(tau=tau, n_iters=n)
                (_, psi_n), r = run_and_compare(K, "B11b", args, kw,
                                                f"B11b tau={tau} n_iters={n} at {res}")
                log("B11b", "B11b", res, r, tau=tau, n_iters=n,
                    against_one_sweep_plan=b11b_plan_against_one_sweep(args, kw, sms))
                if n == params.poisson_iters:
                    psi = psi_n
        for row in b11b_emit_checks(K, params, d["h"], d["mflags_block"], d["rhs"], sms,
                                    f"at {res}"):
            rows.append(dict(row, res=list(res)))
        return psi

    for res, seed in (((34, 66, 130), 1), ((130, 66, 130), 2)):
        params, d = seeded_inputs(res, seed, dev)
        d["rho_ca"] = K["B2"].wrapper(d["rho_pre"], d["flags"], params.contact_angle)
        # B1 also at 7 sweeps, which the plan's k does not divide (a
        # remainder pass)
        checks = [("B4", params), ("B1", params), ("B1", params.replace(poisson_iters=7)),
                  ("B2", params), ("B2", params.replace(contact_angle=0.35 * math.pi)),
                  ("B3", params), ("B3", params.replace(tau=0.8))]
        for kid, p in checks:
            args, kw = kernel_calls(p, d)[kid]
            got, r = run_and_compare(K, kid, args, kw,
                                     f"{kid} tau={p.tau} n_iters={p.poisson_iters} at {res}")
            extra = b2_cells_differing(got, K[kid].plain(*args, **kw)) if kid == "B2" else {}
            log(kid, kid, res, r, contact_angle=p.contact_angle, tau=p.tau,
                n_iters=p.poisson_iters, **extra)
        psi = substitute_obstacles(b11b_checks(params, d, res), d["mflags_block"])
        stencil_checks(psi, d["fields4"], res)
        if res == (130, 66, 130):
            b10a_batch = b10a_batch_row(K, psi, f"B10a batch form at {res}")
            rows.append({"kernel": "B10a batch form", "res": list(res), **b10a_batch})
        for emit_mac in (False, True):
            args, kw = epilogue_call(K, params, d, emit_mac)
            _, r = run_and_compare(K, "B5", args, kw, f"B5 emit_mac={emit_mac} at {res}")
            log("B5", "B5", res, r, emit_mac=emit_mac)
            _, r = run_and_compare(K, "B10b", (args[5],), dict(dx=params.dx),
                                   f"B10b on density at {res}")
            log("B10b", "B10b", res, r, field="density(rho_ca)")
    # two_droplets' grid, which no tile divides
    params, d = seeded_inputs((50, 50, 193), 6, dev)
    b11b_checks(params, d, (50, 50, 193))
    stencil_checks(d["s2"][:, :1].contiguous(), d["fields4"], (50, 50, 193))
    del d
    # Z = 4: the z clamp at both ends of every strip
    rng = np.random.default_rng(9)
    f4 = torch.as_tensor(rng.standard_normal((1, 5, 4, 66, 130)).astype(np.float32),
                         device=dev)
    stencil_checks(f4[:, 4:].contiguous(), f4[:, :4].contiguous(), (4, 66, 130))
    del f4
    for res, seed in (((34, 66, 130), 3), ((130, 130, 130), 4), ((50, 50, 193), 7)):
        params, d = hcz_seeded_inputs(res, seed, dev)

        def record(label, kid, args, kw):
            got, r = run_and_compare(K, kid, args, kw, f"{label} at {res}")
            extra = b2_cells_differing(got, K[kid].plain(*args, **kw)) if kid == "B2" else {}
            log(kid, label, res, r, contact_angle=params.contact_angle, **extra)
            return got

        ctx = hcz_chain(K, params, d, record)
        for label, r in stencil_route_rows(params, d, ctx, f"at {res}").items():
            for against, rr in r.items():
                log("B10b", f"stencil route {label} {against}", res, rr)
    # B5's plans against the cell plan, bit for bit, and against plain
    for seed, res in enumerate(B5_GRIDS, 11):
        args, kw = b5_hcz_inputs(K, res, seed, dev, bf16=False)
        r, held = b5_plan_rows(K, args, kw, f"at {res}")
        log("B5", "B5 plans against the cell plan", res, r, plans=held)
        del args
    emit({"phase": "kernels", "bar_rel": BAR_REL, "bar_vel_abs": BAR_VEL_ABS,
          "checks": rows, "ok": True})
    return worst, b10a_batch


def b10a_batch_row(K, one, what, batch=2):
    """B10a's batch form on ``one`` ([1, N, ...]) and ``batch - 1`` more
    elements moved by seeded noise: one call of the batch bit for bit to
    its elements' B = 1 calls, against its plain version (phase 3's bars;
    whether it is bit for bit too), its launches (``launches_batch``, one a
    chunk of the B * N fields), ms beside the B = 1 calls one after another
    (``sequential_ms``) and the plain version, its bound at B (``cost``
    counts every element)."""
    import torch

    k = K["B10a"]
    gen = torch.Generator(device=one.device).manual_seed(41)
    noise = torch.rand((batch, *one.shape[1:]), generator=gen, device=one.device) * 2 - 1
    noise[0] = 0
    x = (one * (1 + 1e-3 * noise)).contiguous()
    n0, b0 = k.wrapper.launches, k.wrapper.launches_batch
    got = k.wrapper(x, dx=1.0)
    launches, batched = k.wrapper.launches - n0, k.wrapper.launches_batch - b0
    want = k.module.launches_per_call(batch * one.shape[1])
    check(launches == batched == want, f"{what}: {launches} launches ({batched} counted as a "
                                       f"batch's), {want} expected")
    for b in range(batch):
        alone = k.wrapper(x[b:b + 1], dx=1.0)
        torch.cuda.synchronize()
        check(torch.equal(got[b:b + 1], alone),
              f"{what}: element {b} differs from its B = 1 call by "
              f"{float((got[b:b + 1].double() - alone.double()).abs().max()):.3e}")
    plain_bits = bool(torch.equal(got, k.plain(x, dx=1.0)))
    row = measure(K, "B10a", (x,), dict(dx=1.0), want, want, what)
    row.update(batch=batch, n_fields=int(one.shape[1]), launches=launches,
               bit_for_bit_to_b1_calls=True, bit_for_bit_to_plain=plain_bits,
               sequential_ms=time_cuda(lambda: [k.wrapper(x[b:b + 1], dx=1.0)
                                                for b in range(batch)], reps=10))
    return row


def _golden_rows(what, pairs):
    rows = {}
    for name, got, want in pairs:
        got = got.double().cpu().numpy()
        want = np.asarray(want.cpu() if hasattr(want, "cpu") else want, np.float64)
        err = float(np.abs(got - want).max())
        scale = float(np.abs(want).max())
        rows[name] = {"max_abs_err": err, "scale": scale}
        check(err <= 2e-5 + 2e-4 * scale, f"{what} {name}: {err:.3e} at scale {scale:.3e}")
    return rows


def phase_golden(dev):
    import torch

    from lbm_ferrofluid_tpu_torch.models import (
        SimulationParams, ferrofluid_step, hcz_step, init_ferrofluid_state, init_hcz_state,
        prime_premac,
    )
    from lbm_ferrofluid_tpu_torch.ops.scalar_poisson import compare_views

    gas = dict(density_gas=0.02381, density_fluid=0.2508, rho_gas=0.02381,
               rho_fluid=0.2508)
    d = np.load(ROOT / "tests" / "golden" / "ferro3d.npz")
    res = d["rho0"].shape[2:]
    # tests/test_parity.py:test_ferro3d_parity's configuration
    params = SimulationParams(
        dim=3, kappa=0.01, tau_f=0.68, tau_g=0.68, gravity=1e-4,
        contact_angle=0.5 * math.pi, mag_strength=85.0, poisson_iters=30, **gas,
    )
    mflags = np.full((1, 1, *res), 2, np.uint8)
    mflags[..., 1:-1, :, 1:-1] = 1
    # the capillogue steady state with the scalar tau == 1 carry (B1) and
    # with the channel-form solve (B11b, B10a), then the un-carried step
    # (no priming: B4, B11b, B10a, B2, B6, B5)
    for route, p, prime in (("scalar carry", params, True),
                            ("channel form", params.replace(scalar_carry=False), True),
                            ("un-carried", params, False)):
        st = init_ferrofluid_state(p, d["rho0"], d["den0"],
                                   np.zeros((1, 3, *res), np.float32), d["flags"], mflags,
                                   device=dev)
        if prime:
            st = prime_premac(p, st, device=dev)
        for _ in range(8):
            st = ferrofluid_step(p, st, device=dev)
        check((st.premac is None) != prime, f"golden ferro3d {route}: premac {st.premac}")
        if st.h.shape[1] == 2:
            a, b = compare_views(st.h, torch.as_tensor(d["h"], device=dev), st.magnetic_flags)
        else:
            a, b = st.h, d["h"]
        rows = _golden_rows(f"golden ferro3d {route}", (
            ("h", a, b), ("f", st.f, d["f"]), ("g", st.g, d["g"]), ("vel", st.vel, d["vel"]),
            ("density", st.density, d["den"])))
        emit({"phase": "golden", "file": "tests/golden/ferro3d.npz", "steps": 8,
              "route": route, "h_channels": st.h.shape[1], "fields": rows, "ok": True})

    d = np.load(ROOT / "tests" / "golden" / "hcz3d.npz")
    res = d["rho0"].shape[2:]
    # tests/test_parity.py:test_hcz3d_parity's configuration
    params = SimulationParams(dim=3, kappa=0.01, tau_f=0.68, tau_g=0.68, gravity=1e-4,
                              contact_angle=0.5 * math.pi, **gas)
    st = init_hcz_state(params, d["rho0"], d["den0"], np.zeros((1, 3, *res), np.float32),
                        d["flags"], device=dev)
    for _ in range(10):
        st = hcz_step(params, st, device=dev)
    rows = _golden_rows("golden hcz3d", (
        ("f", st.f, d["f"]), ("g", st.g, d["g"]), ("vel", st.vel, d["vel"]),
        ("density", st.density, d["den"])))
    emit({"phase": "golden", "file": "tests/golden/hcz3d.npz", "steps": 10,
          "fields": rows, "ok": True})


def kernel_vs_plain(params, s0, step, dev, n_steps, what, fields, prepare=None):
    """``n_steps`` kernel steps against ``n_steps`` plain steps on the card,
    from ``prepare(s0, plain)`` (``s0`` itself without ``prepare``); returns
    the kernel state and the per-field errors (phase 3's bars), the carried
    premac's leaves included."""
    sk = prepare(s0, False) if prepare else s0
    sp = prepare(s0, True) if prepare else s0
    for _ in range(n_steps):
        sk = step(params, sk, device=dev)
    for _ in range(n_steps):
        sp = step(params, sp, device=dev, plain=True)
    premac = list(getattr(sk, "premac", None) or ())
    names = list(fields) + OUTPUTS["B3"][5:5 + len(premac)]
    rows = compare(what, names, [getattr(sk, n) for n in fields] + premac,
                   [getattr(sp, n) for n in fields] + list(getattr(sp, "premac", None) or ()))
    return sk, rows


def primed(params, dev):
    """``prepare`` for :func:`kernel_vs_plain`: the capillogue steady state."""
    from lbm_ferrofluid_tpu_torch.models import prime_premac

    return lambda s, plain: prime_premac(params, s, device=dev, plain=plain)


def epilogue_state(params, dev):
    """``prepare`` for :func:`kernel_vs_plain`: the epilogue steady state
    (5-leaf premac), built as the JAX package's prime builds it where its
    capillogue does not fit: the prologue's macros and the scalar carry,
    with phi, force and H_ext kept."""
    from lbm_ferrofluid_tpu_torch.models import prime_premac

    def prepare(s, plain):
        p = prime_premac(params, s, device=dev, plain=plain)
        return s.replace(h=p.h, cmask=p.cmask, premac=p.premac[:5])
    return prepare


def fluid_mass(state) -> float:
    return float(state.rho.double()[state.flags == 1].sum())


FERRO_FIELDS = ("f", "g", "h", "rho", "vel", "density", "pressure")
HCZ_FIELDS = ("f", "g", "rho", "vel", "density", "pressure", "force")


def phase_main(dev, kernels_pkg, card):
    """The Rosensweig path: counters zeroed just before, read just after."""
    from lbm_ferrofluid_tpu_torch.models import SimulationRunner, ferrofluid_step, rosensweig_3d
    from lbm_ferrofluid_tpu_torch.models.runner import assert_finite

    ids = kernels_pkg.PATHS["ferrofluid"]
    params, s0 = rosensweig_3d(device=dev)
    runner = SimulationRunner(params, ferrofluid_step, device=dev)
    kernels_pkg.reset_launch_counts()
    sk, rows = kernel_vs_plain(params, s0, ferrofluid_step, dev, 30, "main path",
                               FERRO_FIELDS, primed(params, dev))
    mass0, mass30 = fluid_mass(s0), fluid_mass(sk)
    sk, stats = runner.benchmark(sk, n_steps=200, warmup=0)
    assert_finite(sk, fields=vars(sk))
    mass230 = fluid_mass(sk)
    launches = kernels_pkg.launch_counts(ids)
    check(all(v > 0 for v in launches.values()), f"a kernel never launched: {launches}")
    # the priming runs B4 once; each step B1's passes and H2, B2, B3
    K = kernels_pkg.KERNELS
    check_launches("main path", launches, {
        "B1": K["B1"].module.launches_per_call(params.poisson_iters, sk.rho.shape),
        "B2": K["B2"].module.N_LAUNCHES, "B3": K["B3"].module.N_LAUNCHES}, sk.step,
        extra={"B4": 1})
    emit({"phase": "main_path", "scene": "rosensweig_3d", "res": list(sk.rho.shape[2:]),
          "steps": sk.step, "kernel_vs_plain_after_30_steps": rows, "finite": True,
          "sum_rho_fluid": {"step0": mass0, "step30": mass30, "step230": mass230,
                            "drift_30_to_230": (mass230 - mass30) / mass30},
          "mlups": stats["mlups"], "seconds_200_steps": stats["seconds"], "card": card,
          "launches": launches, "ok": True})
    return launches


def phase_hcz_main(dev, kernels_pkg, card):
    """The HCZ path (``multiphase_3d`` then ``droplet_spread_3d`` at 130^3):
    counters zeroed just before, read just after."""
    from lbm_ferrofluid_tpu_torch.models import (
        SimulationRunner, droplet_spread_3d, hcz_step, multiphase_3d,
    )
    from lbm_ferrofluid_tpu_torch.models.runner import assert_finite

    ids = kernels_pkg.PATHS["hcz"]
    params, s0 = multiphase_3d(device=dev)
    runner = SimulationRunner(params, hcz_step, device=dev)
    kernels_pkg.reset_launch_counts()
    sk, rows = kernel_vs_plain(params, s0, hcz_step, dev, 30, "hcz main path", HCZ_FIELDS)
    mass0, mass30 = fluid_mass(s0), fluid_mass(sk)
    sk, stats = runner.benchmark(sk, n_steps=200, warmup=0)
    assert_finite(sk, fields=vars(sk))
    mass230 = fluid_mass(sk)
    res, steps = list(sk.rho.shape[2:]), sk.step
    del sk, s0
    params2, s2 = droplet_spread_3d(device=dev)
    sk2, rows2 = kernel_vs_plain(params2, s2, hcz_step, dev, 30, "droplet spread",
                                 HCZ_FIELDS)
    assert_finite(sk2, fields=vars(sk2))
    launches = kernels_pkg.launch_counts()
    K = kernels_pkg.KERNELS
    check_launches("hcz main path", launches, {
        "B8b": 1, "B8a": 1, "B2": K["B2"].module.N_LAUNCHES, "B6": K["B6"].module.N_LAUNCHES,
        "B9": 1}, steps + sk2.step)
    launches = {kid: launches[kid] for kid in ids}
    emit({"phase": "hcz_main_path", "scene": "multiphase_3d", "res": res,
          "kernel_vs_plain_after_30_steps": rows, "finite": True,
          "sum_rho_fluid": {"step0": mass0, "step30": mass30, "step230": mass230,
                            "drift_30_to_230": (mass230 - mass30) / mass30},
          "mlups": stats["mlups"], "seconds_200_steps": stats["seconds"],
          "droplet_spread_3d_kernel_vs_plain_after_30_steps": rows2, "card": card,
          "launches": launches, "ok": True})
    return launches


def phase_two_droplets(dev, kernels_pkg, card):
    """``two_droplets_3d`` at its native 50x50x193 on the ferrofluid path
    (magnetic walls on all six faces): counters zeroed just before, read
    just after."""
    from lbm_ferrofluid_tpu_torch.models import ferrofluid_step, two_droplets_3d
    from lbm_ferrofluid_tpu_torch.models.runner import assert_finite

    ids = kernels_pkg.PATHS["ferrofluid"]
    params, s0 = two_droplets_3d(device=dev)
    kernels_pkg.reset_launch_counts()
    sk, rows = kernel_vs_plain(params, s0, ferrofluid_step, dev, 30, "two droplets",
                               FERRO_FIELDS, primed(params, dev))
    assert_finite(sk, fields=vars(sk))
    launches = kernels_pkg.launch_counts()
    K = kernels_pkg.KERNELS
    check_launches("two droplets", launches, {
        "B1": K["B1"].module.launches_per_call(params.poisson_iters, sk.rho.shape),
        "B2": K["B2"].module.N_LAUNCHES, "B3": K["B3"].module.N_LAUNCHES}, sk.step,
        extra={"B4": 1})
    launches = {kid: launches[kid] for kid in ids}
    emit({"phase": "two_droplets", "scene": "two_droplets_3d", "res": list(sk.rho.shape[2:]),
          "kernel_vs_plain_after_30_steps": rows, "finite": True, "card": card,
          "launches": launches, "ok": True})
    return launches


def phase_channel_main(dev, kernels_pkg, card):
    """The channel-form Rosensweig path at 130x66x130: ``scalar_carry=False``
    at tau = 1, then tau = 0.8; counters zeroed just before each, read just
    after.  The first is also held against the scalar carry (B1)."""
    from lbm_ferrofluid_tpu_torch.models import SimulationRunner, ferrofluid_step, rosensweig_3d
    from lbm_ferrofluid_tpu_torch.models.runner import assert_finite
    from lbm_ferrofluid_tpu_torch.ops.scalar_poisson import compare_views

    ids = kernels_pkg.PATHS["ferrofluid_channel"]
    params, s0 = rosensweig_3d(device=dev)
    ss = SimulationRunner(params, ferrofluid_step, device=dev).run(s0, 30)
    out = {"phase": "channel_main_path", "scene": "rosensweig_3d", "res": list(s0.rho.shape[2:]),
           "card": card}
    total = {kid: 0 for kid in ids}
    total["B11b emit"] = 0
    for label, p, n_timed in (("scalar_carry=False", params.replace(scalar_carry=False), 200),
                              ("tau=0.8", params.replace(tau=0.8), 0)):
        runner = SimulationRunner(p, ferrofluid_step, device=dev)
        kernels_pkg.reset_launch_counts()
        sk, rows = kernel_vs_plain(p, s0, ferrofluid_step, dev, 30, f"channel {label}",
                                   FERRO_FIELDS, primed(p, dev))
        check(sk.h.shape[1] == 19 and sk.cmask is None, f"{label}: not the channel form")
        row = {"kernel_vs_plain_after_30_steps": rows}
        if n_timed:
            a, b = compare_views(ss.h, sk.h, sk.magnetic_flags)
            row["against_scalar_carry_after_30_steps"] = compare(
                f"channel {label} vs scalar carry", ["f", "g", "h", "rho", "vel", "density",
                                                     "pressure"],
                [sk.f, sk.g, b, sk.rho, sk.vel, sk.density, sk.pressure],
                [ss.f, ss.g, a, ss.rho, ss.vel, ss.density, ss.pressure])
            mass30 = fluid_mass(sk)
            sk, stats = runner.benchmark(sk, n_steps=n_timed, warmup=0)
            mass230 = fluid_mass(sk)
            row.update(mlups=stats["mlups"], seconds_200_steps=stats["seconds"],
                       sum_rho_fluid={"step30": mass30, "step230": mass230,
                                      "drift_30_to_230": (mass230 - mass30) / mass30})
        assert_finite(sk, fields=vars(sk))
        launches = kernels_pkg.launch_counts()
        steps = sk.step
        K = kernels_pkg.KERNELS
        per_step = {"B11b": K["B11b"].module.launches_per_call(p.poisson_iters, sk.h.shape),
                    "B2": K["B2"].module.N_LAUNCHES, "B3": K["B3"].module.N_LAUNCHES}
        check_launches(f"channel {label}", launches, per_step, steps, extra={"B4": 1})
        total["B11b emit"] += check_emit_launches(f"channel {label}", kernels_pkg, steps)
        for kid in ids:
            total[kid] += launches[kid]
        out[label] = dict(row, steps=steps, launches={kid: launches[kid] for kid in ids},
                          launches_a_step=sum(per_step.values()))
    emit(dict(out, finite=True, ok=True))
    return total


def check_launches(label, launches, per_step, steps, extra=None):
    """Exact launch counts of a path: ``per_step`` launches a step of each
    kernel it names (plus ``extra``), none of any other kernel."""
    want = {kid: per_step.get(kid, 0) * steps + (extra or {}).get(kid, 0) for kid in launches}
    check(launches == want, f"{label}: launches {launches}, expected {want}")


def check_emit_launches(label, kernels_pkg, steps):
    """B11b's launches with the trailing stage (``launches_emit``) on a
    channel-form path: one a step, the solve's last pass (on a slab its
    last round); returns them."""
    n = kernels_pkg.launch_counts(["B11b"], form=True)["B11b"]
    check(n == steps, f"{label}: {n} launches of B11b's trailing stage in {steps} steps")
    return n


def phase_uncarried_main(dev, kernels_pkg, card):
    """The un-carried step at 130x66x130: the Rosensweig state stepped as it
    is, never primed (channel-form h), 30 kernel steps against 30 plain
    steps; counters zeroed just before, read just after."""
    from lbm_ferrofluid_tpu_torch.models import ferrofluid_step, rosensweig_3d
    from lbm_ferrofluid_tpu_torch.models.runner import assert_finite

    K = kernels_pkg.KERNELS
    params, s0 = rosensweig_3d(device=dev)
    kernels_pkg.reset_launch_counts()
    sk, rows = kernel_vs_plain(params, s0, ferrofluid_step, dev, 30, "un-carried",
                               FERRO_FIELDS + ("phi", "force"))
    assert_finite(sk, fields=vars(sk))
    launches = kernels_pkg.launch_counts()
    check(sk.premac is None and sk.h.shape[1] == 19 and sk.H_ext is not None,
          "un-carried: the state changed form")
    per_step = {"B4": 1, "B11b": K["B11b"].module.launches_per_call(params.poisson_iters,
                                                                     sk.h.shape),
                "B2": K["B2"].module.N_LAUNCHES, "B6": K["B6"].module.N_LAUNCHES, "B5": 1}
    check_launches("un-carried", launches, per_step, sk.step)
    n_emit = check_emit_launches("un-carried", kernels_pkg, sk.step)
    ids = kernels_pkg.PATHS["ferrofluid_uncarried"]
    emit({"phase": "uncarried_main_path", "scene": "rosensweig_3d",
          "res": list(sk.rho.shape[2:]), "steps": sk.step,
          "kernel_vs_plain_after_30_steps": rows, "finite": True, "card": card,
          "launches": {kid: launches[kid] for kid in ids},
          "launches_a_step": sum(per_step.values()), "ok": True})
    return dict(launches, **{"B11b emit": n_emit})


def phase_epilogue_main(dev, kernels_pkg, card):
    """The epilogue steady state (5-leaf premac, scalar carry) at
    130x66x130: 30 kernel steps against 30 plain steps, counters zeroed just
    before and read just after; then against 30 steps of the capillogue
    steady state with kernels (the same function, capillogue.py:826-829)."""
    from lbm_ferrofluid_tpu_torch.models import ferrofluid_step, rosensweig_3d
    from lbm_ferrofluid_tpu_torch.models.runner import assert_finite

    K = kernels_pkg.KERNELS
    params, s0 = rosensweig_3d(device=dev)
    fields = FERRO_FIELDS + ("phi", "force")
    kernels_pkg.reset_launch_counts()
    sk, rows = kernel_vs_plain(params, s0, ferrofluid_step, dev, 30, "epilogue steady state",
                               fields, epilogue_state(params, dev))
    assert_finite(sk, fields=vars(sk))
    launches = kernels_pkg.launch_counts()
    check(len(sk.premac) == 5 and sk.h.shape[1] == 2, "epilogue: the state changed form")
    check_launches("epilogue steady state", launches, {
        "B1": K["B1"].module.launches_per_call(params.poisson_iters, s0.rho.shape),
        "B2": K["B2"].module.N_LAUNCHES,
        "B6": K["B6"].module.N_LAUNCHES, "B5": 2}, sk.step, extra={"B4": 1})
    s6 = primed(params, dev)(s0, False)
    for _ in range(30):
        s6 = ferrofluid_step(params, s6, device=dev)
    names = list(FERRO_FIELDS) + OUTPUTS["B3"][5:10]
    against = compare("epilogue vs capillogue steady state", names,
                      [getattr(sk, n) for n in FERRO_FIELDS] + list(sk.premac),
                      [getattr(s6, n) for n in FERRO_FIELDS] + list(s6.premac[:5]))
    ids = kernels_pkg.PATHS["ferrofluid_epilogue"]
    emit({"phase": "epilogue_main_path", "scene": "rosensweig_3d",
          "res": list(sk.rho.shape[2:]), "steps": sk.step,
          "kernel_vs_plain_after_30_steps": rows,
          "against_capillogue_steady_state_after_30_steps": against, "finite": True,
          "card": card, "launches": {kid: launches[kid] for kid in ids}, "ok": True})
    return launches


def stencil_hcz_step(params, state, *, device=None, plain=False):
    """The HCZ step with its capillary stage on the stencil route (B10b,
    B10a), as the JAX package's ``hcz_step`` runs it under ``jit``, where
    gravity is traced: B8b, B8a, B2, ``hcz_capillary_stencils`` with the
    streamed moments, B9.  ``plain=True`` is the plain HCZ step, the
    reference it is held to."""
    import torch

    from lbm_ferrofluid_tpu_torch.models import hcz_step
    from lbm_ferrofluid_tpu_torch.ops import kernels as kernels_pkg

    if plain:
        return hcz_step(params, state, device=device, plain=True)
    K = kernels_pkg.KERNELS
    gas = dict(rho_gas=params.rho_gas, rho_fluid=params.rho_fluid,
               density_gas=params.density_gas, density_fluid=params.density_fluid)
    fl, dx, dt = state.flags, params.dx, params.dt
    f, rho, vel, den = K["B8b"].wrapper(state.f, fl, state.rho, state.vel, c=dx / dt, **gas)
    g, m0g, m1g = K["B8a"].wrapper(state.g, fl)
    rho_ca = K["B2"].wrapper(rho, fl, params.contact_angle)
    gravity = torch.tensor(params.gravity_vec(), dtype=torch.float32, device=rho.device)
    _, vel, den, pres, force, dfai, dprho = kernels_pkg.hcz_capillary_stencils(
        rho, vel, fl, den, state.pressure, rho_ca, None, None, m0g, m1g, kappa=params.kappa,
        gravity=gravity.reshape(1, 3, 1, 1, 1), dx=dx, dt=dt, **gas)
    f, g = K["B9"].wrapper(f, g, rho_ca, vel, den, pres, fl, force, dfai, dprho,
                           tau_f=params.tau_f, tau_g=params.tau_g, dx=dx, dt=dt)
    return state.replace(f=f, g=g, rho=rho_ca, vel=vel, density=den, pressure=pres,
                         force=force, step=state.step + 1)


def phase_stencils_main(dev, kernels_pkg, card):
    """The capillary stage's stencil route on the HCZ ``multiphase_3d`` at
    130^3: 30 steps of :func:`stencil_hcz_step` against 30 plain HCZ steps;
    counters zeroed just before, read just after."""
    from lbm_ferrofluid_tpu_torch.models import multiphase_3d
    from lbm_ferrofluid_tpu_torch.models.runner import assert_finite

    K = kernels_pkg.KERNELS
    params, s0 = multiphase_3d(device=dev)
    check(s0.vel_pin_mask is None, "multiphase_3d pins velocities")
    kernels_pkg.reset_launch_counts()
    sk, rows = kernel_vs_plain(params, s0, stencil_hcz_step, dev, 30, "stencil route",
                               HCZ_FIELDS)
    assert_finite(sk, fields=vars(sk))
    launches = kernels_pkg.launch_counts()
    check_launches("stencil route", launches, {
        "B8b": 1, "B8a": 1, "B2": K["B2"].module.N_LAUNCHES, "B10b": 1, "B10a": 1, "B9": 1},
        sk.step)
    ids = kernels_pkg.PATHS["capillary_stencils"]
    emit({"phase": "stencils_main_path", "scene": "multiphase_3d",
          "res": list(sk.rho.shape[2:]), "steps": sk.step,
          "kernel_vs_plain_after_30_steps": rows, "finite": True, "card": card,
          "launches": {kid: launches[kid] for kid in ids}, "ok": True})
    return launches


def time_cuda(fn, reps, warm=1):
    """Milliseconds per call from CUDA events around ``reps`` calls."""
    import torch

    for _ in range(warm):
        fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def launch_split(modules, fn, reps):
    """Per C entry point that ``fn`` launches through the ``call`` of
    ``modules``: launches per call and milliseconds per call, from CUDA
    events around each launch (one warm call first)."""
    import torch

    from lbm_ferrofluid_tpu_torch.ops.kernels import _lib

    events = {}

    def timed(fn_name, *args):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        _lib.call(fn_name, *args)
        end.record()
        events.setdefault(fn_name, []).append((start, end))

    fn()
    for m in modules:
        m.call = timed
    try:
        for _ in range(reps):
            fn()
    finally:
        for m in modules:
            m.call = _lib.call
    torch.cuda.synchronize()
    res = {}
    for name, ev in events.items():
        per = len(ev) // reps
        res[name] = {"launches_per_call": len(ev) / reps,
                     "ms_per_call": sum(s.elapsed_time(e) for s, e in ev) / reps}
        if per > 1:  # the i-th launch of a call, averaged over the calls
            res[name]["ms_per_launch"] = [
                sum(s.elapsed_time(e) for s, e in ev[i::per]) / reps for i in range(per)]
    return res


def blocks_per_sm(entry, *ints) -> int:
    """Resident blocks an SM that the C entry point ``entry`` reports."""
    import ctypes

    from lbm_ferrofluid_tpu_torch.ops.kernels import _lib

    n = ctypes.c_int(0)
    _lib.call(entry, *(ctypes.c_int(v) for v in ints), ctypes.byref(n))
    return n.value


def measure(K, kid, args, kw, per_call, per_step, what, rows=None):
    """Kernel-vs-plain errors, times (kernel, plain) and bound of one call;
    ``rows(K, kid, args, kw, what)`` gives the errors where the float32
    bars of :func:`run_and_compare` do not apply (the bfloat16 forms)."""
    import torch

    k = K[kid]
    r = (rows or (lambda *a: run_and_compare(*a)[1]))(K, kid, args, kw, what)
    moved, flops = k.cost(*args, **kw)
    ms = time_cuda(lambda: k.wrapper(*args, **kw), reps=10)
    plain_ms = time_cuda(lambda: k.plain(*args, **kw), reps=2)
    t_bytes = moved / HBM_BYTES_PER_S * 1e3
    t_ops = flops / F32_FLOPS_PER_S * 1e3
    torch.cuda.empty_cache()
    return {
        "ms": ms, "plain_ms": plain_ms, "launches_per_call": per_call,
        "launches_per_step": per_step, "mean_ms_per_launch": ms / per_call,
        "bound_ms": max(t_bytes, t_ops), "bound_by": "bytes" if t_bytes >= t_ops else "operations",
        "bytes": moved, "flops": flops, "bytes_ms": t_bytes, "flops_ms": t_ops,
        "max_abs_err": max(v["max_abs_err"] for v in r.values()),
        "max_rel": max(v["rel"] for v in r.values()),
    }


def conv3d_pad(kid, x, dx):
    """The timing yardstick beside B10a (``kid`` "B10a") and B10b, never on
    a path: cuDNN's ``F.conv3d`` of the interior in full float32 (TF32 off
    for the timing, then restored), then ``F.pad``, replicate for the
    gradients (the ring rule), zeros for the Laplacian: 2 calls.  Returns
    its ms per call and its max abs error against the kernel's plain
    version."""
    import torch
    import torch.nn.functional as F

    from lbm_ferrofluid_tpu_torch.ops import kernels as kernels_pkg

    n = x.shape[1]
    offs = [(oz, oy, ox) for oz in (-1, 0, 1) for oy in (-1, 0, 1) for ox in (-1, 0, 1)]
    if kid == "B10a":
        # (gx, gy, gz): the tap's step along the axis, twice on it, once one step off it
        taps = [[o[2 - d] * (2, 1, 0)[sum(map(abs, o)) - abs(o[2 - d])] for o in offs]
                for d in range(3)]
        weight = torch.tensor(taps).reshape(3, 1, 3, 3, 3).repeat(n, 1, 1, 1, 1) / (12.0 * dx)
        mode = "replicate"
    else:
        # 2 on the faces, 1 on the edges, -24 at the centre
        taps = [{0: -24.0, 1: 2.0, 2: 1.0}.get(sum(map(abs, o)), 0.0) for o in offs]
        weight = torch.tensor(taps).reshape(1, 1, 3, 3, 3) / (6.0 * dx * dx)
        mode = "constant"
    weight = weight.to(device=x.device, dtype=x.dtype)

    def fn():
        return F.pad(F.conv3d(x, weight, groups=n if kid == "B10a" else 1), (1,) * 6,
                     mode=mode)

    tf32 = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    try:
        got = fn()
        plain = kernels_pkg.KERNELS[kid].plain(x, dx=dx)
        err = float((got.double() - plain.double()).abs().max())
        ms = time_cuda(fn, reps=10)
    finally:
        torch.backends.cudnn.allow_tf32 = tf32
    return {"ms": ms, "calls": 2, "max_abs_err": err,
            "what": "conv3d + pad, 2 calls (cuDNN, TF32 off)"}


def stencil_stack(params, d, ctx, kelvin):
    """The fields B10a differentiates on the stencil route on the HCZ
    chain's intermediates ``ctx``: [lap, fai, prho], with chi as a fourth
    field when ``kelvin``."""
    from lbm_ferrofluid_tpu_torch.ops.kernels import capillary_stack

    return capillary_stack(
        ctx["rho"], d["flags"], ctx["den"], d["pres"], ctx["rho_ca"],
        ctx["phi"] if kelvin else None, rho_gas=params.rho_gas, rho_fluid=params.rho_fluid,
        density_gas=params.density_gas, density_fluid=params.density_fluid, dx=params.dx,
        dt=params.dt)[1]


def stencil_plan_report(res, n_fields, ptxas=None):
    """The plan B10a takes on ``res`` with ``n_fields`` fields (0: B10b's),
    with resident blocks an SM as the card reports them and as ``plan``
    models them, shared memory and the instance's ptxas line."""
    import torch

    from lbm_ferrofluid_tpu_torch.ops.kernels import stencil3d

    lap = n_fields == 0
    nf = max(n_fields, 1)
    pl = stencil3d.plan(*res, torch.cuda.get_device_properties(0).multi_processor_count,
                        min(nf, stencil3d.MAX_FIELDS), laplacian=lap)
    ry = {(tx, ty): r for tx, ty, r in stencil3d.TILES}[(pl.tx, pl.ty)]
    chunk = min(nf, stencil3d.MAX_FIELDS)
    name = f"lbm_stencil_kernel<{pl.tx},{pl.ty},{ry},{chunk},{int(lap)}>"
    return dict(tile=[pl.tx, pl.ty], rows_a_thread=ry, zb=pl.zb,
                launches=1 if lap else stencil3d.launches_per_call(nf),
                smem_bytes=stencil3d.smem_bytes(pl.tx, pl.ty, chunk),
                blocks_per_sm=blocks_per_sm("lbm_stencil_occupancy", pl.tx, pl.ty, chunk,
                                            int(lap)),
                blocks_per_sm_model=stencil3d.blocks_per_sm(pl.tx, pl.ty, chunk, lap),
                ptxas={name: (ptxas or {}).get(name)})


def next_step_calls(K, params, st):
    """:func:`kernel_calls` at the inputs that the next step (and the
    priming) of the primed state ``st`` give each kernel: its carried
    macros and source, H2 from B1, rho_ca from B2."""
    pm = st.premac
    d = dict(s2=st.h, cmask=st.cmask, rhs=pm[5], rho_pre=pm[0], flags=st.flags,
             f=st.f, g=st.g, den_pre=pm[2], pres=st.pressure, gsum=pm[3], gmom=pm[4],
             vel_pre=pm[1], mflags=st.magnetic_flags, rho_old=st.rho, vel_old=st.vel,
             H2=None, rho_ca=None)
    calls = kernel_calls(params, d)
    d["H2"] = K["B1"].wrapper(*calls["B1"][0], **calls["B1"][1])[1]
    d["rho_ca"] = K["B2"].wrapper(*calls["B2"][0], **calls["B2"][1])
    return kernel_calls(params, d)


def epilogue_inputs(K, params, s5):
    """The inputs that the next step of the epilogue steady state ``s5``
    (a 5-leaf premac) gives the capillary stage and B5 (for
    :func:`epilogue_call`): its macros, H2 from B1, rho_ca from B2."""
    from lbm_ferrofluid_tpu_torch.ops.magnetic import poisson_rhs_scaled
    from lbm_ferrofluid_tpu_torch.ops.moments import phi_from_density

    rho_pre, vel_pre, den_pre, gsum, gmom = s5.premac
    h_ext = tuple(params.mag_strength if a == params.h_ext_axis else 0.0 for a in range(3))
    rhs = poisson_rhs_scaled(phi_from_density(den_pre, params.density_gas, params.density_fluid),
                             s5.magnetic_flags, h_ext, tau=params.tau, dx=params.dx,
                             dt=params.dt)
    return dict(f=s5.f, g=s5.g, flags=s5.flags, rho_pre=rho_pre, vel_pre=vel_pre,
                den_pre=den_pre, gsum=gsum, gmom=gmom, pres=s5.pressure,
                H2=K["B1"].wrapper(s5.h, s5.cmask, rhs, n_iters=params.poisson_iters,
                                   dx=params.dx, h_ext=h_ext)[1],
                rho_ca=K["B2"].wrapper(rho_pre, s5.flags, params.contact_angle))


def step_cost_bytes(K, params, st, kids):
    """Bytes of one step's kernel calls by their ``cost``
    (``ops/kernels/*.py``), per entry of ``kids`` (kernel ids; "B5
    emit_mac" is B5 with its emission), on the state ``st`` of the route.
    A cost reads the flags, the storage types and which optional inputs a
    call passes, never the fields' values, so the state's own fields stand
    in for the step's intermediates (held to the ``measure`` rows' bytes
    where a phase has them, :func:`traffic_row`)."""
    n, flags, nones = params.poisson_iters, st.flags, (None,) * 8
    calls = {
        "B1": ((st.h, st.cmask, None), dict(n_iters=n, emit="h2")),
        "B2": ((st.rho, flags), {}),
        "B3": ((st.f, st.g, flags, *nones, st.magnetic_flags), dict(emit_rhs=True)),
        "B4": ((st.f, st.g, flags, None, None), {}),
        "B5": ((st.f, st.g, flags, *nones[:7]), dict(emit_mac=False)),
        "B5 emit_mac": ((st.f, st.g, flags, *nones[:7]), dict(emit_mac=True)),
        # H2 given: the Kelvin form of the capillary stage
        "B6": ((None, None, None, None, st.rho, None, flags, None, None, None), {}),
        "B11b": ((st.h, st.magnetic_flags, None), emit_kw(params, "h2", params.tau, n)),
    }
    return {kid: K[kid.split()[0]].cost(*calls[kid][0], **calls[kid][1])[0] for kid in kids}


def traffic_row(params, st, mlups, kernel_bytes, measured=None):
    """The traffic figures of a timed route on ``st``'s grid, as a
    benchmark's ``pct_roofline`` reckons them: the port's model bytes a
    cell (``models/traffic.py``, for the route the state's premac and h
    name and its storage), the rate they make at ``mlups`` and its share of
    the data sheet's 3.35 TB/s; beside them the bytes a cell of the step's
    kernel calls by their ``cost`` (``kernel_bytes``, from
    :func:`step_cost_bytes`), held to the bytes of the ``measure`` rows of
    the same calls (``measured``: kernel id -> bytes) where the phase has
    them."""
    from lbm_ferrofluid_tpu_torch.models.traffic import model_bytes_per_cell
    from lbm_ferrofluid_tpu_torch.ops.kernels._lib import elem_bytes

    for kid, b in (measured or {}).items():
        check(kernel_bytes[kid] == b, f"traffic: {kid}'s cost on the state {kernel_bytes[kid]} "
                                      f"is not its measured call's {b}")
    res = tuple(st.f.shape[2:])
    cells = math.prod(res)
    scalar = st.h.shape[1] == 2
    premac = None if st.premac is None else len(st.premac)
    b_fg, b_h = elem_bytes(st.f), 4 if scalar else elem_bytes(st.h)
    model = model_bytes_per_cell(params.poisson_iters, b_fg, b_h, res, scalar, premac=premac)
    cost = sum(kernel_bytes.values()) / cells
    rate = mlups * 1e6
    return {"premac": premac, "solve": "scalar carry" if scalar else "channel form",
            "b_fg": b_fg, "b_h": b_h, "mlups": mlups,
            "model_bytes_per_cell": model, "model_GBps": rate * model / 1e9,
            "pct_of_3.35TBps": 100 * rate * model / HBM_BYTES_PER_S,
            "kernel_cost_bytes_per_cell": cost,
            "kernel_cost_by_kernel": {kid: b / cells for kid, b in kernel_bytes.items()},
            "kernel_cost_GBps": rate * cost / 1e9,
            "kernel_cost_pct_of_3.35TBps": 100 * rate * cost / HBM_BYTES_PER_S}


def phase_flagship(dev, K, card):
    import torch

    from lbm_ferrofluid_tpu_torch.models import SimulationRunner, ferrofluid_step, rosensweig_3d

    # bench.py's workload: the Rosensweig geometry at 256^3, mag_strength 85
    params, st = rosensweig_3d(res=(256, 256, 256), mag_strength=85.0, device=dev)
    runner = SimulationRunner(params, ferrofluid_step, device=dev)
    torch.cuda.reset_peak_memory_stats()
    st, stats = runner.benchmark(st, n_steps=30, warmup=20)
    peak = torch.cuda.max_memory_allocated()
    calls = next_step_calls(K, params, st)
    sp = K["B1"].module
    per_call = {"B1": sp.launches_per_call(params.poisson_iters, st.rho.shape),
                "B2": K["B2"].module.N_LAUNCHES, "B3": K["B3"].module.N_LAUNCHES, "B4": 1}
    # the prologue runs once, at priming; the other three every step
    per_step = dict(per_call, B4=0)
    out = {kid: measure(K, kid, *calls[kid], per_call[kid], per_step[kid], f"{kid} at 256^3")
           for kid in ("B1", "B2", "B3", "B4")}
    # B1's pass launches apart from H2's; B3's chain launch by launch:
    # (a) lbm_cap_derived, (b) lbm_cap_collide, (c) lbm_prologue, (d) lbm_cap_rhs
    from lbm_ferrofluid_tpu_torch.ops.kernels import capillogue, fused_step, scalar_poisson
    for kid, mods in (("B1", [scalar_poisson]), ("B3", [capillogue, fused_step])):
        out[kid]["split"] = launch_split(
            mods, lambda kid=kid: K[kid].wrapper(*calls[kid][0], **calls[kid][1]), reps=10)
    pl = sp.plan(*st.rho.shape[2:], params.poisson_iters,
                 torch.cuda.get_device_properties(0).multi_processor_count)
    out["B1"]["plan"] = dict(k=pl.k, tile=[sp.EXT_WIDTH - 2 * pl.k, pl.ty], lz=pl.lz,
                             passes=list(pl.passes), smem_bytes=sp.smem_bytes(pl.k, pl.ty),
                             blocks_per_sm=blocks_per_sm("lbm_scalar_pass_occupancy",
                                                         pl.k, pl.ty))
    out["B3"]["collide_blocks_per_sm"] = blocks_per_sm("lbm_cap_collide_occupancy", 0)
    kids = ("B1", "B2", "B3")
    traffic = traffic_row(params, st, stats["mlups"], step_cost_bytes(K, params, st, kids),
                          {kid: out[kid]["bytes"] for kid in kids})
    emit({"phase": "flagship", "scene": "rosensweig_3d", "res": [256, 256, 256],
          "mlups": stats["mlups"], "seconds_30_steps": stats["seconds"],
          "peak_mem_gb": peak / 1e9, "card": card, "per_kernel": out, "traffic": traffic,
          "ok": True})
    return out


def b11b_plan_report(pl, tau, ptxas=None, bf16=False):
    """B11b's plan with its shared memory, resident blocks an SM and the
    pass kernel's ptxas line (its bfloat16 instance with ``bf16``)."""
    from lbm_ferrofluid_tpu_torch.ops.kernels import poisson as pp

    tau1 = int(1.0 / tau == 1.0)
    name = f"lbm_poisson_pass_kernel<{'bf16,' if bf16 else ''}{tau1},{pl.ty + 2 * pl.k - 2},0>"
    return dict(k=pl.k, tile=[pp.tile_width(pl.k), pl.ty], lz=pl.lz, passes=list(pl.passes),
                threads=pp.threads(pl.k, pl.ty),
                smem_bytes=pp.smem_bytes(pl.k, pl.ty, 2 if bf16 else 4),
                blocks_per_sm=blocks_per_sm("lbm_poisson_pass_occupancy", pl.k, pl.ty, tau1,
                                            int(bf16), 0),
                ptxas={name: (ptxas or {}).get(name)})


def bits_rows(K, kid, args, kw, what):
    """Kernel ``kid`` against its plain version on the same inputs, bit for
    bit (the check fails otherwise): rows of :func:`measure`."""
    import torch

    got, want = K[kid].wrapper(*args, **kw), K[kid].plain(*args, **kw)
    torch.cuda.synchronize()
    names = ["h", kw.get("emit", "psi")]
    for n, a, b in zip(names, got, want):
        check(torch.equal(a, b), f"{what} {n}: differs from the plain version by "
                                 f"{float((a.double() - b.double()).abs().max()):.3e}")
    return {n: {"max_abs_err": 0.0, "rel": 0.0} for n in names}


@contextlib.contextmanager
def psi_route():
    """Within the block the solve takes the psi route, the channel-form
    tail before B7's trailing stage was ported: B11b's psi, the obstacle
    substitution, B10a and the H2 ops (``poisson.emit_ok`` refuses every
    grid): the yardstick of time in the same call."""
    from lbm_ferrofluid_tpu_torch.ops.kernels import poisson as pp

    real, pp.emit_ok = pp.emit_ok, lambda *a, **kw: False
    try:
        yield
    finally:
        pp.emit_ok = real


def trail_report(K, params, st, ptxas, bf16=False):
    """B11b with B7's trailing stage at the inputs of the next channel-form
    step: the h2 call (``measure``, bit for bit to its plain version, its
    bound from ``cost(emit="h2")``), the hint call, and the psi call with
    the tail it replaces (the substitution, B10a, the H2 ops), these two
    timed in turns (psi route, h2, h2, psi route); each call launch by
    launch (the last launch the trailing pass, or psi's last pass); the
    trailing pass's plan, shared memory, resident blocks an SM and ptxas
    line."""
    import torch

    from lbm_ferrofluid_tpu_torch.ops.kernels import poisson as pp
    from lbm_ferrofluid_tpu_torch.ops.kernels import stencil3d
    from lbm_ferrofluid_tpu_torch.ops.magnetic import h_int_from_psi

    tag = " bf16" if bf16 else ""
    args = (st.h, st.magnetic_flags, st.premac[5])
    n = params.poisson_iters
    per_call = pp.launches_per_call(n, st.h.shape)
    out = {}
    for emit in ("h2", "hint"):
        kw = emit_kw(params, emit, params.tau, n)
        row = measure(K, "B11b", args, kw, per_call, per_call, f"B11b emit={emit}{tag} at 256^3",
                      rows=bits_rows)
        row["split"] = launch_split([pp], lambda kw=kw: K["B11b"].wrapper(*args, **kw), reps=5)
        out[emit] = row
    psi_kw = dict(tau=params.tau, n_iters=n)
    hext = static_field(params)

    def composition():
        _, psi = K["B11b"].wrapper(*args, **psi_kw)
        return h_int_from_psi(psi, st.magnetic_flags, dx=params.dx, h2_ext=hext,
                              grad=stencil3d.grad_fields)

    h2_kw = emit_kw(params, "h2", params.tau, n)
    turns = {}
    for label, fn in (("psi_route", composition), ("h2", lambda: K["B11b"].wrapper(*args, **h2_kw)),
                      ("h2_again", lambda: K["B11b"].wrapper(*args, **h2_kw)),
                      ("psi_route_again", composition)):
        turns[label] = time_cuda(fn, reps=10)
    d = (K["B11b"].wrapper(*args, **h2_kw)[1].double() - composition().double()).abs().max()
    out["against_psi_route"] = dict(turns, h2_max_abs_diff=float(d), psi_split=launch_split(
        [pp], lambda: K["B11b"].wrapper(*args, **psi_kw), reps=5))
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    tp = pp.trail_pass(*st.h.shape[2:], pp.plan(*st.h.shape[2:], n, sms, 2 if bf16 else 4)
                       .passes[-1], sms, 2 if bf16 else 4)
    tau1 = int(1.0 / params.tau == 1.0)
    name = f"lbm_poisson_trail_kernel<{'bf16,' if bf16 else ''}{tau1},{tp.ty + 2 * tp.k},0,0>"
    out["instances"] = trail_instances(K, params, st, ptxas, bf16)
    out["trail_pass"] = dict(
        k=tp.k, tile=[pp.tile_width(tp.k + 1), tp.ty], lz=tp.lz,
        threads=pp.threads(tp.k, tp.ty),
        smem_bytes=pp.smem_bytes(tp.k, tp.ty, 2 if bf16 else 4, trail=True),
        blocks_per_sm=blocks_per_sm("lbm_poisson_pass_occupancy", tp.k, tp.ty, tau1, int(bf16),
                                    1),
        ptxas={name: (ptxas or {}).get(name)})
    torch.cuda.empty_cache()
    return out


#: the trailing pass's instances (``trail_instances``): label, tau (None:
#: the scene's), emit and form: "one" (B = 1), "batch" (B = 2), a slab of
#: ``TRAIL_SLAB`` planes at the domain's lower true edge ("edge", clamp (1,
#: Zl)) or between two neighbours ("inner", clamp (-1, Zl))
TRAIL_INSTANCES = (("tau 1 h2", 1.0, "h2", "one"), ("tau 1 hint", 1.0, "hint", "one"),
                   ("tau 0.8 h2", 0.8, "h2", "one"), ("tau 0.8 hint", 0.8, "hint", "one"),
                   ("B=2 h2", None, "h2", "batch"), ("slab edge h2", None, "h2", "edge"),
                   ("slab inner h2", None, "h2", "inner"))
#: a slab's planes and band planes a side (G >= k + 1)
TRAIL_SLAB = (64, 4)


def trail_instance_args(params, st, tau, emit, form):
    """(args, kw, cost) of one launch of B11b's trailing pass, a call of k =
    3 sweeps with B7's trailing stage, on ``st``'s inputs in ``form``
    (``TRAIL_INSTANCES``); a slab is cut from the grid with its bands and
    its flags and rhs extended by G planes a side (wrapped)."""
    import functools

    import torch

    from lbm_ferrofluid_tpu_torch.ops.kernels import poisson as pp

    h, mf, rhs = st.h, st.magnetic_flags, st.premac[5]
    kw = emit_kw(params, emit, params.tau if tau is None else tau, 3)
    if form == "one":
        return (h, mf, rhs), kw, pp.cost
    if form == "batch":
        return ((torch.cat([h, h.roll(1, dims=-1)]), torch.cat([mf, mf]), torch.cat([rhs, rhs])),
                kw, pp.cost)
    Zl, G = TRAIL_SLAB
    z0 = 0 if form == "edge" else (h.shape[2] - Zl) // 2
    idx = torch.arange(z0 - G, z0 + Zl + G, device=h.device) % h.shape[2]
    hz = h.index_select(2, idx)
    kw = dict(kw, ghosts=(hz[:, :, :G].contiguous(), hz[:, :, G + Zl:].contiguous()),
              clamp=(1 if form == "edge" else -1, Zl))
    return ((hz[:, :, G:G + Zl].contiguous(), mf.index_select(2, idx), rhs.index_select(2, idx)),
            kw, functools.partial(pp.cost_slab, rounds=(3,), G=G))


def trail_instances(K, params, st, ptxas, bf16=False, plain=True, reps=10):
    """B11b's trailing pass alone (one launch) on ``st``'s inputs in each
    of ``TRAIL_INSTANCES``: ms beside a regular pass of the same k (which
    stores psi) on the same inputs, its bound (``cost``, ``cost_slab``), a
    hash of the emitted field's bits and, with ``plain``, both outputs held
    bit for bit to the plain version's (the check fails otherwise) with the
    plain field's hash; its plan, resident blocks an SM and the ptxas line
    of its instance."""
    import torch

    from lbm_ferrofluid_tpu_torch.ops.kernels import poisson as pp

    sms = torch.cuda.get_device_properties(0).multi_processor_count
    tag = " bf16" if bf16 else ""
    rows = {}
    for label, tau, emit, form in TRAIL_INSTANCES:
        args, kw, cost = trail_instance_args(params, st, tau, emit, form)
        got = K["B11b"].wrapper(*args, **kw)
        row = {"form": form, "emit": emit, "tau": kw["tau"], "B": args[0].shape[0],
               "sha256": _bits_sha(got[1])[:16]}
        if plain:
            want = K["B11b"].plain(*args, **kw)
            torch.cuda.synchronize()
            check(all(torch.equal(a, b) for a, b in zip(got, want)),
                  f"B11b's trailing pass {label}{tag}: differs from its plain version")
            row["plain_sha256"] = _bits_sha(want[1])[:16]
            del want
        del got
        regular = {key: v for key, v in kw.items() if key not in ("emit", "dx", "h_ext", "clamp")}
        row["ms"] = time_cuda(lambda: K["B11b"].wrapper(*args, **kw), reps)
        row["regular_pass_ms"] = time_cuda(lambda: K["B11b"].wrapper(*args, **regular), reps)
        moved, flops = cost(*args, **kw)
        t_bytes, t_ops = moved / HBM_BYTES_PER_S * 1e3, flops / F32_FLOPS_PER_S * 1e3
        tp = pp.trail_pass(*args[0].shape[2:], 3, sms, 2 if bf16 else 4)
        tau1 = int(1.0 / kw["tau"] == 1.0)
        name = (f"lbm_poisson_trail_kernel<{'bf16,' if bf16 else ''}{tau1},{tp.ty + 6},"
                f"{int(form in ('edge', 'inner'))},{int(form == 'batch')}>")
        row.update(bound_ms=max(t_bytes, t_ops), bound_by="bytes" if t_bytes >= t_ops else
                   "operations", ty=tp.ty, lz=tp.lz,
                   blocks_per_sm=blocks_per_sm("lbm_poisson_pass_occupancy", 3, tp.ty, tau1,
                                               int(bf16), 1),
                   ptxas={name: (ptxas or {}).get(name)})
        rows[label] = row
        del args, kw
        torch.cuda.empty_cache()
    return rows


def phase_trail_time(dev, card, ptxas=None):
    """B11b's trailing pass alone in each instance (``trail_instances``,
    float32 and bfloat16 h, 20 launches each) at the inputs of the 256^3
    channel-form step after 5 steps, in the package that
    ``lbm_ferrofluid_tpu_torch`` imports from (``--trail-time ROOT``: a
    checkout at ROOT, for an A/B of two trees in one call, whose hashes of
    the outputs' bits must agree); then :func:`phase_route_time`."""
    import torch

    import lbm_ferrofluid_tpu_torch
    from lbm_ferrofluid_tpu_torch.models import SimulationRunner, ferrofluid_step, rosensweig_3d
    from lbm_ferrofluid_tpu_torch.ops import kernels as kernels_pkg

    out = {"phase": "trail_time", "package": lbm_ferrofluid_tpu_torch.__file__, "card": card}
    params, st = rosensweig_3d(res=(256, 256, 256), mag_strength=85.0, device=dev)
    params = params.replace(scalar_carry=False)
    for label, (p, s) in (("f32", (params, st)), ("bf16", turbo(params, st, dev))):
        s, _ = SimulationRunner(p, ferrofluid_step, device=dev).benchmark(s, n_steps=3, warmup=2)
        check(s.h.shape[1] == 19, f"trail time {label}: not the channel form")
        out[label] = trail_instances(kernels_pkg.KERNELS, p, s, ptxas, bf16=label == "bf16",
                                     plain=False, reps=20)
        del s
        torch.cuda.empty_cache()
    del st
    emit(dict(out, ok=True))
    phase_route_time(dev, card)


def phase_slab_time(dev, card, ptxas=None, reps=20, steps=10):
    """B1's slab solve on one rank with ``slab=True`` (route Z slab-forced)
    at each of ``SHARDED_GRIDS``, in the package that
    ``lbm_ferrofluid_tpu_torch`` imports from (``--slab-time ROOT``: a
    checkout at ROOT, for an A/B of two trees in one call): after 5 meshed
    steps, ms of the slab solve and of the single-device call on its
    inputs (CUDA events, ``reps`` calls each), route Z's ms a step
    slab-forced and on one device (``steps`` steps after 3, in turns),
    B1's launches a slab step, and hashes of the solve's outputs (slab
    and single device equal bit for bit); then B11b's
    (:func:`phase_slab_time_b11b`)."""
    import torch

    import lbm_ferrofluid_tpu_torch
    from lbm_ferrofluid_tpu_torch.models import ferrofluid_step, prime_premac
    from lbm_ferrofluid_tpu_torch.ops import kernels as kernels_pkg
    from lbm_ferrofluid_tpu_torch.ops.kernels import scalar_poisson as sp
    from lbm_ferrofluid_tpu_torch.parallel import make_mesh, shard_state, step3d

    out = {"phase": "slab_time", "package": lbm_ferrofluid_tpu_torch.__file__, "card": card}
    mesh = make_mesh(slab=True)
    for res, mag in SHARDED_GRIDS:
        params, s0 = sharded_scene(res, mag, dev)
        sm = prime_premac(params, shard_state(s0, mesh), mesh=mesh)
        ss = prime_premac(params, s0, device=dev)
        for _ in range(5):
            sm = ferrofluid_step(params, sm, mesh=mesh)
        h_ext = tuple(params.mag_strength if a == params.h_ext_axis else 0.0 for a in range(3))
        kw = dict(n_iters=params.poisson_iters, dx=params.dx, h_ext=h_ext)
        args = (sm.h, sm.cmask, sm.premac[5])
        torch.cuda.synchronize()
        slab = step3d.scalar_poisson_sharded(*args, mesh, **kw)
        one = sp.scalar_wavefront(*args, **kw)[::-1]
        torch.cuda.synchronize()
        row = {"plan": list(step3d.scalar_slab_plan(mesh, step3d.global_shape(sm.h.shape, mesh),
                                                    params.poisson_iters)),
               "slab_bit_for_bit_to_single_device": all(
                   torch.equal(a, b) for a, b in zip(slab, one, strict=True)),
               "sha256": {name: hashlib.sha256(t.cpu().numpy().tobytes()).hexdigest()[:16]
                          for name, t in zip(("H2", "s2"), slab)}}
        ms = {}
        for label, fn in (("slab_solve", lambda: step3d.scalar_poisson_sharded(*args, mesh, **kw)),
                          ("single_device", lambda: sp.scalar_wavefront(*args, **kw)),
                          ("slab_solve_again",
                           lambda: step3d.scalar_poisson_sharded(*args, mesh, **kw)),
                          ("single_device_again", lambda: sp.scalar_wavefront(*args, **kw))):
            ms[label] = time_cuda(fn, reps)
        row["ms"] = ms
        kernels_pkg.reset_launch_counts()
        sm = ferrofluid_step(params, sm, mesh=mesh)
        torch.cuda.synchronize()
        row["b1_launches_a_slab_step"] = kernels_pkg.launch_counts(["B1"], slab=True)["B1"]
        step_ms = {}
        on_slab = meshed_step(mesh)
        for label, fn, st in (("slab", on_slab, sm), ("single_device", ferrofluid_step, ss),
                              ("single_device_again", ferrofluid_step, ss),
                              ("slab_again", on_slab, sm)):
            _, stats = timed_steps(params, st, fn, dev, steps, warmup=3)
            step_ms[label] = stats["seconds"] / steps * 1e3
        row["route_z_ms_per_step"] = step_ms
        out["x".join(map(str, res))] = row
        del sm, ss, s0, slab, one, args
        torch.cuda.empty_cache()
    emit(dict(out, ok=True))
    phase_slab_time_b11b(dev, card, ptxas, reps, steps)


#: an H100's SM: registers, shared memory (bytes, 1 KB of it reserved a
#: block), warps and blocks it holds at most, and the registers a warp is
#: allotted at a time
SM_REGS, SM_SMEM, SMEM_RESERVED, SM_WARPS, SM_BLOCKS, REG_UNIT = 65536, 233472, 1024, 64, 32, 256


def resident_blocks(regs, threads, smem):
    """Blocks of a kernel of ``regs`` registers a thread, ``threads`` a block
    and ``smem`` bytes of shared memory a block that an SM holds at once,
    by the occupancy rules of the card (``SM_*``)."""
    warps = -(-threads // 32)
    per_warp = -(-regs * 32 // REG_UNIT) * REG_UNIT
    return min(SM_REGS // per_warp // warps, SM_SMEM // (smem + SMEM_RESERVED),
               SM_WARPS // warps, SM_BLOCKS)


def b11b_slab_instances(params, shape, mesh, bf16, ptxas):
    """The slab kernels B11b's slab solve with the trailing stage launches on
    a rank's [1, 19, Zl, Y, X] h (``channel_slab_rounds(h2=True)``): per
    instance its rounds, registers, spills (ptxas) and resident blocks an
    SM (:func:`resident_blocks` of them, the block's threads and shared
    memory), beside the one-device pass of the same geometry's blocks as
    the card reports them."""
    import torch

    from lbm_ferrofluid_tpu_torch.ops.kernels import poisson as pp
    from lbm_ferrofluid_tpu_torch.parallel import step3d

    Zl, Y, X = shape[2:]
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    elem, tag = (2, "bf16,") if bf16 else (4, "")
    tau1 = int(1.0 / float(params.tau) == 1.0)
    rounds, _, emitted = step3d.channel_slab_rounds(
        mesh, step3d.global_shape(shape, mesh), params.poisson_iters, h2=True)
    out = {}
    for i, k in enumerate(rounds):
        if emitted and i == len(rounds) - 1:
            pl = pp.trail_pass(Zl, Y, X, k, sms, elem)
            ey, threads, trail = pl.ty + 2 * k, 32 * (pl.ty + 2 * k), True
            name = f"lbm_poisson_trail_kernel<{tag}{tau1},{ey},1,0>"
        else:
            pl = pp.slab_plan(Zl, Y, X, k, sms, elem)
            ey, threads, trail = pl.ty + 2 * (k - 1), 32 * (pl.ty + 2 * k), False
            name = f"lbm_poisson_slab_kernel<{tag}{tau1},{ey}>"
        if name in out:
            out[name]["rounds"] += 1
            continue
        info = dict((ptxas or {}).get(name) or {})
        smem = pp.smem_bytes(k, pl.ty, elem, trail=trail) + info.get("smem", 0)
        out[name] = dict(rounds=1, k=k, ty=pl.ty, lz=pl.lz, threads=threads, smem_bytes=smem,
                         ptxas=info, resident_blocks=resident_blocks(info["regs"], threads, smem)
                         if "regs" in info else None,
                         one_device_pass_blocks=blocks_per_sm("lbm_poisson_pass_occupancy", k,
                                                              pl.ty, tau1, int(bf16),
                                                              int(trail)))
    return out


def phase_slab_time_b11b(dev, card, ptxas=None, reps=20, steps=10):
    """B11b's slab solve on one rank with ``slab=True`` at each of
    ``SHARDED_GRIDS``, in the package that ``lbm_ferrofluid_tpu_torch``
    imports from (``--slab-time ROOT``): after 5 meshed steps of route C,
    h in float32 and rounded to bfloat16, ms of the slab solve with B7's
    trailing stage emitting H2 as the step runs it
    (``poisson_sweeps_sharded(emit_h2=)``) and of the single-device emitting
    call on its inputs (CUDA events, ``reps`` calls each, in turns), the
    solve's rounds, hashes of its outputs (slab and single device equal bit
    for bit), and its slab instances' registers, spills and resident blocks
    (:func:`b11b_slab_instances`), its launches timed one by one
    (:func:`launch_split`) and the rest of its time; then ms a step of routes C and U19
    slab-forced and on one device (``steps`` steps after 3, in turns) and
    B11b's launches a slab step."""
    import torch

    import lbm_ferrofluid_tpu_torch
    from lbm_ferrofluid_tpu_torch.models import ferrofluid_step
    from lbm_ferrofluid_tpu_torch.ops import kernels as kernels_pkg
    from lbm_ferrofluid_tpu_torch.ops.kernels import poisson as pp
    from lbm_ferrofluid_tpu_torch.parallel import make_mesh, shard_state, step3d

    out = {"phase": "slab_time_b11b", "package": lbm_ferrofluid_tpu_torch.__file__,
           "card": card}
    mesh = make_mesh(slab=True)
    for res, mag in SHARDED_GRIDS:
        params, s0 = sharded_scene(res, mag, dev, route="C")
        sm = start_route(params, shard_state(s0, mesh), "C", mesh=mesh)
        for _ in range(5):
            sm = ferrofluid_step(params, sm, mesh=mesh)
        n, hext = params.poisson_iters, static_field(params)
        row = {"rounds": step3d.channel_slab_rounds(mesh, step3d.global_shape(sm.h.shape, mesh),
                                                    n, h2=True)[:2]}
        for storage in (torch.float32, torch.bfloat16):
            args = (sm.h.to(storage), sm.magnetic_flags, sm.premac[5])
            kw = dict(tau=params.tau, n_iters=n)

            def slab():
                return step3d.poisson_sweeps_sharded(*args, mesh, emit_h2=hext, dx=params.dx,
                                                     **kw)

            def one():
                return pp.poisson_sweeps(*args, emit="h2", dx=params.dx, h_ext=hext, **kw)

            got, want = slab(), one()
            torch.cuda.synchronize()
            check(got[2], f"slab time {res}: the slab solve did not take B7's trailing stage")
            bits = torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
            check(bits, f"slab time {res} {storage}: the slab solve differs from one device")
            ms = {label: time_cuda(fn, reps) for label, fn in (
                ("slab_solve", slab), ("single_device", one), ("single_device_again", one),
                ("slab_solve_again", slab))}
            # the solve's kernel launches, each between CUDA events, and the
            # rest of the solve (its exchanges, copies and host work)
            split = launch_split([pp], slab, reps)["lbm_poisson_pass"]
            row[str(storage).replace("torch.", "")] = {
                "ms": ms, "kernels_ms": split["ms_per_call"],
                "outside_kernels_ms": (ms["slab_solve"] + ms["slab_solve_again"]) / 2
                - split["ms_per_call"], "ms_per_launch": split["ms_per_launch"],
                "slab_bit_for_bit_to_single_device": bits,
                "sha256": {name: _bits_sha(t)[:16] for name, t in zip(("h", "H2"), got)},
                "instances": b11b_slab_instances(params, args[0].shape, mesh,
                                                 storage == torch.bfloat16, ptxas)}
            del args, got, want
        del sm
        torch.cuda.empty_cache()
        for route in ("C", "U19"):
            params, s0 = sharded_scene(res, mag, dev, route=route)
            sm = start_route(params, shard_state(s0, mesh), route, mesh=mesh)
            ss = start_route(params, s0, route, device=dev)
            on_slab = meshed_step(mesh, route)
            kernels_pkg.reset_launch_counts()
            sm = on_slab(params, sm)
            torch.cuda.synchronize()
            launches = kernels_pkg.launch_counts(["B11b"], slab=True)["B11b"]
            step_ms = {}
            for label, fn, st in (("slab", on_slab, sm), ("single_device", ferrofluid_step, ss),
                                  ("single_device_again", ferrofluid_step, ss),
                                  ("slab_again", on_slab, sm)):
                _, stats = timed_steps(params, st, fn, dev, steps, warmup=3)
                step_ms[label] = stats["seconds"] / steps * 1e3
            row[f"route_{route}"] = {"ms_per_step": step_ms, "b11b_launches_a_slab_step":
                                     launches}
            del sm, ss, s0
            torch.cuda.empty_cache()
        out["x".join(map(str, res))] = row
    emit(dict(out, ok=True))


def route_turns(params, state, dev):
    """ms a step of ``state``'s route at the trailing stage and on the psi
    route, in turns (trailing stage, psi route, psi route, trailing stage;
    10 steps each after 3), with the kernels' launches a step of each:
    (ms, launches a step)."""
    n_steps = 10
    import torch

    from lbm_ferrofluid_tpu_torch.models import ferrofluid_step
    from lbm_ferrofluid_tpu_torch.ops import kernels as kernels_pkg

    ms, per_step = {}, {}
    for label, psi in (("trailing_stage", False), ("psi_route", True),
                       ("psi_route_again", True), ("trailing_stage_again", False)):
        with psi_route() if psi else contextlib.nullcontext():
            _, st = timed_steps(params, state, ferrofluid_step, dev, n_steps, warmup=3)
            ms[label] = st["seconds"] / n_steps * 1e3
            kernels_pkg.reset_launch_counts()
            ferrofluid_step(params, state, device=dev)
            torch.cuda.synchronize()
            per_step[label.replace("_again", "")] = sum(kernels_pkg.launch_counts().values())
    return ms, per_step


def phase_channel_flagship(dev, K, card, ptxas=None):
    """bench.py's Rosensweig scene at 256^3 on the channel-form solve
    (``scalar_carry=False``): MLUPS and peak memory over warm steps, then
    B11b and B10a at the inputs the next step gives them, B11b pass by pass
    with its plan."""
    import torch

    from lbm_ferrofluid_tpu_torch.models import SimulationRunner, ferrofluid_step, rosensweig_3d
    from lbm_ferrofluid_tpu_torch.ops.stencils import substitute_obstacles

    params, st = rosensweig_3d(res=(256, 256, 256), mag_strength=85.0, device=dev)
    params = params.replace(scalar_carry=False)
    runner = SimulationRunner(params, ferrofluid_step, device=dev)
    torch.cuda.reset_peak_memory_stats()
    st, stats = runner.benchmark(st, n_steps=20, warmup=10)
    peak = torch.cuda.max_memory_allocated()
    check(st.h.shape[1] == 19, "256^3 channel flagship: not the channel form")
    args = (st.h, st.magnetic_flags, st.premac[5])
    kw = dict(tau=params.tau, n_iters=params.poisson_iters)
    pp = K["B11b"].module
    per_call = pp.launches_per_call(params.poisson_iters, st.h.shape)
    out = {"B11b": measure(K, "B11b", args, kw, per_call, per_call, "B11b at 256^3")}
    out["B11b"]["split"] = launch_split([pp], lambda: K["B11b"].wrapper(*args, **kw), reps=10)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    out["B11b"]["plan"] = b11b_plan_report(pp.plan(*st.h.shape[2:], params.poisson_iters, sms),
                                           params.tau, ptxas)
    psi_sub = substitute_obstacles(K["B11b"].wrapper(*args, **kw)[1], st.magnetic_flags)
    out["B10a"] = measure(K, "B10a", (psi_sub,), dict(dx=params.dx), 1, 1, "B10a at 256^3")
    out["B10a"]["conv3d_pad"] = conv3d_pad("B10a", psi_sub, params.dx)
    out["B10a"]["plan"] = stencil_plan_report(psi_sub.shape[2:], 1, ptxas)
    del psi_sub
    trail = trail_report(K, params, st, ptxas)
    out["B11b emit"] = trail["h2"]
    traffic = traffic_row(params, st, stats["mlups"],
                          step_cost_bytes(K, params, st, ("B11b", "B2", "B3")),
                          {"B11b": trail["h2"]["bytes"]})
    routes = {"C": route_turns(params, st, dev)}
    del st
    torch.cuda.empty_cache()
    su = rosensweig_3d(res=(256, 256, 256), mag_strength=85.0, device=dev)[1]
    routes["U"] = route_turns(params.replace(scalar_carry=True), su, dev)
    check(all(r[1] == {"trailing_stage": n, "psi_route": n + 1} for r, n in
              ((routes["C"], 15), (routes["U"], 14))),
          f"256^3 launches a step: {[r[1] for r in routes.values()]}")
    del su
    torch.cuda.empty_cache()
    emit({"phase": "channel_flagship", "scene": "rosensweig_3d", "res": [256, 256, 256],
          "solve": "channel form (scalar_carry=False)", "mlups": stats["mlups"],
          "ms_per_step": stats["seconds"] / stats["steps"] * 1e3,
          "seconds_20_steps": stats["seconds"], "peak_mem_gb": peak / 1e9, "card": card,
          "per_kernel": out, "trailing_stage": trail, "traffic": traffic,
          "routes_ms_a_step": {k: v[0] for k, v in routes.items()},
          "routes_launches_a_step": {k: v[1] for k, v in routes.items()}, "ok": True})
    return out


def timed_steps(params, state, step, dev, n_steps, warmup):
    """``warmup`` then ``n_steps`` timed steps of ``step`` on the state as it
    is (``SimulationRunner.benchmark`` primes first): (state, stats)."""
    import torch

    for _ in range(warmup):
        state = step(params, state, device=dev)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n_steps):
        state = step(params, state, device=dev)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    return state, {"mlups": state.rho.numel() * n_steps / seconds / 1e6, "seconds": seconds,
                   "steps": n_steps}


#: the kernel calls of a step of the un-carried route in channel form (U)
#: and of the epilogue steady state with the scalar carry (E)
UNCARRIED_KIDS = ("B4", "B11b", "B2", "B6", "B5")
EPILOGUE_KIDS = ("B1", "B2", "B6", "B5 emit_mac")


def phase_epilogue_flagship(dev, K, card, ptxas=None):
    """bench.py's Rosensweig scene at 256^3 on the two routes of B5: the
    un-carried step (channel-form h) and the epilogue steady state (scalar
    carry), MLUPS, ms a step and peak memory over warm steps; then B5 in
    both modes at the inputs the epilogue steady state's next step gives
    it, with its plans (``b5_flagship_plans``)."""
    import torch

    from lbm_ferrofluid_tpu_torch.models import SimulationRunner, ferrofluid_step, rosensweig_3d

    params, st = rosensweig_3d(res=(256, 256, 256), mag_strength=85.0, device=dev)
    out = {"phase": "epilogue_flagship", "scene": "rosensweig_3d", "res": [256, 256, 256],
           "card": card}
    torch.cuda.reset_peak_memory_stats()
    su, stats = timed_steps(params, st, ferrofluid_step, dev, n_steps=20, warmup=10)
    check(su.premac is None and su.h.shape[1] == 19, "256^3 un-carried: the state changed form")
    out["uncarried"] = dict(stats, ms_per_step=stats["seconds"] / stats["steps"] * 1e3,
                            peak_mem_gb=torch.cuda.max_memory_allocated() / 1e9)
    uncarried_bytes = step_cost_bytes(K, params, su, UNCARRIED_KIDS)
    out["uncarried"]["traffic"] = traffic_row(params, su, stats["mlups"], uncarried_bytes)
    del su
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    runner = SimulationRunner(params, ferrofluid_step, device=dev)
    s5, stats = runner.benchmark(epilogue_state(params, dev)(st, False), n_steps=20, warmup=10)
    check(len(s5.premac) == 5, "256^3 epilogue: the state changed form")
    out["epilogue_steady_state"] = dict(
        stats, ms_per_step=stats["seconds"] / stats["steps"] * 1e3,
        peak_mem_gb=torch.cuda.max_memory_allocated() / 1e9)
    del st
    d = epilogue_inputs(K, params, s5)
    per_kernel = {}
    for emit_mac, label in ((False, "B5"), (True, "B5 emit_mac")):
        args, kw = epilogue_call(K, params, d, emit_mac)
        n = 2 if emit_mac else 1
        per_kernel[label] = measure(K, "B5", args, kw, n, n, f"{label} at 256^3")
    per_kernel["B5"]["plans"] = b5_flagship_plans(K, args, kw, ptxas)
    out["per_kernel"] = per_kernel
    out["epilogue_steady_state"]["traffic"] = traffic_row(
        params, s5, out["epilogue_steady_state"]["mlups"],
        step_cost_bytes(K, params, s5, EPILOGUE_KIDS),
        {"B5 emit_mac": per_kernel["B5 emit_mac"]["bytes"]})
    # B5 without the emission (the un-carried step's) on the same flags
    check(uncarried_bytes["B5"] == per_kernel["B5"]["bytes"],
          "traffic: B5's cost on the un-carried state is not its measured call's")
    emit(dict(out, ok=True))
    return per_kernel


def b5_instance(form, bf16, ptxas=None):
    """A B5 form (``FORMS``) with its instance's resident blocks an SM and
    ptxas line."""
    from lbm_ferrofluid_tpu_torch.ops.kernels import fused_step

    name = {"cell": "lbm_epilogue_kernel", "stage": "lbm_epilogue_stage"}[form] + (
        "<bf16>" if bf16 else "")
    return dict(form=form, blocks_per_sm=blocks_per_sm(
        "lbm_epilogue_occupancy", fused_step.FORMS.index(form), int(bf16)),
        ptxas={name: (ptxas or {}).get(name)})


def b5_flagship_plans(K, args, kw, ptxas=None):
    """B5 at the flagship's inputs under the step's plan, a strip of 4
    planes and the cell plan (one thread a cell): each instance's
    resident blocks an SM and ptxas line, its ``emit_mac`` call timed
    launch by launch (the form's launch, then the prologue's) after warm
    calls of its own, and each plan held bit for bit to the cell plan in
    both modes.  ``--epilogue-plans`` times every plan whole."""
    import torch

    from lbm_ferrofluid_tpu_torch.ops.kernels import fused_step

    res = tuple(args[0].shape[2:])
    bf16 = args[0].dtype == torch.bfloat16
    plans = dict(epilogue_plans(res, bf16), cell=fused_step.CELL)
    out = {}
    for emit_mac in (False, True):
        kwm = dict(kw, emit_mac=emit_mac)
        want = with_epilogue_plan(fused_step.CELL, lambda: K["B5"].wrapper(*args, **kwm))
        for label, pl in plans.items():
            row = out.setdefault(label, dict(plan=list(pl), **b5_instance(pl.form, bf16, ptxas)))

            def fn(pl=pl):
                return with_epilogue_plan(pl, lambda: K["B5"].wrapper(*args, **kwm))

            got = fn()
            torch.cuda.synchronize()
            check(all(torch.equal(a, b) for a, b in zip(flat(got), flat(want), strict=True)),
                  f"B5 at {res} emit_mac={emit_mac} under the {label} plan differs from the "
                  "cell plan")
            del got
            if emit_mac:
                time_cuda(fn, 5)  # warm: the first plan timed read high without it
                row["emit_mac launches"] = launch_split([fused_step], fn, reps=10)
        del want
        torch.cuda.empty_cache()
    return out


def phase_epilogue_plans(dev, card, ptxas=None):
    """B5 at the inputs that the epilogue steady state's next step gives it
    on the Rosensweig scene at 256^3 (mag 85, bench.py's) and at the native
    130x66x130, in float32 and in bfloat16 storage, without and with
    ``emit_mac`` (then the prologue's launch): the stage form with strips
    of 1 to 64 planes and the cell plan, each held bit for bit to
    the plan ``plan`` chooses (the per-cell arithmetic is the same) and
    timed with CUDA events over 20 calls after warm calls of its own; the
    chosen plan also against its plain version.  ``MAX_STRIP`` and
    ``STRIP_START`` of ``ops/kernels/fused_step.py`` were chosen from it."""
    import torch

    from lbm_ferrofluid_tpu_torch.models import rosensweig_3d
    from lbm_ferrofluid_tpu_torch.ops import kernels as kernels_pkg
    from lbm_ferrofluid_tpu_torch.ops.kernels import fused_step

    K = kernels_pkg.KERNELS
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    for res, extra in (((256, 256, 256), dict(mag_strength=85.0)), ((130, 66, 130), {})):
        Z = res[0]
        params, st = rosensweig_3d(res=res, device=dev, **extra)
        for bf16 in (False, True):
            p, s = turbo(params, st, dev) if bf16 else (params, st)
            d = epilogue_inputs(K, p, epilogue_state(p, dev)(s, False))
            args, kw = epilogue_call(K, p, d, False)
            del d, s
            out = {"phase": "epilogue_plans", "res": list(res),
                   "storage": "bfloat16" if bf16 else "float32", "card": card,
                   "instances": {form: b5_instance(form, bf16, ptxas)
                                 for form in fused_step.FORMS}}
            for emit_mac in (False, True):
                kwm = dict(kw, emit_mac=emit_mac)
                chosen = fused_step.plan(*res, sms, bf16)

                def run(pl):
                    return with_epilogue_plan(pl, lambda: K["B5"].wrapper(*args, **kwm))

                want = run(chosen)
                against_plain = (bf16_rows if bf16 else lambda *a: run_and_compare(*a)[1])(
                    K, "B5", args, kwm, f"B5 chosen plan at {res}")
                candidates = [fused_step.EpiloguePlan("stage", zb)
                              for zb in sorted({1, 2, 4, 8, 16, 32, 64, chosen.zb}
                                               & set(range(1, Z + 1)))]
                candidates.append(fused_step.CELL)
                rows = []
                for pl in candidates:
                    got = run(pl)
                    torch.cuda.synchronize()
                    check(all(torch.equal(a, b) for a, b in zip(flat(got), flat(want),
                                                                 strict=True)),
                          f"B5 at {res} emit_mac={emit_mac} under plan {tuple(pl)} differs "
                          f"from the chosen plan {tuple(chosen)}")
                    del got
                    rows.append(dict(plan=list(pl), ms=time_cuda(lambda: run(pl), 20, warm=3)))
                out[f"emit_mac={emit_mac}"] = {
                    "chosen": list(chosen),
                    "chosen_ms": time_cuda(lambda: run(chosen), 20, warm=3),
                    "chosen_against_plain": against_plain,
                    "best_stage": min((r for r in rows if r["plan"][0] == "stage"),
                                      key=lambda r: r["ms"]),
                    "cell_ms": next(r["ms"] for r in rows if r["plan"][0] == "cell"),
                    "plans": rows}
                del want
                torch.cuda.empty_cache()
            emit(dict(out, ok=True))
            del args, kw
            torch.cuda.empty_cache()
        del st


def b6_plan_report(pl, ptxas=None):
    """B6's plan with the resident blocks an SM and the ptxas line of its
    kernel without and with H2."""
    return dict(tile=[pl.tx, pl.ty], zb=pl.zb, **{
        f"h2={h2}": dict(
            blocks_per_sm=blocks_per_sm("lbm_capmac_occupancy", pl.tx, pl.ty, h2),
            ptxas=(ptxas or {}).get(f"lbm_capmac_kernel<{pl.tx},{pl.ty},{h2}>"))
        for h2 in (0, 1)})


def phase_hcz_flagship(dev, K, card, ptxas=None):
    """``multiphase_3d`` at 256^3: MLUPS and peak memory over warm steps,
    then each HCZ kernel at the inputs the next step gives it (B2 and B6
    launch by launch, B6 with its plan), the capillary stage's stencil
    route (B10b, B10a) on the same inputs, and B2, B6 and the stencil route
    again with an obstacle block across B6's first tile edge and z seam."""
    import torch

    from lbm_ferrofluid_tpu_torch.models import SimulationRunner, hcz_step, multiphase_3d
    from lbm_ferrofluid_tpu_torch.ops.kernels import capmac, contact3d, hcz_capillary_stencils
    from lbm_ferrofluid_tpu_torch.ops.moments import rho_to_density

    params, st = multiphase_3d(res=(256, 256, 256), device=dev)
    runner = SimulationRunner(params, hcz_step, device=dev)
    torch.cuda.reset_peak_memory_stats()
    st, stats = runner.benchmark(st, n_steps=30, warmup=20)
    peak = torch.cuda.max_memory_allocated()
    rng = np.random.default_rng(5)
    h2 = 1e4 * (1 + 0.1 * rng.uniform(-1, 1, tuple(st.rho.shape)).astype(np.float32))
    d = dict(flags=st.flags, f=st.f, g=st.g, rho_old=st.rho, vel_old=st.vel,
             pres=st.pressure, H2=torch.as_tensor(h2, device=dev))
    per_call = {"B8b": 1, "B8a": 1, "B2": K["B2"].module.N_LAUNCHES,
                "B6": K["B6"].module.N_LAUNCHES, "B9": 1}
    out, errs, calls = {}, {}, {}

    def record(label, kid, args, kw):
        calls[label] = (args, kw)
        if label != kid:  # B6 with H2: errors only, the step runs without it
            got, r = run_and_compare(K, kid, args, kw, f"{label} at 256^3")
            errs[label] = max(v["max_abs_err"] for v in r.values())
            return got
        out[kid] = measure(K, kid, args, kw, per_call[kid], per_call[kid],
                           f"{kid} at 256^3")
        return K[kid].wrapper(*args, **kw)

    ctx = hcz_chain(K, params, d, record)
    for kid, mod in (("B2", contact3d), ("B6", capmac)):
        out[kid]["split"] = launch_split(
            [mod], lambda kid=kid: K[kid].wrapper(*calls[kid][0], **calls[kid][1]), reps=10)
    args, kw = calls["B6 with H2"]
    out["B6"]["ms_with_h2"] = time_cuda(lambda: K["B6"].wrapper(*args, **kw), reps=10)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    out["B6"]["plan"] = b6_plan_report(capmac.plan(256, 256, 256, sms), ptxas)
    # the stencil route on the same inputs: B10b alone, then the route
    # against its plain version and against B6's outputs, and its time
    den_ca = rho_to_density(ctx["rho_ca"], rho_gas=params.rho_gas, rho_fluid=params.rho_fluid,
                            density_gas=params.density_gas, density_fluid=params.density_fluid)
    out["B10b"] = measure(K, "B10b", (den_ca,), dict(dx=params.dx), 1, 1, "B10b at 256^3")
    out["B10b"]["conv3d_pad"] = conv3d_pad("B10b", den_ca, params.dx)
    out["B10b"]["plan"] = stencil_plan_report(den_ca.shape[2:], 0, ptxas)
    # B10a on the route's stack: N = 3 without H2, 4 with it
    for kelvin in (False, True):
        stack = stencil_stack(params, d, ctx, kelvin)
        n = stack.shape[1]
        per_call = K["B10a"].module.launches_per_call(n)
        out[f"B10a N={n}"] = dict(
            measure(K, "B10a", (stack,), dict(dx=params.dx), per_call, per_call,
                    f"B10a N={n} at 256^3"),
            conv3d_pad=conv3d_pad("B10a", stack, params.dx),
            plan=stencil_plan_report(stack.shape[2:], n, ptxas))
        del stack
    route = stencil_route_rows(params, d, ctx, "at 256^3")
    errs["stencil route"] = max(v["max_abs_err"] for r in route.values() for rr in r.values()
                                for v in rr.values())
    gravity = torch.tensor(params.gravity_vec(), dtype=torch.float32, device=dev)
    route_ms = time_cuda(lambda: hcz_capillary_stencils(
        ctx["rho"], ctx["vel"], d["flags"], ctx["den"], d["pres"], ctx["rho_ca"],
        g=ctx["g_post"], kappa=params.kappa, gravity=gravity.reshape(1, 3, 1, 1, 1),
        dx=params.dx, dt=params.dt, rho_gas=params.rho_gas, rho_fluid=params.rho_fluid,
        density_gas=params.density_gas, density_fluid=params.density_fluid), reps=10)
    del ctx, calls, args, kw
    torch.cuda.empty_cache()
    # errors only: the chain and the stencil route with B6's seam block
    seam = {}

    def seam_record(label, kid, args, kw):
        got, r = run_and_compare(K, kid, args, kw, f"{label} at 256^3 with the seam block")
        seam[label] = max(v["max_abs_err"] for v in r.values())
        return got

    ds = dict(d, flags=capillary_seam_block(d["flags"]))
    ctx = hcz_chain(K, params, ds, seam_record)
    route_seam = stencil_route_rows(params, ds, ctx, "at 256^3 with the seam block")
    seam["stencil route"] = max(v["max_abs_err"] for r in route_seam.values()
                                for rr in r.values() for v in rr.values())
    emit({"phase": "hcz_flagship", "scene": "multiphase_3d", "res": [256, 256, 256],
          "mlups": stats["mlups"], "seconds_30_steps": stats["seconds"],
          "peak_mem_gb": peak / 1e9, "card": card, "per_kernel": out,
          "stencil_route": {"ms_moments_from_g": route_ms, "checks": route},
          "other_checks_max_abs_err": errs, "seam_block_max_abs_err": seam, "ok": True})
    out["B6"]["max_abs_err"] = max(out["B6"]["max_abs_err"], errs["B6 with H2"], seam["B6"],
                                   seam["B6 with H2"])
    out["B2"]["max_abs_err"] = max(out["B2"]["max_abs_err"], seam["B2"])
    return out


def phase_capillary_plans(dev, card, ptxas=None):
    """B6 on the HCZ ``multiphase_3d`` scene at 256^3 and 130^3 (inputs from
    three warm steps, then B8b, B8a and B2 as the step gives them), without
    and with H2, under every tile ``TILES`` builds and strips of 1 to 64
    planes, each held bit for bit to the plan ``plan`` chooses (the
    per-cell arithmetic is the same) and timed with CUDA events: the data
    ``TILE`` and ``STRIP_START`` of ``ops/kernels/capmac.py`` were chosen
    from.  The chosen plan is also held to the plain version at the phase
    3 bars."""
    import torch

    from lbm_ferrofluid_tpu_torch.models import hcz_step, multiphase_3d
    from lbm_ferrofluid_tpu_torch.ops import kernels as kernels_pkg
    from lbm_ferrofluid_tpu_torch.ops.kernels import capmac
    from lbm_ferrofluid_tpu_torch.ops.moments import phi_from_density

    K = kernels_pkg.KERNELS
    for res in ((256, 256, 256), (130, 130, 130)):
        Z, Y, X = res
        params, st = multiphase_3d(res=res, device=dev)
        for _ in range(3):
            st = hcz_step(params, st, device=dev)
        gas = dict(rho_gas=params.rho_gas, rho_fluid=params.rho_fluid,
                   density_gas=params.density_gas, density_fluid=params.density_fluid)
        _, rho, vel, den = K["B8b"].wrapper(st.f, st.flags, st.rho, st.vel,
                                            c=params.dx / params.dt, **gas)
        _, m0g, m1g = K["B8a"].wrapper(st.g, st.flags)
        rho_ca = K["B2"].wrapper(rho, st.flags, params.contact_angle)
        rng = np.random.default_rng(8)
        H2 = torch.as_tensor(
            1e4 * (1 + 0.1 * rng.uniform(-1, 1, tuple(rho.shape)).astype(np.float32)), device=dev)
        phi = phi_from_density(den, params.density_gas, params.density_fluid)
        kw = dict(kappa=params.kappa, dx=params.dx, dt=params.dt,
                  gravity=tuple(float(v) for v in params.gravity_vec().reshape(-1)), **gas)
        chosen = capmac.plan(*res, torch.cuda.get_device_properties(0).multi_processor_count)
        out = {"phase": "capillary_plans", "res": list(res), "card": card,
               "chosen": b6_plan_report(chosen, ptxas)}
        for label, h2, ph in (("without H2", None, None), ("with H2", H2, phi)):
            args = (rho, den, st.pressure, rho_ca, h2, ph, st.flags, m0g, m1g, vel)
            want = capmac.hcz_capillary_gradmac(*args, **kw)
            against_plain = run_and_compare(K, "B6", args, kw, f"B6 {label} at {res}")[1]
            rows, real = [], capmac.plan
            try:
                for tx, ty in capmac.TILES:
                    for zb in sorted({1, 2, 4, 8, 16, 32, 64, chosen.zb} & set(range(1, Z + 1))):
                        pl = capmac.CapPlan(tx, ty, zb)
                        capmac.plan = lambda *a, pl=pl: pl
                        got = capmac.hcz_capillary_gradmac(*args, **kw)
                        check(all(torch.equal(a, b) for a, b in zip(got, want)),
                              f"B6 {label} under plan {pl} differs from the chosen plan {chosen}")
                        rows.append(dict(tile=[tx, ty], zb=zb, ms=time_cuda(
                            lambda: capmac.hcz_capillary_gradmac(*args, **kw), 5)))
            finally:
                capmac.plan = real
            out[label] = {"chosen_ms": time_cuda(
                lambda: capmac.hcz_capillary_gradmac(*args, **kw), 5),
                "chosen_against_plain": against_plain,
                "best": min(rows, key=lambda r: r["ms"]), "plans": rows}
        emit(dict(out, ok=True))
        del st, rho, vel, den, rho_ca, H2, phi, m0g, m1g, want, args
        torch.cuda.empty_cache()


def phase_stencil_plans(dev, card, ptxas=None):
    """B10a (N = 1, 3 and 4) and B10b on the HCZ ``multiphase_3d`` scene
    at 256^3 and 130x66x130 (three warm steps, then B8b and B2 as the step
    gives them, and the stencil route's stacks [lap, fai, prho] and, with
    chi, of 4 fields; N = 1 takes the first field), under every tile
    ``TILES`` builds for it and strips of 1 to 64 planes, each held bit for
    bit to the plan ``plan`` chooses (the per-cell arithmetic is the same)
    and timed with CUDA events over 20 calls: the data ``SHAPES`` and
    ``STRIP_START`` of ``ops/kernels/stencil3d.py`` were chosen from.  The
    chosen plan is also held to the plain version at the phase 3 bars."""
    import torch

    from lbm_ferrofluid_tpu_torch.models import hcz_step, multiphase_3d
    from lbm_ferrofluid_tpu_torch.ops import kernels as kernels_pkg
    from lbm_ferrofluid_tpu_torch.ops.kernels import stencil3d
    from lbm_ferrofluid_tpu_torch.ops.moments import phi_from_density, rho_to_density

    K = kernels_pkg.KERNELS
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    for res in ((256, 256, 256), (130, 66, 130)):
        Z = res[0]
        params, st = multiphase_3d(res=res, device=dev)
        for _ in range(3):
            st = hcz_step(params, st, device=dev)
        gas = dict(rho_gas=params.rho_gas, rho_fluid=params.rho_fluid,
                   density_gas=params.density_gas, density_fluid=params.density_fluid)
        _, rho, _, den = K["B8b"].wrapper(st.f, st.flags, st.rho, st.vel,
                                          c=params.dx / params.dt, **gas)
        rho_ca = K["B2"].wrapper(rho, st.flags, params.contact_angle)
        ctx = dict(rho=rho, den=den, rho_ca=rho_ca,
                   phi=phi_from_density(den, params.density_gas, params.density_fluid))
        stack = stencil_stack(params, dict(pres=st.pressure, flags=st.flags), ctx, kelvin=True)
        del st, ctx
        out = {"phase": "stencil_plans", "res": list(res), "card": card}
        for label, kid, x, n in (("B10a N=1", "B10a", stack[:, :1].contiguous(), 1),
                                 ("B10a N=3", "B10a", stack[:, :3].contiguous(), 3),
                                 ("B10a N=4", "B10a", stack, 4),
                                 ("B10b", "B10b", rho_to_density(rho_ca, **gas), 0)):
            fn = K[kid].wrapper
            want = fn(x, dx=params.dx)
            against_plain = run_and_compare(K, kid, (x,), dict(dx=params.dx),
                                            f"{label} chosen plan at {res}")[1]
            rows, real = [], stencil3d.plan
            chosen = real(*res, sms, max(n, 1), laplacian=n == 0)
            try:
                for tx, ty in [t[:2] for t in stencil3d.TILES
                               if stencil3d.fits(*t[:2], max(n, 1))]:
                    for zb in sorted({1, 2, 4, 8, 16, 32, 64, chosen.zb} & set(range(1, Z + 1))):
                        pl = stencil3d.StencilPlan(tx, ty, zb)
                        stencil3d.plan = lambda *a, pl=pl, **_: pl
                        check(torch.equal(fn(x, dx=params.dx), want),
                              f"{label} under plan {pl} differs from the chosen plan")
                        rows.append(dict(tile=[tx, ty], zb=zb, ms=time_cuda(
                            lambda: fn(x, dx=params.dx), 20)))
            finally:
                stencil3d.plan = real
            out[label] = {"chosen": stencil_plan_report(res, n, ptxas),
                          "chosen_ms": time_cuda(lambda: fn(x, dx=params.dx), 20),
                          "chosen_against_plain": against_plain,
                          "best": min(rows, key=lambda r: r["ms"]), "plans": rows}
            del want
        out["blocks_per_sm"] = {
            f"{tx}x{ty} N={n}": [blocks_per_sm("lbm_stencil_occupancy", tx, ty, max(n, 1),
                                               int(n == 0)),
                                 stencil3d.blocks_per_sm(tx, ty, max(n, 1), n == 0)]
            for tx, ty, _ in stencil3d.TILES for n in (0, 1, 2, 3, 4)
            if stencil3d.fits(tx, ty, max(n, 1))}
        emit(dict(out, ok=True))
        del stack, rho, den, rho_ca
        torch.cuda.empty_cache()


def phase_scalar_plans(dev, card, slab_only=False):
    """B1 on the primed Rosensweig scene at 256^3 and 130x66x130 under the
    plans its pass kernel takes (k = 1..6, tile heights in steps of 4, z
    chunk counts from 1 to 32 and the count that fills the card once), each
    held bit for bit to the plan ``plan`` chooses (the per-cell arithmetic
    is the same) and timed with CUDA events: the data ``K`` and ``TY`` of
    ``ops/kernels/scalar_poisson.py`` were chosen from.  Then B1's slab
    solve on one rank with ``slab=True`` under every round length k that
    divides the sweeps (G = k + 1 <= Zl), each bit for bit to the chosen
    one and timed in turns: the data ``parallel/step3d.py:ROUND_CELL_SWEEPS``
    was chosen from (``slab_only``: this part alone, ``--scalar-slab-plans``)."""
    import torch

    from lbm_ferrofluid_tpu_torch.models import prime_premac, rosensweig_3d
    from lbm_ferrofluid_tpu_torch.ops.kernels import scalar_poisson as sp
    from lbm_ferrofluid_tpu_torch.parallel import make_mesh, step3d

    for res in ((256, 256, 256), (130, 66, 130)):
        Z, Y, X = res
        params, st = rosensweig_3d(res=res, mag_strength=85.0, device=dev)
        st = prime_premac(params, st, device=dev)
        n = params.poisson_iters
        h_ext = tuple(params.mag_strength if a == params.h_ext_axis else 0.0 for a in range(3))
        args, kw = (st.h, st.cmask, st.premac[5]), dict(n_iters=n, dx=params.dx, h_ext=h_ext)
        sms = torch.cuda.get_device_properties(0).multi_processor_count
        chosen = sp.plan(*res, n, sms)
        want = sp.scalar_wavefront(*args, **kw)
        rows, real = [], sp.plan
        try:
            for k in range(1, 1 if slab_only else sp.MAX_K + 1):
                for ty in range(sp.ROWS, sp.MAX_EXT_HEIGHT - 2 * k + 1, sp.ROWS):
                    if sp.smem_bytes(k, ty) > sp.SMEM_BLOCK_MAX:
                        continue
                    tiles = -(-X // (sp.EXT_WIDTH - 2 * k)) * -(-Y // ty)
                    fill = max(1, 2 * sms // tiles)
                    for chunks in sorted({1, 2, 4, 8, 12, 16, 24, 32, fill} & set(range(1, Z + 1))):
                        pl = sp.ScalarPlan(k, ty, -(-Z // chunks),
                                           (k,) * (n // k) + ((n % k,) if n % k else ()))
                        sp.plan = lambda *a, pl=pl, **_: pl
                        got = sp.scalar_wavefront(*args, **kw)
                        check(all(torch.equal(a, b) for a, b in zip(got, want)),
                              f"B1 under plan {pl} differs from the chosen plan {chosen}")
                        rows.append(dict(k=k, ty=ty, lz=pl.lz, smem_bytes=sp.smem_bytes(k, ty),
                                         ms=time_cuda(lambda: sp.scalar_wavefront(*args, **kw), 5)))
        finally:
            sp.plan = real
        if rows:
            emit({"phase": "scalar_plans", "res": list(res), "n_iters": n, "card": card,
                  "chosen": dict(k=chosen.k, ty=chosen.ty, lz=chosen.lz,
                                 ms=time_cuda(lambda: sp.scalar_wavefront(*args, **kw), 5)),
                  "best": min(rows, key=lambda r: r["ms"]), "plans": rows, "ok": True})
        del want
        mesh, real = make_mesh(slab=True), step3d.scalar_slab_plan
        chosen = real(mesh, st.h.shape, n)

        def slab_solve():
            return step3d.scalar_poisson_sharded(*args, mesh, **kw)

        want = slab_solve()
        one = sp.scalar_wavefront(*args, **kw)[::-1]

        def in_rounds(k):
            """The slab solve in rounds of k (G = k + 1)."""
            step3d.scalar_slab_plan = lambda *a, k=k: (k, k + 1)
            try:
                return slab_solve()
            finally:
                step3d.scalar_slab_plan = real

        ks, errs = [k for k in range(2, n + 1) if n % k == 0 and k < st.h.shape[2]], {}
        for k in ks:
            got = in_rounds(k)
            check(all(torch.equal(a, b) for a, b in zip(got, want)),
                  f"B1 slab solve in rounds of {k} differs from rounds of {chosen[0]}")
            check(all(torch.equal(a, b) for a, b in zip(got, one)),
                  f"B1 slab solve in rounds of {k} differs from the single-device call")
            err = compare(f"B1 slab solve in rounds of {k}", ["H2", "s2"], got,
                          step3d.scalar_poisson_sharded(*args, mesh, plain=True, **kw))
            errs[k] = {m: e["max_abs_err"] for m, e in err.items()}
            del got
        turns = time_in_turns({k: (lambda k=k: in_rounds(k)) for k in ks}, 5)
        rows = [dict(k=k, rounds=n // k, ms=float(np.median(turns[k])), ms_turns=turns[k],
                     faster_than_chosen_in_every_turn=all(
                         a < b for a, b in zip(turns[k], turns[chosen[0]])),
                     max_abs_err=errs[k]) for k in ks]
        emit({"phase": "scalar_slab_plans", "res": list(res), "n_iters": n, "card": card,
              "fit": scalar_slab_fit(res, n, rows),
              "chosen": dict(k=chosen[0], ms=time_cuda(slab_solve, 5)),
              "single_device_ms": time_cuda(lambda: sp.scalar_wavefront(*args, **kw), 5),
              "best": min(rows, key=lambda r: r["ms"]), "rounds": rows, "ok": True})
        del st, args, want
        torch.cuda.empty_cache()


def scalar_slab_fit(res, n, rows):
    """``step3d.ROUND_CELL_SWEEPS`` fitted to B1's slab solves' median ms
    at every k of one grid (``rows``): by least squares ms = c0 + c1 n / k +
    c2 2 n (k + 1) Y X, the model of ``scalar_slab_plan`` (a round's own
    cost beside the ghost planes' cell-sweeps), whose round cost in
    cell-sweeps is c1 / c2; with the k it chooses there."""
    _, Y, X = res
    a = np.asarray([[1.0, n // r["k"], 2 * n * (r["k"] + 1) * Y * X] for r in rows])
    c = np.linalg.lstsq(a, np.asarray([r["ms"] * 1e6 for r in rows]), rcond=None)[0]
    sweeps = float(c[1] / c[2])
    return dict(round_cell_sweeps=sweeps, chosen_by_fit=min(
        (r["k"] for r in rows), key=lambda k: n // k * sweeps + 2 * n * (k + 1) * Y * X))


def phase_small_grid(dev, kernels_pkg):
    """A grid with an axis of 3 cells: the kernel route refuses it on the
    card and names ``plain=True``; the plain versions step it (one HCZ
    step, one un-carried ferrofluid step), launching nothing."""
    import torch

    from lbm_ferrofluid_tpu_torch.models import (
        ferrofluid_step, hcz_step, multiphase_3d, rosensweig_3d,
    )
    from lbm_ferrofluid_tpu_torch.models.runner import assert_finite

    res = (3, 8, 16)
    kernels_pkg.reset_launch_counts()
    out = {"phase": "small_grid", "res": list(res)}
    for name, build, step in (("hcz_step", multiphase_3d, hcz_step),
                              ("ferrofluid_step", rosensweig_3d, ferrofluid_step)):
        params, st = build(res=res, device=dev)
        try:
            step(params, st, device=dev)
            refused = None
        except ValueError as e:
            refused = str(e)
        check(refused is not None and "plain=True" in refused,
              f"{name} on {res}: the kernel route did not refuse the grid ({refused})")
        nxt = step(params, st, device=dev, plain=True)
        torch.cuda.synchronize()
        assert_finite(nxt, fields=vars(nxt))
        out[name] = {"kernel_route": refused, "plain_step_finite": True}
    check(not any(kernels_pkg.launch_counts().values()),
          f"small grid: kernels launched {kernels_pkg.launch_counts()}")
    emit(dict(out, ok=True))


def phase_poisson_plans(dev, card):
    """B11b on the channel-form Rosensweig scene at 256^3 and 130x66x130
    (three warm steps from the scene, so h is no longer zero), with h in
    float32 and rounded to bfloat16, under the plans its pass kernel is
    built for (k = 1..4, tile heights up to the shared memory limit, z
    chunk counts from 1 to 32 and the count that fills the card once), each
    held bit for bit to the plan ``plan`` chooses (the per-cell arithmetic
    is the same) and timed with CUDA events: the data ``K`` and ``TY`` of
    ``ops/kernels/poisson.py`` were chosen from.  The chosen plan is also
    held to the plain version at the phase 3 bars (bit for bit at
    bfloat16)."""
    import torch

    from lbm_ferrofluid_tpu_torch.models import ferrofluid_step, prime_premac, rosensweig_3d
    from lbm_ferrofluid_tpu_torch.ops import kernels as kernels_pkg
    from lbm_ferrofluid_tpu_torch.ops.kernels import poisson as pp

    heights = POISSON_PLAN_HEIGHTS
    for res in ((256, 256, 256), (130, 66, 130)):
        Z, Y, X = res
        params, st = rosensweig_3d(res=res, mag_strength=85.0, device=dev)
        params = params.replace(scalar_carry=False)
        st = prime_premac(params, st, device=dev)
        for _ in range(3):
            st = ferrofluid_step(params, st, device=dev)
        n = params.poisson_iters
        sms = torch.cuda.get_device_properties(0).multi_processor_count
        for storage in (torch.float32, torch.bfloat16):
            bf16 = storage == torch.bfloat16
            elem = 2 if bf16 else 4
            args = (st.h.to(storage), st.magnetic_flags, st.premac[5])
            kw = dict(tau=params.tau, n_iters=n)
            chosen = pp.plan(*res, n, sms, elem)
            want = pp.poisson_sweeps(*args, **kw)
            K = kernels_pkg.KERNELS
            against_plain = (bf16_rows if bf16 else lambda *a: run_and_compare(*a)[1])(
                K, "B11b", args, kw, f"B11b chosen plan at {res} in {storage}")
            rows, real = [], pp.plan
            try:
                for k, tys in heights.items():
                    for ty in tys:
                        if pp.smem_bytes(k, ty, elem) > pp.SMEM_BLOCK_MAX:
                            continue
                        tiles = -(-X // pp.tile_width(k)) * -(-Y // ty)
                        fill = max(1, sms // tiles)
                        for chunks in sorted({1, 2, 4, 8, 12, 16, 24, 32, fill}
                                             & set(range(1, Z + 1))):
                            pl = pp.PoissonPlan(k, ty, -(-Z // chunks), pp.passes(n, k))
                            pp.plan = lambda *a, pl=pl, **_: pl
                            got = pp.poisson_sweeps(*args, **kw)
                            check(all(torch.equal(a, b) for a, b in zip(got, want)),
                                  f"B11b ({storage}) under plan {pl} differs from the chosen "
                                  f"plan {chosen}")
                            rows.append(dict(
                                k=k, ty=ty, lz=pl.lz, smem_bytes=pp.smem_bytes(k, ty, elem),
                                blocks_per_sm=blocks_per_sm("lbm_poisson_pass_occupancy", k, ty,
                                                            1, int(bf16), 0),
                                ms=time_cuda(lambda: pp.poisson_sweeps(*args, **kw), 5)))
            finally:
                pp.plan = real
            emit({"phase": "poisson_plans", "res": list(res), "n_iters": n,
                  "storage": str(storage), "card": card,
                  "chosen": dict(k=chosen.k, ty=chosen.ty, lz=chosen.lz,
                                 ms=time_cuda(lambda: pp.poisson_sweeps(*args, **kw), 5)),
                  "chosen_against_plain": against_plain,
                  "best": min(rows, key=lambda r: r["ms"]), "plans": rows, "ok": True})
            del args, want
        del st
        torch.cuda.empty_cache()


def phase_channel_slab_plans(dev, card):
    """B11b's slab solve (``parallel/step3d.py:poisson_sweeps_sharded``) on
    one rank with ``slab=True``, on the channel-form Rosensweig scene at
    256^3 and 130x66x130 (three warm steps, so h is no longer zero), h in
    float32 and bfloat16, in rounds of every k of 1..``MAX_K`` (G = k, the
    remainder round on the same bands), each bit for bit to the chosen
    plan's and timed with CUDA events beside the single-device call: the
    data ``CHANNEL_ROUND_NS`` and ``CHANNEL_PASS_NS`` of ``step3d`` were
    chosen from."""
    import torch

    from lbm_ferrofluid_tpu_torch.models import ferrofluid_step, prime_premac, rosensweig_3d
    from lbm_ferrofluid_tpu_torch.ops.kernels import poisson as pp
    from lbm_ferrofluid_tpu_torch.parallel import make_mesh, step3d

    mesh = make_mesh(slab=True)
    fits = []
    for res in ((256, 256, 256), (130, 66, 130)):
        params, st = rosensweig_3d(res=res, mag_strength=85.0, device=dev)
        params = params.replace(**CHANNEL)
        st = prime_premac(params, st, device=dev)
        for _ in range(3):
            st = ferrofluid_step(params, st, device=dev)
        n, real = params.poisson_iters, step3d.channel_slab_plan
        for storage in (torch.float32, torch.bfloat16):
            args = (st.h.to(storage), st.magnetic_flags, st.premac[5])
            kw = dict(tau=params.tau, n_iters=n)
            chosen = real(mesh, args[0].shape, n)

            def solve():
                return step3d.poisson_sweeps_sharded(*args, mesh, **kw)

            want = solve()

            def in_rounds(k):
                """The solve in rounds of k (G = k, the remainder on the same bands)."""
                step3d.channel_slab_plan = lambda *a, k=k: (k, k, n % k)
                try:
                    return solve()
                finally:
                    step3d.channel_slab_plan = real

            ks = range(1, pp.MAX_K + 1)
            for k in ks:
                check(all(torch.equal(a, b) for a, b in zip(in_rounds(k), want)),
                      f"B11b slab solve in rounds of {k} differs from rounds of {chosen[0]}")
            turns = time_in_turns({k: (lambda k=k: in_rounds(k)) for k in ks}, 5)
            rows = [dict(k=k, rounds=-(-n // k), ms=float(np.median(turns[k])), ms_turns=turns[k],
                         faster_than_chosen_in_every_turn=all(
                             a < b for a, b in zip(turns[k], turns[chosen[0]])))
                    for k in ks]
            if storage == torch.float32:
                fits.append((res, n, rows))
            emit({"phase": "channel_slab_plans", "res": list(res), "n_iters": n,
                  "storage": str(storage), "card": card,
                  "chosen": dict(k=chosen[0], remainder=chosen[2], ms=time_cuda(solve, 5)),
                  "single_device_ms": time_cuda(lambda: pp.poisson_sweeps(*args, **kw), 5),
                  "best": min(rows, key=lambda r: r["ms"]), "rounds": rows, "ok": True})
            del args, want
        del st
        torch.cuda.empty_cache()
    emit(dict(channel_slab_fit(fits), phase="channel_slab_fit", card=card, ok=True))


def channel_slab_fit(fits):
    """``step3d``'s ``CHANNEL_ROUND_NS`` and ``CHANNEL_PASS_NS`` fitted by
    least squares to the float32 slab solves' median ms at every k of both
    grids (``fits``: (res, n_iters, rows)), the model of
    ``channel_slab_plan``'s cost: ceil(n / k) rounds of a fixed cost, n // k
    walks of (Zl + 2k - 2) Y X cells at k's cost a cell and the remainder's
    walk; with the k that the fitted constants and the current ones choose
    at each grid."""
    from lbm_ferrofluid_tpu_torch.parallel import step3d

    ks = sorted({r["k"] for _, _, rows in fits for r in rows})
    a, b = [], []
    for (Zl, Y, X), n, rows in fits:
        for r in rows:
            k = r["k"]
            line = [0.0] * (1 + len(ks))
            line[0] = -(-n // k)
            line[1 + ks.index(k)] += n // k * (Zl + 2 * k - 2) * Y * X
            if n % k:
                line[1 + ks.index(n % k)] += (Zl + 2 * (n % k) - 2) * Y * X
            a.append(line)
            b.append(r["ms"] * 1e6)
    sol = np.linalg.lstsq(np.asarray(a), np.asarray(b), rcond=None)[0]
    fitted = dict(round_ns=float(sol[0]), pass_ns={k: float(v) for k, v in zip(ks, sol[1:])})

    def chosen(res, n, round_ns, pass_ns):
        Zl, Y, X = res

        def walk(k):
            return (Zl + 2 * k - 2) * Y * X * pass_ns[k]

        return min(ks, key=lambda k: -(-n // k) * round_ns + n // k * walk(k)
                   + (walk(n % k) if n % k else 0))

    return dict(fitted, residual_ms=[float(v) for v in (np.asarray(a) @ sol - b) / 1e6],
                chosen_by_fit={"x".join(map(str, res)): chosen(res, n, sol[0], fitted["pass_ns"])
                               for res, n, _ in fits},
                chosen_now={"x".join(map(str, res)): chosen(res, n, step3d.CHANNEL_ROUND_NS,
                                                            step3d.CHANNEL_PASS_NS)
                            for res, n, _ in fits})


def time_in_turns(fns, reps):
    """ms a call of each of ``fns`` (key -> callable), timed with CUDA events
    (``reps`` calls) in 4 turns: the keys in order, reversed, in order,
    reversed; {key: [ms of each turn]}."""
    keys, out = list(fns), {key: [] for key in fns}
    for turn in range(4):
        for key in keys if turn % 2 == 0 else keys[::-1]:
            out[key].append(time_cuda(fns[key], reps))
    return out


# ---------------------------------------------------------------- bfloat16 storage
#: share of a bfloat16 output's elements that may be one ulp apart from the
#: plain version's (the float32 values before rounding straddle a rounding
#: point where FMA contraction and sum order move them by an ulp of float32)
BF16_SHARE = 2e-3
#: bars of a bfloat16 path (tests/test_bf16_h.py, tests/test_bf16_physics.py):
#: max |density difference| over max|density| against plain through the
#: initial transient; the fluid mass and the mean level of the dense phase
#: (in cells) beyond it and against float32, since bfloat16 storage itself moves
#: the interface: after 30 steps of the Rosensweig scene at 16x66x16 the JAX
#: package's own bfloat16 run lies 5.0e-3 of max|density| from its float32
#: run, and the port's 5.1e-3 (tests/test_torch_bf16_slice.py, on the CPU),
#: where 3 steps give 2.3e-3, and the distance grows with the grid's width
BF16_DENSITY, BF16_MASS, BF16_LEVEL = 5e-3, 5e-3, 1.0


def turbo(params, state, dev, h="bfloat16"):
    """``params`` with f and g stored in bfloat16 and h in ``h`` (the JAX
    package's turbo mode), and the scene's initial state built again by
    the init entry point in that storage (which rounds f, g and h as JAX's
    ``astype`` does)."""
    from lbm_ferrofluid_tpu_torch.models import init_ferrofluid_state, init_hcz_state

    p = params.replace(fg_dtype="bfloat16", h_dtype=h)
    if hasattr(state, "h"):
        return p, init_ferrofluid_state(p, state.rho, state.density, state.vel, state.flags,
                                        state.magnetic_flags, device=dev)
    return p, init_hcz_state(p, state.rho, state.density, state.vel, state.flags,
                             state.vel_pin_mask, state.vel_pin_value, device=dev)


def compare_bf16(what, names, got, want):
    """Per-field errors of bfloat16 outputs: each element equal to the
    plain version's or one bfloat16 ulp (of the larger magnitude) apart, in
    at most ``BF16_SHARE`` of the elements; raises otherwise.  An element
    may be more than one ulp apart only where the difference is within the
    float32 bar (``BAR_REL`` of the field's max): a collided value that
    cancels to a millionth of the field's scale (an f' of 6e-8 among values
    of 1e-2) keeps the float32 kernel-vs-plain difference (there 1.5 % of
    the value before rounding), which spans several of its own ulps."""
    import torch

    rows = {}
    for field, a, b in zip(names, flat(got), flat(want), strict=True):
        check(a.dtype == b.dtype == torch.bfloat16, f"{what} {field}: {a.dtype}, {b.dtype}")
        check(bool(torch.isfinite(a).all()), f"{what} {field}: non-finite values")
        differ = a.view(torch.int16) != b.view(torch.int16)
        a64, b64 = a.double(), b.double()
        big = torch.maximum(a64.abs(), b64.abs())
        ulp = torch.exp2(torch.floor(torch.log2(torch.where(big > 0, big, 1.0))) - 7)
        err = (a64 - b64).abs()
        share = float(differ.double().mean())
        scale = max(float(b64.abs().max()), 1e-30)
        over = err > ulp
        over_rel = float(err[over].max()) / scale if bool(over.any()) else 0.0
        rows[field] = {"max_abs_err": float(err.max()), "rel": float(err.max()) / scale,
                       "ulp_share": share, "over_one_ulp": int(over.sum()),
                       "over_one_ulp_max_rel": over_rel}
        check(over_rel <= BAR_REL and share <= BF16_SHARE,
              f"{what} {field}: {share:.2e} of the elements apart, {int(over.sum())} over one "
              f"ulp by up to {over_rel:.2e} of the field's max")
    return rows


def bits_equal(what, names, got, want):
    """Per-field rows of outputs that must equal the plain version's bit
    for bit; raises otherwise."""
    import torch

    rows = {}
    for field, a, b in zip(names, flat(got), flat(want), strict=True):
        check(a.dtype == b.dtype and torch.equal(a, b), f"{what} {field}: not bit for bit")
        rows[field] = {"max_abs_err": 0.0, "rel": 0.0, "bit_for_bit": True}
    return rows


def bf16_rows(K, kid, args, kw, what):
    """Call bfloat16 form ``kid`` and its plain version on the same inputs
    and hold them to each other: streamed values (B8a, B8b) and B11b bit
    for bit, bfloat16 collide outputs (B3, B5, B9) within one ulp in a
    bounded share, float32 outputs at phase 3's bars.  A float32 output
    computed from a bfloat16 intermediate (B3's and B5's emission) is held
    to the plain stage fed the kernel's own f'/g', so that a one-ulp flip
    is not counted twice."""
    import torch

    from lbm_ferrofluid_tpu_torch.ops.magnetic import poisson_rhs_scaled
    from lbm_ferrofluid_tpu_torch.ops.moments import phi_from_density

    got = K[kid].wrapper(*args, **kw)
    want = K[kid].plain(*args, **kw)
    torch.cuda.synchronize()
    names = OUTPUTS[kid][:len(flat(got))]
    if kid in ("B8a", "B8b"):
        return dict(bits_equal(what, names[:1], got[:1], want[:1]),
                    **compare(what, names[1:], got[1:], want[1:]))
    if kid == "B11b":
        return bits_equal(what, names, got, want)
    if kid == "B4":
        return compare(what, names, got, want)
    rows = compare_bf16(what, names[:2], got[:2], want[:2])
    if kid == "B3":
        rows.update(compare(what, names[2:5], got[2:5], want[2:5]))
        flags, rho_ca, mflags = args[2], args[6], args[11]
        c, gas = kw["dx"] / kw["dt"], {n: kw[n] for n in
                                       ("rho_gas", "rho_fluid", "density_gas", "density_fluid")}
        mac = K["B4"].plain(got[0], got[1], flags, rho_ca, got[2], c=c, **gas)
        axis, hm, tau_mag = kw["emit_rhs"]
        rhs = poisson_rhs_scaled(
            phi_from_density(mac[2], gas["density_gas"], gas["density_fluid"]), mflags,
            tuple(hm if a == axis else 0.0 for a in range(3)), tau=tau_mag, dx=kw["dx"],
            dt=kw["dt"])
        rows.update(compare(f"{what} (emission on its own f'/g')", names[5:], got[5],
                            mac + (rhs,)))
    elif kid == "B5" and kw.get("emit_mac"):
        c, rg, rf, dg, df = kw["mac_consts"]
        mac = K["B4"].plain(got[0], got[1], args[2], args[3], args[4], c=c, rho_gas=rg,
                            rho_fluid=rf, density_gas=dg, density_fluid=df)
        rows.update(compare(f"{what} (emission on its own f'/g')", names[2:], got[2], mac))
    return rows


def b11b_bf16_plans(K, h, mflags, rhs, res):
    """B11b at bfloat16 h under every plan ``--poisson-plans`` times (k =
    1..4 at its tile heights, z chunks of 1, 4 and the count that fills the
    card once), each bit for bit with the plain version (30 sweeps, tau 1)."""
    import torch

    from lbm_ferrofluid_tpu_torch.ops.kernels import poisson as pp

    Z, Y, X = res
    kw = dict(tau=1.0, n_iters=30)
    want = K["B11b"].plain(h, mflags, rhs, **kw)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    plans, real = [], pp.plan
    try:
        for k, tys in POISSON_PLAN_HEIGHTS.items():
            for ty in tys:
                if pp.smem_bytes(k, ty, 2) > pp.SMEM_BLOCK_MAX:
                    continue
                fill = max(1, sms // (-(-X // pp.tile_width(k)) * -(-Y // ty)))
                for chunks in sorted({1, 4, fill} & set(range(1, Z + 1))):
                    pl = pp.PoissonPlan(k, ty, -(-Z // chunks), pp.passes(30, k))
                    pp.plan = lambda *a, pl=pl, **_: pl
                    got = pp.poisson_sweeps(h, mflags, rhs, **kw)
                    torch.cuda.synchronize()
                    check(all(torch.equal(a, b) for a, b in zip(got, want)),
                          f"B11b bf16 under plan {pl} differs from the plain version")
                    plans.append([k, ty, pl.lz])
    finally:
        pp.plan = real
    return {"plans_bit_for_bit": plans}


def phase_kernels_bf16(dev, K):
    """The bfloat16 forms against their plain versions (phase 3's inputs
    rounded to bfloat16): B4, B3 at the magnetic tau 1 and 0.8, B5 with and
    without ``emit_mac``, B11b at tau 1 and 0.8 and at 30 and 7 sweeps (its
    chosen plan also against the one-sweep plan, and every plan of
    ``--poisson-plans`` at 34x66x130), at 34x66x130 and 130x66x130; the HCZ
    chain's B8b, B8a and B9 at 34x66x130 and 130^3."""
    import torch

    bf = torch.bfloat16
    worst = {kid: 0.0 for kid in ("B3", "B4", "B5", "B8a", "B8b", "B9", "B11b")}
    rows = []
    sms = torch.cuda.get_device_properties(0).multi_processor_count

    def log(kid, label, res, r, **extra):
        err = max(v["max_abs_err"] for v in r.values())
        worst[kid] = max(worst[kid], err)
        rows.append({"kernel": label, "res": list(res), **extra, "max_abs_err": err,
                     "max_ulp_share": max(v.get("ulp_share", 0.0) for v in r.values())})

    for res, seed in (((34, 66, 130), 1), ((130, 66, 130), 2)):
        params, d = seeded_inputs(res, seed, dev)
        d["rho_ca"] = K["B2"].wrapper(d["rho_pre"], d["flags"], params.contact_angle)
        d = dict(d, f=d["f"].to(bf), g=d["g"].to(bf), h=d["h"].to(bf))
        for kid, p in (("B4", params), ("B3", params), ("B3", params.replace(tau=0.8))):
            args, kw = kernel_calls(p, d)[kid]
            log(kid, f"{kid} bf16", res, bf16_rows(K, kid, args, kw, f"{kid} bf16 tau={p.tau}"),
                tau=p.tau)
        for emit_mac in (False, True):
            args, kw = epilogue_call(K, params, d, emit_mac)
            log("B5", "B5 bf16", res,
                bf16_rows(K, "B5", args, kw, f"B5 bf16 emit_mac={emit_mac} at {res}"),
                emit_mac=emit_mac)
        mfl = poisson_seam_block(d["mflags_block"], sms, params.poisson_iters)
        for tau in (1.0, 0.8):
            for n in (params.poisson_iters, 7):
                args, kw = (d["h"], mfl, d["rhs"]), dict(tau=tau, n_iters=n)
                r = bf16_rows(K, "B11b", args, kw, f"B11b bf16 tau={tau} n_iters={n} at {res}")
                log("B11b", "B11b bf16", res, r, tau=tau, n_iters=n,
                    against_one_sweep_plan=b11b_plan_against_one_sweep(args, kw, sms))
        for row in b11b_emit_checks(K, params, d["h"], d["mflags_block"], d["rhs"], sms,
                                    f"bf16 at {res}"):
            rows.append(dict(row, res=list(res)))
        if res == (34, 66, 130):
            rows.append({"kernel": "B11b bf16 plan sweep", "res": list(res),
                         **b11b_bf16_plans(K, d["h"], mfl, d["rhs"], res)})
        del d
    for res, seed in (((34, 66, 130), 3), ((130, 130, 130), 4)):
        params, d = hcz_seeded_inputs(res, seed, dev)
        d = dict(d, f=d["f"].to(bf), g=d["g"].to(bf))

        def record(label, kid, args, kw):
            if kid in worst:
                log(kid, f"{label} bf16", res, bf16_rows(K, kid, args, kw,
                                                          f"{label} bf16 at {res}"))
            return K[kid].wrapper(*args, **kw)

        hcz_chain(K, params, d, record)
    for seed, res in enumerate(B5_GRIDS, 11):
        args, kw = b5_hcz_inputs(K, res, seed, dev, bf16=True)
        r, held = b5_plan_rows(K, args, kw, f"bf16 at {res}", rows=bf16_rows)
        log("B5", "B5 bf16 plans against the cell plan", res, r, plans=held)
        del args
    emit({"phase": "kernels_bf16", "bar_rel": BAR_REL, "bar_vel_abs": BAR_VEL_ABS,
          "bar_ulp_share": BF16_SHARE, "checks": rows, "ok": True})
    return worst


def dense_level(params, state) -> float:
    """Mean level of the dense phase: the cells above the midpoint of the
    two phases' densities, per (z, x) column (the Rosensweig pool's mean
    interface height; for a drop, its volume over the floor's area)."""
    mid = 0.5 * (params.density_gas + params.density_fluid)
    den = state.density[0, 0]
    return float((den > mid).sum()) / (den.shape[0] * den.shape[2])


def against(what, params, sk, sref, fields, pointwise):
    """The statistical bars of a bfloat16 run against another run: every
    field finite, fluid mass at rtol ``BF16_MASS``, and with
    ``pointwise`` max |density difference| within ``BF16_DENSITY`` of
    max|density|, else the mean level of the dense phase within
    ``BF16_LEVEL`` cells (the distance is reported either way).  Returns
    the row; ``row["failed"]`` holds what missed its bar."""
    import torch

    failed = [f"{what}: {n} not finite" for n in fields
              if not bool(torch.isfinite(getattr(sk, n).float()).all())]
    dd = float((sk.density.double() - sref.density.double()).abs().max())
    scale = float(sref.density.double().abs().max())
    m, mref = fluid_mass(sk), fluid_mass(sref)
    level = dense_level(params, sk) - dense_level(params, sref)
    row = {"max_abs_density_diff": dd, "density_scale": scale, "density_rel": dd / scale,
           "fluid_mass": m, "fluid_mass_ref": mref, "mass_rel": abs(m / mref - 1.0),
           "dense_level_diff": level}
    if abs(m / mref - 1.0) > BF16_MASS:
        failed.append(f"{what}: mass {abs(m / mref - 1.0):.2e} apart")
    if pointwise and dd > BF16_DENSITY * scale:
        failed.append(f"{what}: density {dd / scale:.2e} of max apart")
    if not pointwise and abs(level) > BF16_LEVEL:
        failed.append(f"{what}: dense phase {level:.3f} cells apart")
    return dict(row, failed=failed)


def phase_bf16_main(dev, kernels_pkg, card):
    """The five routes in bfloat16 storage (f, g and h; the scalar carry
    stays float32): Rosensweig 130x66x130 in the capillogue steady state
    with the scalar carry, the channel form (bfloat16 h), the un-carried
    step and the epilogue steady state, and HCZ ``multiphase_3d`` at 130^3.
    Each: counters zeroed just before 30 kernel steps and read just after
    (the float32 counts a step, every kernel that reads or writes f, g or h
    in its bfloat16 form); then 30 plain steps and 30 float32 kernel steps
    from the same scene.  Held, as tests/test_bf16_physics.py holds the
    JAX package's turbo mode, pointwise through the sharp initial
    interface's transient and statistically beyond it: against plain,
    max |density difference| within ``BF16_DENSITY`` after 10 steps (the
    one-ulp flips in which any two bfloat16 runs differ grow through the
    transient; the rows report the distance after 10 and after 30 steps),
    and one plain step from the kernels' state after 29 steps against their 30th
    (f, g within one ulp in a bounded share, the macros at phase 3's
    bars); after 30 steps, against plain and against float32, fluid mass
    at ``BF16_MASS`` and the dense phase's mean level within
    ``BF16_LEVEL`` cells, the pointwise distance reported."""
    import torch

    from lbm_ferrofluid_tpu_torch.models import (
        ferrofluid_step, hcz_step, multiphase_3d, rosensweig_3d,
    )

    K = kernels_pkg.KERNELS
    out = {"phase": "bf16_main_paths", "card": card, "bar_density_10_steps": BF16_DENSITY,
           "bar_mass": BF16_MASS, "bar_level_cells": BF16_LEVEL}
    total = {kid: 0 for kid in kernels_pkg.BF16_FORMS}
    total["B11b emit"] = 0
    params, s0 = rosensweig_3d(device=dev)
    n = params.poisson_iters
    b1 = K["B1"].module.launches_per_call(n, s0.rho.shape)
    b11b = K["B11b"].module.launches_per_call(n, s0.rho.shape)
    hp, hs0 = multiphase_3d(device=dev)
    routes = (
        ("capillogue steady state", params, s0, primed, {"B1": b1, "B2": 1, "B3": 4},
         {"B4": 1}),
        ("channel form", params.replace(scalar_carry=False), s0, primed,
         {"B11b": b11b, "B2": 1, "B3": 4}, {"B4": 1}),
        ("un-carried", params, s0, None,
         {"B4": 1, "B11b": b11b, "B2": 1, "B6": 1, "B5": 1}, {}),
        ("epilogue steady state", params, s0, epilogue_state,
         {"B1": b1, "B2": 1, "B6": 1, "B5": 2}, {"B4": 1}),
        ("hcz", hp, hs0, None, {"B8b": 1, "B8a": 1, "B2": 1, "B6": 1, "B9": 1}, {}),
    )
    failed = []
    for label, p, s32, prep, per_step, extra in routes:
        p16, s16 = turbo(p, s32, dev)
        step = hcz_step if label == "hcz" else ferrofluid_step
        fields = ("f", "g", "rho", "vel", "density", "pressure") + (
            () if label == "hcz" else ("h",))
        kernels_pkg.reset_launch_counts()
        sk = prep(p16, dev)(s16, False) if prep else s16
        for i in range(30):
            if i == 10:
                sk10 = sk
            if i == 29:
                sk29 = sk
            sk = step(p16, sk, device=dev)
        torch.cuda.synchronize()
        launches = kernels_pkg.launch_counts()
        bf16 = kernels_pkg.launch_counts(kernels_pkg.BF16_FORMS, bf16=True)
        check_launches(f"bf16 {label}", launches, per_step, 30, extra=extra)
        if "B11b" in per_step:
            total["B11b emit"] += check_emit_launches(f"bf16 {label}", kernels_pkg, 30)
        check(all(bf16[kid] == launches[kid] for kid in bf16) and any(bf16.values()),
              f"bf16 {label}: a kernel ran its float32 form on bfloat16 storage: {bf16}")
        check(sk.f.dtype == sk.g.dtype == torch.bfloat16
              and (label == "hcz" or sk.h.dtype == (torch.float32 if sk.h.shape[1] == 2
                                                     else torch.bfloat16)),
              f"bf16 {label}: the state left its storage")
        one = step(p16, sk29, device=dev, plain=True)
        names = ("f", "g", "rho", "vel", "density", "pressure")
        one_step = dict(
            compare_bf16(f"bf16 {label} step 30 vs a plain step", names[:2],
                         [sk.f, sk.g], [one.f, one.g]),
            **compare(f"bf16 {label} step 30 vs a plain step", names[2:],
                      [getattr(sk, n) for n in names[2:]], [getattr(one, n) for n in names[2:]]))
        del sk29, one
        sp = prep(p16, dev)(s16, True) if prep else s16
        for i in range(30):
            if i == 10:
                sp10 = sp
            sp = step(p16, sp, device=dev, plain=True)
        sf = prep(p, dev)(s32, False) if prep else s32
        for _ in range(30):
            sf = step(p, sf, device=dev)
        row = {
            "res": list(sk.rho.shape[2:]), "steps": sk.step,
            "h": None if label == "hcz" else [sk.h.shape[1], str(sk.h.dtype)],
            "against_plain_after_10_steps": against(f"bf16 {label} vs plain at 10 steps", p16,
                                                    sk10, sp10, fields, pointwise=True),
            "step_30_against_a_plain_step": one_step,
            "against_plain_after_30_steps": against(f"bf16 {label} vs plain", p16, sk, sp,
                                                    fields, pointwise=False),
            "against_float32_after_30_steps": against(f"bf16 {label} vs float32", p16, sk, sf,
                                                      fields, pointwise=False),
            "launches": {kid: v for kid, v in launches.items() if v},
            "launches_bf16_form": {kid: v for kid, v in bf16.items() if v},
            "launches_a_step": sum(per_step.values()),
        }
        failed += [m for key in ("against_plain_after_10_steps", "against_plain_after_30_steps",
                                 "against_float32_after_30_steps") for m in row[key]["failed"]]
        out[label] = row
        for kid in kernels_pkg.BF16_FORMS:
            total[kid] += bf16[kid]
        del sk, sp, sf, s16, sk10, sp10
        torch.cuda.empty_cache()
    emit(dict(out, finite=True, ok=not failed))
    check(not failed, "; ".join(failed))
    return total


def interface_heights(params, state):
    """Fill height of the pool in each (z, x) column: the cells along y
    whose density is above the midpoint of the two phases' densities (the
    Rosensweig scene's field and pool are along y)."""
    import torch

    mid = 0.5 * (params.density_gas + params.density_fluid)
    return (state.density[0, 0] > mid).sum(dim=1).to(torch.float64)


#: bars of the long horizon: the bfloat16 kernels against the bfloat16
#: plain path (fluid mass), and bfloat16 against float32 (fluid mass; the
#: dense phase's level in cells, as tests/test_bf16_physics.py).  The JAX
#: package's own bfloat16 run of this scene loses its float32 run's mass
#: by more than that test's 5e-3 within 300 steps (5.1e-3 at 16x66x16, the
#: port's plain path 5.2e-3: tests/test_torch_bf16_slice.py), so bfloat16
#: against float32 is held at 2e-2 and the kernels' own share of the
#: drift, against the plain path that computes the same function, at 1e-3
LONG_MASS_PLAIN, LONG_MASS_F32, LONG_LEVEL = 1e-3, 2e-2, 1.0


def phase_long_horizon(dev, card, steps=2000, plain_steps=250):
    """``steps`` (2000) kernel steps of Rosensweig 130x66x130 (the
    capillogue steady state) in float32 and in bfloat16 storage from the
    same scene, and ``plain_steps`` (250; 1000, then 500, each cut for card
    time: the plain run was 55 of the phase's 59 s, then 23 of 26) bfloat16
    steps on the plain path: after as many kernel steps, bfloat16 kernels
    against plain at ``LONG_MASS_PLAIN`` (fluid mass) and the dense phase's
    mean level within ``LONG_LEVEL`` cells; bfloat16
    against float32 at ``LONG_MASS_F32`` and the mean interface level
    within ``LONG_LEVEL`` cells, as tests/test_bf16_physics.py holds the
    JAX package's turbo mode; the corrugation amplitude and the pointwise
    height difference are printed, and held to that test's bars only
    where the float32 run corrugated by 2 cells or more."""
    import torch

    from lbm_ferrofluid_tpu_torch.models import ferrofluid_step, prime_premac, rosensweig_3d
    from lbm_ferrofluid_tpu_torch.models.runner import assert_finite

    params, s0 = rosensweig_3d(device=dev)
    p16, s16 = turbo(params, s0, dev)
    runs = {}
    for label, p, s, n, plain in (("float32", params, s0, steps, False),
                                  ("bfloat16", p16, s16, steps, False),
                                  ("bfloat16 plain", p16, s16, plain_steps, True)):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        st = prime_premac(p, s, device=dev, plain=plain)
        marks = {}
        for i in range(1, n + 1):
            st = ferrofluid_step(p, st, device=dev, plain=plain)
            if i == plain_steps:
                marks = {"mass": fluid_mass(st), "level": dense_level(p, st)}
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        assert_finite(st, fields=vars(st))
        runs[label] = {"state": st, "heights": interface_heights(p, st), "seconds": seconds,
                       "mlups": st.rho.numel() * n / seconds / 1e6, "half": marks}
    a, b, c = runs["float32"], runs["bfloat16"], runs["bfloat16 plain"]
    amp32 = float(a["heights"].max() - a["heights"].min())
    amp16 = float(b["heights"].max() - b["heights"].min())
    mean_diff = float(b["heights"].mean() - a["heights"].mean())
    pointwise = (b["heights"] - a["heights"]).abs()
    m32, m16 = fluid_mass(a["state"]), fluid_mass(b["state"])
    half = {k: {"mass": v["half"]["mass"], "dense_level": v["half"]["level"]}
            for k, v in runs.items()}
    half["step"] = plain_steps
    plain_mass = abs(b["half"]["mass"] / c["half"]["mass"] - 1.0)
    plain_level = b["half"]["level"] - c["half"]["level"]
    row = {"phase": "long_horizon", "scene": "rosensweig_3d", "res": list(s0.rho.shape[2:]),
           "steps": steps, "card": card,
           "fluid_mass": {"float32": m32, "bfloat16": m16, "rel": abs(m16 / m32 - 1.0)},
           "at_plain_steps": dict(half, bf16_kernels_vs_plain_mass_rel=plain_mass,
                           bf16_kernels_vs_plain_level_diff=plain_level),
           "mean_interface_level": {"float32": float(a["heights"].mean()),
                                    "bfloat16": float(b["heights"].mean()), "diff": mean_diff},
           "corrugation_amplitude": {"float32": amp32, "bfloat16": amp16},
           "pointwise_height_diff": {"max": float(pointwise.max()),
                                     "mean": float(pointwise.mean())},
           "seconds": {k: v["seconds"] for k, v in runs.items()},
           "mlups": {k: v["mlups"] for k, v in runs.items()},
           "bars": {"mass_vs_plain": LONG_MASS_PLAIN, "mass_vs_float32": LONG_MASS_F32,
                    "level_cells": LONG_LEVEL}}
    row["corrugated"] = amp32 >= 2
    failed = []
    if plain_mass > LONG_MASS_PLAIN or abs(plain_level) > LONG_LEVEL:
        failed.append(f"long horizon: bf16 kernels vs plain mass {plain_mass:.2e}, "
                      f"level {plain_level:.3f} cells")
    if abs(m16 / m32 - 1.0) > LONG_MASS_F32:
        failed.append(f"long horizon: fluid mass {m16} vs {m32}")
    if abs(mean_diff) > LONG_LEVEL:
        failed.append(f"long horizon: mean interface level {mean_diff} cells apart")
    if row["corrugated"] and not 0.3 * amp32 <= amp16 <= 3.0 * amp32:
        failed.append(f"long horizon: corrugation {amp16} against {amp32}")
    if row["corrugated"] and float(pointwise.mean()) > 3.0:
        failed.append(f"long horizon: mean pointwise height difference {float(pointwise.mean())}")
    emit(dict(row, ok=not failed))
    check(not failed, "; ".join(failed))


#: the spike-pattern golden: the reference solver's perturbed 64x33x64
#: Rosensweig scene with density snapshots every 500 steps to 4000
SPIKE_REF = ROOT / "tests" / "golden" / "rosensweig3d_spikes_ref.npz"
SPIKE_SNAPS = tuple(range(500, 4001, 500))


def spike_failures(ref, snaps: dict, mode: str) -> tuple[dict, list]:
    """tests/test_spike_parity.py's bars on one run's density snapshots
    ``{step: [B, 1, Z, Y, X] array}`` against the reference ``ref`` (the
    loaded ``SPIKE_REF``).  float32: at every snapshot of ``SPIKE_SNAPS``
    the same ``k_dominant``, ``|amp_ratio - 1| <= 1e-2`` and correlation
    >= 0.999, and the run's own k 4 at step 2500 and 3 at step 3000.
    turbo: at step 4000 the same k, ``0.6 < amp_ratio < 1.7`` and
    correlation > 0.5.  Returns (metrics per step, failures)."""
    from tools.spike_metric import compare_runs

    rows, failed = {}, []
    for step in SPIKE_SNAPS:
        m = compare_runs(ref[f"den_{step}"][0, 0], np.asarray(snaps[step])[0, 0])
        rows[step] = {"k_ref": m["ref"]["k_dominant"], "k": m["ours"]["k_dominant"],
                      "amp_ratio": float(m["amp_ratio"]),
                      "height_correlation": float(m["height_correlation"])}
    if mode == "float32":
        for step, r in rows.items():
            if r["k"] != r["k_ref"]:
                failed.append(f"spikes float32 step {step}: k {r['k']} against {r['k_ref']}")
            if abs(r["amp_ratio"] - 1.0) > 1e-2:
                failed.append(f"spikes float32 step {step}: amp_ratio {r['amp_ratio']}")
            if not r["height_correlation"] >= 0.999:
                failed.append(f"spikes float32 step {step}: correlation "
                              f"{r['height_correlation']}")
        if (rows[2500]["k"], rows[3000]["k"]) != (4, 3):
            failed.append(f"spikes float32: k {rows[2500]['k']} at 2500 and "
                          f"{rows[3000]['k']} at 3000, not 4 and 3")
    else:
        r = rows[4000]
        if r["k"] != r["k_ref"]:
            failed.append(f"spikes turbo step 4000: k {r['k']} against {r['k_ref']}")
        if not 0.6 < r["amp_ratio"] < 1.7:
            failed.append(f"spikes turbo step 4000: amp_ratio {r['amp_ratio']}")
        if not r["height_correlation"] > 0.5:
            failed.append(f"spikes turbo step 4000: correlation {r['height_correlation']}")
    return rows, failed


def spike_params(ref, mode: str):
    """tools/run_rosensweig_spikes_ours.py's parameters, on the port."""
    from lbm_ferrofluid_tpu_torch.models import SimulationParams

    dt = "bfloat16" if mode == "turbo" else "float32"
    return SimulationParams(
        dim=3, density_gas=0.02381, density_fluid=0.2508, rho_gas=0.02381,
        rho_fluid=0.2508, kappa=0.01, tau_f=0.68, tau_g=0.68,
        gravity=float(ref["gravity"]), mag_strength=float(ref["mag"]), poisson_iters=30,
        fg_dtype=dt, h_dtype=dt, mag_flags_shell=True)


def spike_run(ref, mode: str, dev, steps=SPIKE_SNAPS[-1]):
    """The golden's initial fields (zero velocity), primed, stepped
    ``steps`` times through ``ferrofluid_step`` on ``dev``; returns the
    density every 500 steps and the seconds of the stepping."""
    import torch

    from lbm_ferrofluid_tpu_torch.models import (
        ferrofluid_step, init_ferrofluid_state, prime_premac,
    )

    params = spike_params(ref, mode)
    res = ref["flags"].shape[2:]
    state = init_ferrofluid_state(
        params, ref["rho0"].astype(np.float32), ref["den0"].astype(np.float32),
        np.zeros((1, 3, *res), np.float32), ref["flags"], ref["mflags"], device=dev)
    state = prime_premac(params, state, device=dev)
    snaps = {}
    if dev != "cpu":
        torch.cuda.synchronize()
    t0 = time.perf_counter()
    for i in range(1, steps + 1):
        state = ferrofluid_step(params, state, device=dev)
        if i % 500 == 0:
            snaps[i] = state.density.float().cpu().numpy()
    if dev != "cpu":
        torch.cuda.synchronize()
    return state, snaps, time.perf_counter() - t0


def phase_spikes(dev, kernels_pkg, card):
    """Spike-pattern parity (ROADMAP A14): the reference solver's perturbed
    64x33x64 Rosensweig scene (``mag_flags_shell``) from its stored initial
    fields, 4000 steps through the port's kernel route (the capillogue
    steady state with the scalar carry) in float32 and in turbo (bfloat16
    f, g and h), each density snapshot every 500 steps held to the
    reference snapshot through tools/spike_metric.py:compare_runs at
    tests/test_spike_parity.py's bars (``spike_failures``).  Counters
    zeroed just before each run and read just after.  Returns the float32
    run's launches and the turbo run's bfloat16-form launches."""
    from lbm_ferrofluid_tpu_torch.models.runner import assert_finite

    ref = np.load(SPIKE_REF)
    K = kernels_pkg.KERNELS
    ids = kernels_pkg.PATHS["ferrofluid"]
    failed, launches, launches16 = [], {}, {}
    for mode in ("float32", "turbo"):
        kernels_pkg.reset_launch_counts()
        state, snaps, seconds = spike_run(ref, mode, dev)
        got = kernels_pkg.launch_counts(ids)
        got16 = kernels_pkg.launch_counts(kernels_pkg.BF16_FORMS, bf16=True)
        assert_finite(state, fields=vars(state))
        check_launches(f"spikes {mode}", got, {
            "B1": K["B1"].module.launches_per_call(30, state.rho.shape),
            "B2": K["B2"].module.N_LAUNCHES, "B3": K["B3"].module.N_LAUNCHES},
            state.step, extra={"B4": 1})
        if mode == "float32":
            launches = got
        else:
            launches16 = got16
            check(got16["B3"] == got["B3"] and got16["B4"] == got["B4"],
                  f"spikes turbo: a kernel ran its float32 form: {got16} against {got}")
        rows, bad = spike_failures(ref, snaps, mode)
        failed += bad
        emit({"phase": "spikes", "mode": mode, "res": list(state.rho.shape[2:]),
              "steps": state.step, "ms_per_step": 1e3 * seconds / state.step,
              "snapshots": rows, "card": card, "launches": got, "ok": not bad})
    check(not failed, "; ".join(failed))
    return launches, launches16


def triangle_set_distance(a, b, chunk=2048) -> float:
    """How far two triangle sets ([N, 3, 3] tensors on one device) lie
    apart: for each triangle of one set, its nearest triangle of the other
    (among the 4 of nearest centroid) by the largest distance from one of
    its corners to the nearest corner of the other (max-norm), taken over
    both sets.  The sets are equal within it."""
    import torch

    def one_way(x, y):
        cx, cy = x.mean(1), y.mean(1)
        worst = 0.0
        for i in range(0, len(x), chunk):
            near = torch.cdist(cx[i:i + chunk], cy).topk(4, largest=False).indices
            cand = y[near]  # [n, 4, 3, 3]
            d = (x[i:i + chunk, None, :, None] - cand[:, :, None]).abs().amax(-1)
            worst = max(worst, float(d.amin(-1).amax(-1).amin(-1).max()))
        return worst

    return max(one_way(a, b), one_way(b, a))


#: bars of the rendered frames: the on-card pipeline against the host
#: path (tests/test_mesh_jax.py:97-130), the two triangle sets, and the
#: rasterizer on the card against the CPU
PIPE_MEAN, PIPE_MAX, TRI_ATOL, RASTER_ABS = 2e-3, 0.1, 2e-3, 1e-5


def frame_is_rendered(img) -> bool:
    """Neither blank nor constant: more than one value, and some pixels
    off the background."""
    return int(img.max()) != int(img.min()) and bool((img < 250).any())


def phase_demo(dev, kernels_pkg, card, steps=100, io_interval=50, image_size=256,
               min_budget=1 << 16):
    """The north-star demo end to end: the port's Rosensweig driver
    (``demo_3d_LBM_Rosensweig_instability.main``) at its native 130x66x130
    on the card, ``steps`` steps with a frame every ``io_interval``, into a
    temporary directory (counters zeroed just before, read just after:
    B1, B2, B3 every step, B4 once).  Its frames are written and rendered
    (not blank, not constant), and its OBJ has the face count of host
    ``phi_to_mesh`` of the final phi.  The final phi rendered through
    ``make_render_pipeline`` (on the card) and through the host path,
    images within ``PIPE_MEAN``/``PIPE_MAX``; ``phi_to_mesh_torch``'s
    triangle set on the card equal to the host's within ``TRI_ATOL``;
    ``soft_rasterize`` on the card against the CPU for a 64-pixel sphere
    within ``RASTER_ABS`` (in float64; float32 reported).  ms a frame of
    each path (the two frames compared: mesh and image, no PNG), ms a step
    of the demo's steps.  Frames are ``image_size``
    pixels a side (the driver's default), and the pipeline's triangle
    budget the power of 2 of the host mesh, at least ``min_budget`` (the
    JAX package's default)."""
    import tempfile

    import torch

    from lbm_ferrofluid_tpu_torch.demo import demo_3d_LBM_Rosensweig_instability as demo
    from lbm_ferrofluid_tpu_torch.models import (
        SimulationRunner, ferrofluid_step, phi_field, rosensweig_3d,
    )
    from lbm_ferrofluid_tpu_torch.models.runner import assert_finite
    from lbm_ferrofluid_tpu_torch.render import (
        _bucket_mesh, _image, default_renderer, make_render_pipeline, phi_to_mesh,
        phi_to_mesh_torch, soft_rasterize, vertices_to_faces,
    )
    from lbm_ferrofluid_tpu_torch.utils.io import read_png

    K = kernels_pkg.KERNELS
    ids = kernels_pkg.PATHS["ferrofluid"]
    out = {"phase": "demo", "driver": "demo_3d_LBM_Rosensweig_instability", "card": card}
    with tempfile.TemporaryDirectory() as tmp:
        kernels_pkg.reset_launch_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state = demo.main(["--total_steps", str(steps), "--io_interval", str(io_interval),
                           "--out_dir", tmp, "--image_size", str(image_size)])
        torch.cuda.synchronize()
        out["demo_seconds"] = time.perf_counter() - t0
        launches = kernels_pkg.launch_counts(ids)
        assert_finite(state, fields=vars(state))
        check_launches("demo", launches, {
            "B1": K["B1"].module.launches_per_call(30, state.rho.shape),
            "B2": K["B2"].module.N_LAUNCHES, "B3": K["B3"].module.N_LAUNCHES},
            state.step, extra={"B4": 1})
        frames = sorted(pathlib.Path(tmp).glob("*.png"))
        want = [f"{s:05d}.png" for s in range(0, steps + 1, io_interval)]
        check([f.name for f in frames] == want, f"demo: frames {[f.name for f in frames]}")
        for f in frames:
            img = read_png(f)
            check(img.shape == (image_size, image_size, 3) and frame_is_rendered(img),
                  f"demo: frame {f.name} blank or constant ({img.shape})")
        obj = pathlib.Path(tmp) / demo.OBJ_NAME
        obj_faces = sum(1 for line in obj.open() if line.startswith("f "))
    res = tuple(state.rho.shape[2:])
    params = rosensweig_3d(res, device="cpu")[0]  # the driver's, at its defaults
    phi = phi_field(params, state)
    verts, faces = phi_to_mesh(phi, res)
    check(obj_faces == len(faces), f"demo: OBJ has {obj_faces} faces, phi_to_mesh {len(faces)}")
    bucket = len(_bucket_mesh(verts, faces)[1])
    budget = max(min_budget, bucket)
    renderer = default_renderer(image_size, device=dev)

    def host_frame():
        v, f = phi_to_mesh(phi, res)
        vb, fb = _bucket_mesh(v, f)
        return _image(renderer, torch.as_tensor(vb, device=dev), torch.as_tensor(fb, device=dev),
                      0.68)

    pipe = make_render_pipeline(res, renderer=renderer, budget=budget, device=dev)
    ms = {}
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    img_h = host_frame()
    torch.cuda.synchronize()
    ms["host"] = (time.perf_counter() - t0) * 1e3
    img_d, count = pipe(phi)
    torch.cuda.synchronize()
    ms["pipeline"] = (time.perf_counter() - t0) * 1e3 - ms["host"]
    check(int(count) == len(faces) <= budget,
          f"demo: device mesh {int(count)} triangles, host {len(faces)}, budget {budget}")
    d = (img_d - img_h).abs()
    out["pipeline_vs_host"] = {"mean_abs": float(d.mean()), "max_abs": float(d.max()),
                               "bars": [PIPE_MEAN, PIPE_MAX]}
    check(float(d.mean()) < PIPE_MEAN and float(d.max()) < PIPE_MAX,
          f"demo: pipeline image off the host's: {out['pipeline_vs_host']}")
    tv, _, tcount = phi_to_mesh_torch(phi, res, budget=budget)
    dist = triangle_set_distance(tv.reshape(-1, 3, 3)[:int(tcount)],
                                 torch.as_tensor(verts[faces], device=dev))
    out["triangles"] = {"host": len(faces), "device": int(tcount), "set_distance": dist,
                        "bar": TRI_ATOL}
    check(int(tcount) == len(faces) and dist <= TRI_ATOL,
          f"demo: device triangle set off the host's: {out['triangles']}")
    out.update(faces=len(faces), bucket=bucket, budget=budget, ms_per_frame=ms)
    # the rasterizer on the card against the CPU: a sphere at 64 pixels
    n = 12
    i, j, k = np.mgrid[0:n, 0:n, 0:n]
    sph = np.tanh((np.sqrt((i - n / 2) ** 2 + (j - n / 2) ** 2 + (k - n / 2) ** 2) - 4) / 2)
    sv, sf = phi_to_mesh(sph[None, None].astype(np.float32), (n, n, n))
    errs = {}
    for dt in (torch.float64, torch.float32):
        imgs = []
        for where in (dev, "cpu"):
            r = default_renderer(32, device=where)
            v = torch.as_tensor(sv, device=where, dtype=dt)[None]
            fv = vertices_to_faces(r.project_to_image(r.transform_to_camera_frame(v)),
                                   torch.as_tensor(sf, device=where)[None])
            tex = torch.full((1, len(sf), 2, 3), 0.68, dtype=dt, device=where)
            imgs.append(soft_rasterize(fv, tex, 64, r.bg_color.to(dt)).cpu())
        errs[str(dt).split(".")[-1]] = float((imgs[0] - imgs[1]).abs().max())
    out["soft_rasterize_card_vs_cpu"] = dict(errs, bar_float64=RASTER_ABS, faces=len(sf))
    check(errs["float64"] <= RASTER_ABS, f"demo: soft_rasterize card vs CPU {errs}")
    # the demo's steps alone
    runner = SimulationRunner(params, ferrofluid_step, device=dev)
    state, stats = runner.benchmark(state, n_steps=50, warmup=5)
    out.update(res=list(res), steps=steps, io_interval=io_interval, launches=launches,
               ms_per_step=stats["seconds"] / 50 * 1e3, mlups=stats["mlups"], ok=True)
    emit(out)
    del state, pipe, img_d, img_h, tv
    torch.cuda.empty_cache()
    return launches


#: the other demo drivers
DEMOS = (
    "demo_2d_LBM", "demo_2d_LBM_KBC", "demo_2d_LBM_Rosensweig_instability",
    "demo_2d_LBM_droplet_spread", "demo_2d_LBM_multiphase_HCZ", "demo_2d_LBM_multiphase_SC",
    "demo_2d_LBM_two_droplets", "demo_2d_wave", "demo_3d_LBM_droplet_spread",
    "demo_3d_LBM_multiphase", "demo_3d_LBM_two_droplets",
)


def phase_demos(dev, kernels_pkg, card, steps=20, io_interval=10):
    """Each of the other demo drivers at its default grid on the card,
    ``steps`` steps with a frame every ``io_interval`` into a temporary
    directory: its frames written and not constant, its final state
    finite; the 3D drivers launch their path's kernels (counters zeroed
    just before the phase, read just after).  Then the 2D two-droplets
    driver at 24x48 for 400 steps with ``--io_interval 400``: its step-400
    Tecplot dump is written, with one line a cell."""
    import importlib
    import tempfile

    import torch

    from lbm_ferrofluid_tpu_torch.models.runner import assert_finite
    from lbm_ferrofluid_tpu_torch.utils.io import read_png

    out = {"phase": "demos", "card": card, "steps": steps, "drivers": {}}
    kernels_pkg.reset_launch_counts()
    for name in DEMOS:
        mod = importlib.import_module(f"lbm_ferrofluid_tpu_torch.demo.{name}")
        with tempfile.TemporaryDirectory() as tmp:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            state = mod.main(["--total_steps", str(steps), "--io_interval", str(io_interval),
                              "--out_dir", tmp])
            torch.cuda.synchronize()
            seconds = time.perf_counter() - t0
            assert_finite(state, fields=vars(state))
            frames = sorted(pathlib.Path(tmp).glob("*.png"))
            check(len(frames) == steps // io_interval + 1, f"demos {name}: {len(frames)} frames")
            for f in frames:
                img = read_png(f)
                check(int(img.max()) != int(img.min()), f"demos {name}: frame {f.name} constant")
        out["drivers"][name] = {"res": list(state.rho.shape[2:]), "steps": state.step,
                                "frames": len(frames), "seconds": seconds}
    launches = kernels_pkg.launch_counts()
    for kid in ("B1", "B2", "B3", "B4", "B6", "B8a", "B8b", "B9"):
        check(launches[kid] > 0, f"demos: {kid} never launched: {launches}")
    mod = importlib.import_module("lbm_ferrofluid_tpu_torch.demo.demo_2d_LBM_two_droplets")
    with tempfile.TemporaryDirectory() as tmp:
        mod.main(["--res", "24", "48", "--total_steps", "400", "--io_interval", "400",
                  "--out_dir", tmp])
        plt = pathlib.Path(tmp) / "00400.plt"
        lines = plt.read_text().splitlines() if plt.exists() else []
        check(len(lines) == 4 + 24 * 48, f"demos: step-400 Tecplot dump has {len(lines)} lines")
    emit(dict(out, plt_lines=len(lines), launches=launches, ok=True))
    return launches


def phase_bf16_flagships(dev, K, card, ptxas=None):
    """The 256^3 flagships in bfloat16 storage: MLUPS over warm steps of the
    Rosensweig scene (mag_strength 85) in the capillogue steady state with
    the scalar carry (turbo), on the channel form (bfloat16 h), un-carried
    and in the epilogue steady state, and of HCZ ``multiphase_3d``; then
    each bfloat16 form at the inputs the next step gives it, timed beside
    its plain version and its bfloat16 bound (``cost``), B3 launch by
    launch and B11b with its plan."""
    import torch

    from lbm_ferrofluid_tpu_torch.models import (
        SimulationRunner, ferrofluid_step, hcz_step, multiphase_3d, rosensweig_3d,
    )
    from lbm_ferrofluid_tpu_torch.ops.kernels import capillogue, fused_step

    res = (256, 256, 256)
    out = {"phase": "bf16_flagships", "res": list(res), "card": card}
    per_kernel = {}

    def steps(label, p, s, run):
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        s, stats = run(p, s)
        out[label] = dict(stats, ms_per_step=stats["seconds"] / stats["steps"] * 1e3,
                          peak_mem_gb=torch.cuda.max_memory_allocated() / 1e9)
        return s

    def bench(p, s, n=20, warm=10):
        return SimulationRunner(p, ferrofluid_step, device=dev).benchmark(
            s, n_steps=n, warmup=warm)

    params, s32 = rosensweig_3d(res=res, mag_strength=85.0, device=dev)
    p16, s16 = turbo(params, s32, dev)
    del s32
    st = steps("turbo", p16, s16, lambda p, s: bench(p, s, 30, 20))
    calls = next_step_calls(K, p16, st)
    for kid, n in (("B3", K["B3"].module.N_LAUNCHES), ("B4", 1)):
        per_kernel[kid] = measure(K, kid, *calls[kid], n, 0 if kid == "B4" else n,
                                  f"{kid} bf16 at 256^3", rows=bf16_rows)
    out["turbo"]["traffic"] = traffic_row(
        p16, st, out["turbo"]["mlups"], step_cost_bytes(K, p16, st, ("B1", "B2", "B3")),
        {"B1": K["B1"].cost(*calls["B1"][0], **calls["B1"][1])[0],
         "B3": per_kernel["B3"]["bytes"]})
    per_kernel["B3"]["split"] = launch_split(
        [capillogue, fused_step], lambda: K["B3"].wrapper(*calls["B3"][0], **calls["B3"][1]),
        reps=10)
    per_kernel["B3"]["collide_blocks_per_sm"] = blocks_per_sm("lbm_cap_collide_occupancy", 1)
    del st, calls

    _, s16 = turbo(params, rosensweig_3d(res=res, mag_strength=85.0, device=dev)[1], dev)
    pc = p16.replace(scalar_carry=False)
    st = steps("channel_form", pc, s16, bench)
    check(st.h.shape[1] == 19 and st.h.dtype == torch.bfloat16, "256^3 bf16 channel form")
    args, kw = (st.h, st.magnetic_flags, st.premac[5]), dict(tau=pc.tau, n_iters=pc.poisson_iters)
    pp = K["B11b"].module
    n = pp.launches_per_call(pc.poisson_iters, st.h.shape)
    per_kernel["B11b"] = measure(K, "B11b", args, kw, n, n, "B11b bf16 at 256^3",
                                 rows=bf16_rows)
    per_kernel["B11b"]["plan"] = b11b_plan_report(
        pp.plan(*res, pc.poisson_iters, torch.cuda.get_device_properties(0).multi_processor_count,
                2), pc.tau, ptxas, bf16=True)
    trail = trail_report(K, pc, st, ptxas, bf16=True)
    per_kernel["B11b emit"] = trail["h2"]
    out["trailing_stage"] = trail
    out["channel_form"]["traffic"] = traffic_row(
        pc, st, out["channel_form"]["mlups"], step_cost_bytes(K, pc, st, ("B11b", "B2", "B3")),
        {"B11b": trail["h2"]["bytes"]})
    del st, args

    _, s16 = turbo(params, rosensweig_3d(res=res, mag_strength=85.0, device=dev)[1], dev)
    su = steps("uncarried", p16, s16, lambda p, s: timed_steps(p, s, ferrofluid_step, dev,
                                                               n_steps=20, warmup=10))
    check(su.premac is None and su.h.dtype == torch.bfloat16, "256^3 bf16 un-carried")
    out["uncarried"]["traffic"] = traffic_row(p16, su, out["uncarried"]["mlups"],
                                              step_cost_bytes(K, p16, su, UNCARRIED_KIDS))
    del su
    s5 = steps("epilogue_steady_state", p16, epilogue_state(p16, dev)(s16, False), bench)
    check(len(s5.premac) == 5, "256^3 bf16 epilogue: the state changed form")
    del s16
    d = epilogue_inputs(K, p16, s5)
    for emit_mac, label in ((False, "B5"), (True, "B5 emit_mac")):
        args, kw = epilogue_call(K, p16, d, emit_mac)
        n = 2 if emit_mac else 1
        per_kernel[label] = measure(K, "B5", args, kw, n, n, f"{label} bf16 at 256^3",
                                    rows=bf16_rows)
    per_kernel["B5"]["plans"] = b5_flagship_plans(K, args, kw, ptxas)
    out["epilogue_steady_state"]["traffic"] = traffic_row(
        p16, s5, out["epilogue_steady_state"]["mlups"],
        step_cost_bytes(K, p16, s5, EPILOGUE_KIDS),
        {"B5 emit_mac": per_kernel["B5 emit_mac"]["bytes"]})
    del s5, d, args
    torch.cuda.empty_cache()

    hp, hs = multiphase_3d(res=res, device=dev)
    hp16, hs16 = turbo(hp, hs, dev)
    del hs
    st = steps("hcz", hp16, hs16, lambda p, s: SimulationRunner(p, hcz_step, device=dev).benchmark(
        s, n_steps=30, warmup=20))
    d = dict(flags=st.flags, f=st.f, g=st.g, rho_old=st.rho, vel_old=st.vel, pres=st.pressure,
             H2=torch.full_like(st.rho, 1e4))

    def record(label, kid, args, kw):
        if kid in ("B8a", "B8b", "B9") and label == kid:
            per_kernel[kid] = measure(K, kid, args, kw, 1, 1, f"{kid} bf16 at 256^3",
                                      rows=bf16_rows)
        return K[kid].wrapper(*args, **kw)

    hcz_chain(K, hp16, d, record)
    del st, d
    torch.cuda.empty_cache()
    emit(dict(out, per_kernel=per_kernel, ok=True))
    return per_kernel


# ---------------------------------------------------------------- 2D and single phase
GAS_2D = dict(density_gas=0.02381, density_fluid=0.2508, rho_gas=0.02381, rho_fluid=0.2508)


def phase_golden_2d(dev):
    """The six 2D and single-phase goldens of tests/test_parity.py (reference
    solver) through the port on the card, at that file's bars and step
    counts: ``singlephase_bgk`` and ``singlephase_kbc_a`` (20 steps),
    ``sc`` (20), ``hcz`` and ``hcz_kbc_wetting`` (20), ``ferro2d`` (10; in
    channel form as tests/test_parity.py runs it, and primed into the
    scalar carry, its h through ``compare_views``)."""
    import torch

    from lbm_ferrofluid_tpu_torch.models import (
        SimulationParams, ferrofluid_step, hcz_step, init_ferrofluid_state, init_hcz_state,
        init_sc_state, init_singlephase_state, prime_premac, sc_step, singlephase_step,
    )
    from lbm_ferrofluid_tpu_torch.ops.scalar_poisson import compare_views

    kbc_a = 0b10000101
    gold = ROOT / "tests" / "golden"
    rows = {}
    for variant in ("bgk", "kbc_a"):
        d = np.load(gold / f"singlephase_{variant}.npz")
        res = d["f0"].shape[2:]
        p = SimulationParams(dim=2, tau=float(d["tau"]),
                             kbc_type=kbc_a if variant == "kbc_a" else None)
        st = init_singlephase_state(p, np.full((1, 1, *res), 0.265, np.float32),
                                    d["vel0"].astype(np.float32),
                                    np.full((1, 1, *res), 1, np.uint8), device=dev)
        for _ in range(20):
            st = singlephase_step(p, st, device=dev)
        rows[f"singlephase_{variant}"] = _golden_rows(f"golden singlephase_{variant}", (
            ("f", st.f, d["f"]), ("rho", st.rho, d["rho"]), ("vel", st.vel, d["vel"])))
    d = np.load(gold / "sc.npz")
    res = d["rho0"].shape[2:]
    p = SimulationParams(dim=2, tau=1.0, **GAS_2D)
    st = init_sc_state(p, d["rho0"], d["den0"], np.zeros((1, 2, *res), np.float32), d["flags"],
                       device=dev)
    for _ in range(20):
        st = sc_step(p, st, device=dev)
    rows["sc"] = _golden_rows("golden sc", (
        ("f", st.f, d["f"]), ("rho", st.rho, d["rho"]), ("vel", st.vel, d["vel"]),
        ("density", st.density, d["den"])))
    hcz = dict(dim=2, kappa=0.08, tau_f=0.7, tau_g=0.8, contact_angle=0.5 * math.pi, **GAS_2D)
    for name, change in (("hcz", {}), ("hcz_kbc_wetting", dict(
            kbc_type=kbc_a, gravity=1e-4, contact_angle=0.75 * math.pi))):
        d = np.load(gold / f"{name}.npz")
        p = SimulationParams(**dict(hcz, **change))
        st = init_hcz_state(p, d["rho0"], d["den0"], np.zeros((1, 2, *res), np.float32),
                            d["flags"], device=dev)
        for _ in range(20):
            st = hcz_step(p, st, device=dev)
        pairs = [("f", st.f, d["f"]), ("g", st.g, d["g"]), ("vel", st.vel, d["vel"]),
                 ("density", st.density, d["den"])]
        if name == "hcz":
            pairs += [("rho", st.rho, d["rho"]), ("pressure", st.pressure, d["p"])]
        rows[name] = _golden_rows(f"golden {name}", pairs)
    d = np.load(gold / "ferro2d.npz")
    p = SimulationParams(**dict(hcz, kappa=0.5, tau_f=0.68, tau_g=0.68, mag_strength=100.0,
                                poisson_iters=30))
    mflags = np.full((1, 1, *res), 2, np.uint8)
    mflags[..., 1:-1, :] = 1
    for route in ("channel form", "scalar carry"):
        st = init_ferrofluid_state(p, d["rho0"], d["den0"], np.zeros((1, 2, *res), np.float32),
                                   d["flags"], mflags, device=dev)
        if route == "scalar carry":
            st = prime_premac(p, st, device=dev)
            check(st.h.shape[1] == 2, "golden ferro2d: priming did not take the scalar carry")
        for _ in range(10):
            st = ferrofluid_step(p, st, device=dev)
        if st.h.shape[1] == 2:
            a, b = compare_views(st.h, torch.as_tensor(d["h"], device=dev), st.magnetic_flags)
        else:
            a, b = st.h, d["h"]
        rows[f"ferro2d {route}"] = _golden_rows(f"golden ferro2d {route}", (
            ("h", a, b), ("f", st.f, d["f"]), ("g", st.g, d["g"]), ("vel", st.vel, d["vel"]),
            ("density", st.density, d["den"])))
    emit({"phase": "golden_2d", "files": ["singlephase_bgk", "singlephase_kbc_a", "sc", "hcz",
                                          "hcz_kbc_wetting", "ferro2d"],
          "bars": "atol 2e-5 + rtol 2e-4 (tests/test_parity.py)", "fields": rows, "ok": True})


def taylor_green_3d(res, dev, *, tau=0.8, u0=0.05, seed=0, batch=1):
    """Single-phase D3Q19 BGK on a seeded Taylor-Green-like field: rho 1,
    |u| <= ``u0`` (the vortex's phase per axis from ``seed``), FLUID inside
    an obstacle frame, tau 0.8.  The JAX package has no 3D single-phase
    scene; this one is built from numpy on the host.  A ``batch`` of more
    than one takes element b's phases from ``seed + b``."""
    from lbm_ferrofluid_tpu_torch.models import SimulationParams, init_singlephase_state

    z, y, x = np.meshgrid(*(2 * np.pi * (np.arange(n, dtype=np.float32) + 0.5) / n
                            for n in res), indexing="ij", sparse=True)
    vel = np.zeros((batch, 3, *res), np.float32)
    amp = np.float32(u0 / math.sqrt(2.0))
    for e in range(batch):
        rng = np.random.default_rng(seed + e)
        a, b, c = (np.float32(v) for v in rng.uniform(0.0, 2 * np.pi, 3))
        vel[e, 0] = amp * np.sin(x + a) * np.cos(y + b) * np.cos(z + c)
        vel[e, 1] = -amp * np.cos(x + a) * np.sin(y + b) * np.cos(z + c)
    flags = np.full((batch, 1, *res), 2, np.uint8)
    flags[..., 1:-1, 1:-1, 1:-1] = 1
    vel *= flags == 1
    params = SimulationParams(dim=3, tau=tau)
    return params, init_singlephase_state(params, np.ones((batch, 1, *res), np.float32), vel,
                                          flags, device=dev)


def phase_singlephase_3d(dev, kernels_pkg, card, res=(256, 256, 256)):
    """Single-phase D3Q19 BGK at 256^3 (16.8 M cells, f 1.27 GB) on the
    seeded Taylor-Green-like field: 30 steps through B8a against 30
    ``plain=True`` steps (phase 3's bars), then 50 timed steps (MLUPS);
    B8a launches once a step; then B8a at the next step's inputs, timed
    beside its plain version and its bound.  Counters zeroed just before
    the path, read just after."""
    import torch

    from lbm_ferrofluid_tpu_torch.models import SimulationRunner, singlephase_step
    from lbm_ferrofluid_tpu_torch.models.runner import assert_finite

    K = kernels_pkg.KERNELS
    params, s0 = taylor_green_3d(res, dev)
    check(float(s0.vel.abs().max()) <= 0.05, "Taylor-Green field above |u| 0.05")
    kernels_pkg.reset_launch_counts()
    sk, rows = kernel_vs_plain(params, s0, singlephase_step, dev, 30,
                               "single-phase 3D BGK", ("f", "rho", "vel"))
    mass0, mass30 = float(s0.rho.double().sum()), float(sk.rho.double().sum())
    del s0
    torch.cuda.reset_peak_memory_stats()
    sk, stats = SimulationRunner(params, singlephase_step, device=dev).benchmark(
        sk, n_steps=50, warmup=5)
    peak = torch.cuda.max_memory_allocated()
    assert_finite(sk, fields=vars(sk))
    launches = kernels_pkg.launch_counts()
    check_launches("single-phase 3D", launches, {"B8a": 1}, sk.step)
    b8a = measure(K, "B8a", (sk.f, sk.flags), {}, 1, 1, f"B8a single-phase at {res}")
    emit({"phase": "singlephase_3d", "scene": "taylor_green_3d", "res": list(res),
          "tau": params.tau, "steps": sk.step, "kernel_vs_plain_after_30_steps": rows,
          "finite": True, "sum_rho": {"step0": mass0, "step30": mass30,
                                      "step85": float(sk.rho.double().sum())},
          "mlups": stats["mlups"], "ms_per_step": stats["seconds"] / stats["steps"] * 1e3,
          "peak_mem_gb": peak / 1e9, "B8a": b8a, "card": card,
          "launches": {"B8a": launches["B8a"]}, "ok": True})
    return {"B8a": launches["B8a"]}, b8a


def launches_per_step(params, state, step, dev, n=3):
    """CUDA kernels a step launches, from ``torch.profiler`` over ``n``
    steps: the host's launch calls (``cudaLaunchKernel`` and kin) and the
    device's kernel records, each divided by ``n``, with the device's busy
    milliseconds a step (0 where the profiler records no device time)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            state = step(params, state, device=dev)
        torch.cuda.synchronize()
    host = device = 0
    busy_us = 0.0
    for e in prof.key_averages():
        if e.key in ("cudaLaunchKernel", "cudaLaunchKernelExC", "cuLaunchKernel",
                     "cuLaunchKernelEx"):
            host += e.count
        if e.device_type == torch.autograd.DeviceType.CUDA:
            device += e.count
            busy_us += getattr(e, "self_device_time_total", 0.0) or 0.0
    return state, {"host_launch_calls": host / n, "device_kernels": device / n,
                   "device_busy_ms": busy_us / n / 1e3}


#: 2D scenes at their demos' default resolutions: (builder, step, res)
SCENES_2D = {
    "shear_layer": ("shear_layer", "singlephase_step", (130, 130), {}),
    "shear_layer_kbc": ("shear_layer", "singlephase_step", (130, 130), {"kbc": True}),
    "multiphase_drop_sc": ("multiphase_drop_sc", "sc_step", (130, 130), {}),
    "multiphase_drop_hcz": ("multiphase_drop_hcz", "hcz_step", (130, 130), {}),
    "wave": ("wave", "hcz_step", (130, 130), {}),
    "droplet_spread_2d": ("droplet_spread_2d", "hcz_step", (130, 130), {}),
    "two_droplets_2d": ("two_droplets_2d", "ferrofluid_step", (98, 384), {}),
    "rosensweig_2d": ("rosensweig_2d", "ferrofluid_step", (130, 130), {}),
}

#: the largest relative change of the summed rho over 1000 steps at the
#: native resolutions (fluid cells of the multiphase scenes, every cell of
#: the periodic shear layer): about 1e-4 for the shear layer in float32
#: (.claude/skills/verify/SKILL.md); for the others 1.5 times the drift of
#: the JAX package's own float32 runs on the CPU, which the port's repeat
#: within 1e-3 (tests/test_torch_hcz2d.py::
#: test_native_1000_step_drift_matches_jax): the multiphase scenes' sharp
#: initial interfaces relax, which moves up to about 2 % of the fluid
#: cells' rho (``rho_drift`` in the phase's output)
SCENE_DRIFT = {"shear_layer": 2e-4, "shear_layer_kbc": 2e-4, "multiphase_drop_sc": 2e-2,
               "multiphase_drop_hcz": 3e-2, "wave": 2e-3, "droplet_spread_2d": 3e-2,
               "two_droplets_2d": 3e-2, "rosensweig_2d": 1e-2}

#: the paths whose ms a step and launches a step are reported, at native
#: size and at 2048^2: (scene key, params change, prime)
TIMED_2D = {
    "singlephase_bgk": ("shear_layer", {}, False),
    "singlephase_kbc": ("shear_layer_kbc", {}, False),
    "hcz": ("multiphase_drop_hcz", {}, False),
    "ferrofluid_scalar_carry": ("rosensweig_2d", {}, True),
    "ferrofluid_channel": ("rosensweig_2d", {"scalar_carry": False}, True),
}


def _scene_mass(state) -> float:
    rho = state.rho.double()
    if hasattr(state, "density"):
        return float(rho[state.flags == 1].sum())
    return float(rho.sum())


#: seconds the 2D jobs' processes may take, together
JOBS_2D_TIMEOUT = 400
#: the 2D scenes' drift runs in one process (45.7 and 48.0 s at 1000 steps
#: for each half when each scene runs alone on an H100; 250 steps now):
#: with the two 2000-step ``rosensweig_2d`` runs, the window's long pole,
#: three processes share the card (ten, one a run, slowed the short steps up
#: to 8x; four, up to 4x: every process more slows the others)
SCENE_GROUPS_2D = (("rosensweig_2d", "wave", "shear_layer_kbc", "shear_layer",
                    "two_droplets_2d", "droplet_spread_2d", "multiphase_drop_hcz",
                    "multiphase_drop_sc"),)


def scene_2d_run(dev, name, steps):
    """One 2D scene at its demo's default resolution through the runner
    (which primes the ferrofluid scenes into the scalar carry): ``steps``
    steps, fields finite, the summed rho within ``SCENE_DRIFT``."""
    import torch

    from lbm_ferrofluid_tpu_torch import models
    from lbm_ferrofluid_tpu_torch.models import SimulationRunner
    from lbm_ferrofluid_tpu_torch.models.runner import assert_finite

    build, step, res, kw = SCENES_2D[name]
    params, s0 = getattr(models, build)(res=res, device=dev, **kw)
    runner = SimulationRunner(params, getattr(models, step), device=dev)
    st = runner.prepare(s0)
    m0 = _scene_mass(st)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    st = runner.run(st, steps)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    assert_finite(st, fields=vars(st))
    drift = _scene_mass(st) / m0 - 1.0
    bar = SCENE_DRIFT[name]
    check(abs(drift) <= bar, f"2D {name}: summed rho drifted {drift:.3e} in {steps} steps")
    return {"res": list(res), "steps": st.step, "finite": True, "rho_drift": drift,
            "drift_bar": bar, "ms_per_step": seconds / steps * 1e3,
            "h_channels": st.h.shape[1] if hasattr(st, "h") else None}


def rosensweig_2d_run(dev, dtype, steps):
    """``rosensweig_2d`` at 64x64 with f, g and h in ``dtype`` (the runner
    primes it into the float32 scalar carry), stopped at each of ``steps``:
    per stop whether the density is finite, the fill height per column and
    the fluid mass."""
    import torch

    from lbm_ferrofluid_tpu_torch.models import (
        SimulationRunner, ferrofluid_step, init_ferrofluid_state, rosensweig_2d,
    )

    params, s0 = rosensweig_2d(res=(64, 64), mag_strength=100.0, device=dev)
    params = params.replace(fg_dtype=dtype, h_dtype=dtype)
    st = init_ferrofluid_state(params, s0.rho, s0.density, s0.vel, s0.flags,
                               s0.magnetic_flags, device=dev)
    runner = SimulationRunner(params, ferrofluid_step, device=dev)
    mid = 0.5 * (params.density_gas + params.density_fluid)
    marks, done = {}, 0
    t0 = time.perf_counter()
    for t in steps:
        st = runner.run(st, t - done)
        done = t
        marks[t] = {"finite": bool(torch.isfinite(st.density).all()),
                    "heights": (st.density[0, 0] > mid).sum(dim=0).double().cpu().tolist(),
                    "mass": float(st.rho.double()[st.flags == 1].sum())}
    torch.cuda.synchronize()
    return dict(marks=marks, seconds=time.perf_counter() - t0, storage=str(st.f.dtype),
                h=list(st.h.shape))


def job_2d(job_json) -> int:
    """One 2D job in a process of its own (``--2d-job``): scenes' drift runs
    one after another, or a ``rosensweig_2d`` run, with its launch counters zeroed just
    before and checked to be zero just after (2D paths launch no kernel);
    prints its row."""
    import torch

    from lbm_ferrofluid_tpu_torch.ops import kernels as kernels_pkg

    job = json.loads(job_json)
    check(torch.cuda.is_available(), "2D job: torch.cuda.is_available() is False")
    torch.set_num_threads(1)
    kernels_pkg.reset_launch_counts()
    if job["kind"] == "scenes":
        row = {"scenes": {name: scene_2d_run("cuda", name, job["steps"])
                          for name in job["names"]}}
    else:
        row = rosensweig_2d_run("cuda", job["dtype"], tuple(job["steps"]))
    launches = kernels_pkg.launch_counts()
    check(not any(launches.values()), f"2D job {job}: launched kernels: {launches}")
    print("JOB_2D " + json.dumps(dict(row, launches=launches)), flush=True)
    return 0


def jobs_2d(steps=250, bf16_steps=(1000, 2000)):
    """The 2D jobs of :func:`phase_2d`: the scenes of each group of
    ``SCENE_GROUPS_2D`` for ``steps``, and ``rosensweig_2d`` in float32
    and bfloat16 to each of ``bf16_steps``."""
    check(sorted(n for g in SCENE_GROUPS_2D for n in g) == sorted(SCENES_2D),
          "SCENE_GROUPS_2D does not hold every 2D scene once")
    jobs = [{"kind": "scenes", "names": list(g), "steps": steps} for g in SCENE_GROUPS_2D]
    return jobs + [{"kind": "rosensweig_2d", "dtype": dtype, "steps": list(bf16_steps)}
                   for dtype in ("float32", "bfloat16")]


def start_2d_jobs(jobs):
    """The 2D jobs started as concurrent processes on the card
    (``--2d-job``): (jobs, processes, start time).  Until
    :func:`run_2d_jobs` has waited for them, phase lines say
    ``beside_2d_jobs``."""
    import os

    procs = start_processes([[str(ROOT / "chip_smoke.py"), "--2d-job", json.dumps(j)]
                             for j in jobs], [dict(os.environ)] * len(jobs))
    _BESIDE_2D_JOBS.append(True)
    return jobs, procs, time.perf_counter()


def run_2d_jobs(started, meanwhile=()):
    """The callables ``meanwhile`` in this process while the 2D jobs
    ``started`` (:func:`start_2d_jobs`) run, then the jobs' end: their
    rows, in order, the callables' results and the jobs' wall seconds; a
    failing process fails the phase, and a failing callable stops the
    processes."""
    import os

    import torch

    jobs, procs, t0 = started
    # a core for each job's one thread (its steps are host-bound)
    threads = torch.get_num_threads()
    torch.set_num_threads(max(1, min(threads, (os.cpu_count() or 1) - len(jobs))))
    try:
        during = [fn() for fn in meanwhile]
        outs = wait_processes("2D jobs", procs, JOBS_2D_TIMEOUT, "JOB_2D")
    except BaseException:
        stop_processes(procs)
        raise
    finally:
        _BESIDE_2D_JOBS.clear()
        torch.set_num_threads(threads)
    for job, out in zip(jobs, outs):
        check(len(out) == 1, f"2D job {job}: {len(out)} rows")
    return [out[0] for out in outs], during, time.perf_counter() - t0


def phase_2d(dev, kernels_pkg, card, big=(2048, 2048), meanwhile=(), started=None):
    """Each 2D scene at its demo's default resolution (:func:`scene_2d_run`,
    250 steps; 1000 before the block route's phase ``mesh3d`` took their
    card time, 500 before its runs at two elements a rank did: fewer
    processes then share the card with the ``rosensweig_2d`` runs, the
    window's long pole), and ``rosensweig_2d`` in float32 and bfloat16 to
    1000 and 2000 steps (:func:`rosensweig_2d_run`, held by
    :func:`phase_rosensweig_2d_bf16`), as three concurrent processes on the
    card (:func:`jobs_2d`; ``started``, or started here), each checking
    that it launches no kernel, while this process runs the callables
    ``meanwhile`` (phases whose times no kernel row or bound reads; their
    lines say ``beside_2d_jobs``).  Then, in this process alone,
    the single-phase BGK and KBC, HCZ and ferrofluid (scalar carry and
    channel form) steps timed at native size and at ``big`` (2048^2, 4.2 M
    cells): ms a step over warm steps ending in ``torch.cuda.synchronize()``,
    and CUDA kernel launches a step from ``torch.profiler``, no kernel
    launched (counters zeroed just before, read just after).  Returns the
    ``rosensweig_2d`` runs by storage type and the results of
    ``meanwhile``."""
    import torch

    from lbm_ferrofluid_tpu_torch import models
    from lbm_ferrofluid_tpu_torch.models.runner import assert_finite

    out = {"phase": "scenes_2d", "card": card, "scenes": {}, "timed": {}}
    if started is None:
        torch.cuda.empty_cache()  # the jobs share the card
        started = start_2d_jobs(jobs_2d())
    rows, during, out["jobs_wall_s"] = run_2d_jobs(started, meanwhile)
    runs = {}
    for job, row in zip(started[0], rows):
        if job["kind"] == "scenes":
            out["scenes"].update(row["scenes"])
        else:
            runs[job["dtype"]] = row
    out["scenes"] = {name: out["scenes"][name] for name in SCENES_2D}
    kernels_pkg.reset_launch_counts()
    for label, (scene, change, prime) in TIMED_2D.items():
        build, step, res, kw = SCENES_2D[scene]
        step = getattr(models, step)
        for size in (res, big):
            params, st = getattr(models, build)(res=size, device=dev, **kw)
            params = params.replace(**change)
            if prime:
                st = models.prime_premac(params, st, device=dev)
            n = 200 if size == res else 20
            st, stats = timed_steps(params, st, step, dev, n_steps=n, warmup=10)
            st, prof = launches_per_step(params, st, step, dev)
            assert_finite(st, fields=vars(st))
            key = "native" if size == res else "x".join(map(str, size))
            out["timed"].setdefault(label, {})[key] = dict(
                res=list(size), ms_per_step=stats["seconds"] / n * 1e3, mlups=stats["mlups"],
                h_channels=st.h.shape[1] if hasattr(st, "h") else None, **prof)
            del st
        torch.cuda.empty_cache()
    launches = kernels_pkg.launch_counts()
    check(not any(launches.values()), f"2D timed paths launched kernels: {launches}")
    emit(dict(out, launches=launches, ok=True))
    return runs, during


def phase_rosensweig_2d_bf16(card, runs, steps=(1000, 2000)):
    """tests/test_bf16_physics.py on the card: ``rosensweig_2d`` at 64x64
    for 2000 steps with f, g and h in bfloat16 and in float32 (``runs``,
    from :func:`phase_2d`'s processes), with that test's assertions
    (:61-88): finite, fluid mass at rtol 5e-3 at 1000 and 2000 steps, the
    fill height per column within 2 cells pointwise at 1000, the float32
    pool corrugated by 2 cells or more at 2000, the mean level within 1
    cell, the bfloat16 corrugation in [0.3, 3] times float32's and the mean
    pointwise height difference within 3 cells."""
    a = {t: dict(m, heights=np.asarray(m["heights"])) for t, m in
         ((int(t), m) for t, m in runs["float32"]["marks"].items())}
    b = {t: dict(m, heights=np.asarray(m["heights"])) for t, m in
         ((int(t), m) for t, m in runs["bfloat16"]["marks"].items())}
    first, last = steps[0], steps[-1]
    h32, h16 = a[last]["heights"], b[last]["heights"]
    amp32, amp16 = float(np.ptp(h32)), float(np.ptp(h16))
    row = {"phase": "rosensweig_2d_bf16", "res": [64, 64], "steps": list(steps), "card": card,
           "mass_rel": {t: b[t]["mass"] / a[t]["mass"] - 1.0 for t in steps},
           "pointwise_height_diff_first": float(
               np.abs(b[first]["heights"] - a[first]["heights"]).max()),
           "mean_level_diff_last": float(h16.mean() - h32.mean()),
           "corrugation_last": {"float32": amp32, "bfloat16": amp16},
           "mean_pointwise_diff_last": float(np.abs(h16 - h32).mean()),
           "seconds": {k: v["seconds"] for k, v in runs.items()},
           "storage": {k: v["storage"] for k, v in runs.items()},
           "concurrent_processes": True}
    failed = []
    for t in steps:
        if not (a[t]["finite"] and b[t]["finite"]):
            failed.append(f"rosensweig_2d bf16: non-finite at step {t}")
        if abs(row["mass_rel"][t]) > 5e-3:
            failed.append(f"rosensweig_2d bf16: mass {row['mass_rel'][t]:.3e} at step {t}")
    if row["pointwise_height_diff_first"] > 2:
        failed.append(f"rosensweig_2d bf16: heights apart by more than 2 cells at step {first}")
    if amp32 < 2 or amp16 < 2:
        failed.append(f"rosensweig_2d bf16: no corrugation ({amp32}, {amp16})")
    if abs(row["mean_level_diff_last"]) > 1.0:
        failed.append(f"rosensweig_2d bf16: mean level {row['mean_level_diff_last']} cells apart")
    if not 0.3 * amp32 <= amp16 <= 3.0 * amp32:
        failed.append(f"rosensweig_2d bf16: corrugation {amp16} against {amp32}")
    if row["mean_pointwise_diff_last"] > 3.0:
        failed.append("rosensweig_2d bf16: mean pointwise height difference over 3 cells")
    emit(dict(row, ok=not failed))
    check(not failed, "; ".join(failed))


def grad_guard_calls(dev, res=(8, 16, 32)):
    """Per kernel id: a call of its wrapper on ``dev`` tensors of ``res``
    whose lead float input requires grad (the values do not matter: the
    guard runs before any other check)."""
    import torch

    def t(*c, dtype=torch.float32):
        return torch.zeros((1, *c, *res), device=dev, dtype=dtype)

    s, v, f = t(1), t(3), t(19)
    fl = t(1, dtype=torch.uint8)
    gas = dict(rho_gas=0.1, rho_fluid=0.2, density_gas=0.1, density_fluid=0.2)
    x = {kid: t(c).requires_grad_(True) for kid, c in (("B1", 2), ("s", 1), ("v", 3))}
    fg = f.clone().requires_grad_(True)
    return {
        "B1": lambda w: w(x["B1"], s, s, n_iters=2, h_ext=(0.0, 1.0, 0.0)),
        "B2": lambda w: w(x["s"], fl, 1.0),
        "B3": lambda w: w(fg, f, fl, s, s, s, s, s, s, v, v, fl, kappa=0.1,
                          gravity=(0.0, 0.0, 0.0), tau_f=0.7, tau_g=0.7,
                          emit_rhs=(1, 1.0, 1.0), **gas),
        "B4": lambda w: w(fg, f, fl, s, v, c=1.0, **gas),
        "B5": lambda w: w(fg, f, fl, s, v, s, s, v, v, v, tau_f=0.7, tau_g=0.7),
        "B6": lambda w: w(x["s"], s, s, s, None, None, fl, s, v, v, kappa=0.1,
                          gravity=(0.0, 0.0, 0.0), **gas),
        "B8a": lambda w: w(fg, fl),
        "B8b": lambda w: w(fg, fl, s, v, c=1.0, **gas),
        "B9": lambda w: w(fg, f, s, v, s, s, fl, v, v, v, tau_f=0.7, tau_g=0.7),
        "B10a": lambda w: w(x["v"], dx=1.0),
        "B10b": lambda w: w(x["s"], dx=1.0),
        "B11b": lambda w: w(fg, fl, s, tau=0.8, n_iters=2),
    }


def phase_grad_guard(dev, kernels_pkg):
    """Each kernel wrapper of ``KERNELS``, given a CUDA input that requires
    grad with grad enabled, raises (``ops/kernels/_lib.py:check_no_grad``)
    and launches nothing."""
    K = kernels_pkg.KERNELS
    calls = grad_guard_calls(dev)
    check(sorted(calls) == sorted(K),
          f"grad guard: calls for {sorted(calls)}, kernels {sorted(K)}")
    kernels_pkg.reset_launch_counts()
    raised = {}
    for kid, k in K.items():
        try:
            calls[kid](k.wrapper)
            raised[kid] = None
        except RuntimeError as e:
            raised[kid] = str(e)
        check(raised[kid] is not None and "an input requires grad" in raised[kid],
              f"grad guard: {kid} did not raise under autograd ({raised[kid]})")
    launches = kernels_pkg.launch_counts()
    check(not any(launches.values()), f"grad guard: launches {launches}")
    emit({"phase": "grad_guard", "kernels": sorted(raised), "message": raised["B9"],
          "ok": True})


def compat_loop(cp, params, state):
    """The reference-style HCZ loop (tests/test_compat.py's order) through
    the facade ``cp`` (``lbm_ferrofluid_tpu_torch.compat``) from an HCZ
    state: returns ``step()``, which steps the facade's fields once, and
    ``fields()``, the state's names for them."""
    sp = cp.SimulationParameters(
        dim=3, simulation_size=(1, 1, *state.rho.shape[2:]), Q=19, kappa=params.kappa,
        tau_f=params.tau_f, tau_g=params.tau_g, tau=params.tau,
        contact_angle=params.contact_angle, rho_gas=params.rho_gas,
        rho_fluid=params.rho_fluid, density_gas=params.density_gas,
        density_fluid=params.density_fluid, device=state.rho.device.type)
    runner = cp.SimulationRunner(sp)
    prop, macro = runner.create_propagation(), runner.create_macro_compute()
    coll = runner.create_collision_HCZ()
    check(params.gravity_axis == 1, "compat: the facade's gravity acts along -y")
    coll.set_gravity(gravity=params.gravity)
    fl = state.flags
    d = dict(f=state.f, g=state.g, rho=state.rho, vel=state.vel, density=state.density,
             pressure=state.pressure, force=state.force)
    dx, dt = params.dx, params.dt

    def step():
        f = prop.propagation(f=d["f"])
        g = prop.propagation(f=d["g"])
        rho, vel, den = macro.macro_compute(dx=dx, dt=dt, f=f, rho=d["rho"], vel=d["vel"],
                                            flags=fl, density=d["density"])
        f = prop.rebounce_obstacle(f=f, flags=fl)
        g = prop.rebounce_obstacle(f=g, flags=fl)
        rho, vel, den, pres, force, dfai, dprho = coll.capillary_process(
            rho=rho, vel=vel, flags=fl, force=d["force"], dt=dt, dx=dx, g=g, density=den,
            pressure=d["pressure"])
        f, g = coll.collision(dx=dx, dt=dt, f=f, rho=rho, vel=vel, density=den, flags=fl,
                              force=force, g=g, pressure=pres, dfai=dfai, dprho=dprho)
        runner.step()
        d.update(f=f, g=g, rho=rho, vel=vel, density=den, pressure=pres, force=force)

    return step, d, coll


def phase_compat(dev, kernels_pkg, card):
    """The reference's driver API through ``compat.py`` on the card, op by
    op: the 3D HCZ loop on ``multiphase_3d`` at 130^3, 10 steps held to
    :func:`stencil_hcz_step` at phase 3's bars, then 100 steps (counters
    zeroed just before, read just after: B2, B10b, B10a and B9 once a
    step), finite, summed rho's drift; ms a step at 130^3 and 256^3; and
    ``capillary_process`` with ``H2``/``phi`` (B10a over 4 fields) against
    the plain ops on the same inputs."""
    import torch

    from lbm_ferrofluid_tpu_torch import compat as cp
    from lbm_ferrofluid_tpu_torch.models import multiphase_3d
    from lbm_ferrofluid_tpu_torch.ops.collide import contact_angle_boundary, hcz_capillary
    from lbm_ferrofluid_tpu_torch.ops.moments import phi_from_density
    from lbm_ferrofluid_tpu_torch.utils.diagnostics import assert_finite

    K = kernels_pkg.KERNELS
    out = {"phase": "compat", "card": card}
    params, s0 = multiphase_3d(device=dev)
    step, d, coll = compat_loop(cp, params, s0)
    sk = s0
    for _ in range(10):
        step()
        sk = stencil_hcz_step(params, sk, device=dev)
    out["facade_vs_stencil_route_after_10_steps"] = compare(
        "compat vs stencil route", list(HCZ_FIELDS), [d[n] for n in HCZ_FIELDS],
        [getattr(sk, n) for n in HCZ_FIELDS])
    del sk
    mass10 = float(d["rho"].double()[s0.flags == 1].sum())
    kernels_pkg.reset_launch_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(100):
        step()
    torch.cuda.synchronize()
    out["ms_per_step"] = {"130^3": (time.perf_counter() - t0) / 100 * 1e3}
    launches = kernels_pkg.launch_counts()
    check_launches("compat", launches, {kid: 1 for kid in kernels_pkg.PATHS["compat3d"]}, 100)
    assert_finite(types.SimpleNamespace(**d, step=110), fields=tuple(d))
    mass110 = float(d["rho"].double()[s0.flags == 1].sum())
    out["sum_rho_fluid"] = {"step10": mass10, "step110": mass110,
                            "drift_10_to_110": (mass110 - mass10) / mass10}
    # capillary_process with the Kelvin term against the plain ops
    rng = np.random.default_rng(21)
    H2 = 1e4 * (1 + torch.as_tensor(rng.uniform(-0.1, 0.1, (1, 1, *s0.rho.shape[2:])),
                                    dtype=torch.float32, device=dev))
    phi = phi_from_density(d["density"], params.density_gas, params.density_fluid)
    args = dict(rho=d["rho"], vel=d["vel"], flags=s0.flags, force=d["force"], g=d["g"],
                density=d["density"], pressure=d["pressure"], H2=H2, phi=phi)
    before = K["B10a"].wrapper.launches
    got = coll.capillary_process(**args)
    check(K["B10a"].wrapper.launches - before == 1, "compat: B10a over 4 fields, not 1 launch")
    gravity = torch.as_tensor(coll._gravity, device=dev)
    want = hcz_capillary(d["rho"], d["vel"], s0.flags, d["density"], d["pressure"],
                         contact_angle_boundary(d["rho"], s0.flags, params.contact_angle),
                         H2, phi, g=d["g"], kappa=params.kappa, gravity=gravity,
                         rho_gas=params.rho_gas, rho_fluid=params.rho_fluid,
                         density_gas=params.density_gas, density_fluid=params.density_fluid)
    out["capillary_process_kelvin_vs_plain"] = compare(
        "compat capillary_process with H2", ["rho", "vel", "density", "pressure", "force",
                                             "dfai", "dprho"], got, want)
    del d, got, want, args, s0
    torch.cuda.empty_cache()
    params, s0 = multiphase_3d(res=(256, 256, 256), device=dev)
    step, d, _ = compat_loop(cp, params, s0)
    del s0
    step()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(20):
        step()
    torch.cuda.synchronize()
    out["ms_per_step"]["256^3"] = (time.perf_counter() - t0) / 20 * 1e3
    del d
    torch.cuda.empty_cache()
    emit(dict(out, launches=launches, ok=True))
    return launches


#: DIB-R card-vs-CPU bars: float64 images, probability maps and normals
#: (rel), vertex gradients (rel), and float32 textures (abs)
DIBR_REL, DIBR_GRAD_REL, TEX_ABS = 1e-9, 1e-8, 1e-6


def droplet_mesh(res):
    """The ``multiphase_3d`` droplet's interface as the demos mesh it
    (``phi_to_mesh`` of the density's phi): numpy (verts, faces)."""
    from lbm_ferrofluid_tpu_torch.models import multiphase_3d
    from lbm_ferrofluid_tpu_torch.ops.moments import phi_from_density
    from lbm_ferrofluid_tpu_torch.render import phi_to_mesh

    params, st = multiphase_3d(res=res, device="cpu")
    return phi_to_mesh(phi_from_density(st.density, params.density_gas, params.density_fluid),
                       res)


def dibr_inputs(verts, where, dtype, seed=5):
    """The DIB-R inputs of each mode for ``verts`` on ``where``: (cameras,
    points, {mode: extra args}), seeded."""
    import torch

    from lbm_ferrofluid_tpu_torch.render import dibr, meshutils

    rng = np.random.default_rng(seed)
    P = len(verts)

    def t(a):
        return torch.as_tensor(np.asarray(a, np.float64), dtype=dtype, device=where)

    rot, pos = dibr.lookat_camera((1.6, 1.1, 2.4), (0, 0, 0), (0, 1, 0))
    cams = (t(rot)[None], t(pos)[None], t(dibr.perspective_proj_matrix(math.radians(45.0))))
    uv = (meshutils.get_spherical_coords_x(verts) + 1) / 2
    tex = rng.uniform(0, 1, (1, 3, 64, 64))
    light = np.asarray([[0.3, 0.5, 0.8]]) / np.linalg.norm([0.3, 0.5, 0.8])
    args = {"VertexColor": [rng.uniform(0, 1, (1, P, 3))],
            "Lambertian": [uv[None], tex],
            "SphericalHarmonics": [uv[None], tex, rng.normal(size=(1, 9))],
            "Phong": [uv[None], tex, light, rng.uniform(0.2, 0.8, (1, 3, 3)), [[4.0]]]}
    return cams, t(verts)[None], {m: [t(a) for a in v] for m, v in args.items()}


def phase_dibr(dev, card, res=(32, 32, 32), image=256, big=(130, 130, 130)):
    """The DIB-R stack on the card against the same calls with
    ``device="cpu"``: the ``multiphase_3d`` droplet's interface at ``res``
    rendered at ``image`` pixels in all four modes (float64 within
    ``DIBR_REL``), ms a frame on each side (and of the card in float32)
    and the card's peak bytes; the vertex gradient of an image loss (float64,
    64 pixels, the 16^3 droplet) within ``DIBR_GRAD_REL``; ms a frame of
    the ``big`` droplet's interface (card only; the default run takes
    64^3, ``--dibr`` 130^3); ``voxelize`` of the
    Rosensweig interface (130x66x130, the demo's phi) at 128^3, the
    boolean grids equal; ``load_textures`` within ``TEX_ABS``."""
    import importlib

    import torch

    from lbm_ferrofluid_tpu_torch.models import rosensweig_3d
    from lbm_ferrofluid_tpu_torch.ops.moments import phi_from_density
    from lbm_ferrofluid_tpu_torch.render import dibr, phi_to_mesh

    voxelize = importlib.import_module("lbm_ferrofluid_tpu_torch.render.voxelize").voxelize
    load_textures = importlib.import_module(
        "lbm_ferrofluid_tpu_torch.render.texture").load_textures
    out = {"phase": "dibr", "card": card, "image": image, "modes": {}}
    verts, faces = droplet_mesh(res)
    out["droplet"] = {"res": list(res), "faces": len(faces)}
    names = ("color", "improb", "normal")
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    for mode in ("VertexColor", "Lambertian", "SphericalHarmonics", "Phong"):
        imgs, ms = [], {}
        for where in (dev, "cpu"):
            cams, pts, args = dibr_inputs(verts, where, torch.float64)
            r = dibr.Renderer(image, image, mode)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            imgs.append([x.cpu() for x in r((pts, faces), cams, *args[mode])])
            torch.cuda.synchronize()
            ms["card" if where == dev else "cpu"] = (time.perf_counter() - t0) * 1e3
        rel = {n: float((a - b).abs().max() / b.abs().max().clamp_min(1e-300))
               for n, a, b in zip(names, *imgs)}
        check(max(rel.values()) <= DIBR_REL, f"dibr {mode}: card vs CPU {rel}")
        check(bool((imgs[0][1] == 1.0).any()) and bool((imgs[0][1] < 0.5).any()),
              f"dibr {mode}: nothing covered or nothing uncovered")
        # the card's frame in float32
        cams, pts, args = dibr_inputs(verts, dev, torch.float32)
        out["modes"][mode] = {"float64": {"ms_per_frame": ms, "rel": rel},
                              "ms_per_frame_card_f32": time_cuda(
                                  lambda: r((pts, faces), cams, *args[mode]), 1, warm=0)}
    out["peak_bytes"] = torch.cuda.max_memory_allocated() - base
    # gradient of an image loss with respect to the vertices, card vs CPU
    gv, gf = droplet_mesh((16, 16, 16))
    grads = []
    for where in (dev, "cpu"):
        cams, pts, args = dibr_inputs(gv, where, torch.float64)
        w = torch.as_tensor(np.random.default_rng(8).normal(size=(1, 64, 64, 3)),
                            device=where)
        pts.requires_grad_(True)
        img, prob, _ = dibr.Renderer(64, 64)((pts, gf), cams, *args["VertexColor"])
        (torch.sum(img * w) + torch.sum(prob * w[..., :1])).backward()
        grads.append(pts.grad.cpu())
    rel = float((grads[0] - grads[1]).abs().max() / grads[1].abs().max())
    out["vertex_grad"] = {"faces": len(gf), "image": 64, "rel": rel,
                          "max_abs": float(grads[1].abs().max())}
    check(rel <= DIBR_GRAD_REL and float(grads[1].abs().max()) > 0,
          f"dibr: vertex gradient card vs CPU {out['vertex_grad']}")
    # a frame of the ``big`` droplet's interface on the card
    bv, bf = droplet_mesh(big)
    cams, pts, args = dibr_inputs(bv, dev, torch.float32)
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    r = dibr.Renderer(image, image)
    out["droplet_big"] = {"res": list(big), "faces": len(bf), "ms_per_frame_card_f32": time_cuda(
        lambda: r((pts, bf), cams, *args["VertexColor"]), 1, warm=0),
        "peak_bytes_f32": torch.cuda.max_memory_allocated() - base}
    del pts, args, cams
    # voxelize the Rosensweig interface at 128^3, card vs CPU
    params, st = rosensweig_3d(device="cpu")
    rres = tuple(st.rho.shape[2:])
    rv, rf = phi_to_mesh(phi_from_density(st.density, params.density_gas,
                                          params.density_fluid), rres)
    tri = (rv[rf] + 1.0) / 2.0
    grids, ms = [], {}
    for where in (dev, "cpu"):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        grids.append(voxelize(torch.as_tensor(tri[None], device=where), 128,
                              normalize=True).cpu())
        torch.cuda.synchronize()
        ms["card" if where == dev else "cpu"] = (time.perf_counter() - t0) * 1e3
    equal = bool(torch.equal(grids[0], grids[1]))
    out["voxelize"] = {"res": list(rres), "faces": len(rf), "voxel_size": 128,
                       "solid": int(grids[1].sum()), "equal": equal, "ms": ms}
    check(equal and int(grids[1].sum()) > 0, f"voxelize: card vs CPU {out['voxelize']}")
    # texture atlases, card vs CPU
    rng = np.random.default_rng(13)
    img = rng.uniform(0, 1, (256, 256, 3)).astype(np.float32)
    fuv = rng.uniform(0, 1, (len(faces), 3, 2)).astype(np.float32)
    upd = rng.uniform(size=len(faces)) > 0.2
    tex = [load_textures(torch.as_tensor(img, device=where), torch.as_tensor(fuv, device=where),
                         4, torch.as_tensor(upd, device=where)).cpu() for where in (dev, "cpu")]
    err = float((tex[0] - tex[1]).abs().max())
    out["load_textures"] = {"faces": len(faces), "texture_res": 4, "max_abs": err,
                            "bar": TEX_ABS}
    check(err <= TEX_ABS, f"load_textures: card vs CPU {err}")
    emit(dict(out, ok=True))


def phase_native(card):
    """The port's native library: its build time (a fresh build into a
    temporary directory) and marching tetrahedra at 130x66x130 on the
    Rosensweig interface's volume (the one ``phi_to_mesh`` extracts):
    native against the numpy path, the triangle sets within
    ``TRI_NATIVE`` (``triangle_set_distance`` on the card), ms of each."""
    import tempfile

    import torch

    from lbm_ferrofluid_tpu_torch import native
    from lbm_ferrofluid_tpu_torch.models import rosensweig_3d
    from lbm_ferrofluid_tpu_torch.ops.moments import phi_from_density
    from lbm_ferrofluid_tpu_torch.render.mesh import marching_tetrahedra_numpy

    out = {"phase": "native", "card": card}
    saved = native.BUILD_DIR
    with tempfile.TemporaryDirectory() as tmp:
        native.BUILD_DIR = pathlib.Path(tmp)
        t0 = time.perf_counter()
        native.build()
        out["build_seconds"] = time.perf_counter() - t0
    native.BUILD_DIR = saved
    check(native.available(), "native: the library did not build")
    params, st = rosensweig_3d(device="cpu")
    res = tuple(st.rho.shape[2:])
    phi = phi_from_density(st.density, params.density_gas, params.density_fluid).numpy()
    closed = np.pad(phi[..., 1:-1, 1:-1, 1:-1], [(0, 0)] * 2 + [(1, 1)] * 3,
                    constant_values=float(phi.max()))
    vol = -closed[0, 0] * (2.0 / max(res))
    ms, meshes = {}, {}
    for name, fn in (("numpy", marching_tetrahedra_numpy),
                     ("native", native.marching_tetrahedra_native)):
        times = []
        for _ in range(2):
            t0 = time.perf_counter()
            meshes[name] = fn(vol, 0.0)
            times.append((time.perf_counter() - t0) * 1e3)
        ms[name] = min(times)
    (vn, fn_), (vc, fc) = meshes["numpy"], meshes["native"]
    dist = triangle_set_distance(torch.as_tensor(vc[fc], device="cuda"),
                                 torch.as_tensor(vn[fn_], device="cuda"))
    out.update(res=list(res), faces={"numpy": len(fn_), "native": len(fc)}, ms=ms,
               speedup=ms["numpy"] / ms["native"], set_distance=dist, bar=TRI_NATIVE)
    check(len(fc) == len(fn_) > 0 and dist <= TRI_NATIVE, f"native: {out}")
    emit(dict(out, ok=True))


#: how far the native and numpy triangle sets may lie apart (float32
#: volume against float64)
TRI_NATIVE = 1e-5


def phase_inverse(dev, kernels_pkg, card, grids=((24, 24), (130, 130))):
    """The inverse-design driver on the card at its default 24x24 and at
    the 2D demos' 130x130 (4 steps, 40 Adam iterations, lr 0.02): the loss
    curve, ms an iteration, and a fall of at least 2x; no kernel launches
    (2D steps run plain PyTorch ops)."""
    import tempfile

    from lbm_ferrofluid_tpu_torch.demo import demo_inverse_design as demo

    out = {"phase": "inverse", "card": card, "runs": {}}
    kernels_pkg.reset_launch_counts()
    for res in grids:
        with tempfile.TemporaryDirectory() as tmp:
            try:
                r = demo.main(["--res", *map(str, res), "--out_dir", tmp])
            except SystemExit as e:
                raise CheckFailed(f"inverse {res}: {e}") from None
            pngs = sorted(p.name for p in pathlib.Path(tmp).glob("*.png"))
        losses = r["losses"]
        out["runs"]["x".join(map(str, res))] = {
            "losses": losses, "final": r["final"], "fall": losses[0] / r["final"],
            "ms_per_iter": r["seconds"] / len(losses) * 1e3, "pngs": pngs}
        check(r["final"] < 0.5 * losses[0] and len(pngs) == 3, f"inverse {res}: {r}")
    launches = kernels_pkg.launch_counts()
    check(not any(launches.values()), f"inverse: kernels launched {launches}")
    emit(dict(out, ok=True))


# ---------------------------------------------------------------- padded layout
#: output names of B3's box form, in return order (force appended last)
OUTPUTS_B3_BOX = ["f", "g", "vel", "pressure", "density", "mac_rho", "mac_vel", "mac_density",
                  "mac_m0g", "mac_m1g", "force"]
#: fields compared through ``phys_view`` after padded steps, and which are vectors
PADDED_FIELDS = (("f", False), ("g", False), ("h", False), ("rho", False), ("vel", True),
                 ("density", False), ("pressure", False), ("force", True), ("phi", False))


def padded_inputs(seed, dev, bf16=False):
    """Seeded inputs of B1's psi form, its H2 launch on the box and B3's box
    form on the padded transposed Rosensweig scene at its full width
    (130x66x130 physical, 66x136x256 array), as :func:`seeded_inputs`
    makes them for the plain layout: the scene's macros perturbed, f =
    feq and g = geq with 0.1 % noise (rounded to bfloat16 with ``bf16``),
    the carried macros from the plain prologue, rho_ca from the plain
    contact angle on the box, H2 about mag^2, a seeded scalar carry and
    source."""
    import torch

    from lbm_ferrofluid_tpu_torch.models import ferrofluid as ff
    from lbm_ferrofluid_tpu_torch.models import rosensweig_3d_tpu
    from lbm_ferrofluid_tpu_torch.ops.equilibrium import feq, geq
    from lbm_ferrofluid_tpu_torch.ops.kernels.fused_step import lbm_prologue_plain
    from lbm_ferrofluid_tpu_torch.ops.moments import eos_pressure, rho_to_density
    from lbm_ferrofluid_tpu_torch.ops.scalar_poisson import make_cmask

    params, st = rosensweig_3d_tpu(device=dev)
    rng = np.random.default_rng(seed)
    shape = tuple(st.rho.shape)

    def t(a):
        return torch.as_tensor(np.asarray(a, np.float32), device=dev)

    fluid = (st.flags == 1).float()
    mfluid = (st.magnetic_flags == 1).float()
    gas = dict(rho_gas=params.rho_gas, rho_fluid=params.rho_fluid,
               density_gas=params.density_gas, density_fluid=params.density_fluid)
    rho = st.rho + t(1e-3 * rng.uniform(-1, 1, shape))
    den = rho_to_density(rho, **gas)
    vel = t(0.01 * rng.uniform(-1, 1, (1, 3, *shape[2:]))) * fluid
    pres = eos_pressure(den)
    f_eq = feq(params.lattice, den, vel)
    f = f_eq * (1 + t(1e-3 * rng.standard_normal((1, 19, *shape[2:]))))
    g = geq(params.lattice, rho, den, pres, f_eq) * (
        1 + t(1e-3 * rng.standard_normal((1, 19, *shape[2:]))))
    if bf16:
        f, g = f.to(torch.bfloat16), g.to(torch.bfloat16)
    rho_pre, vel_pre, den_pre, gsum, gmom = lbm_prologue_plain(
        f, g, st.flags, rho, vel, c=params.dx / params.dt, **gas)
    cmask = make_cmask(st.magnetic_flags)
    return params, dict(
        flags=st.flags, mflags=st.magnetic_flags, f=f, g=g, pres=pres, rho_pre=rho_pre,
        vel_pre=vel_pre, den_pre=den_pre, gsum=gsum, gmom=gmom,
        rho_ca=ff._contact_angle(params, rho_pre, st.flags, plain=True),
        H2=params.mag_strength ** 2 * (1 + t(0.1 * rng.uniform(-1, 1, shape))),
        s2=t(rng.standard_normal((1, 2, *shape[2:]))) * mfluid, cmask=cmask,
        rhs=t(1e-3 * rng.standard_normal(shape)) * mfluid,
        psi=t(rng.standard_normal(shape)))


def padded_calls(params, d):
    """(wrapper args, kwargs) of B1's psi form and B3's box form at ``d``."""
    gas = dict(rho_gas=params.rho_gas, rho_fluid=params.rho_fluid,
               density_gas=params.density_gas, density_fluid=params.density_fluid)
    return {
        "B1": ((d["s2"], d["cmask"], d["rhs"]),
               dict(n_iters=params.poisson_iters, emit="psi")),
        "B3": ((d["f"], d["g"], d["flags"], d["rho_pre"], d["den_pre"], d["pres"],
                d["rho_ca"], d["H2"], d["gsum"], d["gmom"], d["vel_pre"], None),
               dict(kappa=params.kappa,
                    gravity=tuple(float(v) for v in params.gravity_vec().reshape(-1)),
                    tau_f=params.tau_f, tau_g=params.tau_g, dx=params.dx, dt=params.dt,
                    emit_rhs=None, emit_force=True, bounds=tuple(params.phys_extent[1:]),
                    **gas)),
    }


def padded_form_rows(K, kid, args, kw, what):
    """Rows of B1's psi form (s2, psi) or B3's box form against its plain
    version: float32 at phase 3's bars; in bfloat16 f'/g' within one ulp in
    a bounded share, the float32 outputs at phase 3's bars, the emission
    held to the plain prologue on the kernel's own f'/g'."""
    import torch

    got = K[kid].wrapper(*args, **kw)
    want = K[kid].plain(*args, **kw)
    torch.cuda.synchronize()
    if kid == "B1":
        return compare(what, ["s2", "psi"], got, want)
    if got[0].dtype != torch.bfloat16:
        return compare(what, OUTPUTS_B3_BOX, got, want)
    names = OUTPUTS_B3_BOX
    rows = compare_bf16(what, names[:2], got[:2], want[:2])
    rows.update(compare(what, names[2:5] + names[10:], [*got[2:5], got[6]],
                        [*want[2:5], want[6]]))
    c = kw["dx"] / kw["dt"]
    gas = {n: kw[n] for n in ("rho_gas", "rho_fluid", "density_gas", "density_fluid")}
    mac = K["B4"].plain(got[0], got[1], args[2], args[6], got[2], c=c, **gas)
    rows.update(compare(f"{what} (emission on its own f'/g')", names[5:10], got[5], mac))
    return rows


def step_profile(params, state, step, dev, n=5, top=10):
    """Where a step's device time goes, from ``torch.profiler`` over ``n``
    steps: the device's busy ms a step, the CUDA kernels a step, and the
    ``top`` kernels by device time with their ms and launches a step."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            state = step(params, state, device=dev)
        torch.cuda.synchronize()
    rows = [(getattr(e, "self_device_time_total", 0.0) or 0.0, e.count, e.key)
            for e in prof.key_averages()
            if e.device_type == torch.autograd.DeviceType.CUDA]
    rows.sort(reverse=True)
    return state, {
        "device_busy_ms": sum(r[0] for r in rows) / n / 1e3,
        "device_kernels": sum(r[1] for r in rows) / n,
        "top": [{"kernel": k[:80], "ms": us / n / 1e3, "launches": cnt / n}
                for us, cnt, k in rows[:top]]}


def padded_phys(params, state, fields=PADDED_FIELDS):
    """The state's fields (and premac leaves) through ``phys_view``."""
    from lbm_ferrofluid_tpu_torch.models import scenes

    names = [n for n, _ in fields] + [f"premac_{i}" for i in range(len(state.premac or ()))]
    vals = [scenes.phys_view(params, getattr(state, n), vector=v) for n, v in fields]
    vals += [scenes.phys_view(params, x, vector=x.shape[1] == 3) for x in state.premac or ()]
    return names, vals


def phase_padded(dev, kernels_pkg, card, steps=30, timed=200):
    """The padded transposed layout (``scenes.rosensweig_3d_tpu``) at the
    full width of the native demo, 130x66x130 physical in a 66x136x256
    array, on the card:

    - forms: B1's psi form (30 sweeps) and B3's box form (``bounds``,
      ``emit_rhs=None``, ``emit_force``), float32 and bfloat16, and B1's
      H2 launch on the box copy (``_h2_box``), against their plain versions
      on seeded inputs at phase 3's bars (bfloat16 as phase 7 holds it),
      each timed beside its plain version and its bound (``cost``);
    - the capillogue route, counters zeroed just before and read just
      after: primed (B4 once, a 5-leaf premac) and ``steps`` kernel steps
      against ``steps`` ``plain=True`` steps through ``phys_view``, with
      exact launches a step (B1's psi passes and the H2 launch on the box,
      B2 on the box, B3's box form without its source launch); then
      against the port's native 130x66x130 layout after the same
      ``steps`` (its capillogue steady state), through ``phys_view``;
    - ``timed`` more steps: ms a step and MLUPS in array and in physical
      cells (as ``bench.py:run_native_demo`` counts them), beside the
      native layout's ms a step in the same call;
    - the un-carried route (premac None: B4, B1, B2 on the box, the plain
      capillary stage on the box, B5), 10 kernel steps against 10 plain;
    - turbo (bfloat16 f/g): primed, ``steps`` kernel steps against
      ``steps`` plain (pointwise after 10 and statistically after
      ``steps``, as phase 7) and against float32, every f/g kernel in its
      bfloat16 form;
    - the demo driver with ``--tpu_layout 1``: 20 steps at 130x66x130
      with a frame at step 20, its frames and OBJ through ``phys_view``.

    Returns the launches per kernel id of these paths, those of the
    bfloat16 forms, and the rows of the new forms for the ``kernels`` line."""
    import pathlib
    import tempfile

    import torch

    from lbm_ferrofluid_tpu_torch.demo import demo_3d_LBM_Rosensweig_instability as demo
    from lbm_ferrofluid_tpu_torch.models import (
        SimulationRunner, ferrofluid_step, prime_premac, rosensweig_3d, rosensweig_3d_tpu,
        scenes,
    )
    from lbm_ferrofluid_tpu_torch.models import ferrofluid as ff
    from lbm_ferrofluid_tpu_torch.ops.kernels import capillogue as cap_mod
    from lbm_ferrofluid_tpu_torch.ops.kernels import scalar_poisson as sp_mod
    from lbm_ferrofluid_tpu_torch.utils.diagnostics import assert_finite
    from lbm_ferrofluid_tpu_torch.utils.io import read_png

    K = kernels_pkg.KERNELS
    out = {"phase": "padded", "card": card}

    # the new forms on seeded inputs, float32 and bfloat16
    forms = {}
    for bf16 in (False, True):
        params, d = padded_inputs(14, dev, bf16)
        calls = padded_calls(params, d)
        tag = " bf16" if bf16 else ""
        for kid in ("B1", "B3") if not bf16 else ("B3",):
            args, kw = calls[kid]
            per_call = (sp_mod.launches_per_call(params.poisson_iters, d["s2"].shape, "psi")
                        if kid == "B1" else cap_mod.launches_per_call(None))
            forms[kid + tag] = measure(K, kid, args, kw, per_call, per_call,
                                       f"padded {kid}{tag} form", rows=padded_form_rows)
        if not bf16:
            psi, cmask = d["psi"], d["cmask"]
            h2 = ff._h2_box(params, psi, cmask, plain=False)
            h2_rows = compare("padded B1 H2 on the box", ["H2"], h2,
                              ff._h2_box(params, psi, cmask, plain=True))
            box = tuple(scenes.phys_view(params, x).contiguous() for x in (psi, cmask))
            h_ext = (0.0, params.mag_strength, 0.0)
            moved, flops = sp_mod.cost_h2(*box)
            forms["B1 H2 on the box"] = {
                "ms": time_cuda(lambda: sp_mod.scalar_h2(*box, params.dx, h_ext), 10),
                "plain_ms": time_cuda(lambda: sp_mod.h2_from_psi_plain(*box, params.dx,
                                                                       h_ext), 2),
                "bound_ms": max(moved / HBM_BYTES_PER_S, flops / F32_FLOPS_PER_S) * 1e3,
                "bound_by": ("bytes" if moved / HBM_BYTES_PER_S >= flops / F32_FLOPS_PER_S
                             else "operations"),
                "max_abs_err": max(v["max_abs_err"] for v in h2_rows.values()),
                "max_rel": max(v["rel"] for v in h2_rows.values()),
                "with_box_copies_ms": time_cuda(lambda: ff._h2_box(params, psi, cmask, False),
                                                10)}
        del d, calls
        torch.cuda.empty_cache()
    out["forms"] = forms

    params, s0 = rosensweig_3d_tpu(device=dev)
    pz, py, px = params.phys_extent
    phys_cells, array_cells = pz * py * px, s0.rho.numel()
    n = params.poisson_iters
    b1 = sp_mod.launches_per_call(n, s0.rho.shape, "psi") + 1
    per_step = {"B1": b1, "B2": K["B2"].module.N_LAUNCHES, "B3": cap_mod.launches_per_call(None)}
    form_step = {"B1": b1 - 1, "B3": per_step["B3"]}
    total, total16, total_form, total_form16 = {}, {}, {}, {}

    def count(label, per, steps_run, extra, bf16=False):
        launches = kernels_pkg.launch_counts()
        check_launches(label, launches, per, steps_run, extra=extra)
        fl = kernels_pkg.launch_counts(kernels_pkg.FORMS, form=True)
        want = {kid: (form_step.get(kid, 0) * steps_run if per.get(kid) else 0) for kid in fl}
        check(fl == want, f"{label}: form launches {fl}, expected {want}")
        l16 = kernels_pkg.launch_counts(kernels_pkg.BF16_FORMS, bf16=True)
        check(all(v == (launches[kid] if bf16 else 0) for kid, v in l16.items()),
              f"{label}: bfloat16 launches {l16} on {'bf16' if bf16 else 'float32'} storage")
        for kid, v in launches.items():
            total[kid] = total.get(kid, 0) + v
        for kid, v in fl.items():  # B1 runs on the float32 carry in every storage
            into = total_form16 if bf16 and kid in kernels_pkg.BF16_FORMS else total_form
            into[kid] = into.get(kid, 0) + v
        for kid, v in l16.items():
            total16[kid] = total16.get(kid, 0) + v
        return {kid: v for kid, v in launches.items() if v}

    # the capillogue route, kernels against plain=True
    kernels_pkg.reset_launch_counts()
    sk = prime_premac(params, s0, device=dev)
    check(len(sk.premac) == 5 and sk.h.shape[1] == 2 and sk.force is not None,
          "padded: the primed state is not the 5-leaf, scalar-carry form")
    for _ in range(steps):
        sk = ferrofluid_step(params, sk, device=dev)
    torch.cuda.synchronize()
    out["launches_per_step"] = per_step
    out["launches_capillogue_route"] = count("padded capillogue route", per_step, steps,
                                             {"B4": 1})
    sp = prime_premac(params, s0, device=dev, plain=True)
    for _ in range(steps):
        sp = ferrofluid_step(params, sp, device=dev, plain=True)
    names, got = padded_phys(params, sk)
    out[f"kernel_vs_plain_after_{steps}_steps"] = compare(
        "padded capillogue route", names, got, padded_phys(params, sp)[1])
    assert_finite(sk, fields=vars(sk))
    del sp

    # against the native layout after the same steps
    npar, ns0 = rosensweig_3d(device=dev)
    sn = prime_premac(npar, ns0, device=dev)
    for _ in range(steps):
        sn = ferrofluid_step(npar, sn, device=dev)
    fields = (("rho", False), ("vel", True), ("density", False), ("pressure", False))
    out[f"padded_vs_native_after_{steps}_steps"] = compare(
        "padded vs native layout", [n for n, _ in fields],
        [scenes.phys_view(params, getattr(sk, n), vector=v) for n, v in fields],
        [getattr(sn, n) for n, _ in fields])

    # ms a step, padded and native in the same call (not counted: no check)
    _, stats = SimulationRunner(params, ferrofluid_step, device=dev).benchmark(
        sk, n_steps=timed, warmup=0, repeats=3)
    _, nstats = SimulationRunner(npar, ferrofluid_step, device=dev).benchmark(
        sn, n_steps=timed, warmup=0, repeats=3)
    ms = stats["seconds"] / timed * 1e3
    _, prof = step_profile(params, sk, ferrofluid_step, dev)
    _, nprof = step_profile(npar, sn, ferrofluid_step, dev)
    out["timing"] = {
        "steps": timed, "repeats": 3, "ms_per_step": ms,
        "ms_per_step_all": [t / timed * 1e3 for t in stats["seconds_all"]],
        "mlups_array_cells": array_cells / ms * 1e-3,
        "mlups_physical_cells": phys_cells / ms * 1e-3,
        "array_cells": array_cells, "physical_cells": phys_cells,
        "native_ms_per_step": nstats["seconds"] / timed * 1e3,
        "native_mlups": nstats["mlups"], "profile": prof, "native_profile": nprof}
    kernels_pkg.reset_launch_counts()
    del sk, sn, ns0
    torch.cuda.empty_cache()

    # the un-carried route
    kernels_pkg.reset_launch_counts()
    base = prime_premac(params, s0, device=dev, plain=True).replace(premac=None)
    sk, su = base, base
    for _ in range(10):
        sk = ferrofluid_step(params, sk, device=dev)
    torch.cuda.synchronize()
    out["uncarried_launches"] = count("padded un-carried route", {
        "B4": 1, "B1": b1, "B2": K["B2"].module.N_LAUNCHES, "B5": 1}, 10, {})
    for _ in range(10):
        su = ferrofluid_step(params, su, device=dev, plain=True)
    check(sk.premac is None, "padded un-carried: the state changed form")
    names, got = padded_phys(params, sk)
    out["uncarried_kernel_vs_plain_after_10_steps"] = compare(
        "padded un-carried route", names, got, padded_phys(params, su)[1])
    del sk, su, base
    torch.cuda.empty_cache()

    # turbo: bfloat16 f and g (the scalar carry stays float32)
    p16, s16 = turbo(params, s0, dev)
    kernels_pkg.reset_launch_counts()
    sk = prime_premac(p16, s16, device=dev)
    for i in range(steps):
        if i == 10:
            sk10 = sk
        sk = ferrofluid_step(p16, sk, device=dev)
    torch.cuda.synchronize()
    out["bf16_launches"] = count("padded turbo", per_step, steps, {"B4": 1}, bf16=True)
    sp = prime_premac(p16, s16, device=dev, plain=True)
    for i in range(steps):
        if i == 10:
            sp10 = sp
        sp = ferrofluid_step(p16, sp, device=dev, plain=True)
    sf = prime_premac(params, s0, device=dev)
    for _ in range(steps):
        sf = ferrofluid_step(params, sf, device=dev)
    fields = ("f", "g", "rho", "vel", "density", "pressure", "h")
    out["bf16"] = {
        "against_plain_after_10_steps": against("padded turbo vs plain at 10 steps", p16,
                                                sk10, sp10, fields, pointwise=True),
        f"against_plain_after_{steps}_steps": against("padded turbo vs plain", p16, sk, sp,
                                                       fields, pointwise=False),
        f"against_float32_after_{steps}_steps": against("padded turbo vs float32", p16, sk,
                                                         sf, fields, pointwise=False)}
    failed = [m for row in out["bf16"].values() for m in row["failed"]]
    check(not failed, "; ".join(failed))
    del sk, sp, sf, sk10, sp10, s16
    torch.cuda.empty_cache()

    # the demo driver with --tpu_layout 1
    with tempfile.TemporaryDirectory() as tmp:
        kernels_pkg.reset_launch_counts()
        t0 = time.perf_counter()
        st = demo.main(["--tpu_layout", "1", "--total_steps", "20", "--io_interval", "20",
                        "--out_dir", tmp])
        torch.cuda.synchronize()
        demo_s = time.perf_counter() - t0
        out["demo_launches"] = count("padded demo", per_step, 20, {"B4": 1})
        frames = sorted(p.name for p in pathlib.Path(tmp).glob("*.png"))
        obj = pathlib.Path(tmp) / demo.OBJ_NAME
        check(frames == ["00000.png", "00020.png"] and obj.stat().st_size > 0,
              f"padded demo: frames {frames}")
        img = read_png(str(pathlib.Path(tmp) / "00020.png"))
        check(frame_is_rendered(img), "padded demo: the frame at step 20 is blank")
        view = scenes.phys_view(params, st.density)
        check(tuple(view.shape[2:]) == (130, 66, 130) and bool(torch.isfinite(view).all()),
              "padded demo: the physical view is not the finite 130x66x130 box")
        out["demo"] = {"steps": 20, "frames": frames, "seconds": demo_s,
                       "obj_bytes": obj.stat().st_size}
    out["launches"] = {kid: v for kid, v in total.items() if v}
    out["launches_bf16_form"] = {kid: v for kid, v in total16.items() if v}
    out["launches_new_forms"] = {"float32": total_form, "bf16": total_form16}
    emit(dict(out, finite=True, ok=True))
    return {"launches": total, "launches16": total16, "forms": forms,
            "form_launches": total_form, "form_launches16": total_form16}


# ---------------------------------------------------------------------------
# the z-slab path over ranks (phase sharded)
# ---------------------------------------------------------------------------

#: the slab-forced grids (bench.py's 256^3 at mag 85, the native Rosensweig
#: grid at its own field) and the gloo jobs: (grid, mag, (batch, z) mesh,
#: batch, route)
SHARDED_GRIDS = (((256, 256, 256), 85.0), ((130, 66, 130), None))
#: the HCZ step's grid in place of each Rosensweig grid (bench.py's 256^3,
#: the multiphase demo's 130^3)
HCZ_GRID = {(256, 256, 256): (256, 256, 256), (130, 66, 130): (130, 130, 130)}
#: No job runs Z on 2 ranks or E: Z on 4 ranks runs every exchange of Z on
#: 2 (B1's rounds and their bands, B2, B3), C on 2 at 130x66x130 runs B2's
#: and B3's at that grid, and O on 2 every kernel and exchange of E (and its
#: source's phi planes besides).  Two lanes run side by side, each job after
#: the one before it in its lane, the sixth field True for the slab-forced
#: steps once through NCCL (one rank sending its ghosts to itself, which
#: NCCL takes): the jobs of several ranks at 256^3 in one lane, since two at
#: once ran out of the card's memory, the rest in the other.  The last
#: field: None, or a change of the parameters for a second run of the same
#: ranks, held to the first bit for bit (up to the sign of a zero): Z's
#: shell sliver (``scalar_sliver``); C1's full-h bands (C1 is C at tau 1,
#: whose solve rebuilds its bands from psi, ROADMAP B-8)
SHARDED_LANES = (
    (((256, 256, 256), 85.0, (1, 4), 1, "Z", False, {"scalar_sliver": True}),
     ((256, 256, 256), 85.0, (1, 2), 1, "O", False, None),
     ((256, 256, 256), None, (1, 2), 1, "H", False, None)),
    (((130, 66, 130), None, (2, 1), 2, "Z", False, None),
     ((130, 66, 130), None, (1, 2), 1, "C", False, None),
     ((130, 66, 130), None, (1, 2), 1, "C1", False, {"poisson_psi_halo": False}),
     ((256, 256, 256), 85.0, (1, 1), 1, "Z", True, None)),
)
#: the meshed step's routes: Z the capillogue steady state (6-leaf premac:
#: B1, B2, B3), E the epilogue steady state (its first 5 leaves: B1, B2,
#: B10b, B6, B5 with emit_mac), O an out-of-plane field (h_ext_axis=2,
#: primed to 5 leaves, E's kernels), U the un-carried step with the scalar
#: carry (premac None: B4 each step, then E's kernels, B5 without emit_mac);
#: C the capillogue steady state with the channel-form solve (tau 0.8, the
#: 19-channel h kept at priming: B11b's rounds, B10a, B2, B3), U19 the
#: un-carried step on the 19-channel h (never primed: B4, B11b, B10a, B2,
#: B10b, B6, B5), H the HCZ step (B8b, B8a, B2, B10b, B6, then B9)
ROUTES = ("Z", "E", "O", "U", "C", "U19", "H")
#: C1: route C at tau 1 (``scalar_carry=False`` alone), a gloo job's route
#: only: its meshed solve takes the psi-refreshed bands
#: the single-device route each meshed route is held to: its own, except
#: O, whose single-device steps run B3's box form where the meshed step
#: runs E's kernels; the un-carried steps of the same field run those
#: (B4 on f' equals the emission B5 makes)
REF_ROUTE = {"Z": "Z", "E": "E", "O": "U", "U": "U", "C": "C", "U19": "U19", "H": "H",
             "C1": "C1"}
#: the routes whose state is primed before its steps (U drops the premac)
PRIMED = ("Z", "E", "O", "U", "C", "C1")
#: the channel-form routes' change of the scene's parameters
CHANNEL = dict(scalar_carry=False, tau=0.8)
#: seconds a rank job's ranks may take, the card shared by all of them
SHARDED_TIMEOUT = 420


def sharded_scene(res, mag, dev, batch=1, route="Z"):
    """The Rosensweig scene at ``res`` (field ``mag`` if given), with the
    field along z on route O and the channel form on C and U19; the HCZ
    scene ``multiphase_3d`` on H."""
    from lbm_ferrofluid_tpu_torch.models import multiphase_3d, rosensweig_3d

    if route == "H":
        return multiphase_3d(res=res, batch=batch, device=dev)
    kw = {} if mag is None else {"mag_strength": mag}
    params, state = rosensweig_3d(res=res, batch=batch, device=dev, **kw)
    if route == "O":
        params = params.replace(h_ext_axis=2)
    if route in ("C", "U19"):
        params = params.replace(**CHANNEL)
    if route == "C1":
        params = params.replace(scalar_carry=False)
    return params, state


def on_route(state, route):
    """A primed state put on ``route``: E keeps 5 of the 6 leaves, U none."""
    if route == "E":
        return state.replace(premac=state.premac[:5])
    if route == "U":
        return state.replace(premac=None)
    return state


def start_route(params, state, route, **where):
    """The state ``route`` steps from: primed (``where``: ``mesh=`` or
    ``device=``) and put on the route, or as built (U19, H)."""
    from lbm_ferrofluid_tpu_torch.models import prime_premac

    if route not in PRIMED:
        return state
    return on_route(prime_premac(params, state, **where), route)


def route_step(route):
    """The entry point that steps ``route``."""
    from lbm_ferrofluid_tpu_torch.models import ferrofluid_step, hcz_step

    return hcz_step if route == "H" else ferrofluid_step


def route_fields(route):
    """The state's fields a route's runs are compared on (the epilogue
    routes also return phi and force)."""
    if route == "H":
        return list(HCZ_FIELDS)
    return list(FERRO_FIELDS) + ([] if route in ("Z", "C", "C1") else ["phi", "force"])


def slab_launches_per_step(K, params, shape, mesh, route="Z"):
    """Launches a step of each slab form on ``mesh`` on ``route`` (B4 runs
    at priming, and on U and U19 each step): the solve, B1's rounds of
    passes and its H2 or (C, U19) B11b's rounds, the last with B7's
    trailing stage emitting H2 (``channel_slab_plan(..., h2=True)``), B2 once,
    B3's four (Z, C); B10b and B6 once and B5 once, twice with emit_mac
    (E, O, U, U19); on H B8b, B8a, B2, B10b and B6 once (B9, local, runs
    its single-device kernel)."""
    from lbm_ferrofluid_tpu_torch.parallel import step3d

    per = {"B2": K["B2"].module.N_LAUNCHES}
    if route == "H":
        return dict(per, B8a=1, B8b=1, B10b=1, B6=K["B6"].module.N_LAUNCHES)
    n = params.poisson_iters
    if route in ("C", "C1", "U19"):
        k, _, _ = step3d.channel_slab_plan(
            mesh, step3d.global_shape((1, 19, *shape[2:]), mesh), n, h2=True)
        per.update(B11b=-(-n // k))
    else:
        k, _ = step3d.scalar_slab_plan(mesh, step3d.global_shape((1, 2, *shape[2:]), mesh), n)
        per["B1"] = n // k * len(K["B1"].module.passes(k)) + 1
    if route in ("Z", "C", "C1"):
        return dict(per, B3=K["B3"].module.N_LAUNCHES)
    uncarried = route in ("U", "U19")
    per.update({"B10b": 1, "B6": K["B6"].module.N_LAUNCHES, "B5": 1 if uncarried else 2})
    return dict(per, B4=1) if uncarried else per


def meshed_step(mesh, route="Z"):
    step = route_step(route)
    return lambda params, state, device=None: step(params, state, device=device, mesh=mesh)


def slab_form_calls(params, st, mesh):
    """Per slab form: (the slab call as the step makes it on ``mesh``, its
    plain version, the single-device form on the same inputs, the slab
    kernel's (bytes, flops)) on the primed slab state ``st``: B4 on its f
    and g, B1's solve (its rounds and exchanges), B2 on the carried rho,
    B3 on the step's inputs (H2 and rho_ca from B1 and B2)."""
    import torch

    from lbm_ferrofluid_tpu_torch.ops.kernels import capillogue, contact3d, fused_step
    from lbm_ferrofluid_tpu_torch.ops.kernels import scalar_poisson
    from lbm_ferrofluid_tpu_torch.ops.magnetic import poisson_rhs_scaled
    from lbm_ferrofluid_tpu_torch.ops.moments import phi_from_density
    from lbm_ferrofluid_tpu_torch.parallel import step3d

    gas = dict(rho_gas=params.rho_gas, rho_fluid=params.rho_fluid,
               density_gas=params.density_gas, density_fluid=params.density_fluid)
    h_ext = tuple(params.mag_strength if a == params.h_ext_axis else 0.0 for a in range(3))
    rho, vel, den, m0g, m1g, rhs = st.premac
    cap_kw = dict(kappa=params.kappa,
                  gravity=tuple(float(v) for v in params.gravity_vec().reshape(-1)),
                  tau_f=params.tau_f, tau_g=params.tau_g, dx=params.dx, dt=params.dt,
                  emit_rhs=(params.h_ext_axis, params.mag_strength, params.tau), **gas)
    n = params.poisson_iters
    H2, _ = step3d.scalar_poisson_sharded(st.h, st.cmask, rhs, mesh, n_iters=n, dx=params.dx,
                                          h_ext=h_ext)
    rho_ca = step3d.contact3d_sharded(rho, st.flags, params.contact_angle, mesh)
    fg = step3d._fg_ghosts(st.f, st.g, mesh)
    fields = (rho, den, st.pressure, rho_ca, st.flags)
    cap = (step3d.ring_halo(capillogue.cap_bundle(*fields, "lo"), mesh, +1),
           step3d.ring_halo(capillogue.cap_bundle(*fields, "hi"), mesh, -1))
    k, G = step3d.scalar_slab_plan(mesh, step3d.global_shape((1, 2, *st.f.shape[2:]), mesh), n)
    c_ext = step3d._extend(st.cmask, G, mesh)
    bands = (step3d.ring_halo(st.h[:, :, -G:], mesh, +1),
             step3d.ring_halo(st.h[:, :, :G], mesh, -1))
    b1 = [scalar_poisson.cost_slab(st.h, c_ext, c_ext, n_iters=k, emit=emit, ghosts=bands)
          for emit in [None] * (n // k - 1) + ["h2"]]
    b1_bytes, b1_flops = (sum(c[i] for c in b1) for i in (0, 1))
    cap_args = (st.f, st.g, st.flags, rho, den, st.pressure, rho_ca, H2, m0g, m1g, vel,
                st.magnetic_flags)
    pro_args = (st.f, st.g, st.flags, st.rho, st.vel)
    b2g = (step3d.ring_halo(rho[:, :, -1:], mesh, +1), step3d.ring_halo(rho[:, :, :1], mesh, -1))

    def sharded(fn, *args, **kw):
        return (lambda: fn(*args, mesh, **kw), lambda: fn(*args, mesh, plain=True, **kw))

    def emission(fn, gn, vel_n):
        """The plain emission (macros and source) from the kernel's own
        f'/g' and velocity: a bfloat16 flip of f'/g' is not counted twice."""
        mac = step3d.fused_prologue_sharded(fn, gn, st.flags, rho_ca, vel_n, mesh, plain=True,
                                            c=params.dx / params.dt, **gas)
        axis, hm, tau_mag = cap_kw["emit_rhs"]
        rhs = poisson_rhs_scaled(
            phi_from_density(mac[2], params.density_gas, params.density_fluid),
            st.magnetic_flags, tuple(hm if a == axis else 0.0 for a in range(3)), tau=tau_mag,
            dx=params.dx, dt=params.dt)
        return tuple(mac) + (rhs,)

    calls = {
        "B4": (*sharded(step3d.fused_prologue_sharded, *pro_args, c=params.dx / params.dt,
                        **gas),
               lambda: fused_step.lbm_prologue(*pro_args, c=params.dx / params.dt, **gas),
               fused_step.cost_slab(*pro_args, fg)),
        "B1": (*sharded(step3d.scalar_poisson_sharded, st.h, st.cmask, rhs, n_iters=n,
                        dx=params.dx, h_ext=h_ext),
               lambda: scalar_poisson.scalar_wavefront(st.h, st.cmask, rhs, n_iters=n,
                                                       dx=params.dx, h_ext=h_ext)[::-1],
               (int(b1_bytes), int(b1_flops))),
        "B2": (*sharded(step3d.contact3d_sharded, rho, st.flags, params.contact_angle),
               lambda: contact3d.contact_angle_3d(rho, st.flags, params.contact_angle),
               contact3d.cost_slab(rho, st.flags, ghosts=b2g)),
        "B3": (*sharded(step3d.capillogue_sharded, *cap_args, **cap_kw),
               lambda: capillogue.lbm_capillogue(*cap_args, **cap_kw, emit_force=False),
               capillogue.cost_slab(*cap_args, ghosts=fg, cap_ghosts=cap, **cap_kw)),
    }
    torch.cuda.synchronize()
    return calls, emission


def epilogue_form_calls(params, st, mesh):
    """Per slab form of the epilogue route: (the slab call as the step
    makes it on ``mesh``, its plain version, the single-device form on the
    same inputs, the slab kernel's (bytes, flops)) on route E's primed slab
    state ``st``: B10b on rho_ca with its density map, B6 with that
    Laplacian (its single-device form builds the Laplacian from rho_ca
    itself), B5 without and with ``emit_mac`` on B6's outputs."""
    import torch

    from lbm_ferrofluid_tpu_torch.ops.kernels import capmac, fused_step, stencil3d
    from lbm_ferrofluid_tpu_torch.ops.moments import phi_from_density, rho_to_density
    from lbm_ferrofluid_tpu_torch.parallel import step3d

    gas = dict(rho_gas=params.rho_gas, rho_fluid=params.rho_fluid,
               density_gas=params.density_gas, density_fluid=params.density_fluid)
    h_ext = tuple(params.mag_strength if a == params.h_ext_axis else 0.0 for a in range(3))
    rho, vel, den, m0g, m1g = st.premac
    phi = phi_from_density(den, params.density_gas, params.density_fluid)
    rhs = step3d.poisson_rhs_sharded(phi, st.magnetic_flags, mesh, h_ext, tau=params.tau,
                                     dx=params.dx, dt=params.dt)
    H2, _ = step3d.scalar_poisson_sharded(st.h, st.cmask, rhs, mesh,
                                          n_iters=params.poisson_iters, dx=params.dx,
                                          h_ext=h_ext)
    rho_ca = step3d.contact3d_sharded(rho, st.flags, params.contact_angle, mesh)
    den_ca = rho_to_density(rho_ca, **gas)
    Zl = st.f.shape[2]
    clamp = step3d.slab_clamp(mesh, Zl)
    dens_of = tuple(gas.values())
    lap = step3d.laplacian_field_sharded(rho_ca, mesh, dx=params.dx, density_of=dens_of)
    cap_kw = dict(kappa=params.kappa, dx=params.dx, dt=params.dt,
                  gravity=tuple(float(v) for v in params.gravity_vec().reshape(-1)), **gas)
    cap_args = (rho, den, st.pressure, rho_ca, H2, phi, st.flags, m0g, m1g, vel)
    bundles = tuple(capmac.slab_bundle(lap, rho, den, st.pressure, st.flags, phi, side)
                    for side in ("lo", "hi"))
    vel_n, pres, force, dfai, dprho = step3d.capmac_sharded(lap, *cap_args, mesh, **cap_kw)
    epi_args = (st.f, st.g, st.flags, rho_ca, vel_n, den_ca, pres, force, dfai, dprho)
    hcz = dict(tau_f=params.tau_f, tau_g=params.tau_g, dx=params.dx, dt=params.dt)
    emit = dict(emit_mac=True, mac_consts=(params.dx / params.dt, *gas.values()))
    fg = step3d._fg_ghosts(st.f, st.g, mesh)

    def sharded(fn, *args, **kw):
        return (lambda: fn(*args, mesh, **kw), lambda: fn(*args, mesh, plain=True, **kw))

    calls = {
        "B10b": (*sharded(step3d.laplacian_field_sharded, rho_ca, dx=params.dx,
                          density_of=dens_of),
                 lambda: stencil3d.laplacian_field(rho_ca, dx=params.dx, density_of=dens_of),
                 stencil3d.cost_laplacian_slab(rho_ca, clamp=clamp, density_of=dens_of)),
        "B6": (*sharded(step3d.capmac_sharded, lap, *cap_args, **cap_kw),
               lambda: capmac.hcz_capillary_gradmac(*cap_args, **cap_kw),
               capmac.cost_slab(*cap_args, lap=lap, ghosts=bundles, clamp=clamp)),
        "B5": (*sharded(step3d.fused_epilogue_sharded, *epi_args, **hcz),
               lambda: fused_step.lbm_epilogue(*epi_args, **hcz),
               fused_step.cost_epilogue_slab(*epi_args, fg)),
        "B5 emit_mac": (*sharded(step3d.fused_epilogue_sharded, *epi_args, **hcz, **emit),
                        lambda: fused_step.lbm_epilogue(*epi_args, **hcz, **emit),
                        fused_step.cost_epilogue_slab(*epi_args, fg, **emit)),
    }

    def emission(fn, gn):
        """The plain emission from the kernel's own f'/g': a bfloat16 flip
        of f'/g' is not counted twice."""
        return step3d.fused_prologue_sharded(fn, gn, st.flags, rho_ca, vel_n, mesh, plain=True,
                                             c=params.dx / params.dt, **gas)

    torch.cuda.synchronize()
    return calls, emission


def channel_form_calls(params, st, mesh):
    """Per slab form of the channel-form solve: (the slab call as the step
    makes it on ``mesh``, its plain version, the single-device form on the
    same inputs, the slab kernel's (bytes, flops)) on route C's primed slab
    state ``st``: B11b's slab rounds (:func:`step3d.poisson_sweeps_sharded`,
    their exchanges included) with B7's trailing stage emitting H2 in the
    last, as the step runs them ("B11b emit"); the psi route's, psi and
    B10a on the substituted psi."""
    import torch

    from lbm_ferrofluid_tpu_torch.ops.kernels import poisson, stencil3d
    from lbm_ferrofluid_tpu_torch.parallel import step3d

    n, tau, mf, rhs = params.poisson_iters, params.tau, st.magnetic_flags, st.premac[5]
    k, G, r = step3d.channel_slab_plan(mesh, step3d.global_shape(st.h.shape, mesh), n)
    k2, G2, r2 = step3d.channel_slab_plan(mesh, step3d.global_shape(st.h.shape, mesh), n, h2=True)
    rounds2 = [k2] * (n // k2) + [r2] * (r2 > 0)
    hext = static_field(params)
    _, psi = step3d.poisson_sweeps_sharded(st.h, mf, rhs, mesh, tau=tau, n_iters=n)
    psi_sub = step3d.substitute_obstacles_sharded(psi, mf, mesh)
    rounds = [k] * (n // k) + [r] * (r > 0)
    clamp = step3d.slab_clamp(mesh, st.h.shape[2])

    def sharded(fn, *args, **kw):
        return (lambda: fn(*args, mesh, **kw), lambda: fn(*args, mesh, plain=True, **kw))

    def emitting(plain):
        h, h2, emitted = step3d.poisson_sweeps_sharded(st.h, mf, rhs, mesh, tau=tau, n_iters=n,
                                                       emit_h2=hext, dx=params.dx, plain=plain)
        check(emitted, "route C's slab solve did not take B7's trailing stage")
        return h, h2

    calls = {
        "B11b emit": (lambda: emitting(False), lambda: emitting(True),
                      lambda: poisson.poisson_sweeps(st.h, mf, rhs, **emit_kw(params, "h2", tau,
                                                                                n)),
                      poisson.cost_slab(st.h, mf, rhs, tau=tau, n_iters=n, rounds=rounds2, G=G2,
                                        emit="h2", h_ext=hext,
                                        clamp=step3d.slab_clamp(mesh, st.h.shape[2]))),
        "B11b": (*sharded(step3d.poisson_sweeps_sharded, st.h, mf, rhs, tau=tau, n_iters=n),
                 lambda: poisson.poisson_sweeps(st.h, mf, rhs, tau=tau, n_iters=n),
                 poisson.cost_slab(st.h, mf, rhs, tau=tau, n_iters=n, rounds=rounds, G=G)),
        "B10a": (*sharded(step3d.grad_fields_sharded, psi_sub, dx=params.dx),
                 lambda: stencil3d.grad_fields(psi_sub, dx=params.dx),
                 stencil3d.cost_slab(psi_sub, clamp=clamp)),
    }
    torch.cuda.synchronize()
    return calls


def b11b_flag_forms(params, st, what):
    """One round of B11b's slab form on the slab state ``st`` of one rank
    with ``slab=True`` (its own edge planes as its bands), the flags and
    rhs given both ways: as the slab's planes beside bands one plane
    deeper than h's (``aux_ghosts``, as the meshed solve passes them) and
    as the extended pair.  A round of 3 sweeps emitting psi and the bands,
    and one of 3 with B7's trailing stage emitting H2 (4-plane bands, the
    domain's true edges' clamp), each bit for bit to the other form and to
    the plain version.  Returns the hashes of each round's outputs."""
    import torch

    from lbm_ferrofluid_tpu_torch.ops.kernels import poisson as pp

    h, mf, rhs = st.h, st.magnetic_flags, st.premac[5]
    Zl = h.shape[2]
    out = {}
    for label, G, kw in (("psi", 3, dict(emit_bands=True)),
                         ("h2", 4, dict(emit="h2", dx=params.dx, h_ext=static_field(params),
                                        clamp=(1, Zl - 2)))):
        GA = G + 1
        call = dict(tau=params.tau, n_iters=3, ghosts=(h[:, :, -G:].contiguous(),
                                                        h[:, :, :G].contiguous()), **kw)
        aux = tuple((mf[:, :, planes].contiguous(), rhs[:, :, planes].contiguous())
                    for planes in (slice(-GA, None), slice(None, GA)))
        ext = [torch.cat([x[:, :, -G:], x, x[:, :, :G]], dim=2) for x in (mf, rhs)]
        outs = [flat(pp.poisson_sweeps(h, mf, rhs, aux_ghosts=aux, **call)),
                flat(pp.poisson_sweeps(h, *ext, **call)), flat(pp.poisson_sweeps_plain(h, *ext,
                                                                                      **call))]
        torch.cuda.synchronize()
        check(all(torch.equal(a, b) and torch.equal(a, c) for a, b, c in zip(*outs, strict=True)),
              f"{what}: B11b's slab round ({label}) differs between its flag forms (banded, "
              f"extended) or from its plain version")
        out[label] = [_bits_sha(t)[:16] for t in outs[0]]
        del outs, ext, aux
    return out


def hcz_form_calls(params, st, mesh):
    """Per slab form of the HCZ step's streams, as :func:`channel_form_calls`,
    on route H's slab state ``st``: B8b on f with the old macros, B8a on g."""
    import torch

    from lbm_ferrofluid_tpu_torch.ops.kernels import stream3d
    from lbm_ferrofluid_tpu_torch.parallel import step3d

    gas = dict(rho_gas=params.rho_gas, rho_fluid=params.rho_fluid,
               density_gas=params.density_gas, density_fluid=params.density_fluid)
    c = params.dx / params.dt
    macro_args = (st.f, st.flags, st.rho, st.vel)
    ghosts = tuple(torch.empty_like(st.f[:, :5, :1]) for _ in range(2))

    def sharded(fn, *args, **kw):
        return (lambda: fn(*args, mesh, **kw), lambda: fn(*args, mesh, plain=True, **kw))

    calls = {
        "B8b": (*sharded(step3d.stream_bounce_macro_sharded, *macro_args, c=c, **gas),
                lambda: stream3d.stream_bounce_macro(*macro_args, c=c, **gas),
                stream3d.cost_slab(stream3d.cost_macro, *macro_args, ghosts=ghosts)),
        "B8a": (*sharded(step3d.stream_bounce_moments_sharded, st.g, st.flags),
                lambda: stream3d.stream_bounce_moments(st.g, st.flags),
                stream3d.cost_slab(stream3d.cost_moments, st.g, st.flags, ghosts=ghosts)),
    }
    torch.cuda.synchronize()
    return calls


def form_rows(calls, what):
    """Each slab form of ``calls`` against its plain version (phase 3's
    bars; bfloat16 f_post and B11b's h are equal bit for bit: values moved,
    or rounded where the plain version rounds them) and bit for bit
    against its single-device form on the same inputs (the wrap as ghosts
    at one rank); ms a call of the slab call, its plain version and the
    single-device form, and the bound of what the slab call moves."""
    import torch

    rows = {}
    for kid, (slab, plain, single, (nbytes, flops)) in calls.items():
        got, want, one = slab(), plain(), single()
        torch.cuda.synchronize()
        names = OUTPUTS[kid][:len(flat(got))]
        err = compare(f"{what} {kid} slab", names, got, want)
        bits_equal(f"{what} {kid} slab against its single-device form", names, got, one)
        t_bytes, t_ops = nbytes / HBM_BYTES_PER_S * 1e3, flops / F32_FLOPS_PER_S * 1e3
        rows[kid] = {
            "ms": time_cuda(slab, reps=10), "single_device_ms": time_cuda(single, reps=10),
            "plain_ms": time_cuda(plain, reps=1, warm=0),
            "bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "bytes": int(nbytes), "flops": int(flops),
            "max_abs_err": max(v["max_abs_err"] for v in err.values()),
            "bit_for_bit_to_single_device": True,
        }
        del got, want, one
        torch.cuda.empty_cache()
    return rows


def epilogue_form_rows(params, st, mesh, what, bf16=False):
    """Each slab form of the epilogue route on route E's primed slab state:
    against its plain version (phase 3's bars; bfloat16 f'/g' within one
    ulp, as phase 7, the emission against the plain one on the kernel's
    own f'/g'); each bit for bit against its single-device form on the
    same inputs (the wrap as ghosts at one rank; B6's single-device form
    builds the Laplacian itself, with the density map B10b takes); ms a
    call of the slab call, its plain version and the single-device form,
    and the bound of what the slab call moves."""
    import torch

    rows = {}
    calls, emission = epilogue_form_calls(params, st, mesh)
    for key, (slab, plain, single, (nbytes, flops)) in calls.items():
        got, want, one = slab(), plain(), single()
        torch.cuda.synchronize()
        kid = key.split()[0]
        names = OUTPUTS[kid][:len(flat(got))]
        if bf16 and kid == "B5":
            err = compare_bf16(f"{what} {key} slab", names[:2], got[:2], want[:2])
            if len(names) > 2:
                err.update(compare(f"{what} {key} slab (emission on its own f'/g')", names[2:],
                                   got[2], emission(got[0], got[1])))
        else:
            err = compare(f"{what} {key} slab", names, got, want)
        bits_equal(f"{what} {key} slab against its single-device form", names, got, one)
        t_bytes, t_ops = nbytes / HBM_BYTES_PER_S * 1e3, flops / F32_FLOPS_PER_S * 1e3
        rows[key] = {
            "ms": time_cuda(slab, reps=10), "single_device_ms": time_cuda(single, reps=10),
            "plain_ms": time_cuda(plain, reps=1, warm=0),
            "bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "bytes": int(nbytes), "flops": int(flops),
            "max_abs_err": max(v["max_abs_err"] for v in err.values()),
            "bit_for_bit_to_single_device": True,
        }
        torch.cuda.empty_cache()
    return rows


def slab_form_rows(params, st, mesh, what, bf16=False):
    """Each slab form on the primed slab state: against its plain version
    (phase 3's bars; bfloat16 outputs within one ulp, as phase 7) and bit
    for bit against its single-device form on the same inputs (the wrap as
    ghosts at one rank); ms a call of the slab call, its plain version and
    the single-device form, and the bound of what the slab call moves."""
    import torch

    rows = {}
    calls, emission = slab_form_calls(params, st, mesh)
    for kid, (slab, plain, single, (nbytes, flops)) in calls.items():
        got, want, one = slab(), plain(), single()
        torch.cuda.synchronize()
        names = OUTPUTS[kid][:len(flat(got))] if kid != "B1" else ["H2", "s2"]
        if bf16 and kid == "B3":
            err = {**compare_bf16(f"{what} {kid} slab", names[:2], got[:2], want[:2]),
                   **compare(f"{what} {kid} slab", names[2:5], got[2:5], want[2:5]),
                   **compare(f"{what} {kid} slab (emission on its own f'/g')", names[5:],
                             got[5], emission(got[0], got[1], got[2]))}
        else:
            err = compare(f"{what} {kid} slab", names, got, want)
        bits_equal(f"{what} {kid} slab against its single-device form", names, got, one)
        t_bytes, t_ops = nbytes / HBM_BYTES_PER_S * 1e3, flops / F32_FLOPS_PER_S * 1e3
        rows[kid] = {
            "ms": time_cuda(slab, reps=10), "single_device_ms": time_cuda(single, reps=10),
            "plain_ms": time_cuda(plain, reps=1, warm=0),
            "bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "bytes": int(nbytes), "flops": int(flops),
            "max_abs_err": max(v["max_abs_err"] for v in err.values()),
            "bit_for_bit_to_single_device": True,
        }
        torch.cuda.empty_cache()
    if not bf16:
        rows["B1"]["round_lengths"] = b1_round_lengths(params, st, mesh, what)
    return rows


def b1_round_lengths(params, st, mesh, what, timed=5):
    """B1's slab solve on the primed slab state in rounds of every k that
    divides the sweeps (G = k + 1 <= Zl, ``step3d.scalar_slab_plan``
    forced): each bit for bit to the chosen k's solve and to the
    single-device call, and against its plain version at phase 3's bars
    (the kernel's sweep contracts its multiply-adds, and PyTorch divides
    by a scalar through its reciprocal on the card); its ms a solve and
    launches.  The banded kernel reads the bands, cmask and rhs in place
    at every k (one pass a round up to k = 3, several above)."""
    import torch

    from lbm_ferrofluid_tpu_torch.ops.kernels import scalar_poisson as sp
    from lbm_ferrofluid_tpu_torch.parallel import step3d

    h_ext = tuple(params.mag_strength if a == params.h_ext_axis else 0.0 for a in range(3))
    n, Zl = params.poisson_iters, st.h.shape[2]
    args = (st.h, st.cmask, st.premac[5], mesh)
    kw = dict(n_iters=n, dx=params.dx, h_ext=h_ext)
    real = step3d.scalar_slab_plan
    chosen = real(mesh, step3d.global_shape(st.h.shape, mesh), n)
    want = step3d.scalar_poisson_sharded(*args, **kw)
    one = sp.scalar_wavefront(st.h, st.cmask, st.premac[5], **kw)[::-1]
    rows = []
    try:
        for k in [k for k in range(2, n + 1) if n % k == 0 and k + 1 <= Zl]:
            step3d.scalar_slab_plan = lambda *a, k=k: (k, k + 1)
            before = sp.scalar_wavefront.launches
            got = step3d.scalar_poisson_sharded(*args, **kw)
            torch.cuda.synchronize()
            launches = sp.scalar_wavefront.launches - before
            err = compare(f"{what} B1 slab solve in rounds of {k}", ["H2", "s2"], got,
                          step3d.scalar_poisson_sharded(*args, plain=True, **kw))
            for ref, to in ((want, f"rounds of {chosen[0]}"), (one, "the single-device call")):
                bits_equal(f"{what} B1 slab solve in rounds of {k} against {to}", ["H2", "s2"],
                           got, ref)
            check(launches == n // k * len(sp.passes(k)) + 1,
                  f"{what}: B1 slab solve in rounds of {k} launched {launches} times")
            rows.append(dict(k=k, G=k + 1, rounds=n // k, passes_a_round=len(sp.passes(k)),
                             launches=launches, bit_for_bit_to_chosen_and_single_device=True,
                             max_abs_err={name: e["max_abs_err"] for name, e in err.items()},
                             ms=time_cuda(lambda: step3d.scalar_poisson_sharded(*args, **kw),
                                          timed)))
            del got
    finally:
        step3d.scalar_slab_plan = real
    torch.cuda.empty_cache()
    return {"chosen_k": chosen[0], "rows": rows}


def slab_forced(K, kernels_pkg, params, s0, dev, card, what, steps=30, timed=10, bf16=False,
                route="Z"):
    """One rank with ``slab=True`` on the card, on ``route``: prime where the
    route primes and ``steps`` meshed steps (launch counters zeroed just
    before, read just after, exact a step) against as many single-device
    kernel steps of ``REF_ROUTE[route]`` (phase 3's bars; in bfloat16
    pointwise within ``BF16_DENSITY``, as phase 7; route O also against its
    own single-device route, B3's box form, reported), the slab forms'
    rows (route Z: B4, B1, B2, B3; route E: B10b, B6, B5; route C: B11b,
    B10a; route H: B8b, B8a), and ms a step of both routes, timed in turns
    in this call."""
    import torch

    from lbm_ferrofluid_tpu_torch.parallel import make_mesh, shard_state

    mesh = make_mesh(slab=True)
    step = meshed_step(mesh, route)
    kernels_pkg.reset_launch_counts()
    sm = start_route(params, shard_state(s0, mesh), route, mesh=mesh)
    for _ in range(steps):
        sm = step(params, sm)
    torch.cuda.synchronize()
    ids = kernels_pkg.SLAB_FORMS
    slab_l, all_l = kernels_pkg.launch_counts(ids, slab=True), kernels_pkg.launch_counts()
    per = slab_launches_per_step(K, params, sm.f.shape, mesh, route)
    check_launches(f"{what} slab forms", slab_l, per, steps,
                   extra={"B4": 1} if route in PRIMED else {})
    n_emit = check_emit_launches(what, kernels_pkg, steps) if route in ("C", "U19") else 0
    local = {"B9": steps} if route == "H" else {}
    check(all_l == {**{kid: 0 for kid in all_l}, **slab_l, **local},
          f"{what}: a launch outside the slab forms: {all_l}")

    def single(ref_route):
        ss = start_route(params, s0, ref_route, device=dev)
        for _ in range(steps):
            ss = route_step(ref_route)(params, ss, device=dev)
        return ss

    ss = single(REF_ROUTE[route])
    fields = route_fields(route)
    premac = REF_ROUTE[route] == route and getattr(sm, "premac", None) is not None
    if bf16:
        row = against(f"{what} against single-device", params, sm, ss, fields, True)
        check(not row["failed"], "; ".join(row["failed"]))
        errs = {"density_rel": row["density_rel"], "mass_rel": row["mass_rel"]}
    else:
        mac, mac_ref = (list(sm.premac), list(ss.premac)) if premac else ([], [])
        errs = compare(f"{what} against single-device {REF_ROUTE[route]}",
                       fields + OUTPUTS["B3"][5:5 + len(mac)],
                       [getattr(sm, n) for n in fields] + mac,
                       [getattr(ss, n) for n in fields] + mac_ref)
    bits = all(torch.equal(getattr(sm, n), getattr(ss, n)) for n in fields)
    extra = {}
    if route == "O":
        sb = single("O")
        extra["against_single_device_box_form"] = (
            against(f"{what} against the box form", params, sm, sb, fields, True) if bf16 else {
                n: {"max_abs_err": float((getattr(sm, n).double() - getattr(sb, n).double())
                                         .abs().max()),
                    "rel": float((getattr(sm, n).double() - getattr(sb, n).double()).abs().max())
                    / max(float(getattr(sb, n).double().abs().max()), 1e-30)}
                for n in fields})
        del sb
    if route == "Z":
        forms = slab_form_rows(params, sm, mesh, what, bf16=bf16)
    elif route == "E":
        forms = epilogue_form_rows(params, sm, mesh, what, bf16=bf16)
    elif route == "C":
        forms = form_rows(channel_form_calls(params, sm, mesh), what)
        extra["b11b_flag_forms"] = b11b_flag_forms(params, sm, what)
        # the psi route (a field that is not a static constant: solve_H_int
        # without h2_ext), the meshed solve's path through B10a's slab form
        kernels_pkg.reset_launch_counts()
        from lbm_ferrofluid_tpu_torch.ops import solve_H_int

        for _ in range(3):
            solve_H_int(params.lattice, sm.h, None, sm.magnetic_flags, None,
                        tau=float(params.tau), n_iters=params.poisson_iters, dx=params.dx,
                        dt=params.dt, rhs_scaled=sm.premac[5], mesh=mesh)
        torch.cuda.synchronize()
        psi_route = kernels_pkg.launch_counts(["B10a"], slab=True)["B10a"]
        check(psi_route == 3, f"{what}: the psi route launched B10a's slab form {psi_route} times")
        slab_l = dict(slab_l, B10a=slab_l["B10a"] + psi_route)
    elif route == "H":
        forms = form_rows(hcz_form_calls(params, sm, mesh), what)
    else:
        forms = {}
    ms = {}
    one = route_step(route)
    for label, fn, s in (("single_device", one, ss), ("slab", step, sm),
                         ("slab_again", step, sm), ("single_device_again", one, ss)):
        _, st = timed_steps(params, s, fn, dev, timed, warmup=3)
        ms[label] = st["seconds"] / timed * 1e3
    emit({"phase": "sharded", "part": "slab_forced", "what": what, "route": route,
          "single_device_route": REF_ROUTE[route],
          "res": list(s0.f.shape[2:]), "steps": steps, "storage": str(sm.f.dtype),
          "against_single_device": errs, "bit_for_bit_to_single_device": bits, **extra,
          "ms_per_step": ms, "slab_forms": forms, "launches": slab_l,
          "launches_emit": n_emit, "launches_per_step": per, "card": card, "ok": True})
    return forms, dict(slab_l, **{"B11b emit": n_emit})


def _free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def start_processes(argvs, envs):
    """The ``argvs`` (with ``envs``) started as concurrent processes of this
    Python from the checkout's root."""
    return [subprocess.Popen([sys.executable, *argv], env=env, stdout=subprocess.PIPE,
                             stderr=subprocess.PIPE, text=True, cwd=str(ROOT))
            for argv, env in zip(argvs, envs, strict=True)]


def stop_processes(procs):
    for p in procs:
        if p.poll() is None:
            p.kill()
            p.wait()


def run_processes(label, argvs, envs, timeout, tag):
    """Run the ``argvs`` (with ``envs``) as concurrent processes: each
    one's JSON results (:func:`wait_processes`)."""
    return wait_processes(label, start_processes(argvs, envs), timeout, tag)


def wait_processes(label, procs, timeout, tag):
    """Wait for the processes ``procs``: each one's JSON results (its stdout
    lines that start with ``tag``), or CheckFailed for a process that fails
    or outlasts ``timeout`` seconds (every process is then stopped)."""
    outs, deadline = [], time.monotonic() + timeout
    try:
        for r, p in enumerate(procs):
            try:
                out, err = p.communicate(timeout=max(1.0, deadline - time.monotonic()))
            except subprocess.TimeoutExpired:
                raise CheckFailed(f"{label}: process {r} outlasted {timeout} s")
            check(p.returncode == 0, f"{label}: process {r} exited {p.returncode}:\n"
                  f"{err[-4000:]}")
            outs.append([json.loads(line.split(" ", 1)[1]) for line in out.splitlines()
                         if line.startswith(tag + " ")])
    finally:
        stop_processes(procs)
    return outs


def run_rank_job(res, mag, shape, batch, route, slab, pair=None, steps=10):
    """One job's ranks as processes on the one card (``--sharded-rank``),
    torchrun's variables set for each (gloo for several ranks on the card,
    NCCL for one: ``parallel/mesh.py:default_backend``): their rows, or
    CheckFailed for a rank that fails or outlasts ``SHARDED_TIMEOUT``
    (every rank is then stopped).  ``slab``: the mesh's ``slab=True`` (one
    NCCL rank then sends its ghosts to itself); ``pair``: a change of the
    parameters for a second run of the same ranks (:func:`sharded_rank`)."""
    import os

    world = shape[0] * shape[1]
    job = json.dumps({"res": list(res), "mag": mag, "shape": list(shape), "batch": batch,
                      "steps": steps, "slab": slab, "route": route, "pair": pair})
    env = dict(os.environ, MASTER_ADDR="127.0.0.1", MASTER_PORT=str(_free_port()),
               WORLD_SIZE=str(world), LOCAL_WORLD_SIZE=str(world))
    outs = run_processes(f"rank job {job}",
                         [[str(ROOT / "chip_smoke.py"), "--sharded-rank", job]] * world,
                         [dict(env, RANK=str(r), LOCAL_RANK=str(r)) for r in range(world)],
                         SHARDED_TIMEOUT, "SHARDED_RANK")
    rows = [row for out in outs for row in out]
    check(len(rows) == world, f"rank job {job}: {len(rows)} of {world} ranks reported")
    return rows


def sharded_rank(job_json) -> int:
    """A rank of a job of ``run_rank_job``: joins the group from
    torchrun's variables, builds the scene on the card, cuts its part,
    primes and steps it on the mesh (launch counters zeroed just before,
    read just after, exact a step; ``lbm_psi_ghost_band``'s as
    :func:`psi_band_expected` says), gathers, and on rank 0 holds the whole
    state to as many single-device kernel steps of the same scene (phase
    3's bars; each batch element on a batch mesh).  With the job's ``pair``
    the same part is primed and stepped again with the parameters so
    changed, its bytes, exchanges and ms a step beside the first run's, and
    its state held to the first run's bit for bit up to the sign of a
    zero.  Prints its row."""
    import torch
    import torch.distributed as dist

    from lbm_ferrofluid_tpu_torch.ops import kernels as kernels_pkg
    from lbm_ferrofluid_tpu_torch.parallel import (
        gather_state, initialize_distributed, make_mesh, ring_halo, shard_state, step3d,
    )

    job = json.loads(job_json)
    route = job["route"]
    world = initialize_distributed()
    psi_band = kernels_pkg.GLUE_KERNELS["psi_band"].wrapper
    try:
        mesh = make_mesh(("batch", "z"), tuple(job["shape"]), slab=job["slab"])
        K = kernels_pkg.KERNELS
        params, whole = sharded_scene(tuple(job["res"]), job["mag"], mesh.device, job["batch"],
                                      route)
        part = shard_state(whole, mesh)
        del whole  # several ranks share the card
        torch.cuda.empty_cache()
        step = meshed_step(mesh, route)

        def run(p):
            """Prime and step the part with ``p``: (state, its row)."""
            kernels_pkg.reset_launch_counts()
            st = start_route(p, part, route, mesh=mesh)
            ring_halo.sent_bytes, n0 = 0, ring_halo.exchanges
            torch.cuda.synchronize()
            dist.barrier()
            t0 = time.perf_counter()
            for _ in range(job["steps"]):
                st = step(p, st)
            torch.cuda.synchronize()
            dist.barrier()
            seconds = time.perf_counter() - t0
            launches = kernels_pkg.launch_counts(kernels_pkg.SLAB_FORMS)
            slab_l = kernels_pkg.launch_counts(kernels_pkg.SLAB_FORMS, slab=True)
            if step3d.dp_dispatch(mesh):
                per = {"B1": K["B1"].module.launches_per_call(p.poisson_iters, st.rho.shape),
                       "B2": 1, "B3": K["B3"].module.N_LAUNCHES}
                check_launches("batch mesh", launches, per, job["steps"], extra={"B4": 1})
                check(not any(slab_l.values()), f"batch mesh: slab forms launched: {slab_l}")
            else:
                per = slab_launches_per_step(K, p, st.f.shape, mesh, route)
                check_launches("z-slab mesh", slab_l, per, job["steps"],
                               extra={"B4": 1} if route in PRIMED else {})
                check(launches == slab_l,
                      f"z-slab mesh: launches outside the slab forms {launches}")
            psi_want = psi_band_expected(p, st, mesh) * job["steps"]
            check(psi_band.launches == psi_want, f"rank job {job}: lbm_psi_ghost_band launched "
                                                 f"{psi_band.launches} times, not {psi_want}")
            return st, {"launches": launches, "slab_launches": slab_l, "launches_per_step": per,
                        "psi_band_launches": psi_band.launches,
                        "ms_per_step": seconds / job["steps"] * 1e3,
                        "bytes_sent_per_step": ring_halo.sent_bytes / job["steps"],
                        "exchanges_per_step": (ring_halo.exchanges - n0) / job["steps"]}

        st, row = run(params)
        out = {"rank": mesh.rank, "world": world, "backend": mesh.backend, "route": route, **row}
        if job["pair"]:
            paired = params.replace(**job["pair"])
            st2, out["pair"] = run(paired)
            fields = route_fields(route)
            pairs = [(n, getattr(st, n), getattr(st2, n)) for n in fields] + [
                (f"premac.{i}", a, b) for i, (a, b) in enumerate(zip(
                    getattr(st, "premac", None) or (), getattr(st2, "premac", None) or ()))]
            # the rank's part, its zeros' signs dropped (-0.0 + 0.0 is +0.0)
            differ = [n for n, a, b in pairs if not torch.equal(a + 0.0, b + 0.0)]
            check(not differ, f"rank job {job}: the pair's run differs in {differ}")
            out["pair"]["bit_for_bit_to_first_run"] = True
            del st2, pairs
        got = gather_state(st, mesh)
        del st
        if mesh.rank == 0:
            one = sharded_scene(tuple(job["res"]), job["mag"], mesh.device, route=route)[1]
            ref = start_route(params, one, REF_ROUTE[route], device=mesh.device.type)
            for _ in range(job["steps"]):
                ref = route_step(REF_ROUTE[route])(params, ref, device=mesh.device.type)
            fields = route_fields(route)
            n_mac = len(ref.premac) if getattr(ref, "premac", None) is not None else 0
            errs = {}
            for b in range(job["batch"]):
                errs[f"batch {b}"] = compare(
                    f"rank job {job} element {b}", fields + OUTPUTS["B3"][5:5 + n_mac],
                    [getattr(got, n)[b:b + 1] for n in fields]
                    + [x[b:b + 1] for x in (getattr(got, "premac", None) or ())[:n_mac]],
                    [getattr(ref, n) for n in fields] + (list(ref.premac) if n_mac else []))
            out["against_single_device"] = errs
            out["single_device_route"] = REF_ROUTE[route]
            out["bit_for_bit_to_single_device"] = all(
                torch.equal(getattr(got, n)[b:b + 1], getattr(ref, n))
                for n in fields for b in range(job["batch"]))
    finally:
        dist.destroy_process_group()
    print("SHARDED_RANK " + json.dumps(out), flush=True)
    return 0


def rank_job_row(job, ranks, wall):
    """The phase line's row of a rank job (``job`` a tuple of
    ``SHARDED_LANES``, ``ranks`` its ranks' rows, ``wall`` its seconds)."""
    res, _, shape, batch, route, slab, pair = job
    lead = next(r for r in ranks if r["rank"] == 0)
    check(lead["backend"] == ("nccl" if slab else "gloo"),
          f"rank job {res} {shape}: backend {lead['backend']}")
    return {"res": list(res), "mesh": list(shape), "batch": batch, "route": route,
            "transport": ("nccl, one rank sending its ghosts to itself" if slab
                          else "gloo, host-staged, all ranks on one card (not a multi-GPU "
                               "number)"),
            "ms_per_step": [r["ms_per_step"] for r in ranks],
            "bytes_sent_per_step": [r["bytes_sent_per_step"] for r in ranks],
            "exchanges_per_step": lead["exchanges_per_step"],
            "psi_band_launches": [r["psi_band_launches"] for r in ranks],
            "launches_per_step": lead["launches_per_step"],
            "single_device_route": lead["single_device_route"],
            "against_single_device": lead["against_single_device"],
            "bit_for_bit_to_single_device": lead["bit_for_bit_to_single_device"],
            "wall_s": wall, **({"pair": {
                "change": pair,
                **{key: [r["pair"][key] for r in ranks] for key in (
                    "ms_per_step", "bytes_sent_per_step", "psi_band_launches")},
                "exchanges_per_step": lead["pair"]["exchanges_per_step"],
                "bit_for_bit_to_first_run": lead["pair"]["bit_for_bit_to_first_run"],
            }} if pair else {})}


def phase_psi_halo(dev, card):
    """``--psi-halo``: the runs of the meshed solves' exchange options
    alone (ROADMAP B-8 and the shell sliver): ``lbm_psi_ghost_band``'s
    checks, phase ``mesh3d``'s B = 2 slab runs (psi-refreshed and full-h)
    and phase ``sharded``'s paired rank jobs (Z with and without the
    sliver, C1 with and without the refresh), one after another."""
    psi_band_checks(dev, card)
    phase_mesh3d(dev, card, tuple(r for r in MESH3D_RUNS
                                  if r[0].startswith("rosensweig B=2 slabs")))
    jobs = []
    for job in (j for lane in SHARDED_LANES for j in lane if j[6]):
        t0 = time.perf_counter()
        ranks = run_rank_job(*job)
        jobs.append(rank_job_row(job, ranks, time.perf_counter() - t0))
    emit({"phase": "sharded", "part": "paired rank jobs", "jobs": jobs, "card": card,
          "ok": True})


def phase_sharded(dev, kernels_pkg, card):
    """The z-slab path on the one card (phase ``sharded``): one rank with
    ``slab=True`` at 256^3 (bench.py's scene) and 130x66x130 (the HCZ step at
    256^3 and 130^3), float32 and turbo, on each route (Z the capillogue
    steady state; E, O and U, the epilogue routes; C and U19 with the
    channel-form solve; H the HCZ step); gloo jobs of 4 z ranks at 256^3
    on route Z, of 2 at 256^3 on O, of 2 at 130x66x130 on C and of 2 at
    256^3 on H, in two lanes side by side (``SHARDED_LANES``), all sharing
    the card (host-staged gloo
    transport: a correctness check, not a multi-GPU number), a batch mesh
    of 2 ranks, and the slab-forced 256^3 steps once through NCCL (one rank
    sending to itself); the refusal of 4 z ranks at 130x66x130, and a state
    primed on one device refused at the step on 3-plane slabs (ROADMAP C7).
    Returns the slab forms' rows for the ``kernels`` line and the launches
    of ``lbm_psi_ghost_band`` in the rank jobs (C1's)."""
    import torch

    from lbm_ferrofluid_tpu_torch.models import ferrofluid_step, prime_premac
    from lbm_ferrofluid_tpu_torch.parallel import Mesh, shard_state

    K = kernels_pkg.KERNELS
    launches = {kid: 0 for kid in kernels_pkg.SLAB_FORMS + ("B11b emit",)}
    launches16 = dict(launches)
    forms, forms16 = {}, {}
    for res, mag in SHARDED_GRIDS:
        for route in ROUTES:
            grid = HCZ_GRID[res] if route == "H" else res
            params, s0 = sharded_scene(grid, mag, dev, route=route)
            rows, used = slab_forced(K, kernels_pkg, params, s0, dev, card,
                                     f"slab-forced {route} {grid}", route=route)
            for key, row in rows.items():  # the times at 256^3; the largest error of both
                if key not in forms:
                    forms[key] = row
                forms[key]["max_abs_err"] = max(forms[key]["max_abs_err"], row["max_abs_err"])
            for kid in launches:
                launches[kid] += used[kid]
            p16, s16 = turbo(params, s0, dev)
            rows16, used16 = slab_forced(K, kernels_pkg, p16, s16, dev, card,
                                         f"slab-forced turbo {route} {grid}", steps=10,
                                         timed=10 if grid == res and res[0] == 256 else 2,
                                         bf16=True, route=route)
            for key, row in rows16.items():
                forms16.setdefault(key, row)
            for kid in launches16:
                launches16[kid] += used16[kid]
            del s0, s16
            torch.cuda.empty_cache()
    _, s130 = sharded_scene((130, 66, 130), None, dev)
    try:
        shard_state(s130, Mesh(("batch", "z"), (1, 4), 0, torch.device(dev), "gloo"))
        raise CheckFailed("130x66x130 on 4 z ranks did not raise")
    except ValueError as e:
        refused = str(e)
    del s130
    params, s12 = sharded_scene((12, 66, 130), None, dev)
    thin = Mesh(("batch", "z"), (1, 4), 1, torch.device(dev), "gloo")
    try:
        ferrofluid_step(params, shard_state(prime_premac(params, s12, device=dev), thin),
                        mesh=thin)
        raise CheckFailed("a primed state on 3-plane slabs stepped")
    except ValueError as e:
        refused_step = str(e)
    # 3-plane slabs take the block route, which steps un-carried
    check("premac on the block route" in refused_step, f"3-plane slabs: {refused_step}")
    del s12
    torch.cuda.empty_cache()
    def lane(lane_jobs):
        """The lane's jobs one after another: each job's ranks' rows and
        wall seconds."""
        out = []
        for job in lane_jobs:
            t0 = time.perf_counter()
            out.append((run_rank_job(*job), time.perf_counter() - t0))
        return out

    with concurrent.futures.ThreadPoolExecutor(len(SHARDED_LANES)) as pool:
        done = [f.result() for f in [pool.submit(lane, jobs) for jobs in SHARDED_LANES]]
    jobs, psi_launches = [], 0
    for lane_jobs, results in zip(SHARDED_LANES, done):
        for job, (ranks, wall) in zip(lane_jobs, results):
            for r in ranks:
                for run in [r] + ([r["pair"]] if job[6] else []):
                    for kid in launches:
                        launches[kid] += run["slab_launches"].get(kid, 0)
                    psi_launches += run["psi_band_launches"]
            jobs.append(rank_job_row(job, ranks, wall))
    emit({"phase": "sharded", "part": "ranks", "jobs": jobs, "psi_band_launches": psi_launches,
          "refused_4_ranks_130": refused,
          "refused_step_3_planes": refused_step,
          "slab_launches": launches, "slab_launches_bf16": launches16, "card": card,
          "ok": True})
    rows = []
    for kid in kernels_pkg.SLAB_FORMS:
        row = forms["B5 emit_mac" if kid == "B5" else kid]
        rows.append({
            "name": f"{kid} {K[kid].wrapper.__name__} slab", "route": "cuda",
            "source": K[kid].module.CUDA_SOURCE, "replaces": kernels_pkg.SLAB_TPU_KERNELS[kid],
            "launches": launches[kid], "launches_bf16": launches16[kid],
            **{key: row[key] for key in ("max_abs_err", "ms", "plain_ms", "bound_ms",
                                         "bound_by", "single_device_ms")},
            "library_ms": None,
            **({"emit_mac": True, "without_emit_mac": {
                key: forms["B5"][key] for key in ("max_abs_err", "ms", "plain_ms", "bound_ms",
                                                  "single_device_ms")}} if kid == "B5" else {}),
        })
    row16 = forms16["B5 emit_mac"]
    rows.append({
        "name": "B5 lbm_epilogue slab bf16", "route": "cuda", "source": K["B5"].module.CUDA_SOURCE,
        "replaces": kernels_pkg.SLAB_TPU_KERNELS["B5"], "launches": launches16["B5"],
        **{key: row16[key] for key in ("max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
                                       "single_device_ms")},
        "library_ms": None, "emit_mac": True,
        "without_emit_mac": {key: forms16["B5"][key] for key in (
            "max_abs_err", "ms", "plain_ms", "bound_ms", "single_device_ms")},
    })
    for kid in ("B8a", "B8b", "B11b"):
        rows.append({
            "name": f"{kid} {K[kid].wrapper.__name__} slab bf16", "route": "cuda",
            "source": K[kid].module.CUDA_SOURCE, "replaces": kernels_pkg.SLAB_TPU_KERNELS[kid],
            "launches": launches16[kid],
            **{key: forms16[kid][key] for key in ("max_abs_err", "ms", "plain_ms", "bound_ms",
                                                   "bound_by", "single_device_ms")},
            "library_ms": None,
        })
    for tag, fm, n in (("", forms, launches["B11b emit"]),
                       (" bf16", forms16, launches16["B11b emit"])):
        rows.append({
            "name": f"B11b poisson_sweeps slab emit{tag}", "route": "cuda",
            "source": K["B11b"].module.CUDA_SOURCE_EMIT,
            "replaces": K["B11b"].module.TPU_KERNEL_EMIT + " with slab_clamp= and ghosts=",
            "launches": n,
            **{key: fm["B11b emit"][key] for key in ("max_abs_err", "ms", "plain_ms",
                                                      "bound_ms", "bound_by",
                                                      "single_device_ms")},
            "library_ms": None, "what": "the slab solve, its last round with the trailing stage",
        })
    return rows, psi_launches


#: the batched cells of the batch phase: route (U the un-carried Rosensweig
#: step on the 19-channel h, H the HCZ step on ``multiphase_3d``, P 3D
#: single-phase BGK), grid, batch, steps held bit for bit to each element's
#: own B = 1 kernel steps, steps a timed turn, storage of f, g and h
BATCH_CELLS = (
    ("U", (130, 66, 130), 4, 30, 10, "float32"),
    ("U", (130, 66, 130), 4, 30, 10, "bfloat16"),
    ("U", (256, 256, 256), 2, 5, 4, "float32"),
    ("U", (256, 256, 256), 2, 5, 4, "bfloat16"),
    ("H", (130, 130, 130), 4, 30, 10, "float32"),
    ("H", (256, 256, 256), 2, 5, 4, "float32"),
    ("P", (130, 130, 130), 2, 5, 5, "float32"),
)
#: the kernels each batched route launches (``kernels.PATHS``)
BATCH_PATHS = {"U": "ferrofluid_uncarried", "H": "hcz", "P": "singlephase3d"}
BATCH_FIELDS = {"U": FERRO_FIELDS + ("phi", "force"), "H": HCZ_FIELDS, "P": ("f", "rho", "vel")}
#: the 2D cell: ``rosensweig_2d``'s grid, batch and steps a timed turn
BATCH_2D = ((130, 130), 16, 20)


def batch_scene(route, res, batch, storage, dev, seed=17):
    """(params, state, step) of a batched cell: the route's scene at
    ``batch`` elements, f, g and h in ``storage``, each element's f and g
    moved by a relative 1e-3 and its h (zero at init) by 1e-4 of noise from
    its own seed, so that an element that read another would show."""
    import torch

    from lbm_ferrofluid_tpu_torch import models

    if route == "P":
        params, st = taylor_green_3d(res, dev)
        st = st.replace(**{k: torch.cat([v] * batch) for k, v in vars(st).items()
                           if torch.is_tensor(v)})
        step = models.singlephase_step
    elif route == "H":
        params, st = models.multiphase_3d(res=res, batch=batch, device=dev)
        step = models.hcz_step
    else:
        params, st = models.rosensweig_3d(res=res, batch=batch, device=dev)
        step = models.ferrofluid_step
    if storage == "bfloat16":
        params, st = turbo(params, st, dev)
    noisy = {}
    for name, scale, relative in (("f", 1e-3, True), ("g", 1e-3, True), ("h", 1e-4, False)):
        x = getattr(st, name, None)
        if x is None:
            continue
        parts = []
        for b in range(batch):
            gen = torch.Generator(device=x.device).manual_seed(seed + 101 * b)
            n = torch.rand(x[b:b + 1].shape, generator=gen, device=x.device) * 2 - 1
            xb = x[b:b + 1].float()
            parts.append((xb * (1 + scale * n) if relative else xb + scale * n).to(x.dtype))
            del n
        noisy[name] = torch.cat(parts)
    return params, st.replace(**noisy), step


def batch_element(state, b):
    """Element ``b`` of a batched state, as a state of one element."""
    import torch

    def part(v):
        if torch.is_tensor(v):
            return v[b:b + 1]
        if isinstance(v, tuple):
            return tuple(part(x) for x in v)
        return v
    return state.replace(**{k: part(v) for k, v in vars(state).items()})


def batch_launches_a_step(K, route, params, shape):
    """Launches a step of each kernel of a batched route, at every B."""
    if route == "U":
        return {"B4": 1, "B11b": K["B11b"].module.launches_per_call(params.poisson_iters, shape),
                "B2": K["B2"].module.N_LAUNCHES, "B6": K["B6"].module.N_LAUNCHES, "B5": 1}
    if route == "H":
        return {"B8b": 1, "B8a": 1, "B2": K["B2"].module.N_LAUNCHES,
                "B6": K["B6"].module.N_LAUNCHES, "B9": 1}
    return {"B8a": 1}


def batch_turns(params, state, step, dev, n, batch):
    """ms a step of the batched state against ``batch`` sequential B = 1
    steps (one an element) a step, in turns batched, sequential,
    sequential, batched, ``n`` steps a turn, after one untimed step of the
    elements (the batch is warm): (state, row)."""
    import torch

    out = {"batched": [], "sequential": []}
    elements = [step(params, batch_element(state, b), device=dev) for b in range(batch)]
    for kind in ("batched", "sequential", "sequential", "batched"):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(n):
            if kind == "batched":
                state = step(params, state, device=dev)
            else:
                elements = [step(params, e, device=dev) for e in elements]
        torch.cuda.synchronize()
        out[kind].append((time.perf_counter() - t0) / n * 1e3)
    cells = state.rho.numel()
    return state, {
        "ms_per_step": out["batched"], "sequential_ms_per_step": out["sequential"],
        "mlups": [cells / ms / 1e3 for ms in out["batched"]],
        "sequential_mlups": [cells / ms / 1e3 for ms in out["sequential"]],
        "steps_a_turn": n, "order": "batched, sequential, sequential, batched"}


def batch_cell(dev, kernels_pkg, route, res, batch, n_bits, n_timed, storage):
    """One batched cell: ``n_bits`` steps of the batch with the launch
    counters zeroed just before and read just after (every kernel of the
    route once a step, each launch for the whole batch), each element then
    held bit for bit to ``n_bits`` B = 1 kernel steps of it alone, the
    peak memory of the batched steps, and ms a step in turns against
    sequential B = 1 steps.  Returns (row, launches, params, state)."""
    import torch

    from lbm_ferrofluid_tpu_torch.models import prime_premac
    from lbm_ferrofluid_tpu_torch.models.runner import assert_finite

    K = kernels_pkg.KERNELS
    label = f"batch {route} {'x'.join(map(str, res))} B={batch} {storage}"
    params, s0, step = batch_scene(route, res, batch, storage, dev)
    ids = kernels_pkg.PATHS[BATCH_PATHS[route]]
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    kernels_pkg.reset_launch_counts()
    sb = s0
    if route == "U":
        sb = prime_premac(params, s0, device=dev)
        check(sb is s0 and sb.premac is None and sb.h.shape[1] == 19,
              f"{label}: prime_premac changed a batch")
    for _ in range(n_bits):
        sb = step(params, sb, device=dev)
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated()
    launches = kernels_pkg.launch_counts()
    batched = kernels_pkg.launch_counts(ids, batch=True)
    per_step = batch_launches_a_step(K, route, params, s0.f.shape)
    check_launches(label, launches, per_step, n_bits)
    check(all(batched[kid] == launches[kid] for kid in ids),
          f"{label}: launches not at the batch: {batched} of {launches}")
    n_emit = check_emit_launches(label, kernels_pkg, n_bits) if route == "U" else 0
    assert_finite(sb, fields=vars(sb))
    names = BATCH_FIELDS[route]
    for b in range(batch):
        sa = batch_element(s0, b)
        for _ in range(n_bits):
            sa = step(params, sa, device=dev)
        torch.cuda.synchronize()
        for n in names:
            got, want = getattr(sb, n)[b:b + 1], getattr(sa, n)
            check(torch.equal(got, want),
                  f"{label} element {b} {n}: differs from its B = 1 kernel steps by "
                  f"{float((got.double() - want.double()).abs().max()):.3e}")
        del sa
    del s0
    sb, turns = batch_turns(params, sb, step, dev, n_timed, batch)
    torch.cuda.empty_cache()
    row = {"route": route, "res": list(res), "batch": batch, "storage": storage,
           "steps_held_bit_for_bit": n_bits, "fields": list(names),
           "launches_a_step": sum(per_step.values()), "launches": {k: launches[k] for k in ids},
           "peak_mem_gb": peak / 1e9, **turns}
    return row, dict(launches, **{"B11b emit": n_emit}), params, sb


def uncarried_chain(K, params, st, record):
    """The un-carried step's kernels in its order on the state ``st``, each
    fed with what the kernels before it produced: B4, B11b with B7's
    trailing stage (H2), B2, B6 with H2 and phi, B5."""
    from lbm_ferrofluid_tpu_torch.ops.magnetic import poisson_rhs_scaled
    from lbm_ferrofluid_tpu_torch.ops.moments import phi_from_density, rho_to_density

    gas = dict(rho_gas=params.rho_gas, rho_fluid=params.rho_fluid,
               density_gas=params.density_gas, density_fluid=params.density_fluid)
    rho, vel, den, m0g, m1g = record("B4", "B4", (st.f, st.g, st.flags, st.rho, st.vel),
                                     dict(c=params.dx / params.dt, **gas))
    phi = phi_from_density(den, params.density_gas, params.density_fluid)
    rhs = poisson_rhs_scaled(phi, st.magnetic_flags, static_field(params), tau=params.tau,
                             dx=params.dx, dt=params.dt)
    _, H2 = record("B11b", "B11b", (st.h, st.magnetic_flags, rhs),
                   emit_kw(params, "h2", params.tau, params.poisson_iters))
    rho_ca = record("B2", "B2", (rho, st.flags, params.contact_angle), {})
    cap_kw = dict(kappa=params.kappa, dx=params.dx, dt=params.dt,
                  gravity=tuple(float(v) for v in params.gravity_vec().reshape(-1)), **gas)
    vel2, pres, force, dfai, dprho = record(
        "B6", "B6", (rho, den, st.pressure, rho_ca, H2, phi, st.flags, m0g, m1g, vel), cap_kw)
    record("B5", "B5", (st.f, st.g, st.flags, rho_ca, vel2, rho_to_density(rho_ca, **gas), pres,
                        force, dfai, dprho),
           dict(tau_f=params.tau_f, tau_g=params.tau_g, dx=params.dx, dt=params.dt))


def batch_kernel_rows(K, params, st, chain, what):
    """Each kernel of a batched route on the batched state ``st`` (``chain``
    runs the route's kernels in its order): the batched call bit for bit
    to B = 1 calls of its elements, against its plain version at phase 3's
    bars, ms beside the B = 1 calls of all its elements one after another
    (``sequential_ms``) and the plain version, its bound at B (``cost``
    counts every element)."""
    import torch

    batch = st.f.shape[0]
    rows = {}

    def element(args, b):
        return tuple(a[b:b + 1] if torch.is_tensor(a) else a for a in args)

    def record(label, kid, args, kw):
        k = K[kid]
        out = k.wrapper(*args, **kw)
        for b in range(batch):
            alone = k.wrapper(*element(args, b), **kw)
            torch.cuda.synchronize()
            check(all(torch.equal(x[b:b + 1], y) for x, y in zip(flat(out), flat(alone),
                                                                  strict=True)),
                  f"{label} {what}: element {b} of the batched call differs from its B = 1 call")
            del alone
        per_call = (k.module.launches_per_call(kw["n_iters"], args[0].shape)
                    if kid == "B11b" else 1)
        rows[label] = dict(measure(K, kid, args, kw, per_call, per_call, f"{label} {what}"),
                           batch=batch, res=list(args[0].shape[2:]), sequential_ms=time_cuda(
                               lambda: [k.wrapper(*element(args, b), **kw)
                                        for b in range(batch)], reps=3))
        return out

    chain(K, params, st, record)
    return rows


def hcz_state_chain(K, params, st, record):
    """:func:`hcz_chain` on a batched HCZ state (the Kelvin variant of B6
    with H2 1e4)."""
    import torch

    hcz_chain(K, params, dict(flags=st.flags, f=st.f, g=st.g, rho_old=st.rho, vel_old=st.vel,
                              pres=st.pressure, H2=torch.full_like(st.rho, 1e4)), record)


def batch_2d(dev):
    """``rosensweig_2d`` at 130x130 with B = 16 against B = 1 (plain ops,
    no kernel launch; un-primed, so both solve on the 9-channel h): ms a
    step in turns (B = 16, B = 1, B = 1, B = 16), and element 0 of the
    batch (the B = 1 state; the others moved by noise) against the B = 1
    run at phase 3's bars."""
    import torch

    from lbm_ferrofluid_tpu_torch.models import ferrofluid_step, rosensweig_2d

    res, batch, n = BATCH_2D
    params, one = rosensweig_2d(res=res, device=dev)
    _, many = rosensweig_2d(res=res, batch=batch, device=dev)
    gen = torch.Generator(device=many.f.device).manual_seed(23)
    noise = torch.rand(many.f.shape, generator=gen, device=many.f.device) * 2 - 1
    noise[0] = 0
    many = many.replace(f=many.f * (1 + 1e-3 * noise))
    check(torch.equal(many.f[:1], one.f), "2D batch: element 0 is not the B = 1 state")
    times = {1: [], batch: []}
    states = {1: one, batch: many}
    for b in (batch, 1, 1, batch):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(n):
            states[b] = ferrofluid_step(params, states[b], device=dev)
        torch.cuda.synchronize()
        times[b].append((time.perf_counter() - t0) / n * 1e3)
    s1, sb = states[1], states[batch]
    check(sb.h.shape[1] == 9 and s1.h.shape[1] == 9, "2D batch: not on the 9-channel h")
    rows = compare("2D batch element 0 vs B = 1", list(FERRO_FIELDS),
                   [getattr(sb, k)[:1] for k in FERRO_FIELDS],
                   [getattr(s1, k) for k in FERRO_FIELDS])
    return {"scene": "rosensweig_2d", "res": list(res), "batch": batch, "steps": s1.step,
            "ms_per_step_b1": times[1], f"ms_per_step_b{batch}": times[batch],
            "order": f"B={batch}, B=1, B=1, B={batch}",
            "element0_vs_b1": rows}


def phase_batch(dev, kernels_pkg, card):
    """Batched states on one device (ROADMAP A12 slice 5): each cell of
    ``BATCH_CELLS`` (:func:`batch_cell`), the kernels of routes U and H at
    256^3 B = 2 (float32) on the batched state (:func:`batch_kernel_rows`)
    and the 2D cell.  Returns (launches of the kernels summed over the
    cells' counted steps, the kernel rows)."""
    import torch

    K = kernels_pkg.KERNELS
    t0 = time.perf_counter()
    cells, total, kernel_rows = [], {}, {}
    for route, res, batch, n_bits, n_timed, storage in BATCH_CELLS:
        row, launches, params, sb = batch_cell(dev, kernels_pkg, route, res, batch, n_bits,
                                               n_timed, storage)
        for kid, n in launches.items():
            total[kid] = total.get(kid, 0) + n
        if res == (256, 256, 256) and storage == "float32" and route in ("U", "H"):
            rows = batch_kernel_rows(K, params, sb,
                                     uncarried_chain if route == "U" else hcz_state_chain,
                                     f"batch {route} 256^3 B={batch}")
            kernel_rows.update({f"{route} {label}": r for label, r in rows.items()})
        del sb
        torch.cuda.empty_cache()
        cells.append(row)
    two_d = batch_2d(dev)
    emit({"phase": "batch", "cells": cells, "kernels": kernel_rows, "2d": two_d,
          "launches": {kid: total.get(kid, 0) for kid in kernels_pkg.BATCH_FORMS},
          "seconds": time.perf_counter() - t0, "card": card, "ok": True})
    return total, kernel_rows


def batch_rows(K, total, kernel_rows, b10a=None, mesh3d_batch=None):
    """The ``kernels`` line's rows of the batch forms: launches over the
    batch phase's counted steps; times and bound of the batched call at
    256^3 B = 2 on route U (B2, B4, B5, B6 with H2, B11b with the trailing
    stage) or the HCZ route (B8a, B8b, B9), the largest error over both
    routes.  B10a's batch form (the block route's psi route, which the
    batch phase's routes do not take): its launches on phase ``mesh3d``'s
    runs at two elements a rank (``mesh3d_batch``), its times and bound at
    B = 2 on psi at 130x66x130 (``b10a``, from the kernel phase)."""
    from lbm_ferrofluid_tpu_torch.ops.kernels import BATCH_FORMS

    rows = []
    for kid in BATCH_FORMS:
        if kid == "B10a":
            if b10a is not None:
                rows.append({
                    "name": f"B10a {K[kid].wrapper.__name__} batch", "route": "cuda",
                    "source": K[kid].module.CUDA_SOURCE, "replaces": K[kid].tpu_kernel,
                    "launches": (mesh3d_batch or {}).get(kid, 0), "res": [130, 66, 130],
                    **{key: b10a[key] for key in ("ms", "plain_ms", "bound_ms", "bound_by",
                                                  "batch", "sequential_ms", "max_abs_err")},
                    "library_ms": None})
            continue
        own = [r for label, r in kernel_rows.items() if label.split(" ", 1)[1] == kid]
        row = kernel_rows.get(f"U {kid}", own[0])
        rows.append({
            "name": f"{kid} {K[kid].wrapper.__name__} batch", "route": "cuda",
            "source": K[kid].module.CUDA_SOURCE, "replaces": K[kid].tpu_kernel,
            "launches": total.get(kid, 0),
            **{key: row[key] for key in ("ms", "plain_ms", "bound_ms", "bound_by", "batch",
                                         "res", "sequential_ms")},
            "max_abs_err": max(r["max_abs_err"] for r in own), "library_ms": None})
    return rows


# ---------------------------------------------------------------- phase mesh2d
#: the 2D models on y/x meshes (phase ``mesh2d``): each run (scene of
#: ``SCENES_2D``, mesh axes, mesh shape, grid, storage, params change,
#: batch, timed steps) after 2 warm steps, held bit for bit to one device's
#: steps on the card.  ``rosensweig_2d`` at 2048^2 (phase 7's large 2D
#: size) on 2x2 ranks in float32 and bfloat16 storage with h in the scalar
#: carry and in 9 channels; the other models at their demo size cut to
#: 128^2 (130 does not split into 4) on 4x2 and 2x4 ranks; a batch of 2 on
#: (batch, y, x) = (2, 2, 1) at the demo size
MESH2D_BIG = (2048, 2048)
MESH2D_DEMO = (128, 128)
MESH2D_JOBS = (
    [(scene, ("y", "x"), shape, MESH2D_DEMO, "float32", {}, 1, 6)
     for shape in ((4, 2), (2, 4))
     for scene in ("droplet_spread_2d", "multiphase_drop_sc", "shear_layer", "shear_layer_kbc")],
    [("rosensweig_2d", ("y", "x"), (2, 2), MESH2D_BIG, storage, change, 1, 6)
     for storage in ("float32", "bfloat16") for change in ({}, {"scalar_carry": False})]
    + [("rosensweig_2d", ("batch", "y", "x"), (2, 2, 1), (130, 130), "float32", {}, 2, 6)],
)
#: seconds a job's ranks may take
MESH2D_TIMEOUT = 300
MESH2D_FIELDS = ("f", "g", "h", "rho", "vel", "density", "pressure", "force", "phi")


def mesh2d_scene(run, dev):
    """(params, whole state, step function) of a run of :data:`MESH2D_JOBS`
    on ``dev``: the scene at the run's grid and storage, its batch elements
    after the first moved by seeded noise (f by a relative 1e-3)."""
    import torch

    from lbm_ferrofluid_tpu_torch import models

    scene, _, _, res, storage, change, batch, _ = run
    build, step, _, kw = SCENES_2D[scene]
    params, st = getattr(models, build)(res=tuple(res), batch=batch, device=dev, **kw)
    params = params.replace(**change)
    if storage == "bfloat16":
        params = params.replace(fg_dtype="bfloat16", h_dtype="bfloat16")
        st = models.init_ferrofluid_state(params, st.rho, st.density, st.vel, st.flags,
                                          st.magnetic_flags, device=dev)
    if batch > 1:
        gen = torch.Generator(device=st.f.device).manual_seed(29)
        noise = torch.rand(st.f.shape, generator=gen, device=st.f.device) * 2 - 1
        noise[0] = 0
        st = st.replace(f=(st.f.float() * (1 + 1e-3 * noise)).to(st.f.dtype))
    return params, st, getattr(models, step)


def _state_fields(st):
    return {n: getattr(st, n) for n in MESH2D_FIELDS if getattr(st, n, None) is not None}


def _bits_sha(x) -> str:
    import torch

    x = x.detach().contiguous()
    if x.dtype == torch.bfloat16:
        x = x.view(torch.int16)
    return hashlib.sha256(x.cpu().numpy().tobytes()).hexdigest()


def mesh2d_one_device(run, dev):
    """The one-device steps of a run (each batch element alone, as each
    rank of the batch mesh primes and steps its own): the state after the
    warm and timed steps, and ms a timed step."""
    import dataclasses

    import torch

    params, whole, step = mesh2d_scene(run, dev)
    prime = SCENES_2D[run[0]][1] == "ferrofluid_step"
    from lbm_ferrofluid_tpu_torch.models import prime_premac

    elems, ms = [], []
    for b in range(whole.f.shape[0]):
        st = dataclasses.replace(whole, **{
            f.name: _elem(getattr(whole, f.name), b)
            for f in dataclasses.fields(whole) if f.name != "step"})
        if prime:
            st = prime_premac(params, st, device=dev)
        st, stats = timed_steps(params, st, step, dev, run[7], warmup=2)
        elems.append(st)
        ms.append(stats["seconds"] / run[7] * 1e3)
    out = elems[0] if len(elems) == 1 else dataclasses.replace(elems[0], **{
        n: torch.cat([getattr(e, n) for e in elems]) for n in _state_fields(elems[0])})
    return out, float(np.mean(ms))


def _elem(v, b):
    if v is None or isinstance(v, (int, float)):
        return v
    if isinstance(v, tuple):
        return tuple(_elem(x, b) for x in v)
    return v[b:b + 1] if v.shape[0] > 1 else v


def mesh2d_rank(job_json) -> int:
    """A rank of a job of :func:`phase_mesh2d`: joins the group from
    torchrun's variables and, for each run, builds the scene on the card,
    cuts its block, primes (the ferrofluid scenes) and steps it on the mesh
    through the model's entry point (2 warm steps, then the timed ones,
    each rank synchronising its device, then a barrier), launch counters
    zeroed before the job and read after it (2D launches no kernel); hashes
    its block of each field.  Rank 0 then runs the one-device steps alone
    and holds each rank's block of them to that rank's hashes.  The host
    wall time inside the exchanges is summed (each staged exchange first
    waits for the device work queued before it).  Prints its rows."""
    import dataclasses

    import torch
    import torch.distributed as dist

    from lbm_ferrofluid_tpu_torch.models import prime_premac
    from lbm_ferrofluid_tpu_torch.ops import kernels as kernels_pkg
    from lbm_ferrofluid_tpu_torch.parallel import (
        blocks, initialize_distributed, make_mesh, ring_halo, shard_state,
    )

    in_exchanges = [0.0]

    def timed_halo(*args, **kw):
        t = time.perf_counter()
        try:
            return ring_halo(*args, **kw)
        finally:
            in_exchanges[0] += time.perf_counter() - t

    blocks.ring_halo = timed_halo
    runs = json.loads(job_json)
    world = initialize_distributed()
    rows = []
    try:
        kernels_pkg.reset_launch_counts()
        for run in runs:
            scene, axes, shape, res, storage, change, batch, steps = run
            mesh = make_mesh(tuple(axes), tuple(shape))
            params, whole, step = mesh2d_scene(run, mesh.device)
            st = shard_state(whole, mesh)
            del whole
            if step.__name__ == "ferrofluid_step":
                st = prime_premac(params, st, mesh=mesh)
            for _ in range(2):
                st = step(params, st, mesh=mesh)
            n0, b0 = ring_halo.exchanges, ring_halo.sent_bytes
            torch.cuda.synchronize()
            dist.barrier()
            in_exchanges[0] = 0.0
            t0 = time.perf_counter()
            for _ in range(steps):
                st = step(params, st, mesh=mesh)
            torch.cuda.synchronize()
            dist.barrier()
            seconds = time.perf_counter() - t0
            row = {"scene": scene, "mesh": dict(zip(axes, shape)), "res": list(res),
                   "storage": storage, "change": change, "batch": batch,
                   "h_channels": st.h.shape[1] if getattr(st, "h", None) is not None else None,
                   "steps": st.step, "ms_per_step": seconds / steps * 1e3,
                   "exchanges_per_step": (ring_halo.exchanges - n0) / steps,
                   "ms_in_exchanges_per_step": in_exchanges[0] / steps * 1e3,
                   "bytes_sent_per_step": (ring_halo.sent_bytes - b0) / steps}
            mine = {n: _bits_sha(x) for n, x in _state_fields(st).items()}
            every = [None] * world
            dist.all_gather_object(every, mine)
            if mesh.rank == 0:
                ref, ms1 = mesh2d_one_device(run, mesh.device)
                differ = [(r, n) for r in range(world) for n, x in _state_fields(
                    shard_state(ref, dataclasses.replace(mesh, rank=r))).items()
                          if every[r].get(n) != _bits_sha(x)]
                row.update(ms_per_step_one_device=ms1, bit_for_bit_to_one_device=not differ,
                           differ=differ[:8])
                check(not differ, f"mesh2d {scene} {dict(zip(axes, shape))} {res} "
                      f"{storage} {change}: blocks differ from one device: {differ[:8]}")
            dist.barrier()
            rows.append(row)
            del st
            torch.cuda.empty_cache()
        launches = kernels_pkg.launch_counts()
        check(not any(launches.values()), f"mesh2d: 2D steps launched kernels: {launches}")
    finally:
        dist.destroy_process_group()
    print("MESH2D_RANK " + json.dumps({"rank": int(os.environ["RANK"]), "rows": rows}),
          flush=True)
    return 0


def phase_mesh2d(dev, card):
    """The 2D models on y/x meshes (phase ``mesh2d``, ROADMAP A12 slice 4):
    each job of :data:`MESH2D_JOBS` as gloo ranks sharing the one card
    (processes of ``chip_smoke.py --mesh2d-rank``, torchrun's variables
    set), one job after the other; each run bit for bit to one device's
    steps, with ms a step beside one device's in the same call, bytes a
    rank sends a step and exchanges a step (rank 0's)."""
    del dev
    t0 = time.perf_counter()
    out = []
    for runs in MESH2D_JOBS:
        world = math.prod(runs[0][2])
        check(all(math.prod(r[2]) == world for r in runs), "mesh2d: a job's meshes differ")
        env = dict(os.environ, MASTER_ADDR="127.0.0.1", MASTER_PORT=str(_free_port()),
                   WORLD_SIZE=str(world), LOCAL_WORLD_SIZE=str(world))
        outs = run_processes("mesh2d job",
                             [[str(ROOT / "chip_smoke.py"), "--mesh2d-rank", json.dumps(runs)]]
                             * world,
                             [dict(env, RANK=str(r), LOCAL_RANK=str(r)) for r in range(world)],
                             MESH2D_TIMEOUT, "MESH2D_RANK")
        first = [o for out_ in outs for o in out_ if o["rank"] == 0]
        check(len(first) == 1, f"mesh2d: rank 0 reported {len(first)} times")
        out += first[0]["rows"]
    emit({"phase": "mesh2d", "runs": out, "seconds": time.perf_counter() - t0, "card": card,
          "ok": True})
    return out


# ---------------------------------------------------------------- phase mesh3d
#: the 3D states on the block route (phase ``mesh3d``), one job of 4 gloo
#: ranks sharing the card: (label, scene builder, its keywords, mesh axes,
#: mesh shape, storage, params change).  Rosensweig at the demo's native
#: 130x66x130 (mag 100) on (z, y) = (2, 2) with the scalar carry, in float32
#: and turbo; bench.py's 256^3 (mag 85) on (2, 2); the channel form at
#: 130x66x130 on (y, x) = (2, 2); HCZ multiphase_3d 130^3 on (z, y, x) =
#: (2, 2, 1); single phase 128^3 on (y, x) = (2, 2); HCZ on 2-plane z-slabs
#: (8x130x130 on 4 z ranks, which the slab forms do not take).  Two batch
#: elements a rank (ROADMAP A12 slice 7, keyword ``batch``; each element
#: after the first moved by seeded noise): Rosensweig 130x66x130 at B = 2
#: on (z, y) = (2, 2) in float32 and turbo (h in 19 channels, the psi
#: route); the same float32 state on (batch, z) = (2, 2), one element a rank
#: on the slab route U19 (un-carried, never primed): the block route at two
#: elements a rank against the slab route at one, the grounds of slice 7b;
#: HCZ 128^3 at B = 2 on 4 z ranks; single phase 128^3 at B = 2 on (y, x)
#: = (2, 2).  The padded transposed layout (ROADMAP A12 slice 4c): the
#: demo's ``rosensweig_3d_tpu()`` (arrays 66x136x256, box 66x130x130) on
#: (z, y) = (2, 2) in float32 and turbo and on (y, x) = (2, 2) (rank x = 1
#: holds 2 box columns), the block route; ``rosensweig_3d_tpu(res=(130, 64,
#: 130))`` (arrays 64x136x256: physical y cut 66 -> 64 to split in 4) on 4 z
#: ranks, the slab route, primed to a 5-leaf premac.  The B = 2 slab run
#: (tau 1, the shell declared: ROADMAP B-8's psi-refreshed bands) and its
#: full-h twin (``poisson_psi_halo=False``), one pair: each bit for bit to
#: one device, with its bytes and exchanges (4 time-sliced ranks on a
#: shared host move one run's ms by tens of per cent, so the pair's ms
#: compare nothing)
MESH3D_RUNS = (
    ("rosensweig", "rosensweig_3d", {"res": (130, 66, 130)}, ("z", "y"), (2, 2), "float32", {}),
    ("rosensweig turbo", "rosensweig_3d", {"res": (130, 66, 130)}, ("z", "y"), (2, 2),
     "bfloat16", {}),
    ("rosensweig 256", "rosensweig_3d", {"res": (256, 256, 256), "mag_strength": 85.0},
     ("z", "y"), (2, 2), "float32", {}),
    ("channel", "rosensweig_3d", {"res": (130, 66, 130)}, ("y", "x"), (2, 2), "float32",
     {"scalar_carry": False}),
    ("hcz", "multiphase_3d", {"res": (130, 130, 130)}, ("z", "y", "x"), (2, 2, 1), "float32",
     {}),
    ("single", "taylor_green_3d", {"res": (128, 128, 128)}, ("y", "x"), (2, 2), "float32", {}),
    ("hcz 2-plane slabs", "multiphase_3d", {"res": (8, 130, 130)}, ("z",), (4,), "float32", {}),
    ("rosensweig B=2", "rosensweig_3d", {"res": (130, 66, 130), "batch": 2}, ("z", "y"),
     (2, 2), "float32", {}),
    ("rosensweig turbo B=2", "rosensweig_3d", {"res": (130, 66, 130), "batch": 2},
     ("z", "y"), (2, 2), "bfloat16", {}),
    ("rosensweig B=2 slabs", "rosensweig_3d", {"res": (130, 66, 130), "batch": 2},
     ("batch", "z"), (2, 2), "float32", {}),
    ("rosensweig B=2 slabs full-h", "rosensweig_3d", {"res": (130, 66, 130), "batch": 2},
     ("batch", "z"), (2, 2), "float32", {"poisson_psi_halo": False}),
    ("hcz B=2", "multiphase_3d", {"res": (128, 128, 128), "batch": 2}, ("z",), (4,), "float32",
     {}),
    ("single B=2", "taylor_green_3d", {"res": (128, 128, 128), "batch": 2}, ("y", "x"), (2, 2),
     "float32", {}),
    ("padded", "rosensweig_3d_tpu", {"res": (130, 66, 130)}, ("z", "y"), (2, 2), "float32", {}),
    ("padded turbo", "rosensweig_3d_tpu", {"res": (130, 66, 130)}, ("z", "y"), (2, 2),
     "bfloat16", {}),
    ("padded y/x", "rosensweig_3d_tpu", {"res": (130, 66, 130)}, ("y", "x"), (2, 2), "float32",
     {}),
    ("padded slabs", "rosensweig_3d_tpu", {"res": (130, 64, 130)}, ("z",), (4,), "float32", {}),
)
MESH3D_WARM, MESH3D_STEPS = 2, 4
MESH3D_TIMEOUT = 360


def mesh3d_scene(run, dev):
    """(params, whole state, step function) of a run of :data:`MESH3D_RUNS`
    on ``dev``."""
    from lbm_ferrofluid_tpu_torch import models

    import torch

    _, build, kw, _, _, storage, change = run
    kw = dict(kw, res=tuple(kw["res"]))
    if build == "taylor_green_3d":
        params, st = taylor_green_3d(kw["res"], dev, batch=kw.get("batch", 1))
        return params, st, models.singlephase_step
    params, st = getattr(models, build)(device=dev, **kw)
    params = params.replace(**change)
    if storage == "bfloat16":
        params, st = turbo(params, st, dev)
    if st.f.shape[0] > 1:
        # the scene copies one element: move the others' f by seeded noise
        gen = torch.Generator(device=st.f.device).manual_seed(37)
        noise = torch.rand(st.f.shape, generator=gen, device=st.f.device) * 2 - 1
        noise[0] = 0
        st = st.replace(f=(st.f.float() * (1 + 1e-3 * noise)).to(st.f.dtype))
    step = models.ferrofluid_step if build.startswith("rosensweig") else models.hcz_step
    return params, st, step


def mesh3d_fields(st) -> dict:
    """The fields of a meshed run's state that are hashed: those of
    :data:`MESH2D_FIELDS` and the premac's leaves."""
    return dict(_state_fields(st), **{f"premac.{i}": x for i, x in
                                      enumerate(getattr(st, "premac", None) or ())})


def mesh3d_primes(params, step, slabs) -> bool:
    """Whether a meshed run primes on the mesh: the ferrofluid step on the
    block route, and a padded layout on slabs too (to its 5-leaf premac);
    the other slab runs step as built (route U19)."""
    return step.__name__ == "ferrofluid_step" and (params.phys_extent is not None
                                                   or not slabs)


def mesh3d_expected(params, state, step, mesh) -> dict:
    """The kernels a step of the rank part ``state`` on ``mesh`` launches,
    and how often.  The block route: B4, B1's passes in each round and its
    H2 launch (or B11b's passes in each round and B10a on psi, one launch
    for the rank's elements), B2, B6 and B5; HCZ B8b, B8a, B2, B6 and B9;
    single phase B8a.  The z-slab route U19 (a never-primed state on z and
    batch axes, one element a rank): the slab forms of B4, B11b (a launch
    a round of ``step3d.channel_slab_plan``, the last emitting H2, or B10a
    on psi where its h2 plan refuses), B2, B10b, B6 and B5.  A padded
    layout: B1's psi passes in the rounds of the rank's blocks (z-only on
    slabs), and where the rank's block holds a box cell B1's H2 launch and
    B2 on its part of the box; then B5, after B4 on blocks, with
    ``emit_mac`` (2 launches) on slabs."""
    from lbm_ferrofluid_tpu_torch.models import ferrofluid_step, hcz_step
    from lbm_ferrofluid_tpu_torch.ops.kernels import poisson, scalar_poisson, stencil3d
    from lbm_ferrofluid_tpu_torch.parallel import step3d

    if step is hcz_step:
        return {k: 1 for k in ("B8b", "B8a", "B2", "B6", "B9")}
    if step is not ferrofluid_step:
        return {"B8a": 1}
    if params.phys_extent is not None:
        blk = step3d.blocks3d(mesh, state.f)
        box = all(c0 < p for (_, _, c0, _), p in zip(blk.axes.values(), params.phys_extent))
        passes = sum(len(scalar_poisson.passes(k)) for k in blk.rounds(params.poisson_iters))
        out = {"B1": passes + box, "B2": 1} if box else {"B1": passes}
        slabs = step3d.on_slabs(mesh, state.f.shape)
        return dict(out, **({"B5": 2} if slabs else {"B4": 1, "B5": 1}))
    if step3d.on_slabs(mesh, state.f.shape):
        shape = (1, 19, *step3d.global_shape(state.f.shape, mesh)[2:])
        n = params.poisson_iters
        plan = step3d.channel_slab_plan(mesh, shape, n, h2=True)
        k, _, r = plan or step3d.channel_slab_plan(mesh, shape, n)
        out = {k_: 1 for k_ in ("B4", "B2", "B10b", "B6", "B5")}
        out["B11b"] = n // k + (r > 0)
        if plan is None:
            out["B10a"] = stencil3d.launches_per_call(1)
        return out
    rounds = step3d.blocks3d(mesh, state.f).rounds(params.poisson_iters)
    out = {k: 1 for k in ("B4", "B2", "B6", "B5")}
    if state.h.shape[1] == 2:
        out["B1"] = sum(len(scalar_poisson.passes(k)) for k in rounds) + 1
    else:
        out["B11b"] = sum(len(poisson.passes(k)) for k in rounds)
        out["B10a"] = stencil3d.launches_per_call(state.f.shape[0])
    return out


def psi_band_expected(params, state, mesh) -> int:
    """Launches a step of ``lbm_psi_ghost_band`` on the rank part ``state``:
    two a band of the channel-form slab solve that is rebuilt from psi
    (the shell declared, ``poisson_psi_halo``, ``step3d.psi_refresh_ok``
    for its depth), none elsewhere."""
    from lbm_ferrofluid_tpu_torch.parallel import step3d

    h = getattr(state, "h", None)  # an HCZ state has none
    if not (h is not None and h.shape[1] == 19 and step3d.on_slabs(mesh, state.f.shape)
            and params.mag_flags_shell and params.poisson_psi_halo):
        return 0
    shape = (1, 19, *step3d.global_shape(state.f.shape, mesh)[2:])
    _, depth, _ = step3d.channel_slab_rounds(mesh, shape, params.poisson_iters, h2=True)
    Zl = state.f.shape[2]
    return 2 * sum(step3d.psi_refresh_ok(params.tau, g, Zl) for g in depth[1:])


def mesh3d_one_device(run, params, whole, step, dev, slabs=False):
    """One device's steps of the whole batch on the meshed route's route
    (the block route: priming only converts h, the un-carried step, the
    channel form's solve on the psi route; ``slabs``, route U19: never
    primed, the solve's H2 from B7's trailing stage; a padded layout on
    slabs: a one-rank ``slab=True`` mesh, primed on it): the state after
    the warm and timed steps, ms a timed step and launches a step."""
    from lbm_ferrofluid_tpu_torch.models import ferrofluid_step, prime_premac
    from lbm_ferrofluid_tpu_torch.ops import kernels as kernels_pkg
    from lbm_ferrofluid_tpu_torch.parallel import Mesh

    st = whole
    if slabs and params.phys_extent is not None:
        one = Mesh(("batch", "z"), (1, 1), 0, dev, None, slab=True)
        st = prime_premac(params, st, mesh=one)

        def step(params, state, device=None):
            return ferrofluid_step(params, state, mesh=one)
    elif step is ferrofluid_step and not slabs:
        primed = prime_premac(params, st, device=dev)
        st = st.replace(h=primed.h, cmask=primed.cmask)
    with contextlib.nullcontext() if slabs else psi_route():
        for _ in range(MESH3D_WARM):
            st = step(params, st, device=dev)
        kernels_pkg.reset_launch_counts()
        st, stats = timed_steps(params, st, step, dev, MESH3D_STEPS, warmup=0)
        launches = {k: n / MESH3D_STEPS for k, n in kernels_pkg.launch_counts().items() if n}
    return st, stats["seconds"] / MESH3D_STEPS * 1e3, launches


def mesh3d_rank(job_json) -> int:
    """A rank of phase ``mesh3d``: joins the group from torchrun's
    variables and, for each run, builds the scene on the card, cuts its
    block, primes it on the mesh (the ferrofluid scenes) and steps it
    through the model's entry point (warm steps, then the timed ones, each
    rank synchronising its device, then a barrier), with the launch
    counters zeroed just before the warm steps and read after the timed
    ones; hashes its block of each field.  Rank 0 then runs one device's
    steps of the whole batch alone and holds each rank's block of them to
    that rank's hashes.  A never-primed run on the slab route (U19) is not
    primed; a padded layout's slab run is, to a 5-leaf premac, whose leaves
    are hashed too.  At two or more elements a rank every launch takes the rank's
    batch (``launches_batch``).  Prints its rows and its launches over the
    runs, all and at B > 1."""
    import dataclasses

    import torch
    import torch.distributed as dist

    from lbm_ferrofluid_tpu_torch.models import prime_premac
    from lbm_ferrofluid_tpu_torch.ops import kernels as kernels_pkg
    from lbm_ferrofluid_tpu_torch.parallel import (
        blocks, initialize_distributed, make_mesh, ring_halo, shard_state, step3d,
    )

    in_exchanges = [0.0]

    def timed_halo(*args, **kw):
        t = time.perf_counter()
        try:
            return ring_halo(*args, **kw)
        finally:
            in_exchanges[0] += time.perf_counter() - t

    blocks.ring_halo = step3d.ring_halo = timed_halo
    psi_band = kernels_pkg.GLUE_KERNELS["psi_band"].wrapper
    runs = json.loads(job_json)
    world = initialize_distributed()
    rows, total, total_batch = [], {"psi_band": 0}, {}
    try:
        for run in runs:
            label, _, _, axes, shape, storage, change = run
            mesh = make_mesh(tuple(axes), tuple(shape))
            params, whole, step = mesh3d_scene(run, mesh.device)
            st = shard_state(whole, mesh)
            if mesh.rank != 0:
                del whole
            torch.cuda.empty_cache()
            kernels_pkg.reset_launch_counts()
            slabs = step3d.on_slabs(mesh, st.f.shape)
            route = "z-slabs" if slabs else "blocks"
            if mesh3d_primes(params, step, slabs):
                st = prime_premac(params, st, mesh=mesh)
            leaves = len(getattr(st, "premac", None) or ())
            want = 5 if slabs and params.phys_extent is not None else 0
            check(leaves == want, f"mesh3d {label}: priming on the {route} route left "
                                  f"{leaves} premac leaves, not {want}")
            for _ in range(MESH3D_WARM):
                st = step(params, st, mesh=mesh)
            n0, b0 = ring_halo.exchanges, ring_halo.sent_bytes
            before = kernels_pkg.launch_counts()
            before_batch = kernels_pkg.launch_counts(batch=True)
            psi0 = psi_band.launches
            torch.cuda.synchronize()
            dist.barrier()
            in_exchanges[0] = 0.0
            t0 = time.perf_counter()
            for _ in range(MESH3D_STEPS):
                st = step(params, st, mesh=mesh)
            torch.cuda.synchronize()
            dist.barrier()
            seconds = time.perf_counter() - t0
            counts = kernels_pkg.launch_counts()
            counts_batch = kernels_pkg.launch_counts(batch=True)
            psi_per_step = (psi_band.launches - psi0) / MESH3D_STEPS
            check(psi_per_step == psi_band_expected(params, st, mesh),
                  f"mesh3d {label}: lbm_psi_ghost_band launched {psi_per_step} times a step, "
                  f"not {psi_band_expected(params, st, mesh)}")
            total["psi_band"] += psi_band.launches
            for k, n in counts.items():
                total[k] = total.get(k, 0) + n
                total_batch[k] = total_batch.get(k, 0) + counts_batch[k]
            per_step = {k: (n - before[k]) / MESH3D_STEPS for k, n in counts.items()
                        if n - before[k]}
            per_step_batch = {k: (n - before_batch[k]) / MESH3D_STEPS
                              for k, n in counts_batch.items() if n - before_batch[k]}
            want = mesh3d_expected(params, st, step, mesh)
            check(per_step == want, f"mesh3d {label}: launches a step {per_step}, the {route} "
                                    f"route launches {want}")
            check(per_step_batch == (want if st.f.shape[0] > 1 else {}),
                  f"mesh3d {label}: batch launches a step {per_step_batch} at "
                  f"{st.f.shape[0]} elements a rank")
            row = {"run": label, "mesh": dict(zip(axes, shape)), "res": list(run[2]["res"]),
                   "route": route, "batch": run[2].get("batch", 1),
                   "batch_a_rank": st.f.shape[0],
                   "storage": storage, "change": change, "block": list(st.f.shape[2:]),
                   "h_channels": st.h.shape[1] if getattr(st, "h", None) is not None else None,
                   "steps": st.step, "ms_per_step": seconds / MESH3D_STEPS * 1e3,
                   "launches_per_step": per_step,
                   "psi_band_launches_per_step": psi_per_step,
                   "exchanges_per_step": (ring_halo.exchanges - n0) / MESH3D_STEPS,
                   "ms_in_exchanges_per_step": in_exchanges[0] / MESH3D_STEPS * 1e3,
                   "bytes_sent_per_step": (ring_halo.sent_bytes - b0) / MESH3D_STEPS}
            mine = {n: _bits_sha(x) for n, x in mesh3d_fields(st).items()}
            every = [None] * world
            dist.all_gather_object(every, mine)
            del st
            torch.cuda.empty_cache()
            if mesh.rank == 0:
                ref, ms1, launches1 = mesh3d_one_device(run, params, whole, step, mesh.device,
                                                        slabs)
                del whole
                differ = [(r, n) for r in range(world) for n, x in mesh3d_fields(
                    shard_state(ref, dataclasses.replace(mesh, rank=r))).items()
                          if every[r].get(n) != _bits_sha(x)]
                check(all(every[r] for r in range(world)), f"mesh3d {label}: no fields hashed")
                row.update(ms_per_step_one_device=ms1, launches_per_step_one_device=launches1,
                           bit_for_bit_to_one_device=not differ, differ=differ[:8])
                check(not differ, f"mesh3d {label}: blocks differ from one device: "
                                  f"{differ[:8]}")
                del ref
                torch.cuda.empty_cache()
            dist.barrier()
            rows.append(row)
    finally:
        dist.destroy_process_group()
    print("MESH3D_RANK " + json.dumps({"rank": int(os.environ["RANK"]), "rows": rows,
                                       "launches": total, "launches_batch": total_batch}),
          flush=True)
    return 0


def phase_mesh3d(dev, card, runs=MESH3D_RUNS):
    """3D states on the block route (phase ``mesh3d``, ROADMAP A12 slice
    4b): the runs of :data:`MESH3D_RUNS` as 4 gloo ranks sharing the one
    card (processes of ``chip_smoke.py --mesh3d-rank``, torchrun's
    variables set), each held bit for bit to one device's steps on the same
    route, its launches a step checked kernel by kernel, with ms a step
    beside one device's in the same call, exchanges and bytes a rank sends
    a step (rank 0's); the B = 2 Rosensweig state's block run (two elements
    a rank) beside its slab run (one element a rank).  Returns the launches
    of every rank's meshed steps by kernel id, all and at B > 1."""
    del dev
    t0 = time.perf_counter()
    world = math.prod(runs[0][4])
    check(all(math.prod(r[4]) == world for r in runs), "mesh3d: the runs' meshes differ")
    env = dict(os.environ, MASTER_ADDR="127.0.0.1", MASTER_PORT=str(_free_port()),
               WORLD_SIZE=str(world), LOCAL_WORLD_SIZE=str(world))
    outs = run_processes("mesh3d job",
                         [[str(ROOT / "chip_smoke.py"), "--mesh3d-rank",
                           json.dumps(runs)]] * world,
                         [dict(env, RANK=str(r), LOCAL_RANK=str(r)) for r in range(world)],
                         MESH3D_TIMEOUT, "MESH3D_RANK")
    reports = [o for out_ in outs for o in out_]
    first = [o for o in reports if o["rank"] == 0]
    check(len(first) == 1 and len(reports) == world, f"mesh3d: {len(reports)} rank reports")
    launches, launches_batch = {}, {}
    for o in reports:
        for k, n in o["launches"].items():
            launches[k] = launches.get(k, 0) + n
        for k, n in o["launches_batch"].items():
            launches_batch[k] = launches_batch.get(k, 0) + n
    rows = first[0]["rows"]
    by_label = {r["run"]: r for r in rows}
    block, slab = by_label.get("rosensweig B=2"), by_label.get("rosensweig B=2 slabs")
    pair = None if not (block and slab) else {
        "state": "rosensweig_3d 130x66x130 B=2, float32, un-carried, h in 19 channels",
        "blocks_2_a_rank_ms": block["ms_per_step"], "slabs_1_a_rank_ms": slab["ms_per_step"],
        "one_device_ms": [block["ms_per_step_one_device"], slab["ms_per_step_one_device"]],
        "blocks_over_slabs": block["ms_per_step"] / slab["ms_per_step"],
        "bytes_sent_per_step": [block["bytes_sent_per_step"], slab["bytes_sent_per_step"]],
        "exchanges_per_step": [block["exchanges_per_step"], slab["exchanges_per_step"]]}
    turns = [by_label.get(f"rosensweig B=2 slabs{tag}") for tag in ("", " full-h")]
    psi, full = turns
    psi_pair = None if not all(turns) else {
        "state": "rosensweig_3d 130x66x130 B=2 on (batch, z) = (2, 2), tau 1, the shell "
                 "declared, h in 19 channels: the psi-refreshed bands, then the full-h "
                 "ones, each bit for bit to one device by hashes",
        **{key: [r[key] for r in turns] for key in (
            "ms_per_step", "ms_in_exchanges_per_step", "bytes_sent_per_step",
            "exchanges_per_step", "psi_band_launches_per_step")},
        "bytes_ratio": psi["bytes_sent_per_step"] / full["bytes_sent_per_step"]}
    if psi_pair:
        check(psi["psi_band_launches_per_step"] > 0 and psi["exchanges_per_step"]
              == full["exchanges_per_step"], f"mesh3d psi pair: {psi_pair}")
    emit({"phase": "mesh3d", "runs": rows, "block_vs_slab_b2": pair, "psi_vs_full_b2": psi_pair,
          "launches": launches,
          "launches_batch": launches_batch, "seconds": time.perf_counter() - t0,
          "card": card, "ok": True})
    return launches, launches_batch


def run_phases(dev, kernels_pkg, smi, ptxas=None, started_2d=None) -> list:
    """Phases 3-8; returns one row per kernel for the ``kernels`` line, one
    per bfloat16 form, one for B11b's last pass with B7's trailing stage in
    float32 and in bfloat16 (its launches on the channel-form main paths),
    and one for each of B1's psi and B3's box forms, the slab forms' rows
    and the batch forms' (:func:`batch_rows`).
    ``launches`` sums the kernel's launches over the main paths of phases 5
    and 5c that run it (B2, B3 and B4 over both ferrofluid solves, the
    padded paths, the spike runs and the demo drivers), a bfloat16 form's
    its launches over phase 7's bfloat16 main paths, the padded turbo run
    and the turbo spike run, and a named form's its launches on the padded
    paths.  ``started_2d``: phase 5b's 2D processes, started before the
    build (:func:`start_2d_jobs`)."""
    K = kernels_pkg.KERNELS
    # while the 2D runs go, the phases whose times no kernel row or bound
    # reads: phase 7's first two parts, its long horizon, the spike golden,
    # the demo drivers, inverse design, the 2D goldens and the native
    # library (host work)
    runs, (worst16, launches16, _, (spikes, spikes16), demos, _, _, _) = phase_2d(
        dev, kernels_pkg, smi, started=started_2d, meanwhile=(
            lambda: phase_kernels_bf16(dev, K), lambda: phase_bf16_main(dev, kernels_pkg, smi),
            lambda: phase_long_horizon(dev, smi), lambda: phase_spikes(dev, kernels_pkg, smi),
            lambda: phase_demos(dev, kernels_pkg, smi),
            lambda: phase_inverse(dev, kernels_pkg, smi), lambda: phase_golden_2d(dev),
            lambda: phase_native(smi)))
    phase_rosensweig_2d_bf16(smi, runs)
    worst, b10a_batch = phase_kernels(dev, K)
    psi_band = psi_band_checks(dev, smi)
    phase_grad_guard(dev, kernels_pkg)
    phase_golden(dev)
    phase_small_grid(dev, kernels_pkg)
    per_path = [phase_main(dev, kernels_pkg, smi), phase_hcz_main(dev, kernels_pkg, smi),
                phase_two_droplets(dev, kernels_pkg, smi),
                phase_channel_main(dev, kernels_pkg, smi),
                phase_uncarried_main(dev, kernels_pkg, smi),
                phase_epilogue_main(dev, kernels_pkg, smi),
                phase_stencils_main(dev, kernels_pkg, smi),
                phase_compat(dev, kernels_pkg, smi)]
    padded = phase_padded(dev, kernels_pkg, smi)
    per_path.append(padded["launches"])
    sharded, psi_sharded = phase_sharded(dev, kernels_pkg, smi)
    per_path.append(phase_demo(dev, kernels_pkg, smi))
    phase_dibr(dev, smi, big=(64, 64, 64))
    sp_launches, sp_b8a = phase_singlephase_3d(dev, kernels_pkg, smi)
    per_path += [sp_launches, spikes, demos]
    launches16 = {kid: n + spikes16.get(kid, 0) + padded["launches16"].get(kid, 0)
                  for kid, n in launches16.items()}
    flag = phase_flagship(dev, K, smi)
    flag.update(phase_channel_flagship(dev, K, smi, ptxas))
    epi = phase_epilogue_flagship(dev, K, smi, ptxas)
    flag["B5"] = dict(epi["B5"], max_abs_err=max(v["max_abs_err"] for v in epi.values()))
    hcz_flag = phase_hcz_flagship(dev, K, smi, ptxas)
    flag["B2"]["max_abs_err"] = max(flag["B2"]["max_abs_err"], hcz_flag["B2"]["max_abs_err"])
    flag["B10a"]["max_abs_err"] = max(flag["B10a"]["max_abs_err"],
                                      *(hcz_flag[f"B10a N={n}"]["max_abs_err"] for n in (3, 4)))
    flag.update({kid: v for kid, v in hcz_flag.items() if kid in K and kid != "B2"})
    flag["B8a"]["max_abs_err"] = max(flag["B8a"]["max_abs_err"], sp_b8a["max_abs_err"])
    flag16 = phase_bf16_flagships(dev, K, smi, ptxas)
    flag16["B5"] = dict(flag16["B5"], max_abs_err=max(flag16["B5"]["max_abs_err"],
                                                       flag16["B5 emit_mac"]["max_abs_err"]))
    batch_total, batch_kernels = phase_batch(dev, kernels_pkg, smi)
    phase_mesh2d(dev, smi)
    mesh3d_launches, mesh3d_batch = phase_mesh3d(dev, smi)
    per_path.append(mesh3d_launches)
    launches = {kid: sum(p.get(kid, 0) for p in per_path) for kid in K}
    psi_band.update(launches=mesh3d_launches["psi_band"] + psi_sharded)
    check(psi_band["launches"] > 0, "lbm_psi_ghost_band: no launch on the main paths")
    return [{
        "name": f"{kid} {k.wrapper.__name__}", "route": "cuda",
        "source": k.module.CUDA_SOURCE, "replaces": k.tpu_kernel,
        "launches": launches[kid],
        "max_abs_err": max(worst[kid], flag[kid]["max_abs_err"]),
        "ms": flag[kid]["ms"], "plain_ms": flag[kid]["plain_ms"],
        "bound_ms": flag[kid]["bound_ms"], "bound_by": flag[kid]["bound_by"],
        "library_ms": None,
        **({"conv3d_pad_ms": flag[kid]["conv3d_pad"]["ms"]} if "conv3d_pad" in flag[kid] else {}),
    } for kid, k in K.items()] + [{
        "name": f"{kid} {K[kid].wrapper.__name__} bf16", "route": "cuda",
        "source": K[kid].module.CUDA_SOURCE, "replaces": K[kid].tpu_kernel,
        "launches": launches16[kid],
        "max_abs_err": max(worst16[kid], flag16[kid]["max_abs_err"]),
        "ms": flag16[kid]["ms"], "plain_ms": flag16[kid]["plain_ms"],
        "bound_ms": flag16[kid]["bound_ms"], "bound_by": flag16[kid]["bound_by"],
        "library_ms": None,
    } for kid in kernels_pkg.BF16_FORMS] + [{
        "name": f"B11b poisson_sweeps emit{tag}", "route": "cuda",
        "source": K["B11b"].module.CUDA_SOURCE_EMIT,
        "replaces": K["B11b"].module.TPU_KERNEL_EMIT,
        "launches": n, "max_abs_err": row["max_abs_err"],
        **{key: row[key] for key in ("ms", "plain_ms", "bound_ms", "bound_by")},
        "library_ms": None, "mode": "h2 (the main paths' mode; hint: the phase line)",
    } for tag, row, n in (
        ("", flag["B11b emit"], sum(p.get("B11b emit", 0) for p in per_path)),
        (" bf16", flag16["B11b emit"], launches16["B11b emit"]))] + [{
        "name": f"{kid} {K[kid].wrapper.__name__} {form}", "route": "cuda",
        "source": K[kid].module.CUDA_SOURCE, "replaces": K[kid].tpu_kernel,
        "launches": padded[launches_key][kid],
        **{key: padded["forms"][row][key] for key in ("max_abs_err", "ms", "plain_ms",
                                                       "bound_ms", "bound_by")},
        "library_ms": None,
    } for kid, form, row, launches_key in (
        ("B1", "psi form", "B1", "form_launches"), ("B3", "box form", "B3", "form_launches"),
        ("B3", "box form bf16", "B3 bf16", "form_launches16"))] + sharded + [psi_band] + (
            batch_rows(K, batch_total, batch_kernels, b10a_batch, mesh3d_batch))


def phase_step_time(dev, card, repeats=5):
    """ms a step of the native Rosensweig 130x66x130 (the capillogue steady
    state with the scalar carry, the main path): ``repeats`` timed runs of
    200 steps after priming and 20 warm steps, in the package that
    ``lbm_ferrofluid_tpu_torch`` imports from (``--step-time ROOT``: a
    checkout at ROOT, for an A/B of two trees in one call)."""
    import lbm_ferrofluid_tpu_torch
    from lbm_ferrofluid_tpu_torch.models import SimulationRunner, ferrofluid_step, rosensweig_3d

    params, s0 = rosensweig_3d(device=dev)
    _, stats = SimulationRunner(params, ferrofluid_step, device=dev).benchmark(
        s0, n_steps=200, warmup=20, repeats=repeats)
    emit({"phase": "step_time", "package": lbm_ferrofluid_tpu_torch.__file__,
          "res": list(stats["res"]), "ms_per_step": stats["seconds"] / 200 * 1e3,
          "ms_per_step_all": [t / 200 * 1e3 for t in stats["seconds_all"]],
          "mlups": stats["mlups"], "card": card, "ok": True})


def phase_route_time(dev, card, steps=20, repeats=3, res=(256, 256, 256)):
    """ms a step of the un-carried Rosensweig step (route U, channel-form h)
    and of the HCZ ``multiphase_3d`` step at ``res`` and B = 1: ``repeats``
    timed runs of ``steps`` steps after 5 warm steps, in the package that
    ``lbm_ferrofluid_tpu_torch`` imports from (``--route-time ROOT``: a
    checkout at ROOT, for an A/B of two trees in one call), and a hash of
    the final rho's bits (two trees with the same kernels at B = 1 give
    the same)."""
    import torch

    import lbm_ferrofluid_tpu_torch
    from lbm_ferrofluid_tpu_torch.models import (
        ferrofluid_step, hcz_step, multiphase_3d, rosensweig_3d,
    )

    out = {"phase": "route_time", "package": lbm_ferrofluid_tpu_torch.__file__,
           "res": list(res), "steps": steps}
    for route, build, step in (("U", rosensweig_3d, ferrofluid_step),
                               ("H", multiphase_3d, hcz_step)):
        params, st = build(res=res, device=dev)
        for _ in range(5):
            st = step(params, st, device=dev)
        runs = []
        for _ in range(repeats):
            st, stats = timed_steps(params, st, step, dev, steps, 0)
            runs.append(stats["seconds"] / steps * 1e3)
        check(bool(torch.isfinite(st.rho).all()), f"route time {route}: non-finite rho")
        # the final rho's bits, to hold two trees' steps to each other
        sha = hashlib.sha256(st.rho.cpu().numpy().tobytes()).hexdigest()[:16]
        out[route] = {"ms_per_step": float(np.median(runs)), "ms_per_step_all": runs,
                      "steps_done": st.step, "rho_sha256": sha}
        del st
        torch.cuda.empty_cache()
    emit(dict(out, card=card, ok=True))


def main() -> int:
    import torch

    if "--sharded-rank" in sys.argv[1:]:
        return sharded_rank(sys.argv[sys.argv.index("--sharded-rank") + 1])
    if "--2d-job" in sys.argv[1:]:
        return job_2d(sys.argv[sys.argv.index("--2d-job") + 1])
    if "--mesh2d-rank" in sys.argv[1:]:
        return mesh2d_rank(sys.argv[sys.argv.index("--mesh2d-rank") + 1])
    if "--mesh3d-rank" in sys.argv[1:]:
        return mesh3d_rank(sys.argv[sys.argv.index("--mesh3d-rank") + 1])
    for flag in ("--step-time", "--route-time", "--trail-time", "--slab-time"):
        if flag in sys.argv[1:]:
            at = sys.argv.index(flag) + 1
            if at < len(sys.argv) and not sys.argv[at].startswith("--"):
                sys.path.insert(0, str(pathlib.Path(sys.argv[at]).resolve()))
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; a CUDA card is required",
              file=sys.stderr)
        return 1
    from lbm_ferrofluid_tpu_torch.ops import kernels as kernels_pkg
    from lbm_ferrofluid_tpu_torch.ops.kernels import _lib

    dev = "cuda"
    smi = nvidia_smi_line()
    emit({"phase": "device", "name": torch.cuda.get_device_name(0),
          "count": torch.cuda.device_count(), "nvidia_smi": smi,
          "torch": torch.__version__, "cuda": torch.version.cuda, "ok": True})

    # the default run starts phase 5b's 2D processes first: their host-bound
    # steps launch none of the library's kernels and run while it builds
    started_2d = start_2d_jobs(jobs_2d()) if len(sys.argv) == 1 else None
    try:
        return run(dev, smi, kernels_pkg, _lib, started_2d)
    finally:
        if started_2d:
            stop_processes(started_2d[1])


def run(dev, smi, kernels_pkg, _lib, started_2d) -> int:
    """``main`` from the build on; ``started_2d``: the default run's 2D
    processes, started before it."""
    import torch

    t0 = time.perf_counter()
    path = _lib.build()
    build_s = time.perf_counter() - t0
    ptxas = ptxas_summary(path.with_suffix(".log").read_text())
    emit({"phase": "build", "seconds": build_s, "library": str(path),
          "ptxas": ptxas, "ok": True})

    if "--scalar-plans" in sys.argv[1:]:
        phase_scalar_plans(dev, smi)
        print(smi, flush=True)
    elif "--scalar-slab-plans" in sys.argv[1:]:
        phase_scalar_plans(dev, smi, slab_only=True)
        print(smi, flush=True)
    elif "--poisson-plans" in sys.argv[1:]:
        phase_poisson_plans(dev, smi)
        phase_channel_slab_plans(dev, smi)
        print(smi, flush=True)
    elif "--channel-slab-plans" in sys.argv[1:]:
        phase_channel_slab_plans(dev, smi)
        print(smi, flush=True)
    elif "--capillary-plans" in sys.argv[1:]:
        phase_capillary_plans(dev, smi, ptxas)
        print(smi, flush=True)
    elif "--stencil-plans" in sys.argv[1:]:
        phase_stencil_plans(dev, smi, ptxas)
        print(smi, flush=True)
    elif "--epilogue-plans" in sys.argv[1:]:
        phase_epilogue_plans(dev, smi, ptxas)
        print(smi, flush=True)
    elif "--spikes" in sys.argv[1:]:
        phase_spikes(dev, kernels_pkg, smi)
        print(smi, flush=True)
    elif "--demo" in sys.argv[1:]:
        phase_demo(dev, kernels_pkg, smi)
        phase_demos(dev, kernels_pkg, smi)
        print(smi, flush=True)
    elif "--step-time" in sys.argv[1:]:
        phase_step_time(dev, smi)
        print(smi, flush=True)
    elif "--2d" in sys.argv[1:]:
        phase_rosensweig_2d_bf16(smi, phase_2d(dev, kernels_pkg, smi)[0])
        print(smi, flush=True)
    elif "--padded" in sys.argv[1:]:
        phase_padded(dev, kernels_pkg, smi)
        print(smi, flush=True)
    elif "--sharded" in sys.argv[1:]:
        rows, _ = phase_sharded(dev, kernels_pkg, smi)
        print(smi, flush=True)
        emit({"kernels": rows})
    elif "--batch" in sys.argv[1:]:
        total, rows = phase_batch(dev, kernels_pkg, smi)
        print(smi, flush=True)
        emit({"kernels": batch_rows(kernels_pkg.KERNELS, total, rows)})
    elif "--route-time" in sys.argv[1:]:
        phase_route_time(dev, smi)
        print(smi, flush=True)
    elif "--trail-time" in sys.argv[1:]:
        phase_trail_time(dev, smi, ptxas)
        print(smi, flush=True)
    elif "--slab-time" in sys.argv[1:]:
        phase_slab_time(dev, smi, ptxas)
        print(smi, flush=True)
    elif "--mesh2d" in sys.argv[1:]:
        phase_mesh2d(dev, smi)
        print(smi, flush=True)
    elif "--psi-halo" in sys.argv[1:]:
        phase_psi_halo(dev, smi)
        print(smi, flush=True)
    elif "--mesh3d" in sys.argv[1:]:
        phase_mesh3d(dev, smi)
        print(smi, flush=True)
    elif {"--compat", "--dibr", "--native", "--inverse"} & set(sys.argv[1:]):
        if "--compat" in sys.argv[1:]:
            phase_grad_guard(dev, kernels_pkg)
            phase_compat(dev, kernels_pkg, smi)
        if "--dibr" in sys.argv[1:]:
            phase_dibr(dev, smi)
        if "--native" in sys.argv[1:]:
            phase_native(smi)
        if "--inverse" in sys.argv[1:]:
            phase_inverse(dev, kernels_pkg, smi)
        print(smi, flush=True)
    else:
        rows = run_phases(dev, kernels_pkg, smi, ptxas, started_2d)
        print(smi, flush=True)
        emit({"kernels": rows})
    emit({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    try:
        sys.exit(main())
    except CheckFailed as e:
        print(f"chip_smoke: FAILED: {e}", file=sys.stderr)
        sys.exit(1)
