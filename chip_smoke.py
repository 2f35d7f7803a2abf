#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's main paths on one GPU and check every kernel.

Run from the repository root with one CUDA card and the CUDA toolkit::

    python3 chip_smoke.py
    python3 chip_smoke.py --scalar-plans   # only B1's plan sweep (256^3, 130x66x130)
    python3 chip_smoke.py --poisson-plans  # only B11b's plan sweep (256^3, 130x66x130; f32, bf16)
    python3 chip_smoke.py --capillary-plans  # only B6's plan sweep (256^3, 130^3)
    python3 chip_smoke.py --stencil-plans  # only B10a's and B10b's (256^3, 130x66x130)
    python3 chip_smoke.py --epilogue-plans  # only B5's (256^3, 130x66x130; f32, bf16)

Phases, each printing one JSON line; any failed check exits non-zero:

1. device: the card's name, count and power limit (``nvidia-smi``);
2. build: one nvcc process per CUDA source, all started together, link the
   kernel library from ``csrc/``;
3. kernels: each kernel against its plain PyTorch version on seeded inputs
   with an interior obstacle block.  Ferrofluid kernels (B1 scalar Poisson
   sweeps + H2 at 30 sweeps and at 7, which its pass depth does not divide,
   B2 contact angle, B3 capillogue chain at the magnetic tau 1
   and 0.8, B4 prologue, B11b channel-form Poisson sweeps at tau 1 and 0.8
   and at 30 and 7 sweeps, with an interior magnetic obstacle block and one
   across a tile edge and a z seam of its plan, its chosen plan also held
   bit for bit to the one-sweep plan, B10a gradients of 1, 3, 4 and 5
   fields with the launches ``launches_per_call`` states, B5 epilogue
   with and without ``emit_mac`` on B6's outputs, B10b Laplacian) at
   34x66x130 and 130x66x130, B11b, B10a and B10b as above at 50x50x193,
   which no tile divides, and B10a and B10b at 4x66x130 (the z clamp at
   both ends of every strip); HCZ kernels (B8b/B8a
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
     ``launches_per_call`` times (one a pass of its plan) and B10a once a
     step;
   - the un-carried step (Rosensweig 130x66x130 never primed: B4, B11b,
     B10a, B2, B6, B5) and the epilogue steady state (5-leaf premac with
     the scalar carry: B1, B2, B6, B5 with ``emit_mac``), each 30 kernel
     against 30 plain steps with exact launch counts, the latter also
     against 30 capillogue steady-state steps;
   - the stencil route in the HCZ step (``multiphase_3d`` 130^3: B8b, B8a,
     B2, B10b, B10a, B9), 30 against 30 plain HCZ steps;
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
   interior then ``F.pad``, 2 calls, in full float32 (``conv3d_pad``);
5b. the 2D and single-phase models (after phase 5): the six 2D and
   single-phase goldens of tests/test_parity.py (``singlephase_bgk``,
   ``singlephase_kbc_a``, ``sc``, ``hcz``, ``hcz_kbc_wetting``, ``ferro2d``
   in channel form and in the scalar carry) at that file's bars; 3D
   single-phase BGK at 256^3 on a seeded Taylor-Green-like field (tau 0.8),
   30 steps through B8a against 30 ``plain=True`` steps at phase 3's bars,
   50 timed steps, B8a once a step, B8a timed beside its bound; each 2D
   scene at its demo's default resolution (130x130, ``two_droplets_2d``
   98x384) for 1000 steps through the runner, finite, summed rho within
   ``SCENE_DRIFT``, no kernel launched; the single-phase BGK and KBC, HCZ
   and ferrofluid (scalar carry, channel form) 2D steps timed at native
   size and at 2048^2 with their CUDA kernel launches a step from
   ``torch.profiler``; and 2000 steps of ``rosensweig_2d`` at 64x64 in
   bfloat16 against float32 with tests/test_bf16_physics.py's assertions;
7. bfloat16 storage of f, g and h (the JAX package's turbo mode; run
   between phases 5b and 6): each bfloat16 form (B3 at the magnetic tau 1
   and 0.8, B4, B5 with and without ``emit_mac``, B11b at tau 1 and 0.8
   and 30 and 7 sweeps at 34x66x130 and 130x66x130; B8b, B8a, B9 in the
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
   B5 with its plans as in phase 6.

The build phase reports each kernel's registers, static shared memory and
spills as ptxas gives them.

Then it prints the ``nvidia-smi`` line, one ``{"kernels": [...]}`` line (a
row for every kernel, and one for each bfloat16 form with its launches on
phase 7's paths) and, last, ``{"ok": true, "device": {...}}``.  Bounds use the H100 SXM peaks of
NVIDIA's data sheet: 3.35 TB/s and 67 TFLOP/s float32 (non-tensor), and
each kernel's ``cost``: the bytes and flops that the call's own inputs need
(an input read only at some cells counts only there).
"""

from __future__ import annotations

import json
import math
import pathlib
import re
import subprocess
import sys
import time

import numpy as np

HBM_BYTES_PER_S = 3.35e12
F32_FLOPS_PER_S = 67e12
BAR_REL, BAR_VEL_ABS = 5e-5, 5e-6
ROOT = pathlib.Path(__file__).resolve().parent


class CheckFailed(Exception):
    pass


def emit(obj) -> None:
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
        psi = b11b_checks(params, d, res)
        stencil_checks(substitute_obstacles(psi, d["mflags_block"]), d["fields4"], res)
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
    return worst


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
        check_launches(f"channel {label}", launches, {
            "B11b": K["B11b"].module.launches_per_call(p.poisson_iters, sk.h.shape),
            "B10a": 1, "B2": K["B2"].module.N_LAUNCHES, "B3": K["B3"].module.N_LAUNCHES},
            steps, extra={"B4": 1})
        for kid in ids:
            total[kid] += launches[kid]
        out[label] = dict(row, steps=steps, launches={kid: launches[kid] for kid in ids})
    emit(dict(out, finite=True, ok=True))
    return total


def check_launches(label, launches, per_step, steps, extra=None):
    """Exact launch counts of a path: ``per_step`` launches a step of each
    kernel it names (plus ``extra``), none of any other kernel."""
    want = {kid: per_step.get(kid, 0) * steps + (extra or {}).get(kid, 0) for kid in launches}
    check(launches == want, f"{label}: launches {launches}, expected {want}")


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
    check_launches("un-carried", launches, {
        "B4": 1, "B11b": K["B11b"].module.launches_per_call(params.poisson_iters, sk.h.shape),
        "B10a": 1, "B2": K["B2"].module.N_LAUNCHES,
        "B6": K["B6"].module.N_LAUNCHES, "B5": 1}, sk.step)
    ids = kernels_pkg.PATHS["ferrofluid_uncarried"]
    emit({"phase": "uncarried_main_path", "scene": "rosensweig_3d",
          "res": list(sk.rho.shape[2:]), "steps": sk.step,
          "kernel_vs_plain_after_30_steps": rows, "finite": True, "card": card,
          "launches": {kid: launches[kid] for kid in ids}, "ok": True})
    return launches


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
    emit({"phase": "flagship", "scene": "rosensweig_3d", "res": [256, 256, 256],
          "mlups": stats["mlups"], "seconds_30_steps": stats["seconds"],
          "peak_mem_gb": peak / 1e9, "card": card, "per_kernel": out, "ok": True})
    return out


def b11b_plan_report(pl, tau, ptxas=None, bf16=False):
    """B11b's plan with its shared memory, resident blocks an SM and the
    pass kernel's ptxas line (its bfloat16 instance with ``bf16``)."""
    from lbm_ferrofluid_tpu_torch.ops.kernels import poisson as pp

    tau1 = int(1.0 / tau == 1.0)
    name = f"lbm_poisson_pass_kernel<{'bf16,' if bf16 else ''}{tau1},{pl.ty + 2 * pl.k - 2}>"
    return dict(k=pl.k, tile=[pp.tile_width(pl.k), pl.ty], lz=pl.lz, passes=list(pl.passes),
                threads=pp.threads(pl.k, pl.ty),
                smem_bytes=pp.smem_bytes(pl.k, pl.ty, 2 if bf16 else 4),
                blocks_per_sm=blocks_per_sm("lbm_poisson_pass_occupancy", pl.k, pl.ty, tau1,
                                            int(bf16)),
                ptxas={name: (ptxas or {}).get(name)})


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
    emit({"phase": "channel_flagship", "scene": "rosensweig_3d", "res": [256, 256, 256],
          "solve": "channel form (scalar_carry=False)", "mlups": stats["mlups"],
          "ms_per_step": stats["seconds"] / stats["steps"] * 1e3,
          "seconds_20_steps": stats["seconds"], "peak_mem_gb": peak / 1e9, "card": card,
          "per_kernel": out, "ok": True})
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


def phase_scalar_plans(dev, card):
    """B1 on the primed Rosensweig scene at 256^3 and 130x66x130 under the
    plans its pass kernel takes (k = 1..6, tile heights in steps of 4, z
    chunk counts from 1 to 32 and the count that fills the card once), each
    held bit for bit to the plan ``plan`` chooses (the per-cell arithmetic
    is the same) and timed with CUDA events: the data ``K`` and ``TY`` of
    ``ops/kernels/scalar_poisson.py`` were chosen from."""
    import torch

    from lbm_ferrofluid_tpu_torch.models import prime_premac, rosensweig_3d
    from lbm_ferrofluid_tpu_torch.ops.kernels import scalar_poisson as sp

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
            for k in range(1, sp.MAX_K + 1):
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
        emit({"phase": "scalar_plans", "res": list(res), "n_iters": n, "card": card,
              "chosen": dict(k=chosen.k, ty=chosen.ty, lz=chosen.lz,
                             ms=time_cuda(lambda: sp.scalar_wavefront(*args, **kw), 5)),
              "best": min(rows, key=lambda r: r["ms"]), "plans": rows, "ok": True})
        del st, args, want
        torch.cuda.empty_cache()


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
                                                            1, int(bf16)),
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
    params, s0 = rosensweig_3d(device=dev)
    n = params.poisson_iters
    b1 = K["B1"].module.launches_per_call(n, s0.rho.shape)
    b11b = K["B11b"].module.launches_per_call(n, s0.rho.shape)
    hp, hs0 = multiphase_3d(device=dev)
    routes = (
        ("capillogue steady state", params, s0, primed, {"B1": b1, "B2": 1, "B3": 4},
         {"B4": 1}),
        ("channel form", params.replace(scalar_carry=False), s0, primed,
         {"B11b": b11b, "B10a": 1, "B2": 1, "B3": 4}, {"B4": 1}),
        ("un-carried", params, s0, None,
         {"B4": 1, "B11b": b11b, "B10a": 1, "B2": 1, "B6": 1, "B5": 1}, {}),
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
        for kid in total:
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


def phase_long_horizon(dev, card, steps=2000):
    """``steps`` (2000) kernel steps of Rosensweig 130x66x130 (the
    capillogue steady state) in float32 and in bfloat16 storage from the
    same scene, and ``steps // 2`` bfloat16 steps on the plain path:
    bfloat16 kernels against plain at ``LONG_MASS_PLAIN`` (fluid mass) and
    the dense phase's mean level within ``LONG_LEVEL`` cells; bfloat16
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
                                  ("bfloat16 plain", p16, s16, steps // 2, True)):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        st = prime_premac(p, s, device=dev, plain=plain)
        marks = {}
        for i in range(1, n + 1):
            st = ferrofluid_step(p, st, device=dev, plain=plain)
            if i == steps // 2:
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
    plain_mass = abs(b["half"]["mass"] / c["half"]["mass"] - 1.0)
    plain_level = b["half"]["level"] - c["half"]["level"]
    row = {"phase": "long_horizon", "scene": "rosensweig_3d", "res": list(s0.rho.shape[2:]),
           "steps": steps, "card": card,
           "fluid_mass": {"float32": m32, "bfloat16": m16, "rel": abs(m16 / m32 - 1.0)},
           "at_half": dict(half, bf16_kernels_vs_plain_mass_rel=plain_mass,
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
    del st, args

    _, s16 = turbo(params, rosensweig_3d(res=res, mag_strength=85.0, device=dev)[1], dev)
    su = steps("uncarried", p16, s16, lambda p, s: timed_steps(p, s, ferrofluid_step, dev,
                                                               n_steps=20, warmup=10))
    check(su.premac is None and su.h.dtype == torch.bfloat16, "256^3 bf16 un-carried")
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


def taylor_green_3d(res, dev, *, tau=0.8, u0=0.05, seed=0):
    """Single-phase D3Q19 BGK on a seeded Taylor-Green-like field: rho 1,
    |u| <= ``u0`` (the vortex's phase per axis from ``seed``), FLUID inside
    an obstacle frame, tau 0.8.  The JAX package has no 3D single-phase
    scene; this one is built from numpy on the host."""
    from lbm_ferrofluid_tpu_torch.models import SimulationParams, init_singlephase_state

    rng = np.random.default_rng(seed)
    z, y, x = np.meshgrid(*(2 * np.pi * (np.arange(n, dtype=np.float32) + 0.5) / n
                            for n in res), indexing="ij", sparse=True)
    a, b, c = (np.float32(v) for v in rng.uniform(0.0, 2 * np.pi, 3))
    vel = np.zeros((1, 3, *res), np.float32)
    amp = np.float32(u0 / math.sqrt(2.0))
    vel[0, 0] = amp * np.sin(x + a) * np.cos(y + b) * np.cos(z + c)
    vel[0, 1] = -amp * np.cos(x + a) * np.sin(y + b) * np.cos(z + c)
    flags = np.full((1, 1, *res), 2, np.uint8)
    flags[..., 1:-1, 1:-1, 1:-1] = 1
    vel *= flags == 1
    params = SimulationParams(dim=3, tau=tau)
    return params, init_singlephase_state(params, np.ones((1, 1, *res), np.float32), vel,
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


def phase_2d(dev, kernels_pkg, card, steps=1000, big=(2048, 2048)):
    """Each 2D scene at its demo's default resolution through the runner
    (which primes the ferrofluid scenes into the scalar carry): ``steps``
    (1000), fields finite, the summed rho within ``SCENE_DRIFT``; no kernel
    launches (counters zeroed just before, read just after).  Then the
    single-phase BGK and KBC, HCZ and ferrofluid (scalar carry and channel
    form) steps timed at native size and at ``big`` (2048^2, 4.2 M cells): ms a step
    over warm steps ending in ``torch.cuda.synchronize()``, and CUDA kernel
    launches a step from ``torch.profiler``."""
    import torch

    from lbm_ferrofluid_tpu_torch import models
    from lbm_ferrofluid_tpu_torch.models import SimulationRunner
    from lbm_ferrofluid_tpu_torch.models.runner import assert_finite

    out = {"phase": "scenes_2d", "card": card, "scenes": {}, "timed": {}}
    kernels_pkg.reset_launch_counts()
    for name, (build, step, res, kw) in SCENES_2D.items():
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
        out["scenes"][name] = {"res": list(res), "steps": st.step, "finite": True,
                               "rho_drift": drift, "drift_bar": bar,
                               "ms_per_step": seconds / steps * 1e3,
                               "h_channels": st.h.shape[1] if hasattr(st, "h") else None}
    launches = kernels_pkg.launch_counts()
    check(not any(launches.values()), f"2D scenes launched kernels: {launches}")
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


def phase_rosensweig_2d_bf16(dev, card, steps=(1000, 2000)):
    """tests/test_bf16_physics.py on the card: ``rosensweig_2d`` at 64x64
    for 2000 steps with f, g and h in bfloat16 and in float32 (the runner
    primes both into the float32 scalar carry), with that test's
    assertions (:61-88): finite, fluid mass at rtol 5e-3 at 1000 and 2000
    steps, the fill height per column within 2 cells pointwise at 1000, the
    float32 pool corrugated by 2 cells or more at 2000, the mean level
    within 1 cell, the bfloat16 corrugation in [0.3, 3] times float32's and
    the mean pointwise height difference within 3 cells."""
    import torch

    from lbm_ferrofluid_tpu_torch.models import (
        SimulationRunner, ferrofluid_step, init_ferrofluid_state, rosensweig_2d,
    )

    runs = {}
    for dtype in ("float32", "bfloat16"):
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
                        "heights": (st.density[0, 0] > mid).sum(dim=0).double().cpu().numpy(),
                        "mass": float(st.rho.double()[st.flags == 1].sum())}
        torch.cuda.synchronize()
        runs[dtype] = dict(marks=marks, seconds=time.perf_counter() - t0,
                           storage=str(st.f.dtype), h=list(st.h.shape))
    a, b = runs["float32"]["marks"], runs["bfloat16"]["marks"]
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
           "storage": {k: v["storage"] for k, v in runs.items()}}
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


def run_phases(dev, kernels_pkg, smi, ptxas=None) -> list:
    """Phases 3-8; returns one row per kernel for the ``kernels`` line, and
    one per bfloat16 form.  ``launches`` sums the kernel's launches over
    the main paths of phase 5 that run it (B2, B3 and B4 over both
    ferrofluid solves), and a bfloat16 form's its launches over phase 7's
    bfloat16 main paths."""
    K = kernels_pkg.KERNELS
    worst = phase_kernels(dev, K)
    phase_golden(dev)
    phase_small_grid(dev, kernels_pkg)
    per_path = [phase_main(dev, kernels_pkg, smi), phase_hcz_main(dev, kernels_pkg, smi),
                phase_two_droplets(dev, kernels_pkg, smi),
                phase_channel_main(dev, kernels_pkg, smi),
                phase_uncarried_main(dev, kernels_pkg, smi),
                phase_epilogue_main(dev, kernels_pkg, smi),
                phase_stencils_main(dev, kernels_pkg, smi)]
    phase_golden_2d(dev)
    sp_launches, sp_b8a = phase_singlephase_3d(dev, kernels_pkg, smi)
    per_path.append(sp_launches)
    phase_2d(dev, kernels_pkg, smi)
    phase_rosensweig_2d_bf16(dev, smi)
    launches = {kid: sum(p.get(kid, 0) for p in per_path) for kid in K}
    worst16 = phase_kernels_bf16(dev, K)
    launches16 = phase_bf16_main(dev, kernels_pkg, smi)
    phase_long_horizon(dev, smi)
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
    } for kid in kernels_pkg.BF16_FORMS]


def main() -> int:
    import torch

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

    t0 = time.perf_counter()
    path = _lib.build()
    build_s = time.perf_counter() - t0
    ptxas = ptxas_summary(path.with_suffix(".log").read_text())
    emit({"phase": "build", "seconds": build_s, "library": str(path),
          "ptxas": ptxas, "ok": True})

    if "--scalar-plans" in sys.argv[1:]:
        phase_scalar_plans(dev, smi)
        print(smi, flush=True)
    elif "--poisson-plans" in sys.argv[1:]:
        phase_poisson_plans(dev, smi)
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
    else:
        rows = run_phases(dev, kernels_pkg, smi, ptxas)
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
