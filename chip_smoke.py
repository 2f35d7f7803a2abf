#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's main paths on one GPU and check every kernel.

Run from the repository root with one CUDA card and the CUDA toolkit::

    python3 chip_smoke.py
    python3 chip_smoke.py --scalar-plans   # only B1's plan sweep (256^3, 130x66x130)
    python3 chip_smoke.py --poisson-plans  # only B11b's plan sweep (256^3, 130x66x130)
    python3 chip_smoke.py --capillary-plans  # only B6's plan sweep (256^3, 130^3)
    python3 chip_smoke.py --stencil-plans  # only B10a's and B10b's (256^3, 130x66x130)

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
   z strip seam, at 34x66x130, 130^3 and 50x50x193.  Bar rel <= 5e-5 per field
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
   with B6's seam block.  B10a is timed on one field (the channel form's
   psi) and on the stencil route's stacks of 3 and 4 fields, B10b on
   density(rho_ca), each with its plan, resident blocks and ptxas line,
   and beside a yardstick that is on no path: cuDNN's ``conv3d`` of the
   interior then ``F.pad``, 2 calls, in full float32 (``conv3d_pad``).

The build phase reports each kernel's registers, static shared memory and
spills as ptxas gives them.

Then it prints the ``nvidia-smi`` line, one ``{"kernels": [...]}`` line and,
last, ``{"ok": true, "device": {...}}``.  Bounds use the H100 SXM peaks of
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
            targs = re.match(r"I((?:L[a-z]+\d+E)+)E", mangled[start + n:])
            if targs:  # a template's instance: <1,13> for <true, 13>
                cur += "<" + ",".join(re.findall(r"L[a-z]+(\d+)E", targs.group(1))) + ">"
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

    real = pp.plan
    chosen = real(*args[0].shape[2:], kw["n_iters"], sms)
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
    assert_finite(sk)
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
    assert_finite(sk)
    mass230 = fluid_mass(sk)
    res, steps = list(sk.rho.shape[2:]), sk.step
    del sk, s0
    params2, s2 = droplet_spread_3d(device=dev)
    sk2, rows2 = kernel_vs_plain(params2, s2, hcz_step, dev, 30, "droplet spread",
                                 HCZ_FIELDS)
    assert_finite(sk2)
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
    assert_finite(sk)
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
        assert_finite(sk)
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
    assert_finite(sk)
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
    assert_finite(sk)
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
    assert_finite(sk)
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


def measure(K, kid, args, kw, per_call, per_step, what):
    """Kernel-vs-plain errors, times (kernel, plain) and bound of one call."""
    import torch

    k = K[kid]
    r = run_and_compare(K, kid, args, kw, what)[1]
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


def phase_flagship(dev, K, card):
    import torch

    from lbm_ferrofluid_tpu_torch.models import SimulationRunner, ferrofluid_step, rosensweig_3d

    # bench.py's workload: the Rosensweig geometry at 256^3, mag_strength 85
    params, st = rosensweig_3d(res=(256, 256, 256), mag_strength=85.0, device=dev)
    runner = SimulationRunner(params, ferrofluid_step, device=dev)
    torch.cuda.reset_peak_memory_stats()
    st, stats = runner.benchmark(st, n_steps=30, warmup=20)
    peak = torch.cuda.max_memory_allocated()
    # each kernel's inputs exactly as the next step (and priming) give them
    pm = st.premac
    d = dict(s2=st.h, cmask=st.cmask, rhs=pm[5], rho_pre=pm[0], flags=st.flags,
             f=st.f, g=st.g, den_pre=pm[2], pres=st.pressure, gsum=pm[3], gmom=pm[4],
             vel_pre=pm[1], mflags=st.magnetic_flags, rho_old=st.rho, vel_old=st.vel,
             H2=None, rho_ca=None)
    calls = kernel_calls(params, d)
    d["H2"] = K["B1"].wrapper(*calls["B1"][0], **calls["B1"][1])[1]
    d["rho_ca"] = K["B2"].wrapper(*calls["B2"][0], **calls["B2"][1])
    calls = kernel_calls(params, d)
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
    out["B3"]["collide_blocks_per_sm"] = blocks_per_sm("lbm_cap_collide_occupancy")
    emit({"phase": "flagship", "scene": "rosensweig_3d", "res": [256, 256, 256],
          "mlups": stats["mlups"], "seconds_30_steps": stats["seconds"],
          "peak_mem_gb": peak / 1e9, "card": card, "per_kernel": out, "ok": True})
    return out


def b11b_plan_report(pl, tau, ptxas=None):
    """B11b's plan with its shared memory, resident blocks an SM and the
    pass kernel's ptxas line."""
    from lbm_ferrofluid_tpu_torch.ops.kernels import poisson as pp

    tau1 = int(1.0 / tau == 1.0)
    name = f"lbm_poisson_pass_kernel<{tau1},{pl.ty + 2 * pl.k - 2}>"
    return dict(k=pl.k, tile=[pp.tile_width(pl.k), pl.ty], lz=pl.lz, passes=list(pl.passes),
                threads=pp.threads(pl.k, pl.ty), smem_bytes=pp.smem_bytes(pl.k, pl.ty),
                blocks_per_sm=blocks_per_sm("lbm_poisson_pass_occupancy", pl.k, pl.ty, tau1),
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


def phase_epilogue_flagship(dev, K, card):
    """bench.py's Rosensweig scene at 256^3 on the two routes of B5: the
    un-carried step (channel-form h) and the epilogue steady state (scalar
    carry), MLUPS, ms a step and peak memory over warm steps; then B5 in
    both modes, and B10b, at the inputs the epilogue steady state's next
    step gives them."""
    import torch

    from lbm_ferrofluid_tpu_torch.models import SimulationRunner, ferrofluid_step, rosensweig_3d
    from lbm_ferrofluid_tpu_torch.ops.magnetic import poisson_rhs_scaled
    from lbm_ferrofluid_tpu_torch.ops.moments import phi_from_density

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
    # the next step's inputs: its macros, H2 from B1, rho_ca from B2
    rho_pre, vel_pre, den_pre, gsum, gmom = s5.premac
    h_ext = tuple(params.mag_strength if a == params.h_ext_axis else 0.0 for a in range(3))
    rhs = poisson_rhs_scaled(phi_from_density(den_pre, params.density_gas, params.density_fluid),
                             s5.magnetic_flags, h_ext, tau=params.tau, dx=params.dx,
                             dt=params.dt)
    d = dict(f=s5.f, g=s5.g, flags=s5.flags, rho_pre=rho_pre, vel_pre=vel_pre, den_pre=den_pre,
             gsum=gsum, gmom=gmom, pres=s5.pressure,
             H2=K["B1"].wrapper(s5.h, s5.cmask, rhs, n_iters=params.poisson_iters, dx=params.dx,
                                h_ext=h_ext)[1],
             rho_ca=K["B2"].wrapper(rho_pre, s5.flags, params.contact_angle))
    per_kernel = {}
    for emit_mac, label in ((False, "B5"), (True, "B5 emit_mac")):
        args, kw = epilogue_call(K, params, d, emit_mac)
        n = 2 if emit_mac else 1
        per_kernel[label] = measure(K, "B5", args, kw, n, n, f"{label} at 256^3")
    out["per_kernel"] = per_kernel
    emit(dict(out, ok=True))
    return per_kernel


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
        assert_finite(nxt)
        out[name] = {"kernel_route": refused, "plain_step_finite": True}
    check(not any(kernels_pkg.launch_counts().values()),
          f"small grid: kernels launched {kernels_pkg.launch_counts()}")
    emit(dict(out, ok=True))


def phase_poisson_plans(dev, card):
    """B11b on the channel-form Rosensweig scene at 256^3 and 130x66x130
    (three warm steps from the scene, so h is no longer zero) under the
    plans its pass kernel is built for (k = 1..4, tile heights up to the
    shared memory limit, z chunk counts from 1 to 32 and the count that fills the
    card once), each held bit for bit to the plan ``plan`` chooses (the
    per-cell arithmetic is the same) and timed with CUDA events: the data
    ``K`` and ``TY`` of ``ops/kernels/poisson.py`` were chosen from.  The
    chosen plan is also held to the plain version at the phase 3 bars."""
    import torch

    from lbm_ferrofluid_tpu_torch.models import ferrofluid_step, prime_premac, rosensweig_3d
    from lbm_ferrofluid_tpu_torch.ops import kernels as kernels_pkg
    from lbm_ferrofluid_tpu_torch.ops.kernels import poisson as pp

    heights = {1: (8, 12), 2: (8, 12, 16), 3: (5, 7, 9, 11), 4: (3, 5)}
    for res in ((256, 256, 256), (130, 66, 130)):
        Z, Y, X = res
        params, st = rosensweig_3d(res=res, mag_strength=85.0, device=dev)
        params = params.replace(scalar_carry=False)
        st = prime_premac(params, st, device=dev)
        for _ in range(3):
            st = ferrofluid_step(params, st, device=dev)
        n = params.poisson_iters
        args, kw = (st.h, st.magnetic_flags, st.premac[5]), dict(tau=params.tau, n_iters=n)
        sms = torch.cuda.get_device_properties(0).multi_processor_count
        chosen = pp.plan(*res, n, sms)
        want = pp.poisson_sweeps(*args, **kw)
        against_plain = run_and_compare(kernels_pkg.KERNELS, "B11b", args, kw,
                                        f"B11b chosen plan at {res}")[1]
        rows, real = [], pp.plan
        try:
            for k, tys in heights.items():
                for ty in tys:
                    if pp.smem_bytes(k, ty) > pp.SMEM_BLOCK_MAX:
                        continue
                    tiles = -(-X // pp.tile_width(k)) * -(-Y // ty)
                    fill = max(1, sms // tiles)
                    for chunks in sorted({1, 2, 4, 8, 12, 16, 24, 32, fill} & set(range(1, Z + 1))):
                        pl = pp.PoissonPlan(k, ty, -(-Z // chunks), pp.passes(n, k))
                        pp.plan = lambda *a, pl=pl, **_: pl
                        got = pp.poisson_sweeps(*args, **kw)
                        check(all(torch.equal(a, b) for a, b in zip(got, want)),
                              f"B11b under plan {pl} differs from the chosen plan {chosen}")
                        rows.append(dict(k=k, ty=ty, lz=pl.lz, smem_bytes=pp.smem_bytes(k, ty),
                                         blocks_per_sm=blocks_per_sm(
                                             "lbm_poisson_pass_occupancy", k, ty, 1),
                                         ms=time_cuda(lambda: pp.poisson_sweeps(*args, **kw), 5)))
        finally:
            pp.plan = real
        emit({"phase": "poisson_plans", "res": list(res), "n_iters": n, "card": card,
              "chosen": dict(k=chosen.k, ty=chosen.ty, lz=chosen.lz,
                             ms=time_cuda(lambda: pp.poisson_sweeps(*args, **kw), 5)),
              "chosen_against_plain": against_plain,
              "best": min(rows, key=lambda r: r["ms"]), "plans": rows, "ok": True})
        del st, args, want
        torch.cuda.empty_cache()


def run_phases(dev, kernels_pkg, smi, ptxas=None) -> list:
    """Phases 3-6; returns one row per kernel for the ``kernels`` line.
    ``launches`` sums the kernel's launches over the main paths of phase 5
    that run it (B2, B3 and B4 over both ferrofluid solves)."""
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
    launches = {kid: sum(p.get(kid, 0) for p in per_path) for kid in K}
    flag = phase_flagship(dev, K, smi)
    flag.update(phase_channel_flagship(dev, K, smi, ptxas))
    epi = phase_epilogue_flagship(dev, K, smi)
    flag["B5"] = dict(epi["B5"], max_abs_err=max(v["max_abs_err"] for v in epi.values()))
    hcz_flag = phase_hcz_flagship(dev, K, smi, ptxas)
    flag["B2"]["max_abs_err"] = max(flag["B2"]["max_abs_err"], hcz_flag["B2"]["max_abs_err"])
    flag["B10a"]["max_abs_err"] = max(flag["B10a"]["max_abs_err"],
                                      *(hcz_flag[f"B10a N={n}"]["max_abs_err"] for n in (3, 4)))
    flag.update({kid: v for kid, v in hcz_flag.items() if kid in K and kid != "B2"})
    return [{
        "name": f"{kid} {k.wrapper.__name__}", "route": "cuda",
        "source": k.module.CUDA_SOURCE, "replaces": k.tpu_kernel,
        "launches": launches[kid],
        "max_abs_err": max(worst[kid], flag[kid]["max_abs_err"]),
        "ms": flag[kid]["ms"], "plain_ms": flag[kid]["plain_ms"],
        "bound_ms": flag[kid]["bound_ms"], "bound_by": flag[kid]["bound_by"],
        "library_ms": None,
        **({"conv3d_pad_ms": flag[kid]["conv3d_pad"]["ms"]} if "conv3d_pad" in flag[kid] else {}),
    } for kid, k in K.items()]


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
