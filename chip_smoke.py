#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's main paths on one GPU and check every kernel.

Run from the repository root with one CUDA card and the CUDA toolkit::

    python3 chip_smoke.py

Phases, each printing one JSON line; any failed check exits non-zero:

1. device: the card's name, count and power limit (``nvidia-smi``);
2. build: one nvcc process per CUDA source, all started together, link the
   kernel library from ``csrc/``;
3. kernels: each kernel against its plain PyTorch version on seeded inputs
   with an interior obstacle block.  Ferrofluid kernels (B1 scalar Poisson
   sweeps + H2, B2 contact angle, B3 capillogue chain at the magnetic tau 1
   and 0.8, B4 prologue, B11b channel-form Poisson sweeps at tau 1 and 0.8
   with an interior magnetic obstacle block, B10a gradients of one and of
   four fields, B5 epilogue with and without ``emit_mac`` on B6's outputs,
   B10b Laplacian) at 34x66x130 and 130x66x130; HCZ kernels (B8b/B8a
   stream + bounce, B2 at 0.75 pi, B6 capillary stage with and without H2,
   B9 collide, each fed with what the kernels before it produced, then the
   capillary stage's stencil route B10b + B10a against its plain version
   and against B6) at 34x66x130 and 130^3.  Bar rel <= 5e-5 per field
   (max|a-b| / max|b|), velocities also pass at abs <= 5e-6
   (docs/PARITY.md:78-93: FMA contraction and reassociation);
4. golden: ``tests/golden/ferro3d.npz`` (8 steps; the capillogue steady
   state with the scalar carry and with the channel-form solve,
   ``scalar_carry=False``, and the un-carried step) and ``hcz3d.npz``
   (10 steps), reference solver, through the port with kernels, at
   tests/test_parity.py's bars;
5. main paths, each with the launch counters zeroed just before it and read
   just after it:
   - Rosensweig at the demo's native 130x66x130, primed and stepped 30
     times with the kernels against 30 plain steps on the card (phase 3's
     bars), then 200 more kernel steps (timed, MLUPS), fields finite, drift
     of sum(rho) over fluid cells;
   - HCZ ``multiphase_3d`` at 130^3 the same way (30 against 30, 200 timed),
     then ``droplet_spread_3d`` at 130^3 (30 against 30);
   - ``two_droplets_3d`` at 50x50x193 on the ferrofluid path (30 against 30);
   - Rosensweig 130x66x130 on the channel-form solve: with
     ``scalar_carry=False`` 30 kernel steps against 30 plain steps and
     against 30 scalar-carry kernel steps (``compare_views``), then 200
     timed; with tau = 0.8 30 against 30.  B11b launches 30 times and B10a
     once a step;
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
   bound, and kernel-vs-plain errors at that size.

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
    """Registers and spills per kernel from nvcc's ``-Xptxas -v`` output."""
    res, cur = {}, None
    for line in log.splitlines():
        m = re.search(r"(?:Compiling entry function|Function properties for) '?(_Z(\d+)\w+)", line)
        if m:
            mangled, n = m.group(1), int(m.group(2))
            cur = mangled[2 + len(m.group(2)):2 + len(m.group(2)) + n]
            res.setdefault(cur, {})
        elif cur and "registers" in line:
            res[cur]["regs"] = int(re.search(r"Used (\d+) registers", line).group(1))
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


def hcz_seeded_inputs(res, seed, dev):
    """HCZ inputs on the card from a numpy seed: the ``multiphase_3d``
    scene's macros with small perturbations and an interior obstacle
    block, f = feq and g = geq with 0.1 % noise per channel, and an H2 for
    B6's Kelvin variant."""
    import torch

    from lbm_ferrofluid_tpu_torch.models import multiphase_3d
    from lbm_ferrofluid_tpu_torch.ops.equilibrium import feq, geq
    from lbm_ferrofluid_tpu_torch.ops.moments import eos_pressure, rho_to_density

    params, st = multiphase_3d(res=res, device=dev)
    rng = np.random.default_rng(seed)
    Z, Y, X = res

    def t(a):
        return torch.as_tensor(np.asarray(a, np.float32), device=dev)

    flags = st.flags.clone()
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
    from lbm_ferrofluid_tpu_torch.ops.stencils import substitute_obstacles

    worst = {kid: 0.0 for kid in K}
    rows = []

    def log(kid, label, res, r, **extra):
        err = max(v["max_abs_err"] for v in r.values())
        worst[kid] = max(worst[kid], err)
        rows.append({"kernel": label, "res": list(res), **extra,
                     "max_rel": max(v["rel"] for v in r.values()), "max_abs_err": err})

    for res, seed in (((34, 66, 130), 1), ((130, 66, 130), 2)):
        params, d = seeded_inputs(res, seed, dev)
        d["rho_ca"] = K["B2"].wrapper(d["rho_pre"], d["flags"], params.contact_angle)
        checks = [("B4", params), ("B1", params), ("B2", params),
                  ("B2", params.replace(contact_angle=0.35 * math.pi)), ("B3", params),
                  ("B3", params.replace(tau=0.8))]
        for kid, p in checks:
            args, kw = kernel_calls(p, d)[kid]
            _, r = run_and_compare(K, kid, args, kw, f"{kid} tau={p.tau} at {res}")
            log(kid, kid, res, r, contact_angle=p.contact_angle, tau=p.tau)
        for tau in (1.0, 0.8):
            (_, psi), r = run_and_compare(
                K, "B11b", (d["h"], d["mflags_block"], d["rhs"]),
                dict(tau=tau, n_iters=params.poisson_iters), f"B11b tau={tau} at {res}")
            log("B11b", "B11b", res, r, tau=tau, n_iters=params.poisson_iters)
        for fields in (substitute_obstacles(psi, d["mflags_block"]), d["fields4"]):
            _, r = run_and_compare(K, "B10a", (fields,), dict(dx=params.dx),
                                   f"B10a N={fields.shape[1]} at {res}")
            log("B10a", "B10a", res, r, n_fields=fields.shape[1])
        for emit_mac in (False, True):
            args, kw = epilogue_call(K, params, d, emit_mac)
            _, r = run_and_compare(K, "B5", args, kw, f"B5 emit_mac={emit_mac} at {res}")
            log("B5", "B5", res, r, emit_mac=emit_mac)
            for field in (args[5], d["fields4"][:, :1].contiguous()):
                _, r = run_and_compare(K, "B10b", (field,), dict(dx=params.dx),
                                       f"B10b at {res}")
                log("B10b", "B10b", res, r)
    for res, seed in (((34, 66, 130), 3), ((130, 130, 130), 4)):
        params, d = hcz_seeded_inputs(res, seed, dev)

        def record(label, kid, args, kw):
            got, r = run_and_compare(K, kid, args, kw, f"{label} at {res}")
            log(kid, label, res, r, contact_angle=params.contact_angle)
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
    res = list(sk.rho.shape[2:])
    del sk, s0
    params2, s2 = droplet_spread_3d(device=dev)
    sk2, rows2 = kernel_vs_plain(params2, s2, hcz_step, dev, 30, "droplet spread",
                                 HCZ_FIELDS)
    assert_finite(sk2)
    launches = kernels_pkg.launch_counts(ids)
    check(all(v > 0 for v in launches.values()), f"an HCZ kernel never launched: {launches}")
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
    launches = kernels_pkg.launch_counts(ids)
    check(all(v > 0 for v in launches.values()), f"a kernel never launched: {launches}")
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
        check(all(launches[kid] > 0 for kid in ids) and launches["B1"] == 0,
              f"{label}: launches {launches}")
        check(launches["B11b"] == p.poisson_iters * steps and launches["B10a"] == steps,
              f"{label}: B11b/B10a launches {launches} over {steps} steps")
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
        "B4": 1, "B11b": params.poisson_iters, "B10a": 1, "B2": K["B2"].module.N_STAGES,
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
        "B1": params.poisson_iters + 1, "B2": K["B2"].module.N_STAGES,
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
        "B8b": 1, "B8a": 1, "B2": K["B2"].module.N_STAGES, "B10b": 1, "B10a": 1, "B9": 1},
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
    per_call = {"B1": params.poisson_iters + 1, "B2": K["B2"].module.N_STAGES,
                "B3": K["B3"].module.N_LAUNCHES, "B4": 1}
    # the prologue runs once, at priming; the other three every step
    per_step = dict(per_call, B4=0)
    out = {kid: measure(K, kid, *calls[kid], per_call[kid], per_step[kid], f"{kid} at 256^3")
           for kid in ("B1", "B2", "B3", "B4")}
    emit({"phase": "flagship", "scene": "rosensweig_3d", "res": [256, 256, 256],
          "mlups": stats["mlups"], "seconds_30_steps": stats["seconds"],
          "peak_mem_gb": peak / 1e9, "card": card, "per_kernel": out, "ok": True})
    return out


def phase_channel_flagship(dev, K, card):
    """bench.py's Rosensweig scene at 256^3 on the channel-form solve
    (``scalar_carry=False``): MLUPS and peak memory over warm steps, then
    B11b and B10a at the inputs the next step gives them."""
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
    out = {"B11b": measure(K, "B11b", args, kw, params.poisson_iters, params.poisson_iters,
                           "B11b at 256^3")}
    psi_sub = substitute_obstacles(K["B11b"].wrapper(*args, **kw)[1], st.magnetic_flags)
    out["B10a"] = measure(K, "B10a", (psi_sub,), dict(dx=params.dx), 1, 1, "B10a at 256^3")
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


def phase_hcz_flagship(dev, K, card):
    """``multiphase_3d`` at 256^3: MLUPS and peak memory over warm steps,
    then each HCZ kernel at the inputs the next step gives it, and the
    capillary stage's stencil route (B10b, B10a) on the same inputs."""
    import torch

    from lbm_ferrofluid_tpu_torch.models import SimulationRunner, hcz_step, multiphase_3d
    from lbm_ferrofluid_tpu_torch.ops.kernels import hcz_capillary_stencils
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
    per_call = {"B8b": 1, "B8a": 1, "B2": K["B2"].module.N_STAGES,
                "B6": K["B6"].module.N_LAUNCHES, "B9": 1}
    out, errs = {}, {}

    def record(label, kid, args, kw):
        if label != kid:  # B6 with H2: errors only, the step runs without it
            got, r = run_and_compare(K, kid, args, kw, f"{label} at 256^3")
            errs[label] = max(v["max_abs_err"] for v in r.values())
            return got
        out[kid] = measure(K, kid, args, kw, per_call[kid], per_call[kid],
                           f"{kid} at 256^3")
        return K[kid].wrapper(*args, **kw)

    ctx = hcz_chain(K, params, d, record)
    # the stencil route on the same inputs: B10b alone, then the route
    # against its plain version and against B6's outputs, and its time
    den_ca = rho_to_density(ctx["rho_ca"], rho_gas=params.rho_gas, rho_fluid=params.rho_fluid,
                            density_gas=params.density_gas, density_fluid=params.density_fluid)
    out["B10b"] = measure(K, "B10b", (den_ca,), dict(dx=params.dx), 1, 1, "B10b at 256^3")
    route = stencil_route_rows(params, d, ctx, "at 256^3")
    errs["stencil route"] = max(v["max_abs_err"] for r in route.values() for rr in r.values()
                                for v in rr.values())
    gravity = torch.tensor(params.gravity_vec(), dtype=torch.float32, device=dev)
    route_ms = time_cuda(lambda: hcz_capillary_stencils(
        ctx["rho"], ctx["vel"], d["flags"], ctx["den"], d["pres"], ctx["rho_ca"],
        g=ctx["g_post"], kappa=params.kappa, gravity=gravity.reshape(1, 3, 1, 1, 1),
        dx=params.dx, dt=params.dt, rho_gas=params.rho_gas, rho_fluid=params.rho_fluid,
        density_gas=params.density_gas, density_fluid=params.density_fluid), reps=10)
    emit({"phase": "hcz_flagship", "scene": "multiphase_3d", "res": [256, 256, 256],
          "mlups": stats["mlups"], "seconds_30_steps": stats["seconds"],
          "peak_mem_gb": peak / 1e9, "card": card, "per_kernel": out,
          "stencil_route": {"ms_moments_from_g": route_ms, "checks": route},
          "other_checks_max_abs_err": errs, "ok": True})
    out["B6"]["max_abs_err"] = max(out["B6"]["max_abs_err"], errs["B6 with H2"])
    return out


def run_phases(dev, kernels_pkg, smi) -> list:
    """Phases 3-6; returns one row per kernel for the ``kernels`` line.
    ``launches`` sums the kernel's launches over the main paths of phase 5
    that run it (B2, B3 and B4 over both ferrofluid solves)."""
    K = kernels_pkg.KERNELS
    worst = phase_kernels(dev, K)
    phase_golden(dev)
    per_path = [phase_main(dev, kernels_pkg, smi), phase_hcz_main(dev, kernels_pkg, smi),
                phase_two_droplets(dev, kernels_pkg, smi),
                phase_channel_main(dev, kernels_pkg, smi),
                phase_uncarried_main(dev, kernels_pkg, smi),
                phase_epilogue_main(dev, kernels_pkg, smi),
                phase_stencils_main(dev, kernels_pkg, smi)]
    launches = {kid: sum(p.get(kid, 0) for p in per_path) for kid in K}
    flag = phase_flagship(dev, K, smi)
    flag.update(phase_channel_flagship(dev, K, smi))
    epi = phase_epilogue_flagship(dev, K, smi)
    flag["B5"] = dict(epi["B5"], max_abs_err=max(v["max_abs_err"] for v in epi.values()))
    hcz_flag = phase_hcz_flagship(dev, K, smi)
    flag["B2"]["max_abs_err"] = max(flag["B2"]["max_abs_err"], hcz_flag["B2"]["max_abs_err"])
    flag.update({kid: v for kid, v in hcz_flag.items() if kid != "B2"})
    return [{
        "name": f"{kid} {k.wrapper.__name__}", "route": "cuda",
        "source": k.module.CUDA_SOURCE, "replaces": k.tpu_kernel,
        "launches": launches[kid],
        "max_abs_err": max(worst[kid], flag[kid]["max_abs_err"]),
        "ms": flag[kid]["ms"], "plain_ms": flag[kid]["plain_ms"],
        "bound_ms": flag[kid]["bound_ms"], "bound_by": flag[kid]["bound_by"],
        "library_ms": None,
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

    rows = run_phases(dev, kernels_pkg, smi)
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
