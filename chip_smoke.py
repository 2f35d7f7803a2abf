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
   sweeps + H2, B2 contact angle, B3 capillogue chain, B4 prologue) at
   34x66x130 and 130x66x130; HCZ kernels (B8b/B8a stream + bounce, B2 at
   0.75 pi, B6 capillary stage with and without H2, B9 collide, each fed
   with what the kernels before it produced) at 34x66x130 and 130^3.  Bar
   rel <= 5e-5 per field (max|a-b| / max|b|), velocities also pass at
   abs <= 5e-6 (docs/PARITY.md:78-93: FMA contraction and reassociation);
4. golden: ``tests/golden/ferro3d.npz`` (8 steps) and ``hcz3d.npz`` (10
   steps), reference solver, through the port with kernels, at
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
6. flagships at 256^3: the Rosensweig scene that bench.py times and the
   HCZ ``multiphase_3d``, warm steps, MLUPS, peak memory, and per-kernel
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
    "B6": ["vel", "pressure", "force", "dfai", "dprho"],
    "B8a": ["f_post", "m0", "m1"],
    "B8b": ["f_post", "rho", "vel", "density"],
    "B9": ["f", "g"],
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


def run_and_compare(K, kid, args, kw, what):
    """Call kernel ``kid`` and its plain version on the same inputs."""
    import torch

    got = K[kid].wrapper(*args, **kw)
    want = K[kid].plain(*args, **kw)
    torch.cuda.synchronize()
    return got, compare(what, OUTPUTS[kid], got, want)


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
    record("B6 with H2", "B6", (rho, den, d["pres"], rho_ca, d["H2"], phi, fl, m0g, m1g, vel),
           cap_kw)
    record("B9", "B9", (f_post, g_post, rho_ca, vel2, rho_to_density(rho_ca, **gas), pres, fl,
                        force, dfai, dprho),
           dict(tau_f=params.tau_f, tau_g=params.tau_g, dx=params.dx, dt=params.dt))


def phase_kernels(dev, K):
    worst = {kid: 0.0 for kid in K}
    rows = []

    def log(kid, label, res, angle, r):
        err = max(v["max_abs_err"] for v in r.values())
        worst[kid] = max(worst[kid], err)
        rows.append({"kernel": label, "res": list(res), "contact_angle": angle,
                     "max_rel": max(v["rel"] for v in r.values()), "max_abs_err": err})

    for res, seed in (((34, 66, 130), 1), ((130, 66, 130), 2)):
        params, d = seeded_inputs(res, seed, dev)
        d["rho_ca"] = K["B2"].wrapper(d["rho_pre"], d["flags"], params.contact_angle)
        checks = [("B4", params), ("B1", params), ("B2", params),
                  ("B2", params.replace(contact_angle=0.35 * math.pi)), ("B3", params)]
        for kid, p in checks:
            args, kw = kernel_calls(p, d)[kid]
            _, r = run_and_compare(K, kid, args, kw, f"{kid} at {res}")
            log(kid, kid, res, p.contact_angle, r)
    for res, seed in (((34, 66, 130), 3), ((130, 130, 130), 4)):
        params, d = hcz_seeded_inputs(res, seed, dev)

        def record(label, kid, args, kw):
            got, r = run_and_compare(K, kid, args, kw, f"{label} at {res}")
            log(kid, label, res, params.contact_angle, r)
            return got

        hcz_chain(K, params, d, record)
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
    st = init_ferrofluid_state(params, d["rho0"], d["den0"],
                               np.zeros((1, 3, *res), np.float32), d["flags"], mflags,
                               device=dev)
    for _ in range(8):
        st = ferrofluid_step(params, st, device=dev)
    a, b = compare_views(st.h, torch.as_tensor(d["h"], device=dev), st.magnetic_flags)
    rows = _golden_rows("golden ferro3d", (
        ("h", a, b), ("f", st.f, d["f"]), ("g", st.g, d["g"]), ("vel", st.vel, d["vel"]),
        ("density", st.density, d["den"])))
    emit({"phase": "golden", "file": "tests/golden/ferro3d.npz", "steps": 8,
          "fields": rows, "ok": True})

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


def kernel_vs_plain(params, s0, step, dev, n_steps, what, fields, runner):
    """``n_steps`` kernel steps (through ``runner``) against ``n_steps``
    plain steps on the card, from ``s0``; returns the kernel state and the
    per-field errors (phase 3's bars)."""
    sk = runner.prepare(s0)
    for _ in range(n_steps):
        sk = runner.step(sk)
    sp = s0
    for _ in range(n_steps):
        sp = step(params, sp, device=dev, plain=True)
    names = list(fields) + (OUTPUTS["B3"][5:] if getattr(sk, "premac", None) else [])
    rows = compare(what, names,
                   [getattr(sk, n) for n in fields] + list(getattr(sk, "premac", None) or ()),
                   [getattr(sp, n) for n in fields] + list(getattr(sp, "premac", None) or ()))
    return sk, rows


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
                               FERRO_FIELDS, runner)
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
    sk, rows = kernel_vs_plain(params, s0, hcz_step, dev, 30, "hcz main path", HCZ_FIELDS,
                               runner)
    mass0, mass30 = fluid_mass(s0), fluid_mass(sk)
    sk, stats = runner.benchmark(sk, n_steps=200, warmup=0)
    assert_finite(sk)
    mass230 = fluid_mass(sk)
    res = list(sk.rho.shape[2:])
    del sk, s0
    params2, s2 = droplet_spread_3d(device=dev)
    sk2, rows2 = kernel_vs_plain(params2, s2, hcz_step, dev, 30, "droplet spread",
                                 HCZ_FIELDS, SimulationRunner(params2, hcz_step, device=dev))
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
    from lbm_ferrofluid_tpu_torch.models import SimulationRunner, ferrofluid_step, two_droplets_3d
    from lbm_ferrofluid_tpu_torch.models.runner import assert_finite

    ids = kernels_pkg.PATHS["ferrofluid"]
    params, s0 = two_droplets_3d(device=dev)
    kernels_pkg.reset_launch_counts()
    sk, rows = kernel_vs_plain(params, s0, ferrofluid_step, dev, 30, "two droplets",
                               FERRO_FIELDS, SimulationRunner(params, ferrofluid_step,
                                                              device=dev))
    assert_finite(sk)
    launches = kernels_pkg.launch_counts(ids)
    check(all(v > 0 for v in launches.values()), f"a kernel never launched: {launches}")
    emit({"phase": "two_droplets", "scene": "two_droplets_3d", "res": list(sk.rho.shape[2:]),
          "kernel_vs_plain_after_30_steps": rows, "finite": True, "card": card,
          "launches": launches, "ok": True})
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


def phase_hcz_flagship(dev, K, card):
    """``multiphase_3d`` at 256^3: MLUPS and peak memory over warm steps,
    then each HCZ kernel at the inputs the next step gives it."""
    import torch

    from lbm_ferrofluid_tpu_torch.models import SimulationRunner, hcz_step, multiphase_3d

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

    hcz_chain(K, params, d, record)
    emit({"phase": "hcz_flagship", "scene": "multiphase_3d", "res": [256, 256, 256],
          "mlups": stats["mlups"], "seconds_30_steps": stats["seconds"],
          "peak_mem_gb": peak / 1e9, "card": card, "per_kernel": out,
          "other_checks_max_abs_err": errs, "ok": True})
    out["B6"]["max_abs_err"] = max(out["B6"]["max_abs_err"], errs["B6 with H2"])
    return out


def run_phases(dev, kernels_pkg, smi) -> list:
    """Phases 3-6; returns one row per kernel for the ``kernels`` line.
    ``launches`` sums the kernel's launches over the main paths of phase 5
    that run it."""
    K = kernels_pkg.KERNELS
    worst = phase_kernels(dev, K)
    phase_golden(dev)
    per_path = [phase_main(dev, kernels_pkg, smi), phase_hcz_main(dev, kernels_pkg, smi),
                phase_two_droplets(dev, kernels_pkg, smi)]
    launches = {kid: sum(p.get(kid, 0) for p in per_path) for kid in K}
    flag = phase_flagship(dev, K, smi)
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
