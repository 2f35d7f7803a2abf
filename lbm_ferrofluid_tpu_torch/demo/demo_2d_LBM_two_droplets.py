"""Ferrofluid droplet merge under a vertical field (reference: demo_2d_LBM_two_droplets.py);
a Tecplot dump of density and velocity at step 400, as the reference."""

from __future__ import annotations

from ..models import ferrofluid_step, scenes
from ..utils.io import dump_2d_plt
from ._driver import density_frame, parse_args, run_demo


def frame_with_plt(state, filename):
    density_frame(state, filename)
    if int(state.step) == 400:  # Tecplot dump, as the reference at step 400
        dump_2d_plt(filename.replace(".png", ".plt"), state.density, state.vel)


def main(argv=None):
    opt = parse_args((98, 384), extra=[
        ("mag_strength", 100.0, "Magnetic strength"),
        ("gravity_strength", 0.0, "Gravity")], argv=argv)
    opt.total_steps = opt.total_steps if opt.total_steps != 1000 else 8000
    params, state = scenes.two_droplets_2d(
        tuple(opt.res), mag_strength=opt.mag_strength, gravity=opt.gravity_strength,
        device=opt.device)
    name = f"2d_LBM_two_droplets_mag{int(opt.mag_strength)}"
    return run_demo(name, params, state, ferrofluid_step, opt.total_steps,
                    opt.io_interval, frame_with_plt, opt.out_dir, device=opt.device)


if __name__ == "__main__":
    main()
