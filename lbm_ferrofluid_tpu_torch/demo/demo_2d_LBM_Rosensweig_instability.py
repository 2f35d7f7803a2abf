"""2D Rosensweig instability (reference: demo_2d_LBM_Rosensweig_instability.py)."""

from __future__ import annotations

from ..models import ferrofluid_step, scenes
from ._driver import density_frame, parse_args, run_demo


def main(argv=None):
    opt = parse_args((130, 130), extra=[
        ("mag_strength", 100.0, "Magnetic strength"),
        ("gravity_strength", 0.0001, "Gravity")], argv=argv)
    opt.total_steps = opt.total_steps if opt.total_steps != 1000 else 2000
    params, state = scenes.rosensweig_2d(
        tuple(opt.res), mag_strength=opt.mag_strength, gravity=opt.gravity_strength,
        device=opt.device)
    name = f"2d_LBM_Rosensweig_mag{int(opt.mag_strength)}"
    return run_demo(name, params, state, ferrofluid_step, opt.total_steps,
                    opt.io_interval, density_frame, opt.out_dir, device=opt.device)


if __name__ == "__main__":
    main()
