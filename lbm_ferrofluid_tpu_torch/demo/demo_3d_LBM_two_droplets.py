"""3D ferrofluid two-droplet merge (reference: demo_3d_LBM_two_droplets.py)."""

from __future__ import annotations

from ..models import ferrofluid_step, scenes
from ._driver import density_interior_frame, parse_args, run_demo


def main(argv=None):
    opt = parse_args((50, 50, 193), extra=[
        ("mag_strength", 100.0, "Magnetic strength"),
        ("gravity_strength", 0.0, "Gravity")], argv=argv)
    opt.total_steps = opt.total_steps if opt.total_steps != 1000 else 8000
    params, state = scenes.two_droplets_3d(
        tuple(opt.res), mag_strength=opt.mag_strength, gravity=opt.gravity_strength,
        device=opt.device)
    name = f"3d_LBM_two_droplets_mag{int(opt.mag_strength)}"
    return run_demo(name, params, state, ferrofluid_step, opt.total_steps,
                    opt.io_interval, density_interior_frame, opt.out_dir, device=opt.device)


if __name__ == "__main__":
    main()
