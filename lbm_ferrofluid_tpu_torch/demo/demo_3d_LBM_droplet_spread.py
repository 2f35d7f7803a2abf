"""3D droplet spread (reference: demo_3d_LBM_droplet_spread.py)."""

from __future__ import annotations

from ..models import hcz_step, scenes
from ._driver import density_interior_frame, parse_args, run_demo


def main(argv=None):
    opt = parse_args((130, 130, 130), extra=[
        ("gravity_strength", 1e-05, "Gravity")], argv=argv)
    params, state = scenes.droplet_spread_3d(
        tuple(opt.res), gravity=opt.gravity_strength, device=opt.device)
    return run_demo("3d_LBM_droplet_spread", params, state, hcz_step, opt.total_steps,
                    opt.io_interval, density_interior_frame, opt.out_dir, device=opt.device)


if __name__ == "__main__":
    main()
