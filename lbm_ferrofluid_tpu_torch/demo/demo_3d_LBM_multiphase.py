"""3D HCZ cube drop (reference: demo_3d_LBM_multiphase.py)."""

from __future__ import annotations

from ..models import hcz_step, scenes
from ._driver import density_interior_frame, parse_args, run_demo


def main(argv=None):
    opt = parse_args((130, 130, 130), argv=argv)
    params, state = scenes.multiphase_3d(tuple(opt.res), device=opt.device)
    return run_demo("3d_LBM_multiphase", params, state, hcz_step, opt.total_steps,
                    opt.io_interval, density_interior_frame, opt.out_dir, device=opt.device)


if __name__ == "__main__":
    main()
