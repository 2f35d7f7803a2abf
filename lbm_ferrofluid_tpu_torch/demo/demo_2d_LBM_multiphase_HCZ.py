"""HCZ multiphase square drop (reference: demo_2d_LBM_multiphase_HCZ.py)."""

from __future__ import annotations

from ..models import hcz_step, scenes
from ._driver import density_interior_frame, parse_args, run_demo


def main(argv=None):
    opt = parse_args((130, 130), argv=argv)
    opt.total_steps = opt.total_steps if opt.total_steps != 1000 else 4000
    params, state = scenes.multiphase_drop_hcz(tuple(opt.res), device=opt.device)
    return run_demo("2d_LBM_multiphase_HCZ", params, state, hcz_step, opt.total_steps,
                    opt.io_interval, density_interior_frame, opt.out_dir, device=opt.device)


if __name__ == "__main__":
    main()
