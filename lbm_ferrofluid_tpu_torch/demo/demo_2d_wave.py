"""Velocity-forced wave pool, HCZ + KBC_A (reference: demo_2d_wave.py)."""

from __future__ import annotations

from ..models import hcz_step, scenes
from ._driver import density_frame, parse_args, run_demo


def main(argv=None):
    opt = parse_args((130, 130), argv=argv)
    params, state = scenes.wave(tuple(opt.res), device=opt.device)
    return run_demo("2d_wave", params, state, hcz_step, opt.total_steps,
                    opt.io_interval, density_frame, opt.out_dir, device=opt.device)


if __name__ == "__main__":
    main()
