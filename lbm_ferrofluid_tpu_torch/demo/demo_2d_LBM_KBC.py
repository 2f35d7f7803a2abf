"""2D shear layer with entropic KBC_A collision (reference: demo_2d_LBM_KBC.py)."""

from __future__ import annotations

from ..models import scenes, singlephase_step
from ..ops import vorticity_2d
from ..utils.io import save_img
from ._driver import parse_args, run_demo


def vort_frame(state, filename):
    save_img(vorticity_2d(state.vel, 1.0), filename)


def main(argv=None):
    opt = parse_args((130, 130), argv=argv)
    params, state = scenes.shear_layer(tuple(opt.res), kbc=True, device=opt.device)
    return run_demo("2d_LBM_KBC", params, state, singlephase_step, opt.total_steps,
                    opt.io_interval, vort_frame, opt.out_dir, device=opt.device)


if __name__ == "__main__":
    main()
