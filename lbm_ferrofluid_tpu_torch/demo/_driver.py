"""Shared demo-driver plumbing: arguments, the step loop, PNG/mp4 artifacts.

Port of ``demo/_driver.py``: the runner's ``run(..., io_interval, io_fn)``
calls a frame function every ``io_interval`` steps (and on the initial
state); the frames are min-max normalized PNGs (``utils/io.py``), as the
reference's.  The arguments are the JAX drivers', plus ``--device`` (the
card unless ``cpu``) and ``--out_dir``.
"""

from __future__ import annotations

import argparse
import pathlib

from ..models import SimulationRunner
from ..utils.io import mkdir, save_img

__all__ = ["parse_args", "run_demo", "density_frame", "density_interior_frame", "HERE"]

#: the directory of the demo drivers, where artifacts go by default
HERE = pathlib.Path(__file__).resolve().parent


def parse_args(default_res, extra=(), argv=None):
    """The JAX drivers' arguments (``--res``, ``--total_steps``, ``--dt``,
    ``--dx``, ``--io_interval`` and the float ``extra`` ones), plus
    ``--device`` and ``--out_dir`` (frames, mp4 and OBJ; default
    ``demo_data_<name>/`` beside the drivers for the frames and the
    drivers' directory for the rest)."""
    p = argparse.ArgumentParser(
        formatter_class=argparse.ArgumentDefaultsHelpFormatter, allow_abbrev=False
    )
    p.add_argument("--res", type=int, nargs="+", default=list(default_res),
                   help="Simulation grid size")
    p.add_argument("--total_steps", type=int, default=1000)
    p.add_argument("--dt", type=float, default=1.0)
    p.add_argument("--dx", type=float, default=1.0)
    p.add_argument("--io_interval", type=int, default=10)
    for name, default, help_ in extra:
        p.add_argument(f"--{name}", type=float, default=default, help=help_)
    p.add_argument("--device", default=None,
                   help="cuda (the default) or cpu (the plain PyTorch versions)")
    p.add_argument("--out_dir", default=None, help="Directory of the artifacts")
    return p.parse_args(argv)


def run_demo(name, params, state, step_impl, total_steps, io_interval,
             frame_fn, out_dir=None, *, device=None):
    """Run the loop on ``device``, saving a PNG via ``frame_fn(state,
    filename)`` on the initial state and every ``io_interval`` steps, then
    assemble an mp4 where ``imageio`` imports."""
    runner = SimulationRunner(params, step_impl, device=device)
    out = pathlib.Path(out_dir) if out_dir else HERE / f"demo_data_{name}"
    mkdir(str(out))
    frames = []

    def io_fn(state):
        filename = str(out / f"{int(state.step):05d}.png")
        frame_fn(state, filename)
        frames.append(filename)

    io_fn(state)
    state = runner.run(state, total_steps, io_interval=io_interval, io_fn=io_fn)

    movie = (pathlib.Path(out_dir) if out_dir else HERE) / f"{name}.mp4"
    try:
        import imageio

        with imageio.get_writer(str(movie), fps=25) as w:
            for f in frames:
                w.append_data(imageio.imread(f))
        print(f"wrote {movie} ({len(frames)} frames)")
    except Exception as e:  # imageio or its codec may be absent
        print(f"mp4 skipped ({e}); {len(frames)} PNGs in {out}")
    return state


def density_frame(state, filename):
    save_img(state.density, filename)


def density_interior_frame(state, filename):
    dim = state.density.ndim - 2
    idx = (Ellipsis,) + tuple(slice(1, -1) for _ in range(dim))
    save_img(state.density[idx], filename)
