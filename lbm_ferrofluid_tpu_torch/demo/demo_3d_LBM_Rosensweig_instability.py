"""3D Rosensweig instability, the north-star demo
(reference: demo_3d_LBM_Rosensweig_instability.py; JAX driver:
demo/demo_3d_LBM_Rosensweig_instability.py).

Steps ``rosensweig_3d`` through ``ferrofluid_step`` (on the card, the
capillogue steady state with the scalar carry), renders a frame of the
interface every ``--io_interval`` steps (``render_phi_frame``: host
marching tetrahedra, soft rasterizer on the card) and exports the final
interface as ``Rosensweig_instability.obj``.  The frames' phi is derived
from the density, as the reference driver derives it (:171); the JAX
driver renders ``phi_field``, which returns the initial state's stored
phi, all zeros, so its first frame is blank.  ``--tpu_layout 1`` steps the
same physics in the JAX package's padded transposed layout
(``scenes.rosensweig_3d_tpu``: the box form of B3, B1's psi form); frames
and the OBJ go through ``scenes.phys_view``, as the JAX driver's.
``--image_size`` sets the frames' side (default 256, rendered at 512 and
pooled).
"""

from __future__ import annotations

import pathlib

from ..models import ferrofluid_step, scenes
from ..ops.moments import phi_from_density
from ..render import default_renderer, phi_to_mesh, render_phi_frame
from ..utils.io import export_obj
from ._driver import HERE, parse_args, run_demo

OBJ_NAME = "Rosensweig_instability.obj"


def main(argv=None):
    opt = parse_args((130, 66, 130), extra=[("mag_strength", 100.0, "Magnetic strength"),
                                            ("gravity_strength", 1e-4, "Gravity"),
                                            ("tpu_layout", 0.0, "1 = padded transposed layout"),
                                            ("image_size", 256.0, "Frame side in pixels")],
                     argv=argv)
    opt.total_steps = opt.total_steps if opt.total_steps != 1000 else 8000
    scene = scenes.rosensweig_3d_tpu if opt.tpu_layout else scenes.rosensweig_3d
    params, state = scene(
        tuple(opt.res), mag_strength=opt.mag_strength, gravity=opt.gravity_strength,
        device=opt.device)
    renderer = default_renderer(int(opt.image_size), device=state.rho.device)

    def phi_of(state):
        return scenes.phys_view(params, phi_from_density(
            state.density, params.density_gas, params.density_fluid))

    def frame(state, filename):
        phi = phi_of(state)
        render_phi_frame(phi, filename, phi.shape[2:], 1.0, renderer=renderer)

    name = f"3d_LBM_Rosensweig_mag{int(opt.mag_strength)}"
    state = run_demo(name, params, state, ferrofluid_step, opt.total_steps,
                     opt.io_interval, frame, opt.out_dir, device=opt.device)
    # final mesh export, as the reference (demo_3d_LBM_Rosensweig_instability.py:221-232)
    phi = phi_of(state)
    verts, faces = phi_to_mesh(phi, phi.shape[2:], opt.dx)
    obj = (pathlib.Path(opt.out_dir) if opt.out_dir else HERE) / OBJ_NAME
    export_obj(str(obj), verts, faces)
    print(f"exported {obj} ({len(faces)} faces)")
    return state


if __name__ == "__main__":
    main()
