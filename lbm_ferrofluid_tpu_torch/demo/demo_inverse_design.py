"""Inverse design by differentiable simulation (port of
``demo/demo_inverse_design.py``).

Optimizes the initial rho of ``multiphase_drop_hcz`` so that after
``--steps`` 2D HCZ steps the density matches a target (the same dynamics
from the droplet rolled by (H/8, W/8)), by gradient descent through the
solver: streaming, bounce-back, the capillary stencils and the collision.
The 2D step runs plain PyTorch ops on any device (no kernel launches, as
in the JAX package, whose demo sets ``use_pallas=False``), so autograd
differentiates it exactly.  ``torch.optim.Adam`` stands in for
``optax.adam``: the same rule (both bias corrections, epsilon outside the
square root).  Artifacts: the initial, optimized and target final
densities as PNGs, and the loss curve on stdout.  It exits non-zero
unless the loss falls at least 2x, as the JAX driver does.

Usage: ``python -m lbm_ferrofluid_tpu_torch.demo.demo_inverse_design
[--res 24 24] [--steps 4] [--iters 40] [--lr 0.02] [--device cpu]
[--out_dir DIR]``.  ``main(argv)`` returns ``{"losses", "final",
"seconds"}``: the loss at each iteration (before its update), the final
loss and the optimization loop's wall seconds.
"""

from __future__ import annotations

import argparse
import pathlib
import time

import torch

from ..models import hcz_step, scenes
from ..utils.device import resolve_device
from ..utils.io import mkdir, save_img
from ._driver import HERE


def parse_args(argv=None):
    p = argparse.ArgumentParser(formatter_class=argparse.ArgumentDefaultsHelpFormatter,
                                allow_abbrev=False)
    p.add_argument("--res", type=int, nargs=2, default=(24, 24))
    p.add_argument("--steps", type=int, default=4, help="forward solver steps")
    p.add_argument("--iters", type=int, default=40, help="Adam iterations")
    p.add_argument("--lr", type=float, default=0.02)
    p.add_argument("--device", default=None,
                   help="cuda (the default) or cpu (the plain PyTorch versions)")
    p.add_argument("--out_dir", default=None,
                   help="Directory of the PNGs (default artifacts/inverse_design/ beside "
                        "the drivers)")
    return p.parse_args(argv)


def main(argv=None):
    opt = parse_args(argv)
    resolve_device(opt.device)
    params, state0 = scenes.multiphase_drop_hcz(tuple(opt.res), device=opt.device)

    def forward(rho0):
        s = state0.replace(rho=rho0)
        for _ in range(opt.steps):
            s = hcz_step(params, s, device=opt.device)
        return s.rho

    def loss_fn(rho0):
        d = forward(rho0) - target
        return torch.mean(d * d)

    H, W = opt.res
    with torch.no_grad():
        target = forward(torch.roll(state0.rho, (H // 8, W // 8), dims=(-2, -1)))
    rho = state0.rho.clone().requires_grad_(True)
    adam = torch.optim.Adam([rho], lr=opt.lr)

    out = pathlib.Path(opt.out_dir) if opt.out_dir else HERE / "artifacts" / "inverse_design"
    mkdir(str(out))
    with torch.no_grad():
        save_img(forward(rho), str(out / "initial_final.png"))
        save_img(target, str(out / "target_final.png"))

    losses = []
    t0 = time.perf_counter()
    for i in range(opt.iters):
        adam.zero_grad()
        loss = loss_fn(rho)
        loss.backward()
        adam.step()
        losses.append(loss.item())
        if i % 10 == 0 or i == opt.iters - 1:
            print(f"iter {i:3d}: loss {losses[-1]:.3e}", flush=True)
    seconds = time.perf_counter() - t0

    with torch.no_grad():
        final = float(loss_fn(rho))
        save_img(forward(rho), str(out / "optimized_final.png"))
    print(f"loss {losses[0]:.3e} -> {final:.3e} "
          f"({losses[0] / max(final, 1e-30):.1f}x reduction); artifacts in {out}")
    if not final < 0.5 * losses[0]:
        raise SystemExit("optimization failed to reduce the loss 2x")
    return {"losses": losses, "final": final, "seconds": seconds}


if __name__ == "__main__":
    main()
