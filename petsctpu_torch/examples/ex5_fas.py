"""SNES ex5 with FAS nonlinear multigrid (the -snes_type fas path).

Counterpart of petsctpu's examples/ex5_fas.py. Reference:
src/snes/examples/tutorials/ex5.c run with -snes_type fas (SNESFAS,
src/snes/impls/fas/fas.c).
    python -m petsctpu_torch.examples.ex5_fas -da_grid_x 33 \\
        -da_grid_y 33 -par 6.0 -fas_levels 3 -snes_monitor
"""

from __future__ import annotations

import sys

import torch

from petsctpu_torch.core.options import Options
from petsctpu_torch.device import resolve_device
from petsctpu_torch.dm import DA
from petsctpu_torch.models.bratu import bratu_initial_guess, bratu_residual
from petsctpu_torch.snes import fas_levels_from_da, snes_fas


def main(argv, device=None):
    dev = resolve_device(device)
    opts = Options.from_args(argv)
    mx = opts.get_int("da_grid_x", 17)
    my = opts.get_int("da_grid_y", 17)
    lam = opts.get_real("par", 6.0)
    nlev = opts.get_int("fas_levels", 3)
    monitor = opts.get_bool("snes_monitor", False)

    da = DA((mx, my))
    levels = fas_levels_from_da(da, lambda d: bratu_residual(d, lam), nlev)
    x0 = bratu_initial_guess(da, lam, device=dev)
    res = snes_fas(levels, x0, rtol=1e-8, maxits=40, monitor=monitor)
    F = bratu_residual(da, lam)
    print(f"FAS({nlev} levels) {'converged' if res.converged else 'FAILED'} "
          f"in {int(res.its)} V-cycles, ||F|| = "
          f"{float(torch.linalg.norm(F(res.x))):.3e}")
    return res


if __name__ == "__main__":
    main(sys.argv[1:])
