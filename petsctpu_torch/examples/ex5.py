"""SNES ex5 analog: 2-D Bratu solid-fuel ignition, Newton-Krylov.

Counterpart of petsctpu's examples/ex5.py. Reference:
src/snes/examples/tutorials/ex5.c.
    python -m petsctpu_torch.examples.ex5 -da_grid_x 17 -da_grid_y 17 \\
        -par 6.0 -snes_monitor
"""

from __future__ import annotations

import sys

from petsctpu_torch.core.options import Options
from petsctpu_torch.device import resolve_device
from petsctpu_torch.dm import DA
from petsctpu_torch.models.bratu import bratu_initial_guess, bratu_residual
from petsctpu_torch.snes import SNES


def main(argv, device=None):
    dev = resolve_device(device)
    opts = Options.from_args(argv)
    mx = opts.get_int("da_grid_x", 4)
    my = opts.get_int("da_grid_y", 4)
    lam = opts.get_real("par", 6.0)
    da = DA((mx, my))
    snes = SNES(options=opts)
    snes.set_function(bratu_residual(da, lam))
    res = snes.solve(bratu_initial_guess(da, lam, device=dev))
    print(f"Number of SNES iterations = {int(res.its)}")
    return res


if __name__ == "__main__":
    main(sys.argv[1:])
