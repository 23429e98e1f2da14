"""SNES ex19 analog: driven cavity (velocity-vorticity + temperature).

Counterpart of petsctpu's examples/ex19.py. Reference:
src/snes/examples/tutorials/ex19.c. Golden (output/ex19_1.out): 25x25
grid, lid velocity 0.0016 → SNES norms 0.0406612, 3.35993e-06,
2.643e-11, 2 Newton iterations.

    python -m petsctpu_torch.examples.ex19 -da_grid 25 -snes_monitor_short
"""

from __future__ import annotations

import sys

from petsctpu_torch.core.options import Options
from petsctpu_torch.device import resolve_device
from petsctpu_torch.ksp.common import KSPConfig
from petsctpu_torch.models.cavity import cavity_initial_guess, \
    cavity_residual
from petsctpu_torch.snes import snes_solve


def main(argv, device=None):
    dev = resolve_device(device)
    opts = Options.from_args(argv)
    mx = my = opts.get_int("da_grid", 25)
    lid = opts.get_real("lidvelocity", 1.0 / (mx * my))
    pr = opts.get_real("prandtl", 1.0)
    gr = opts.get_real("grashof", 1.0)
    print(f"lid velocity = {lid:g}, prandtl # = {pr:g}, grashof # = {gr:g}")
    F = cavity_residual(mx, my, lid, pr, gr)
    res = snes_solve(
        F, cavity_initial_guess(mx, my, gr, device=dev), jac="jvp",
        rtol=1e-8, monitor=opts.get_bool("snes_monitor_short", False)
        or opts.get_bool("snes_monitor", False),
        ksp_cfg=KSPConfig(ksp_type="gmres", rtol=1e-5, maxits=2000,
                          restart=100))
    print(f"Number of SNES iterations = {int(res.its)}")
    return res


if __name__ == "__main__":
    main(sys.argv[1:])
