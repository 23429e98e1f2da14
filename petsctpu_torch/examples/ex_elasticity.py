"""Linear elasticity cantilever with rigid-body-mode GAMG.

Counterpart of petsctpu's examples/ex_elasticity.py. Analog of the
reference's GAMG elasticity workflow (PCSetCoordinates, agg.c:246):
plane-strain Q1 cantilever, CG preconditioned by smoothed aggregation
whose tentative prolongator interpolates the 3 rigid-body modes built
from node coordinates.

    python -m petsctpu_torch.examples.ex_elasticity -mx 32 -my 16
"""

from __future__ import annotations

import sys

import torch

from petsctpu_torch.core.options import Options
from petsctpu_torch.device import resolve_device
from petsctpu_torch.ksp import ksp_solve
from petsctpu_torch.mat import aij_from_scipy
from petsctpu_torch.models.elasticity import elasticity_2d
from petsctpu_torch.pc import make_pc


def main(argv, device=None):
    dev = resolve_device(device)
    opts = Options.from_args(argv)
    mx = opts.get_int("mx", 32)
    my = opts.get_int("my", 16)
    A, coords, b = elasticity_2d(mx, my)
    Ad = aij_from_scipy(A, device=dev)
    pc = make_pc("gamg", A=Ad, A_host=A,
                 options=Options({"pc_gamg_coordinates": coords}))
    res = ksp_solve(Ad, torch.from_numpy(b).to(dev), pc=pc, ksp_type="cg",
                    rtol=opts.get_real("ksp_rtol", 1e-8), maxits=200,
                    monitor=opts.get_bool("ksp_monitor_short", False))
    x = res.x.cpu().numpy()
    print(f"elasticity {mx}x{my} (n={A.shape[0]}): {int(res.its)} its, "
          f"tip deflection = {x[1::2].min():.5f}")
    return res


if __name__ == "__main__":
    main(sys.argv[1:])
