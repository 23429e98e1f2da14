"""KSP ex45 analog: 3-D 7-point Poisson with multigrid.

Counterpart of petsctpu's examples/ex45.py. Reference:
src/ksp/ksp/examples/tutorials/ex45.c.
    python -m petsctpu_torch.examples.ex45 -da_grid 17 -ksp_type cg \\
        -pc_type mg -ksp_monitor_short
"""

from __future__ import annotations

import sys

import numpy as np
import torch

from petsctpu_torch.core.options import Options
from petsctpu_torch.device import resolve_device
from petsctpu_torch.dm import DA
from petsctpu_torch.ksp import KSP
from petsctpu_torch.mat import aij_from_scipy
from petsctpu_torch.models import ex45_system


def main(argv, device=None):
    dev = resolve_device(device)
    opts = Options.from_args(argv)
    g = opts.get_int("da_grid", 9)
    A, b, u = ex45_system(g, g, g)
    if opts.get_str("pc_type", "") == "mg":
        opts.set("pc_mg_da", DA((g, g, g)))
    Ad = aij_from_scipy(A, device=dev)
    ksp = KSP(options=opts)
    ksp.set_operators(Ad, A_host=A)
    res = ksp.solve(torch.from_numpy(b).to(dev))
    rnorm = np.linalg.norm(np.asarray(b) - A @ res.x.cpu().numpy())
    print(f"Residual norm {rnorm:g}")
    print(f"Number of iterations = {int(res.its)}")
    return res


if __name__ == "__main__":
    main(sys.argv[1:])
