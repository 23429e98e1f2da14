"""KSP ex2 analog: 2-D Laplacian solve with runtime options.

Counterpart of petsctpu's examples/ex2.py. Reference:
src/ksp/ksp/examples/tutorials/ex2.c. Golden run:
    python -m petsctpu_torch.examples.ex2 -ksp_monitor_short -m 5 -n 5 \\
        -ksp_gmres_cgs_refinement_type refine_always
prints the reference's output/ex2_1.out residual history
(3.21109 … 0.000387275, 4 iterations, error 0.000392701).
"""

from __future__ import annotations

import sys

import numpy as np
import torch

from petsctpu_torch.core.options import Options
from petsctpu_torch.device import resolve_device
from petsctpu_torch.ksp import KSP
from petsctpu_torch.mat import aij_from_scipy
from petsctpu_torch.models import ex2_system


def main(argv, device=None):
    dev = resolve_device(device)
    opts = Options.from_args(argv)
    m = opts.get_int("m", 8)
    n = opts.get_int("n", 7)
    A, b, u = ex2_system(m, n)
    Ad = aij_from_scipy(A, device=dev)
    ksp = KSP(options=opts)
    ksp.set_operators(Ad, A_host=A)
    ksp.cfg = ksp.cfg.__class__(rtol=1e-2 / ((m + 1) * (n + 1)), atol=1e-50)
    res = ksp.solve(torch.from_numpy(b).to(dev))
    err = np.linalg.norm(res.x.cpu().numpy() - u)
    print(f"Norm of error {err:g} iterations {int(res.its)}")
    unused = opts.unused()
    if unused:
        print(f"WARNING: unused options: {unused}")
    return res


if __name__ == "__main__":
    main(sys.argv[1:])
