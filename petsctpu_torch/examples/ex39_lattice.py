"""KSP ex39 analog: 2-D lattice gauge model, complex scalars.

Counterpart of petsctpu's examples/ex39_lattice.py. Reference:
src/ksp/ksp/examples/tutorials/ex39.c (PCASA lattice gauge,
PETSC_USE_COMPLEX). The gauge operator H is the reference's
entry-exact (models/lattice.py, drawn from its rand48 stream); the
normal-equation solve H² x = Hᵀb runs CG (the ELL kernel in
complex128 on the card).

    python -m petsctpu_torch.examples.ex39_lattice -size 6 -beta 1.0 \\
        -rho 1.0
"""

from __future__ import annotations

import sys

import numpy as np
import torch

from petsctpu_torch.core.options import Options
from petsctpu_torch.device import resolve_device
from petsctpu_torch.ksp import ksp_solve
from petsctpu_torch.mat import aij_from_scipy
from petsctpu_torch.models.lattice import lattice_gauge_system


def main(argv, device=None):
    dev = resolve_device(device)
    opts = Options.from_args(argv)
    n = opts.get_int("size", 6)
    beta = opts.get_real("beta", 1.0)
    rho = opts.get_real("rho", 1.0)
    HtH, Htb, H = lattice_gauge_system(n, beta, rho)
    print(f"lattice {n}x{n}, 2 spin dofs: H {H.shape}, "
          f"||Htb|| = {np.linalg.norm(Htb):.6f}")
    Ad = aij_from_scipy(HtH, dtype=np.complex128, device=dev)
    r = ksp_solve(Ad, torch.from_numpy(Htb).to(dev), ksp_type="cg",
                  rtol=1e-6, maxits=500)
    x = r.x.cpu().numpy()
    res = np.linalg.norm(HtH @ x - Htb)
    print(f"CG converged: reason {int(r.reason)}, its {int(r.its)}, "
          f"residual {res:.3e}")
    return r


if __name__ == "__main__":
    main(sys.argv[1:])
