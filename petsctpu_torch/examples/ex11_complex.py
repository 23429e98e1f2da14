"""KSP ex11 analog: complex-scalar Helmholtz solve.

Counterpart of petsctpu's examples/ex11_complex.py. Reference:
src/ksp/ksp/examples/tutorials/ex11.c — solves
    −Δu − σ₁·u + i·σ₂·u = f
on an n×n grid with σ₁=100 and σ₂=10i·h² on the diagonal
(ex11.c:104-118), demonstrating the PETSC_USE_COMPLEX capability.
Golden run:
    python -m petsctpu_torch.examples.ex11_complex -n 6 -norandom \\
        -pc_type none -ksp_monitor_short \\
        -ksp_gmres_cgs_refinement_type refine_always
prints output/ex11_1.out's history (4.62271 … 0.154866, then happy
breakdown <1e-11; 6 iterations; error <1e-12).
"""

from __future__ import annotations

import sys

import numpy as np
import scipy.sparse as sp
import torch

from petsctpu_torch.core.options import Options
from petsctpu_torch.device import resolve_device
from petsctpu_torch.ksp import ksp_solve
from petsctpu_torch.ksp.common import _fmt_short
from petsctpu_torch.mat import aij_from_scipy


def build(n, sigma1, use_random, rng):
    dim = n * n
    h2 = 1.0 / ((n + 1) * (n + 1))
    rows, cols, vals = [], [], []
    for Ii in range(dim):
        i, j = divmod(Ii, n)
        for ci, cj in ((i - 1, j), (i + 1, j), (i, j - 1), (i, j + 1)):
            if 0 <= ci < n and 0 <= cj < n:
                rows.append(Ii)
                cols.append(cj + n * ci)
                vals.append(-1.0 + 0j)
        sigma2 = (rng.uniform() + 1j * rng.uniform()) if use_random \
            else 10.0j
        rows.append(Ii)
        cols.append(Ii)
        vals.append(4.0 - sigma1 * h2 + sigma2 * h2)
    return sp.csr_matrix((vals, (rows, cols)), shape=(dim, dim),
                         dtype=np.complex128)


def main(argv, device=None):
    dev = resolve_device(device)
    opts = Options.from_args(argv)
    n = opts.get_int("n", 6)
    sigma1 = opts.get_real("sigma1", 100.0)
    use_random = not opts.get_bool("norandom", False)
    rng = np.random.default_rng(0)
    A = build(n, sigma1, use_random, rng)
    u = (rng.standard_normal(n * n) + 1j * rng.standard_normal(n * n)) \
        if use_random else np.full(n * n, 0.5 + 0j)
    b = A @ u
    monitor = opts.get_bool("ksp_monitor_short", False)
    refine = opts.get_str("ksp_gmres_cgs_refinement_type", "never")
    Ad = aij_from_scipy(A, dtype=np.complex128, device=dev)
    r = ksp_solve(Ad, torch.from_numpy(b).to(dev), pc=None,
                  ksp_type=opts.get_str("ksp_type", "gmres"),
                  rtol=1e-5, atol=1e-50,
                  cgs_refine="always" if "always" in refine else "never")
    if monitor:
        for k in range(int(r.its) + 1):
            print(f"{k:3d} KSP Residual norm {_fmt_short(r.history[k])} ")
    err = np.linalg.norm(r.x.cpu().numpy() - u)
    etxt = "< 1.e-12" if err < 1e-12 else f"{err:g}"
    print(f"Norm of error {etxt} iterations {int(r.its)}")
    return r


if __name__ == "__main__":
    main(sys.argv[1:])
