"""KSP ex9 analog: two linear systems solved in alternation.

Counterpart of petsctpu's examples/ex9.py. Reference:
src/ksp/ksp/examples/tutorials/ex9.c — per-solver options prefixes (the
second solver reads `s2_`-prefixed keys), KSPSetInitialGuessNonzero
reuse of the previous solution, and repeated re-assembly/re-solve.
Golden run:
    python -m petsctpu_torch.examples.ex9 -t 2 -pc_type jacobi \\
        -ksp_monitor_short -ksp_type gmres \\
        -ksp_gmres_cgs_refinement_type refine_always \\
        -s2_ksp_type bcgs -s2_pc_type jacobi -s2_ksp_monitor_short
reproduces output/ex9_1.out's four monitor histories (system 1
converges at iteration 0 in round 2 thanks to the nonzero guess).
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
from petsctpu_torch.pc import make_pc


def grid5pt(m, n, diag):
    N = m * n
    rows, cols, vals = [], [], []
    for Ii in range(N):
        i, j = divmod(Ii, n)
        for ci, cj in ((i - 1, j), (i + 1, j), (i, j - 1), (i, j + 1)):
            if 0 <= ci < m and 0 <= cj < n:
                rows.append(Ii)
                cols.append(cj + n * ci)
                vals.append(-1.0)
        rows.append(Ii)
        cols.append(Ii)
        vals.append(diag)
    return sp.csr_matrix((vals, (rows, cols)), shape=(N, N))


def nonsym(m, n, t):
    N = m * n
    rows, cols, vals = [], [], []
    for Ii in range(N):
        i = Ii // n
        if i > 0:
            rows.append(Ii)
            cols.append(Ii - n)
            vals.append(-1.0 * (t + 0.5))
    return sp.csr_matrix((vals, (rows, cols)), shape=(N, N))


def print_history(res, prefix=""):
    for k in range(int(res.its) + 1):
        print(f"{prefix}{k:3d} KSP Residual norm "
              f"{_fmt_short(res.history[k])} ")


def main(argv, device=None):
    """Returns the last round's two results."""
    dev = resolve_device(device)
    opts = Options.from_args(argv)
    ntimes = opts.get_int("t", 2)
    m, n = 3, 2
    u = np.arange(6.0)
    s2 = opts.prefixed("s2_")
    x1 = torch.zeros(6, dtype=torch.float64, device=dev)
    out = None
    for t in range(ntimes):
        C1 = (grid5pt(m, n, 4.0) + nonsym(m, n, t)).tocsr()
        Ad = aij_from_scipy(C1, device=dev)
        pc = make_pc(opts.get_str("pc_type", "jacobi"), A=Ad, A_host=C1)
        refine = opts.get_str("ksp_gmres_cgs_refinement_type", "never")
        r = ksp_solve(Ad, torch.from_numpy(C1 @ u).to(dev), x0=x1, pc=pc,
                      ksp_type=opts.get_str("ksp_type", "gmres"),
                      rtol=1e-5, atol=1e-50,
                      cgs_refine="always" if "always" in refine else
                      "never", guess_nonzero=(t > 0))
        if opts.get_bool("ksp_monitor_short", False):
            print_history(r)
        x1 = r.x
        C2 = (grid5pt(m, n, 6.0 + t * 0.5) + nonsym(m, n, t)).tocsr()
        Ad2 = aij_from_scipy(C2, device=dev)
        pc2 = make_pc(s2.get_str("pc_type", "jacobi"), A=Ad2, A_host=C2)
        r2 = ksp_solve(Ad2, torch.from_numpy(C2 @ u).to(dev), pc=pc2,
                       ksp_type=s2.get_str("ksp_type", "bcgs"),
                       rtol=1e-5, atol=1e-50)
        if s2.get_bool("ksp_monitor_short", False):
            print("  Residual norms for s2_ solve.")
            print_history(r2)
        out = (r, r2)
    return out


if __name__ == "__main__":
    main(sys.argv[1:])
