"""Linear Laplacian-as-SNES model — snes ex35.

Counterpart of petsctpu/models/laplin.py (host scipy and numpy, as
there).

Reference: src/snes/examples/tutorials/ex35.c — "-Laplacian u = b as a
nonlinear problem": F(x) = A·x − b with A the 2-D 5-point Laplacian
(FormMatrix ex35.c:186: hx/hy-weighted star stencil on an m×m vertex
grid, boundary rows handled by MatZeroRowsColumnsStencil with diagonal
2·(hy/hx + hx/hy)) and b a VecSetRandom RHS (ex35.c:117) drawn from
PETSc's default drand48 stream — replicated bit-exactly by
core.random.Rand48, so the golden monitor streams are reproducible.
The same linear system is solved by every SNES/KSP variant of
runex35..runex35_8 (nrichardson vs richardson-self-scale, ngmres vs
gmres, ncg vs cg, MG vs FAS).
"""

from __future__ import annotations

import numpy as np
import scipy.sparse as sp

from petsctpu_torch.core.random import Rand48


def ex35_matrix(m: int) -> sp.csr_matrix:
    """FormMatrix ex35.c:186 on an m×m DMDA vertex grid, including the
    MatZeroRowsColumnsStencil boundary treatment (zeroed boundary rows
    AND columns, diagonal kept at 2·(hydhx + hxdhy))."""
    hx = 1.0 / (m - 1)
    hy = hx
    hxdhy = hx / hy
    hydhx = hy / hx
    d = 2.0 * (hydhx + hxdhy)

    def idx(i, j):
        return j * m + i

    rows, cols, vals = [], [], []
    bnd = np.zeros(m * m, bool)
    for j in range(m):
        for i in range(m):
            r = idx(i, j)
            if i == 0 or j == 0 or i == m - 1 or j == m - 1:
                bnd[r] = True
                rows.append(r)
                cols.append(r)
                vals.append(d)
            else:
                rows += [r] * 5
                cols += [idx(i, j - 1), idx(i - 1, j), r,
                         idx(i + 1, j), idx(i, j + 1)]
                vals += [-hxdhy, -hydhx, d, -hydhx, -hxdhy]
    A = sp.csr_matrix((vals, (rows, cols)), shape=(m * m, m * m))
    # MatZeroRowsColumns: zero boundary COLUMNS of interior rows too
    A = A.tocoo()
    keep = ~(bnd[A.col] & ~bnd[A.row])
    A = sp.csr_matrix((A.data[keep], (A.row[keep], A.col[keep])),
                      shape=A.shape)
    return A


def ex35_rhs(m: int) -> np.ndarray:
    """VecSetRandom(b, NULL) ex35.c:117: the default drand48 stream in
    natural (single-rank) DMDA ordering."""
    return Rand48().get_values(m * m)
