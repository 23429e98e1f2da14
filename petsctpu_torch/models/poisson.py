"""Model problems: structured Laplacians (KSP ex2 / ex45 analogs).

A copy of the builders in petsctpu/models/poisson.py that the solve
path uses; they reproduce the exact linear systems of the reference
tutorials:
  * ex2 (src/ksp/ksp/examples/tutorials/ex2.c:90-100): 2-D 5-point
    Laplacian on an m×n grid, natural ordering Ii = i*n + j, diag 4,
    off-diag -1, exact solution = ones, b = A·1.
  * ex45 (3-D 7-point Poisson, src/ksp/ksp/examples/tutorials/ex45.c):
    built here in the same natural ordering with diag 6.
Matrices are built host-side with scipy and converted to device
formats by callers.
"""

from __future__ import annotations

import numpy as np
import scipy.sparse as sp


def laplacian_2d(m: int, n: int, dtype=np.float64):
    """5-point 2-D Laplacian, natural ordering (row-major in i)."""
    N = m * n
    Ii = np.arange(N)
    i = Ii // n
    j = Ii - i * n
    rows, cols, vals = [Ii], [Ii], [np.full(N, 4.0, dtype)]
    for cond, off in ((i > 0, -n), (i < m - 1, n), (j > 0, -1), (j < n - 1, 1)):
        r = Ii[cond]
        rows.append(r)
        cols.append(r + off)
        vals.append(np.full(len(r), -1.0, dtype))
    A = sp.coo_matrix((np.concatenate(vals),
                       (np.concatenate(rows), np.concatenate(cols))),
                      shape=(N, N)).tocsr()
    return A


def poisson_3d(m: int, n: int, p: int, dtype=np.float64):
    """7-point 3-D Laplacian (ex45-style), natural ordering Ii=(k*n+j)*m+i
    flattened as i fastest."""
    N = m * n * p
    Ii = np.arange(N)
    i = Ii % m
    j = (Ii // m) % n
    k = Ii // (m * n)
    rows, cols, vals = [Ii], [Ii], [np.full(N, 6.0, dtype)]
    for cond, off in ((i > 0, -1), (i < m - 1, 1),
                      (j > 0, -m), (j < n - 1, m),
                      (k > 0, -m * n), (k < p - 1, m * n)):
        r = Ii[cond]
        rows.append(r)
        cols.append(r + off)
        vals.append(np.full(len(r), -1.0, dtype))
    A = sp.coo_matrix((np.concatenate(vals),
                       (np.concatenate(rows), np.concatenate(cols))),
                      shape=(N, N)).tocsr()
    return A


def ex2_system(m: int = 8, n: int = 7, dtype=np.float64):
    """The ex2 linear system: A, b = A·1, u_exact = 1 (ex2.c:146-148)."""
    A = laplacian_2d(m, n, dtype)
    u = np.ones(m * n, dtype)
    b = A @ u
    return A, b, u


def ex45_system(m: int = 8, n: int = 8, p: int = 8, dtype=np.float64):
    A = poisson_3d(m, n, p, dtype)
    u = np.ones(m * n * p, dtype)
    b = A @ u
    return A, b, u
