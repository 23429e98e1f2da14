"""Complete sparse LU and the level-scheduled triangular solve.

Counterpart of the LU part of petsctpu/mat/factor.py (reference:
MatLUFactorNumeric + MatSolve, src/mat/impls/aij/seq/aijfact.c). The
numeric factorization runs on the host at PCSetUp time (scipy's SuperLU,
COLAMD column order, no equilibration, no refinement). The triangular
solves run on the device by level scheduling: rows are grouped into
dependency levels (wavefronts), and all rows of a level solve together
as an ELL gather, a multiply, a row sum and an update; a Python loop
walks the levels. ILU/ICC numerics and the band and dense plans are
ROADMAP queue 1 item 5.
"""

from __future__ import annotations

import numpy as np
import scipy.sparse as sp
import scipy.sparse.linalg as spla
import torch

from petsctpu_torch.device import np_dtype, resolve_device


def lu_factor(A):
    """Complete sparse LU via SuperLU with permutations, as (L, U,
    perm_r, perm_c): x = Pc U⁻¹ L⁻¹ Pr b."""
    A = sp.csc_matrix(A)
    lu = spla.splu(A, permc_spec="COLAMD",
                   options=dict(Equil=False, IterRefine="NOREFINE"))
    L = sp.csr_matrix(lu.L)          # unit lower (diag stored = 1)
    U = sp.csr_matrix(lu.U)
    return L, U, lu.perm_r, lu.perm_c


def cholesky_factor(A):
    """Sparse Cholesky via LU of an SPD matrix (no pivoting needed)."""
    return lu_factor(A)


def _levels(T: sp.csr_matrix, lower: bool) -> np.ndarray:
    """Dependency level of each row for a triangular solve."""
    n = T.shape[0]
    lev = np.zeros(n, dtype=np.int64)
    ai, aj = T.indptr, T.indices
    order = range(n) if lower else range(n - 1, -1, -1)
    for i in order:
        deps = aj[ai[i]:ai[i + 1]]
        deps = deps[deps < i] if lower else deps[deps > i]
        if len(deps):
            lev[i] = lev[deps].max() + 1
    return lev


class SpTRSVPlan:
    """Level-scheduled triangular solve: x = T⁻¹ b.

    level_rows: int64 [nlev, rmax] rows per level (padding = n sentinel)
    cols/vals : ELL off-diagonal entries per row [n+1, K] (padding col =
                n, val 0; row n is the sentinel's)
    dinv      : 1/diag per row [n] (1 for unit diagonal)
    """

    def __init__(self, level_rows, cols, vals, dinv, n: int, nlev: int):
        self.level_rows = level_rows
        self.cols = cols
        self.vals = vals
        self.dinv = dinv
        self.n = n
        self.nlev = nlev

    def solve(self, b: torch.Tensor) -> torch.Tensor:
        n = self.n
        x = torch.zeros(n + 1, dtype=b.dtype, device=b.device)
        one = torch.ones(1, dtype=b.dtype, device=b.device)
        bp = torch.cat([b, torch.zeros_like(one)])
        dinv = torch.cat([self.dinv, one])
        for rows in self.level_rows:
            acc = torch.sum(self.vals[rows] * x[self.cols[rows]], dim=1)
            x[rows] = (bp[rows] - acc) * dinv[rows]
        return x[:n]


def make_sptrsv_plan(T, lower: bool, unit_diag: bool, dtype=None,
                     device=None) -> SpTRSVPlan:
    """Build a device plan from a scipy triangular matrix."""
    dev = resolve_device(device)
    T = sp.csr_matrix(T)
    T.sort_indices()
    n = T.shape[0]
    lev = _levels(T, lower)
    nlev = int(lev.max()) + 1 if n > 0 else 1
    dtype = np_dtype(dtype) or T.dtype

    # group rows by level, padded with sentinel n: a stable argsort by
    # level gives each level's rows in ascending row order
    counts = np.bincount(lev, minlength=nlev)
    rmax = max(int(counts.max()), 1)
    level_rows = np.full((nlev, rmax), n, dtype=np.int64)
    order = np.argsort(lev, kind="stable") if n else np.zeros(0, np.int64)
    starts = np.zeros(nlev + 1, np.int64)
    starts[1:] = np.cumsum(counts)
    pos = np.arange(n) - starts[lev[order]] if n else order
    level_rows[lev[order], pos] = order

    # off-diagonal ELL (padding col = n → reads the scratch slot, val 0)
    ai, aj, av = T.indptr, T.indices, T.data
    diag = np.ones(n, dtype=dtype)
    rows_all = np.repeat(np.arange(n), np.diff(ai))
    is_diag = aj == rows_all
    if not unit_diag and is_diag.any():
        diag[rows_all[is_diag]] = av[is_diag]
    keep = ~is_diag
    rk = rows_all[keep]
    off_counts = np.bincount(rk, minlength=n)
    K = max(int(off_counts.max()) if n else 0, 1)
    cols = np.full((n + 1, K), n, dtype=np.int64)
    vals = np.zeros((n + 1, K), dtype=dtype)
    row_start = np.zeros(n + 1, np.int64)
    row_start[1:] = np.cumsum(off_counts)
    slot = np.arange(len(rk)) - row_start[rk] if len(rk) else rk
    cols[rk, slot] = aj[keep]
    vals[rk, slot] = av[keep]
    dinv = (1.0 / diag).astype(dtype)
    return SpTRSVPlan(torch.from_numpy(level_rows).to(dev),
                      torch.from_numpy(cols).to(dev),
                      torch.from_numpy(vals).to(dev),
                      torch.from_numpy(dinv).to(dev), n, nlev)
