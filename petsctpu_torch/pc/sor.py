"""SOR/SSOR preconditioners, scalar and inode-blocked.

Counterpart of petsctpu/pc/sor.py (reference: PCSOR, src/ksp/pc/impls/
sor, delegating to MatSOR, src/mat/impls/aij/seq/aij.c:1463, and
MatSOR_SeqAIJ_Inode, inode.c:2757). A Gauss-Seidel sweep is a
triangular solve in disguise,

    x ← (D/ω + L)⁻¹ (b − U x + ((1−ω)/ω) D x),

so SORPC runs each sweep as one SpTRSV launch (ops/sptrsv.py) plus an
ELL product (AIJ.mult). InodeSORPC's block sweep applies each inode's
small dense inverse block, which is not the SpTRSV form: it stays a
PyTorch loop over the inode levels (a later kernel, ROADMAP).
"""

from __future__ import annotations

import numpy as np
import scipy.sparse as sp
import torch

from petsctpu_torch.device import np_dtype, resolve_device
from petsctpu_torch.mat.ell import aij_from_scipy
from petsctpu_torch.mat.factor import make_sptrsv_plan


class SORPC:
    """fwd_plan (D/ω + L)⁻¹, bwd_plan (D/ω + U)⁻¹, U_ell/L_ell the
    strict triangles as AIJ, diag the diagonal; `sweeps` forward sweeps,
    each followed by a backward one when symmetric."""

    def __init__(self, fwd_plan, bwd_plan, U_ell, L_ell, diag,
                 omega: float = 1.0, sweeps: int = 1, symmetric: bool = True):
        self.fwd_plan = fwd_plan
        self.bwd_plan = bwd_plan
        self.U_ell = U_ell
        self.L_ell = L_ell
        self.diag = diag
        self.omega = omega
        self.sweeps = sweeps
        self.symmetric = symmetric

    def apply(self, b):
        w = self.omega
        x = torch.zeros_like(b)
        gd = ((1.0 - w) / w) * self.diag
        for _ in range(self.sweeps):
            x = self.fwd_plan.solve(b - self.U_ell.mult(x) + gd * x)
            if self.symmetric:
                x = self.bwd_plan.solve(b - self.L_ell.mult(x) + gd * x)
        return x


def make_sor(A_host, omega: float = 1.0, sweeps: int = 1,
             symmetric: bool = True, dtype=None, device=None) -> SORPC:
    dev = resolve_device(device)
    A = sp.csr_matrix(A_host)
    L = sp.tril(A, k=-1, format="csr")
    U = sp.triu(A, k=1, format="csr")
    d = A.diagonal()
    Dw = sp.diags(d / omega)
    fwd = make_sptrsv_plan((Dw + L).tocsr(), lower=True, unit_diag=False,
                           dtype=dtype, device=dev)
    bwd = make_sptrsv_plan((Dw + U).tocsr(), lower=False, unit_diag=False,
                           dtype=dtype, device=dev)
    dt = np_dtype(dtype) or d.dtype
    return SORPC(fwd, bwd, aij_from_scipy(U, dtype=dt, device=dev),
                 aij_from_scipy(L, dtype=dt, device=dev),
                 torch.from_numpy(d.astype(dt)).to(dev), float(omega),
                 int(sweeps), bool(symmetric))


class InodeSORPC:
    """Node-blocked Gauss-Seidel (MatSOR_SeqAIJ_Inode): consecutive rows
    with identical column patterns form inodes, each inode's ≤5×5
    diagonal block is inverted once, and a sweep walks the inode levels
    (wavefronts of the block-lower or block-upper DAG), every inode of a
    level at once: member-row gathers over strict block-lower/upper ELL
    slices and a batched [m, s, s] inverse-block product (ω = 1 only, as
    the reference).

    fwd_levels/bwd_levels [nl, imax] inode ids (padding m); members
    [m+1, smax] rows (padding n; the last inode is the padding's);
    invB [m+1, smax, smax]; Lcols/Lvals and Ucols/Uvals [n+1, K] the
    strict block-lower and block-upper ELL (padding col n)."""

    def __init__(self, fwd_levels, bwd_levels, members, invB, Lcols, Lvals,
                 Ucols, Uvals, n: int, sweeps: int = 1,
                 symmetric: bool = True, forward_only: bool = False):
        self.fwd_levels = fwd_levels
        self.bwd_levels = bwd_levels
        self.members = members
        self.invB = invB
        self.Lcols = Lcols
        self.Lvals = Lvals
        self.Ucols = Ucols
        self.Uvals = Uvals
        self.n = n
        self.sweeps = sweeps
        self.symmetric = symmetric
        self.forward_only = forward_only

    def _sweep(self, levels, cols, vals, rhs_of, x):
        """One block sweep; returns (x, t) with t the pre-inverse block
        sums (the reference's ssor_work, the zero-guess backward rhs)."""
        t = x.new_zeros(self.n + 1)
        for ids in levels:                               # [imax]
            rows = self.members[ids]                     # [imax, smax]
            acc = torch.sum(vals[rows] * x[cols[rows]], dim=2)
            rhs = rhs_of(rows) - acc
            xI = torch.einsum("ijk,ik->ij", self.invB[ids], rhs)
            real = rows < self.n                         # JAX's mode="drop"
            x[rows[real]] = xI[real]
            t[rows[real]] = rhs[real]
        return x, t

    def _residual(self, bp, vals, cols, xs):
        def rhs(r):
            return bp[r] - torch.sum(vals[r] * xs[cols[r]], dim=2)
        return rhs

    def apply(self, b):
        bp = torch.cat([b, b.new_zeros(1)])
        x = b.new_zeros(self.n + 1)
        t = bp
        for s in range(self.sweeps):
            if s == 0:
                x, t = self._sweep(self.fwd_levels, self.Lcols, self.Lvals,
                                   lambda r: bp[r], x)
            else:
                # a forward sweep with a guess: rhs = b − Ub x_old (the
                # upper columns keep their pre-sweep values)
                x, t = self._sweep(self.fwd_levels, self.Lcols, self.Lvals,
                                   self._residual(bp, self.Uvals, self.Ucols,
                                                  x.clone()), x)
            if self.symmetric and not self.forward_only:
                if s == 0:
                    # zero-guess SSOR: the backward rhs is the stored
                    # block sums t = b − Lb x_half, so rhs = t − Ub x
                    tt = t
                    x, _ = self._sweep(self.bwd_levels, self.Ucols,
                                       self.Uvals, lambda r: tt[r], x)
                else:
                    x, _ = self._sweep(self.bwd_levels, self.Ucols,
                                       self.Uvals,
                                       self._residual(bp, self.Lvals,
                                                      self.Lcols,
                                                      x.clone()), x)
        return x[:self.n]


def _block_levels(C: sp.csr_matrix, lower: bool) -> np.ndarray:
    """Wavefront levels of the block DAG of the inode adjacency C (its
    strict lower or upper part): int32 [nlev, imax], padding m."""
    m = C.shape[0]
    T = sp.tril(C, k=-1, format="csr") if lower \
        else sp.triu(C, k=1, format="csr")
    lev = np.zeros(m, np.int64)
    for i in (range(m) if lower else range(m - 1, -1, -1)):
        cs = T.indices[T.indptr[i]:T.indptr[i + 1]]
        if len(cs):
            lev[i] = lev[cs].max() + 1
    nlev = int(lev.max()) + 1 if m else 1
    groups = [np.flatnonzero(lev == lv) for lv in range(nlev)]
    imax = max((len(g) for g in groups), default=1)
    out = np.full((nlev, imax), m, np.int32)
    for lv, g in enumerate(groups):
        out[lv, :len(g)] = g
    return out


def make_inode_sor(A_host, omega: float = 1.0, sweeps: int = 1,
                   symmetric: bool = True, forward_only: bool = False,
                   dtype=None, limit: int = 5, device=None):
    """MatSOR_SeqAIJ_Inode analog; None when the matrix has no inodes or
    a singular block (the caller takes the scalar make_sor) or omega ≠
    1 (the reference refuses it and points to -mat_no_inode)."""
    from petsctpu_torch.mat.coloring import (inode_compress_pattern,
                                             inode_groups)

    if omega != 1.0:
        return None
    A = sp.csr_matrix(A_host)
    A.sort_indices()
    ns = inode_groups(A, limit)
    if ns is None:
        return None
    dev = resolve_device(device)
    n = A.shape[0]
    m = len(ns)
    starts = np.concatenate([[0], np.cumsum(ns)])
    row2node = np.repeat(np.arange(m), ns)
    smax = int(ns.max())
    dt = np_dtype(dtype) or A.dtype

    members = np.full((m + 1, smax), n, np.int32)
    for i in range(m):
        members[i, :ns[i]] = np.arange(starts[i], starts[i + 1])

    # entries split: block-lower (col < inode start), the diagonal
    # block, block-upper (col ≥ inode end)
    coo = A.tocoo()
    rn = row2node[coo.row]
    lo = coo.col < starts[rn]
    hi = coo.col >= starts[rn + 1]
    mid = ~(lo | hi)
    Lb = sp.coo_matrix((coo.data[lo], (coo.row[lo], coo.col[lo])),
                       shape=A.shape).tocsr()
    Ub = sp.coo_matrix((coo.data[hi], (coo.row[hi], coo.col[hi])),
                       shape=A.shape).tocsr()

    # diagonal blocks and their inverses (identity padding)
    B = np.tile(np.eye(smax, dtype=np.float64), (m + 1, 1, 1))
    br, bc, bv = coo.row[mid], coo.col[mid], coo.data[mid]
    B[row2node[br], br - starts[row2node[br]],
      bc - starts[row2node[br]]] = bv
    if np.abs(np.linalg.det(B[:m])).min() < 1e-300:
        return None
    invB = np.linalg.inv(B).astype(dt)

    def ell(T):
        T = T.tocsr()
        K = max(int(np.diff(T.indptr).max()) if T.nnz else 0, 1)
        ci = np.full((n + 1, K), n, np.int32)
        vi = np.zeros((n + 1, K), dt)
        lens = np.diff(T.indptr)
        rows = np.repeat(np.arange(n), lens)
        slot = np.arange(T.nnz) - np.repeat(T.indptr[:-1], lens)
        ci[rows, slot] = T.indices
        vi[rows, slot] = T.data
        return ci, vi

    Lc, Lv = ell(Lb)
    Uc, Uv = ell(Ub)
    C = inode_compress_pattern(A, ns)

    def t(a, dtype_=None):
        return torch.from_numpy(np.asarray(a)).to(dev, dtype_)

    i64 = torch.int64
    return InodeSORPC(t(_block_levels(C, True), i64),
                      t(_block_levels(C, False), i64), t(members, i64),
                      t(invB), t(Lc, i64), t(Lv), t(Uc, i64), t(Uv), n,
                      int(sweeps), bool(symmetric), bool(forward_only))
