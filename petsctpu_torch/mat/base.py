"""Matrix wrappers (the part of petsctpu/mat/base.py on the solve path).

Ported: `Shell` (MATSHELL, the Eisenstat system's operator),
`Transpose` (MATTRANSPOSE, used by ksp_solve_transpose), `Normal`
(MATNORMAL, CGNE's operator) and the host helpers
`csr_submatrix_keep_zeros` (the bjacobi/ASM subdomain matrices and
fieldsplit's blocks) and `mat_zero_rows` (ksp ex49's Dirichlet rows);
the other wrappers are ROADMAP queue 1 item 3.
"""

from __future__ import annotations

import numpy as np
import scipy.sparse as sp


class Shell:
    """User-callback operator (MATSHELL, src/mat/impls/shell): y =
    mult_fn(ctx, x), ctx any object (the tensors the callback reads);
    multT_fn, when given, is the transpose product."""

    def __init__(self, ctx, mult_fn, shape, multT_fn=None):
        self.ctx = ctx
        self.mult_fn = mult_fn
        self.multT_fn = multT_fn
        self.shape = tuple(shape)

    def mult(self, x):
        return self.mult_fn(self.ctx, x)

    def multT(self, x):
        if self.multT_fn is None:
            raise NotImplementedError("this Shell has no transpose product")
        return self.multT_fn(self.ctx, x)


class Transpose:
    """Implicit Aᵀ (MatCreateTranspose): mult ↔ multT."""

    def __init__(self, A):
        self.A = A

    @property
    def shape(self):
        return self.A.shape[::-1]

    @property
    def dtype(self):
        return self.A.dtype

    @property
    def device(self):
        return self.A.device

    def mult(self, x):
        return self.A.multT(x)

    def multT(self, x):
        return self.A.mult(x)


class Normal:
    """Implicit AᵀA (MATNORMAL, src/mat/impls/normal)."""

    def __init__(self, A):
        self.A = A

    @property
    def shape(self):
        n = self.A.shape[1]
        return (n, n)

    @property
    def dtype(self):
        return self.A.dtype

    @property
    def device(self):
        return self.A.device

    def mult(self, x):
        return self.A.multT(self.A.mult(x))

    multT = mult


def csr_submatrix_keep_zeros(A, rows, cols) -> sp.csr_matrix:
    """A[rows][:, cols] keeping explicitly stored zeros, as the
    reference's MatGetSubMatrix does (scipy's fancy indexing prunes
    them, and ILU(0)/ICC of a subdomain factor on the stored pattern).
    Each row's entries come in ascending new column, entries of equal
    column in stored order: petsctpu/mat/base.py's row loop, vectorized
    over the rows."""
    A = sp.csr_matrix(A)
    rows = np.asarray(rows, dtype=np.int64)
    cols = np.asarray(cols, dtype=np.int64)
    colmap = np.full(A.shape[1], -1, dtype=np.int64)
    colmap[cols] = np.arange(cols.size)
    starts, lens = A.indptr[rows], np.diff(A.indptr)[rows]
    out_row = np.repeat(np.arange(rows.size), lens)
    first = np.repeat(np.cumsum(lens) - lens, lens)
    src = np.repeat(starts, lens) + np.arange(out_row.size) - first
    cj = colmap[A.indices[src]]
    keep = cj >= 0
    out_row, cj, src = out_row[keep], cj[keep], src[keep]
    order = np.lexsort((cj, out_row))
    indptr = np.zeros(rows.size + 1, dtype=np.int64)
    indptr[1:] = np.cumsum(np.bincount(out_row, minlength=rows.size))
    return sp.csr_matrix((A.data[src[order]], cj[order], indptr),
                         shape=(rows.size, cols.size))


def mat_zero_rows(A, rows, diag=1.0) -> sp.csr_matrix:
    """MatZeroRows_SeqAIJ (aij.c:1642) default semantics: each listed
    row is compressed to its diagonal entry alone (value `diag`);
    without MAT_KEEP_NONZERO_PATTERN the off-diagonal slots leave the
    pattern, which changes a later ILU(0)/ICC's fill. The other rows are
    copied whole. petsctpu/mat/base.py's row loop, vectorized; returns a
    new scipy CSR."""
    A = sp.csr_matrix(A)
    rows = np.unique(np.asarray(rows, dtype=np.int64))
    m = A.shape[0]
    mask = np.zeros(m, bool)
    mask[rows] = True
    lens = np.diff(A.indptr)
    row_of = np.repeat(np.arange(m), lens)
    keep = ~mask[row_of]
    counts = np.where(mask, 1, lens)
    indptr = np.zeros(m + 1, np.int64)
    indptr[1:] = np.cumsum(counts)
    ind = np.empty(int(indptr[-1]), A.indices.dtype)
    val = np.empty(int(indptr[-1]), A.dtype)
    src = np.flatnonzero(keep)
    dst = indptr[row_of[src]] + (src - A.indptr[row_of[src]])
    ind[dst] = A.indices[src]
    val[dst] = A.data[src]
    ind[indptr[rows]] = rows
    val[indptr[rows]] = diag
    return sp.csr_matrix((val, ind, indptr), shape=A.shape)
