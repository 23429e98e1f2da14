"""Matrix wrappers (the part of petsctpu/mat/base.py on the solve path).

Ported: `Transpose` (MATTRANSPOSE, used by ksp_solve_transpose) and the
host helper `csr_submatrix_keep_zeros` (the bjacobi/ASM subdomain
matrices); the other wrappers are ROADMAP queue 1 item 3.
"""

from __future__ import annotations

import numpy as np
import scipy.sparse as sp


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
