"""MATNEST — a block matrix of sub-operators, and submatrix extraction.

Counterpart of petsctpu/mat/nest.py (reference: src/mat/impls/nest and
MatGetSubMatrix, src/mat/interface/matrix.c). A Nest keeps its blocks
as independent operators; mult gathers each column field's slice,
applies the blocks of a row field, sums them and writes the row field's
slice. Fields are index sets, contiguous or not.
"""

from __future__ import annotations

import numpy as np
import scipy.sparse as sp
import torch


class Nest:
    """blocks[i][j]: an operator or None; row_is/col_is: int64 index
    tensors of the fields."""

    def __init__(self, blocks, row_is, col_is, n_rows: int, n_cols: int):
        self.blocks = tuple(tuple(r) for r in blocks)
        self.row_is = tuple(row_is)
        self.col_is = tuple(col_is)
        self.n_rows = int(n_rows)
        self.n_cols = int(n_cols)

    @property
    def shape(self):
        return (self.n_rows, self.n_cols)

    def _first_block(self):
        return next(b for row in self.blocks for b in row if b is not None)

    @property
    def dtype(self):
        return self._first_block().dtype

    def mult(self, x):
        y = torch.zeros(self.n_rows, dtype=x.dtype, device=x.device)
        for bi, ris in enumerate(self.row_is):
            acc = None
            for bj, cis in enumerate(self.col_is):
                B = self.blocks[bi][bj]
                if B is not None:
                    v = B.mult(x[cis])
                    acc = v if acc is None else acc + v
            if acc is not None:
                y[ris] = acc
        return y

    def multT(self, x):
        y = torch.zeros(self.n_cols, dtype=x.dtype, device=x.device)
        for bj, cis in enumerate(self.col_is):
            acc = None
            for bi, ris in enumerate(self.row_is):
                B = self.blocks[bi][bj]
                if B is not None:
                    v = B.multT(x[ris])
                    acc = v if acc is None else acc + v
            if acc is not None:
                y[cis] = acc
        return y

    def diagonal(self):
        B0 = self._first_block()
        d = torch.zeros(self.n_rows, dtype=B0.dtype, device=B0.device)
        for bi, ris in enumerate(self.row_is):
            B = self.blocks[bi][bi] if bi < len(self.col_is) else None
            if B is not None:
                d[ris] = B.diagonal()
        return d


def make_nest(blocks, device=None) -> Nest:
    """A Nest from a 2-D list of operators (None = zero block), with
    contiguous fields on the blocks' device (or `device`)."""
    nb, mb = len(blocks), len(blocks[0])
    rs = [next(b.shape[0] for b in row if b is not None) for row in blocks]
    cs = [next(blocks[i][j].shape[1] for i in range(nb)
               if blocks[i][j] is not None) for j in range(mb)]
    dev = device if device is not None else next(
        b for row in blocks for b in row if b is not None).device
    roff = np.concatenate([[0], np.cumsum(rs)]).astype(int)
    coff = np.concatenate([[0], np.cumsum(cs)]).astype(int)
    row_is = tuple(torch.arange(roff[i], roff[i + 1], device=dev)
                   for i in range(nb))
    col_is = tuple(torch.arange(coff[j], coff[j + 1], device=dev)
                   for j in range(mb))
    return Nest(blocks, row_is, col_is, int(roff[-1]), int(coff[-1]))


def get_submatrix(A_host, row_is, col_is=None):
    """MatGetSubMatrix analog (host): A[rows, cols] as scipy CSR."""
    r = np.asarray(row_is.indices if hasattr(row_is, "indices") else row_is)
    c = (np.asarray(col_is.indices if hasattr(col_is, "indices") else col_is)
         if col_is is not None else r)
    return sp.csr_matrix(A_host)[np.ix_(r, c)].tocsr()
