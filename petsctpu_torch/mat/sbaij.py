"""SBAIJ — symmetric blocked sparse storage (upper block triangle only).

Counterpart of petsctpu/mat/sbaij.py (reference: SeqSBAIJ,
src/mat/impls/sbaij/seq/sbaij.c — BSR storing only the upper block
triangle; MatMult applies U plus strict(U)ᵀ). petsctpu's block-ELL
layout over block rows: bcols [nb, K] int32, bvals [nb, K, bs, bs],
padded with the row's own block column and a zero block.

`mult` is the upper part (products with x's gathered blocks, summed)
plus the strict part's transpose products added into their block rows
in slot order through a fold plan (mat/fold.py): petsctpu's scatter
order, deterministic on the card. It takes products and sums and
scalar gathers, as BAIJ does (mat/bsr.py). The plan leaves out the
own-row slots, whose transpose contribution is the zero block petsctpu
adds.
"""

from __future__ import annotations

import numpy as np
import scipy.sparse as sp
import torch

from petsctpu_torch.device import np_dtype, resolve_device
from petsctpu_torch.mat.bsr import block_index
from petsctpu_torch.mat.fold import FoldPlan, fold_plan


class SBAIJ:
    """bcols [nb, K], bvals [nb, K, bs, bs], shape (n, n), nnzb the
    stored block count (for flops)."""

    def __init__(self, bcols: torch.Tensor, bvals: torch.Tensor, shape,
                 bs: int = 1, nnzb: int = 0):
        self.bcols = bcols
        self.bvals = bvals
        self.shape = tuple(shape)
        self.bs = int(bs)
        self.nnzb = int(nnzb)
        self._fold = None
        self._xidx = None

    @property
    def dtype(self):
        return self.bvals.dtype

    @property
    def device(self):
        return self.bvals.device

    @property
    def brows(self):
        return self.bvals.shape[0]

    def _own(self) -> torch.Tensor:
        rows = torch.arange(self.brows, device=self.device)[:, None]
        return self.bcols == rows

    def transpose_fold(self) -> FoldPlan:
        """The strict part's fold plan over the block rows."""
        if self._fold is None:
            self._fold = fold_plan(self.bcols, keep=~self._own())
        return self._fold

    @property
    def bvals_strict(self) -> torch.Tensor:
        """Off-diagonal stored blocks only (diagonal slots zeroed)."""
        zero = torch.zeros((), dtype=self.dtype, device=self.device)
        return torch.where(self._own()[..., None, None], zero, self.bvals)

    def mult(self, x: torch.Tensor) -> torch.Tensor:
        bs = self.bs
        g = x[block_index(self, self.bcols)]            # [nb, K, bs]
        y = (self.bvals * g[:, :, None, :]).sum((1, 3))
        contrib = (self.bvals * x.reshape(-1, bs)[:, None, :, None]).sum(2)
        return self.transpose_fold().fold(
            y, contrib.reshape(-1, bs)).reshape(-1)

    multT = mult                                     # symmetric

    def mult_add(self, x, y):
        return y + self.mult(x)

    def diag_blocks(self) -> torch.Tensor:
        zero = torch.zeros((), dtype=self.dtype, device=self.device)
        return torch.sum(torch.where(self._own()[..., None, None],
                                     self.bvals, zero), dim=1)

    def diagonal(self) -> torch.Tensor:
        return torch.diagonal(self.diag_blocks(), dim1=1, dim2=2).reshape(-1)

    def flops_per_mult(self) -> float:
        # each stored off-diagonal block is used twice, the diagonal once
        return 2.0 * (2 * self.nnzb - self.brows) * self.bs * self.bs

    def rows_sum(self) -> torch.Tensor:
        """Row sums of the full (symmetrized) matrix."""
        s_up = torch.sum(self.bvals, dim=(1, 3))                  # [nb, bs]
        colsums = torch.sum(self.bvals, dim=2)                    # [nb, K, bs]
        return self.transpose_fold().fold(
            s_up, colsums.reshape(-1, self.bs)).reshape(-1)


def sbaij_pack(A, bs: int = 1, dtype=None, check_symmetry: bool = True):
    """Host pack, petsctpu's sbaij_from_scipy vectorized: (bcols int32
    [nb, K], bvals [nb, K, bs, bs], n, nnzb); each block row keeps its
    upper slots (c ≥ r) in BSR order, padded with (r, zero block)."""
    A = sp.csr_matrix(A)
    n = A.shape[0]
    assert n % bs == 0 and A.shape[1] == n
    if check_symmetry:
        d = abs(A - A.T)
        if d.nnz and d.max() > 1e-12 * max(abs(A).max(), 1.0):
            raise ValueError("sbaij requires a symmetric matrix")
    Ab = sp.bsr_matrix(A, blocksize=(bs, bs))
    nb = n // bs
    indptr, indices, data = Ab.indptr, Ab.indices, Ab.data
    row = np.repeat(np.arange(nb), np.diff(indptr))
    up = indices >= row
    row, col, blk = row[up], indices[up], data[up]
    counts = np.bincount(row, minlength=nb)
    K = max(1, int(counts.max()) if nb else 0)
    slot = np.arange(row.size) - np.repeat(
        np.concatenate([[0], np.cumsum(counts)[:-1]]), counts)
    bcols = np.repeat(np.arange(nb, dtype=np.int32)[:, None], K, axis=1)
    bvals = np.zeros((nb, K, bs, bs), np_dtype(dtype) or data.dtype)
    bcols[row, slot] = col
    bvals[row, slot] = blk
    return bcols, bvals, n, int(row.size)


def sbaij_from_scipy(A, bs: int = 1, dtype=None, check_symmetry: bool = True,
                     device=None) -> SBAIJ:
    """Build from a (symmetric) scipy matrix, keeping the upper block
    triangle (MatConvert to SBAIJ analog)."""
    dev = resolve_device(device)
    bcols, bvals, n, nnzb = sbaij_pack(A, bs, dtype, check_symmetry)
    return SBAIJ(torch.from_numpy(bcols).to(dev),
                 torch.from_numpy(bvals).to(dev), (n, n), bs, nnzb)
