"""AIJ — the core sparse matrix format, ELL-packed.

The reference's foundational format is CSR ("SeqAIJ",
src/mat/impls/aij/seq/aij.c — MatMult_SeqAIJ :1173). The layout is
petsctpu's: every row padded to a fixed width K (cols[m,K],
vals[m,K]), so SpMV is a gather, a multiply and a row sum. That keeps
the two packages on the same packed arrays; on the card it is plain
PyTorch (the JAX package leaves it to XLA, not to a kernel).

Padding convention: col = 0, val = 0 (padding contributes 0·x[0]).
"""

from __future__ import annotations

import numpy as np
import scipy.sparse as sp
import torch

from petsctpu_torch.device import np_dtype, resolve_device


class AIJ:
    """ELL-packed general sparse matrix (device-resident).

    cols : int64 [m, K]  column index per slot (0 for padding)
    vals : float [m, K]  value per slot (0 for padding)
    shape: (m, n)
    nnz  : true nonzero count (for flop accounting)
    """

    def __init__(self, cols: torch.Tensor, vals: torch.Tensor, shape,
                 nnz: int = 0):
        self.cols = cols
        self.vals = vals
        self.shape = tuple(shape)
        self.nnz = nnz

    @property
    def dtype(self):
        return self.vals.dtype

    @property
    def device(self):
        return self.vals.device

    # -- core ops -------------------------------------------------------
    def mult(self, x: torch.Tensor) -> torch.Tensor:
        """y = A x  (MatMult analog). Gather + multiply + row reduce."""
        return torch.sum(self.vals * x[self.cols], dim=1)

    def multT(self, x: torch.Tensor) -> torch.Tensor:
        """y = Aᵀ x (MatMultTranspose): scatter-add into columns."""
        contrib = (self.vals * x[:, None]).reshape(-1)
        y = torch.zeros(self.shape[1], dtype=self.dtype, device=self.device)
        return y.index_add_(0, self.cols.reshape(-1), contrib)

    def _on_diag(self) -> torch.Tensor:
        rows = torch.arange(self.shape[0], device=self.device)[:, None]
        return self.cols == rows

    def diagonal(self) -> torch.Tensor:
        """MatGetDiagonal. Padding (col 0, val 0) cannot corrupt row 0's sum."""
        zero = torch.zeros((), dtype=self.dtype, device=self.device)
        return torch.sum(torch.where(self._on_diag(), self.vals, zero), dim=1)

    def scale(self, a) -> "AIJ":
        return AIJ(self.cols, self.vals * a, self.shape, self.nnz)

    def diag_scale(self, left=None, right=None) -> "AIJ":
        """MatDiagonalScale: A ← diag(left) A diag(right)."""
        v = self.vals
        if right is not None:
            v = v * right[self.cols]
        if left is not None:
            v = v * left[:, None]
        return AIJ(self.cols, v, self.shape, self.nnz)

    def shift_diag(self, a) -> "AIJ":
        """A ← A + a·I, assuming the diagonal exists in the pattern
        (the reference's MatShift fast path). Only the FIRST diagonal
        slot of each row is shifted."""
        on_diag = self._on_diag()
        first = on_diag & (torch.cumsum(on_diag.to(torch.int32), dim=1) == 1)
        return AIJ(self.cols, torch.where(first, self.vals + a, self.vals),
                   self.shape, self.nnz)

    def rows_sum(self) -> torch.Tensor:
        return torch.sum(self.vals, dim=1)

    def mult_dense(self, X: torch.Tensor) -> torch.Tensor:
        """Y = A X for dense X [n, k]: gathers X rows then contracts."""
        return torch.einsum("mK,mKk->mk", self.vals, X[self.cols])

    def flops_per_mult(self) -> float:
        """Reference flop convention 2*nnz - nrows (aij.c:1219)."""
        return 2.0 * self.nnz - self.shape[0]


# ---- host converters ---------------------------------------------------------
def aij_pack(A, dtype=None, min_width: int = 1):
    """Host-side ELL pack: (cols int32 [m,K], vals [m,K], shape, nnz)."""
    A = sp.csr_matrix(A)
    A.sum_duplicates()
    m, n = A.shape
    row_nnz = np.diff(A.indptr)
    K = max(int(row_nnz.max()) if m > 0 else 0, min_width)
    cols = np.zeros((m, K), dtype=np.int32)
    vals = np.zeros((m, K), dtype=np_dtype(dtype) or A.dtype)
    # vectorized ELL pack: slot index within each row
    slot = np.arange(A.nnz) - np.repeat(A.indptr[:-1], row_nnz)
    rows_expanded = np.repeat(np.arange(m), row_nnz)
    cols[rows_expanded, slot] = A.indices
    vals[rows_expanded, slot] = A.data.astype(vals.dtype)
    return cols, vals, (m, n), int(A.nnz)


def aij_from_scipy(A, dtype=None, min_width: int = 1, device=None) -> AIJ:
    """Build a device AIJ from any scipy.sparse matrix."""
    dev = resolve_device(device)
    cols, vals, shape, nnz = aij_pack(A, dtype=dtype, min_width=min_width)
    return AIJ(torch.from_numpy(cols).to(dev, torch.int64),
               torch.from_numpy(vals).to(dev), shape, nnz)


def aij_to_scipy(A: AIJ):
    """Back to scipy CSR (drops explicit padding zeros)."""
    cols = A.cols.cpu().numpy()
    vals = A.vals.cpu().numpy()
    m, K = cols.shape
    rows = np.repeat(np.arange(m), K)
    mask = vals.ravel() != 0
    coo = sp.coo_matrix((vals.ravel()[mask], (rows[mask], cols.ravel()[mask])),
                        shape=A.shape)
    return coo.tocsr()
