"""BAIJ — blocked sparse (BSR) for multi-DOF-per-node PDEs.

Counterpart of petsctpu/mat/bsr.py (reference: SeqBAIJ/MPIBAIJ,
src/mat/impls/baij — MatMult_SeqBAIJ_4 baij2.c:387). The layout is
petsctpu's block-ELL: brows = m/bs block rows padded to width K,

  cols [brows, K]        int32 block-column indices
  vals [brows, K, bs, bs] dense blocks (row-major within a block)

so the two packages hold the same arrays. The products are PyTorch ops,
as petsctpu's are XLA code: `mult` gathers x's blocks and sums their
products with the blocks over (k, j); `multT` adds each slot's block
product into its block column in slot order through a fold plan
(mat/fold.py), the order of petsctpu's scatter-add, deterministic on
the card. Both take products and sums, not einsum, whose batched gemv
is 2-4× slower at ex55's 1 M block rows, and gather single values
through scalar indices (scripts/bench_formats.py).

SellBAIJ runs the forward product through the scalar SELL kernel K2
(ops/sell_spmv.py) on the block-expanded pattern and keeps the blocked
metadata (diagonal blocks, multT) on its BAIJ.
"""

from __future__ import annotations

import numpy as np
import scipy.sparse as sp
import torch

from petsctpu_torch.device import np_dtype, resolve_device
from petsctpu_torch.mat.fold import FoldPlan, fold_plan


class BAIJ:
    """Block-ELL; shape is the scalar (m, n), nnz the scalar nonzeros."""

    def __init__(self, cols: torch.Tensor, vals: torch.Tensor, shape,
                 bs: int = 1, nnz: int = 0):
        self.cols = cols
        self.vals = vals
        self.shape = tuple(shape)
        self.bs = int(bs)
        self.nnz = int(nnz)
        self._fold = None
        self._xidx = None

    @property
    def dtype(self):
        return self.vals.dtype

    @property
    def device(self):
        return self.vals.device

    @property
    def brows(self):
        return self.cols.shape[0]

    def mult(self, x: torch.Tensor) -> torch.Tensor:
        """y = A x for a flat scalar x [n]."""
        g = x[block_index(self, self.cols)]             # [brows, K, bs]
        return (self.vals * g[:, :, None, :]).sum((1, 3)).reshape(-1)

    def mult_add(self, x, y):
        return y + self.mult(x)

    def transpose_fold(self) -> FoldPlan:
        """multT's fold plan over the block columns, without the slots
        whose block is zero (the padding)."""
        if self._fold is None:
            self._fold = fold_plan(
                self.cols, keep=(self.vals != 0).flatten(2).any(2))
        return self._fold

    def multT(self, x: torch.Tensor) -> torch.Tensor:
        bs = self.bs
        contrib = (self.vals * x.reshape(-1, bs)[:, None, :, None]).sum(2)
        out = torch.zeros(self.shape[1] // bs, bs, dtype=self.dtype,
                          device=self.device)
        return self.transpose_fold().fold(
            out, contrib.reshape(-1, bs)).reshape(-1)

    def _own(self) -> torch.Tensor:
        rows = torch.arange(self.brows, device=self.device)[:, None]
        return (self.cols == rows)[..., None, None]

    def diag_blocks(self) -> torch.Tensor:
        """Dense bs×bs diagonal blocks [brows, bs, bs] (for PBJacobi)."""
        zero = torch.zeros((), dtype=self.dtype, device=self.device)
        return torch.sum(torch.where(self._own(), self.vals, zero), dim=1)

    def diagonal(self) -> torch.Tensor:
        return torch.diagonal(self.diag_blocks(), dim1=1, dim2=2).reshape(-1)

    def flops_per_mult(self) -> float:
        return 2.0 * self.nnz - self.shape[0]


def block_index(M, cols: torch.Tensor) -> torch.Tensor:
    """The scalar indices [brows, K, bs] of x's entries in each slot's
    block column cols (block column · bs + lane), built at the first
    product of a block-ELL operator M (BAIJ, SBAIJ) and kept on it."""
    if M._xidx is None:
        lane = torch.arange(M.bs, device=cols.device)
        M._xidx = cols.to(torch.int64)[..., None] * M.bs + lane
    return M._xidx


class SellBAIJ(BAIJ):
    """A BAIJ whose forward product is K2 on the block-expanded scalar
    pattern `sell` (petsctpu's TPU route, where the scalar SELL kernel is
    the blocked fast path); multT and the diagonal blocks stay BAIJ's."""

    def __init__(self, base: BAIJ, sell):
        super().__init__(base.cols, base.vals, base.shape, base.bs, base.nnz)
        self.sell = sell

    def mult(self, x):
        return self.sell.mult(x)

    def block_ops(self) -> BAIJ:
        """A BAIJ on the same arrays: the forward product by block ops."""
        return BAIJ(self.cols, self.vals, self.shape, self.bs, self.nnz)


def baij_pack(A, bs: int = None, dtype=None):
    """Host block-ELL pack, petsctpu's: (cols int32 [brows, K], vals
    [brows, K, bs, bs], the BSR matrix, scalar nnz)."""
    if not sp.issparse(A):
        A = sp.csr_matrix(np.asarray(A))
    if bs is None and hasattr(A, "blocksize"):
        bs = A.blocksize[0]
    B = sp.bsr_matrix(A, blocksize=(bs, bs))
    B.sum_duplicates()
    brows = B.shape[0] // bs
    row_nnz = np.diff(B.indptr)
    K = max(int(row_nnz.max()) if brows > 0 else 0, 1)
    cols = np.zeros((brows, K), dtype=np.int32)
    vals = np.zeros((brows, K, bs, bs), dtype=np_dtype(dtype) or B.dtype)
    slot = np.arange(B.indptr[-1]) - np.repeat(B.indptr[:-1], row_nnz)
    rr = np.repeat(np.arange(brows), row_nnz)
    cols[rr, slot] = B.indices
    vals[rr, slot] = B.data.astype(vals.dtype)
    return cols, vals, B, int((B.data != 0).sum())


def baij_from_scipy_bsr(A, bs: int = None, dtype=None, fmt: str = "auto",
                        device=None):
    """Build from scipy (any format), converted to BSR with block size
    bs. fmt "auto" takes SellBAIJ for fp32 SELL-viable operators on the
    card (K2 is the counterpart of the TPU kernel petsctpu gates its
    route on) and the BAIJ on the CPU, as petsctpu keeps off the TPU;
    "sell" forces K2 (fp32 only), "ell" the block ops."""
    from petsctpu_torch.mat.sell import sell_if_viable

    dev = resolve_device(device)
    cols, vals, B, nnz = baij_pack(A, bs, dtype)
    bs = B.blocksize[0]
    base = BAIJ(torch.from_numpy(cols).to(dev),
                torch.from_numpy(vals).to(dev), B.shape, bs, nnz)
    f32 = vals.dtype == np.float32
    if fmt == "sell" and not f32:
        raise ValueError("fmt='sell' needs float32 (K2's dtype)")
    if f32 and (fmt == "sell" or (fmt == "auto" and dev.type == "cuda")):
        # the expansion keeps the explicit zeros inside blocks, as
        # petsctpu's sp.csr_matrix(B) does
        M = sell_if_viable(sp.csr_matrix(B), device=dev)
        if M is not None:
            return SellBAIJ(base, M)
        if fmt == "sell":
            raise ValueError("fmt='sell': operator not SELL-viable")
    return base
