"""DiaMat — diagonal-offset (DIA) storage.

Counterpart of petsctpu/mat/dia.py (the reference's AIJPERM/CRL
"regularize the layout" idea, src/mat/impls/aij/seq/{csrperm,crl}):
coeffs[d, i] = A[i, i + offsets[d]], zero out of range. No index
arrays: the product streams each diagonal against a shifted x, one
diagonal after another in petsctpu's order (PyTorch ops).

Recipe for an irregular matrix A:
    perm = get_ordering(A, "rcm")
    D, fill = dia_fill(A, perm)           # check band compressibility
    Ad = dia_from_scipy(A, perm=perm)     # solve in permuted space
"""

from __future__ import annotations

import numpy as np
import scipy.sparse as sp
import torch

from petsctpu_torch.device import np_dtype, resolve_device


class DiaMat:
    def __init__(self, coeffs: torch.Tensor, offsets, shape, nnz: int = 0):
        self.coeffs = coeffs                             # [D, n]
        self.offsets = tuple(int(o) for o in offsets)
        self.shape = tuple(shape)
        self.nnz = int(nnz)

    @property
    def dtype(self):
        return self.coeffs.dtype

    @property
    def device(self):
        return self.coeffs.device

    @staticmethod
    def _shift(x, off):
        """z[i] = x[i + off], zero out of range."""
        if off == 0:
            return x
        n = x.shape[0]
        if off > 0:
            return torch.nn.functional.pad(x[off:], (0, min(off, n)))
        return torch.nn.functional.pad(x[:max(n + off, 0)],
                                       (min(-off, n), 0))

    def mult(self, x: torch.Tensor) -> torch.Tensor:
        y = torch.zeros_like(x)
        for d, off in enumerate(self.offsets):
            y = y + self.coeffs[d] * self._shift(x, off)
        return y

    def mult_add(self, x, y):
        return y + self.mult(x)

    def multT(self, x: torch.Tensor) -> torch.Tensor:
        y = torch.zeros_like(x)
        for d, off in enumerate(self.offsets):
            y = y + self._shift(self.coeffs[d] * x, -off)
        return y

    def diagonal(self) -> torch.Tensor:
        for d, off in enumerate(self.offsets):
            if off == 0:
                return self.coeffs[d]
        return torch.zeros(self.shape[0], dtype=self.dtype,
                           device=self.device)

    def rows_sum(self) -> torch.Tensor:
        return torch.sum(self.coeffs, dim=0)

    def flops_per_mult(self) -> float:
        return 2.0 * self.nnz - self.shape[0]

    def traffic_per_mult(self) -> float:
        """Bytes streamed per apply (the roofline denominator)."""
        D, n = self.coeffs.shape
        return (D + 2.0) * n * self.coeffs.element_size()


def dia_fill(A, perm=None) -> tuple:
    """(ndiags, fill_ratio) the DIA conversion would produce."""
    A = sp.csr_matrix(A)
    if perm is not None:
        A = A[perm][:, perm]
    D = len(sp.dia_matrix(A).offsets)
    return D, D * A.shape[0] / max(A.nnz, 1)


def dia_pack(A, dtype=None, perm=None, max_fill: float = 64.0):
    """Host (coeffs [D, n], offsets, n, nnz) of (optionally permuted) A;
    raises when the band fill exceeds max_fill (keep ELL then)."""
    A = sp.csr_matrix(A)
    if perm is not None:
        perm = np.asarray(perm)
        A = A[perm][:, perm]
    n = A.shape[0]
    d = sp.dia_matrix(A)
    D = len(d.offsets)
    if D * n > max_fill * max(A.nnz, 1):
        raise ValueError(f"DIA fill {D * n / max(A.nnz, 1):.1f}x exceeds "
                         f"max_fill={max_fill}; keep ELL for this matrix")
    coeffs = np.zeros((D, n), np_dtype(dtype) or d.data.dtype)
    Ac = A.tocoo()
    # each entry's diagonal: its offset's index in d.offsets
    offs = np.asarray(d.offsets, np.int64)
    order = np.argsort(offs, kind="stable")
    k = order[np.searchsorted(offs[order], Ac.col.astype(np.int64) - Ac.row)]
    coeffs[k, Ac.row] = Ac.data
    return coeffs, tuple(int(o) for o in d.offsets), n, int(A.nnz)


def dia_from_scipy(A, dtype=None, perm=None, max_fill: float = 64.0,
                   device=None) -> DiaMat:
    dev = resolve_device(device)
    coeffs, offsets, n, nnz = dia_pack(A, dtype, perm, max_fill)
    return DiaMat(torch.from_numpy(coeffs).to(dev), offsets, (n, n), nnz)
