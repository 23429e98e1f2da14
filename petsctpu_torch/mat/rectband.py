"""RectBandMat — slant-band storage for rectangular operators whose
columns advance at a (near-)constant integer rate per row.

Counterpart of petsctpu/mat/rectband.py (plain tensor code there, XLA;
plain PyTorch here). The MG restriction R = Pᵀ is the motivating case
(reference: MatRestrict → MatMultTranspose on the stored prolongator,
mg.c): after GAMG's locality-preserving aggregate numbering
(pc/gamg.py), coarse row j's nonzero columns sit in a window
[s·j + e_j, s·j + e_j + w) of the fine vector with s ≈ n_fine/n_coarse.
Folding e_j into the layout at plan time gives a dense band
B[j, d] = R[j, s·j + off + d], and

    (R r)[j] = Σ_d B[j, d] · r[s·j + off + d]

where the operand window is assembled from ceil(W/s)+1 strided
reshapes of r: no gather at all.
"""

from __future__ import annotations

import numpy as np
import scipy.sparse as sp
import torch

from petsctpu_torch.device import np_dtype, resolve_device


class RectBandMat:
    """B[j, d] = A[j, s*j + off + d]; zero where out of range."""

    def __init__(self, B: torch.Tensor, s: int, off: int, shape, nnz=0):
        self.B = B                  # [m, W]
        self.s = s                  # column slope
        self.off = off              # window offset
        self.shape = tuple(shape)
        self.nnz = nnz

    @property
    def dtype(self):
        return self.B.dtype

    @property
    def device(self):
        return self.B.device

    def _window(self, x):
        m, W = self.B.shape
        s = self.s
        nseg = -(-W // s) + 1
        pad0 = max(0, -self.off)
        need = pad0 + self.off + nseg * s + s * m
        xp = torch.cat([x.new_zeros(pad0), x,
                        x.new_zeros(max(0, need - pad0 - x.shape[0]))])
        lo = pad0 + self.off
        segs = [xp[lo + k * s:lo + k * s + s * m].reshape(m, s)
                for k in range(nseg)]
        return torch.cat(segs, dim=1)[:, :W]

    def mult(self, x):
        return torch.sum(self.B * self._window(x.to(self.dtype)), dim=1)


def rectband_plan(A: sp.csr_matrix):
    """(s, off, W) minimizing the band width, or None if degenerate."""
    A = sp.csr_matrix(A)
    m, n = A.shape
    rows_nnz = np.diff(A.indptr)
    if m == 0 or A.nnz == 0 or rows_nnz.min() == 0:
        return None
    j = np.arange(m)
    lo = A.indices[A.indptr[:-1]].astype(np.int64)
    hi = A.indices[A.indptr[1:] - 1].astype(np.int64)
    best = None
    for s in {max(1, n // m), max(1, -(-n // m))}:
        off = int((lo - s * j).min())
        W = int((hi - s * j).max()) - off + 1
        if best is None or W < best[2]:
            best = (s, off, W)
    return best


def rectband_pack(A, dtype=None, max_fill: float = 8.0):
    """Host-side slant-band pack (B [m, W], s, off), or None when the
    plan is degenerate or the fill m*W/nnz exceeds max_fill."""
    A = sp.csr_matrix(A)
    A.sum_duplicates()
    A.sort_indices()
    plan = rectband_plan(A)
    if plan is None:
        return None
    s, off, W = plan
    m = A.shape[0]
    if m * W > max_fill * max(A.nnz, 1):
        return None
    dt = (np_dtype(dtype) or np.dtype(A.dtype)).type
    B = np.zeros((m, W), dt)
    coo = A.tocoo()
    d = coo.col.astype(np.int64) - s * coo.row.astype(np.int64) - off
    B[coo.row, d] = coo.data.astype(dt)
    return B, s, off


def rectband_from_scipy(A, dtype=None, max_fill: float = 8.0, device=None):
    """Build a RectBandMat, or return None when the slant-band fill
    (m*W/nnz) exceeds max_fill (caller falls back to another format)."""
    packed = rectband_pack(A, dtype, max_fill)
    if packed is None:
        return None
    B, s, off = packed
    return RectBandMat(torch.from_numpy(B).to(resolve_device(device)), s, off,
                       A.shape, int(sp.csr_matrix(A).nnz))
