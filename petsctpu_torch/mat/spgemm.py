"""Sparse matrix-matrix products: SpGEMM and PtAP (Galerkin).

The port's copy of petsctpu/mat/spgemm.py. Reference: MatMatMult's
symbolic/numeric split (src/mat/impls/aij/seq/matmatmult.c:29 —
symbolic estimates fill once, numeric re-runs cheaply when values
change) and MatPtAP (src/mat/impls/aij/seq/matptap.c:19,44) behind
GAMG's coarse operators (gamg.c:156).

The symbolic phase runs on the host (scipy computes the product pattern
and a flat contribution plan); the numeric phase is PyTorch on the
plan's device: gathers, a product and a row sum over dense per-class
tables (contributions grouped by output slot into power-of-two widths,
the reference's layout, kept so the plans of the two packages are
equal), then one inverse-permutation gather. The class tables stay
int32 as in the reference; a padded slot points at an appended zero.
The row sums fold in PyTorch's order, not XLA's, so the numerics agree
with petsctpu's to rounding, not to the bit.
"""

from __future__ import annotations

import numpy as np
import scipy.sparse as sp
import torch

from petsctpu_torch.device import resolve_device
from petsctpu_torch.mat.ell import AIJ, aij_from_scipy


# ---------------------------------------------------------------------------
# host-only products (plan-time)
# ---------------------------------------------------------------------------
def matmatmult(A, B):
    """C = A·B on host (MatMatMult analog)."""
    return (sp.csr_matrix(A) @ sp.csr_matrix(B)).tocsr()


def ptap(A, P):
    """Galerkin triple product Pᵀ·A·P on host (MatPtAP analog)."""
    P = sp.csr_matrix(P)
    return (P.T @ sp.csr_matrix(A) @ P).tocsr()


def rart(A, R):
    """R·A·Rᵀ (MatRARt analog)."""
    R = sp.csr_matrix(R)
    return (R @ sp.csr_matrix(A) @ R.T).tocsr()


# ---------------------------------------------------------------------------
# device numeric with frozen symbolic pattern
# ---------------------------------------------------------------------------
def _csr_entry_index(M: sp.csr_matrix):
    """The sorted CSR whose data order the plans index."""
    M = sp.csr_matrix(M)
    M.sort_indices()
    return M


def _lookup(M: sp.csr_matrix, rows, cols):
    """Flat data indices of entries (rows[k], cols[k]) — must exist. A
    sorted CSR's data order is the sort order of the key row·ncols +
    col, so one searchsorted resolves every query."""
    ncols = M.shape[1]
    m_rows = np.repeat(np.arange(M.shape[0], dtype=np.int64),
                       np.diff(M.indptr))
    keys = m_rows * ncols + M.indices
    return np.searchsorted(keys, np.asarray(rows, np.int64) * ncols
                           + np.asarray(cols, np.int64))


def _segment_arange(starts, lengths):
    """Concatenate [starts[i], starts[i]+lengths[i]) ranges, vectorized."""
    total = int(lengths.sum())
    if total == 0:
        return np.zeros(0, np.int64)
    seg = np.repeat(np.arange(len(lengths)), lengths)
    first = np.zeros(len(lengths) + 1, np.int64)
    np.cumsum(lengths, out=first[1:])
    local = np.arange(total, dtype=np.int64) - first[seg]
    return np.asarray(starts, np.int64)[seg] + local


def _size_class_tables(c_idx, c_nnz, *index_streams):
    """Group contributions by output slot into power-of-two-width dense
    tables, so the numeric product is gathers, a [n_cls, W] multiply, a
    row sum and one inverse-permutation gather. Returns
    (classes=[(W, padded index arrays per stream)], inv)."""
    order = np.argsort(c_idx, kind="stable")
    cs = np.asarray(c_idx)[order]
    streams = [np.asarray(s)[order] for s in index_streams]
    starts = np.searchsorted(cs, np.arange(c_nnz + 1))
    counts = np.diff(starts)
    W = np.maximum(1, 1 << np.ceil(np.log2(np.maximum(counts, 1)))
                   .astype(np.int64))
    classes = []
    slot_concat = []
    for w in np.unique(W):
        slots = np.flatnonzero(W == w)
        idx2d = starts[slots][:, None] + np.arange(w)[None, :]
        valid = np.arange(w)[None, :] < counts[slots][:, None]
        tables = []
        for s in streams:
            t = np.where(valid, s[np.minimum(idx2d, len(cs) - 1)],
                         -1).astype(np.int64)
            tables.append(t)
        classes.append((int(w), tables))
        slot_concat.append(slots)
    slot_concat = np.concatenate(slot_concat) if slot_concat else \
        np.zeros(0, np.int64)
    inv = np.zeros(c_nnz, np.int64)
    inv[slot_concat] = np.arange(len(slot_concat))
    return classes, inv


def _table(t, pad: int, dev) -> torch.Tensor:
    """A class table on the device, int32 as in the reference, its
    padding (-1) pointing at the appended zero `pad`."""
    return torch.from_numpy(np.where(t < 0, pad, t).astype(np.int32)).to(dev)


def _take(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """x[idx] for an int32 index table of any shape."""
    return x.index_select(0, idx.reshape(-1)).view(idx.shape)


def _with_zero(x: torch.Tensor, dtype) -> torch.Tensor:
    return torch.cat([x.to(dtype), x.new_zeros(1, dtype=dtype)])


class SpGEMMPlan:
    """Numeric C = A·B with frozen patterns.

    Contributions are grouped by output slot into power-of-two-width
    dense tables at plan time (see _size_class_tables), so the numeric
    phase is gathers and dense row sums, no scatter. `template` holds
    C's ELL structure; `ell_pos` maps CSR data order to flat ELL slots.
    Padded slots index a_nnz/b_nnz (an appended zero)."""

    def __init__(self, cls_ai, cls_bi, inv, ell_pos, template, c_nnz,
                 a_nnz=0, b_nnz=0):
        self.cls_ai = tuple(cls_ai)   # per class: int32 [n_cls, W] into a
        self.cls_bi = tuple(cls_bi)   # per class: int32 [n_cls, W] into b
        self.inv = inv                # output slot -> class-concat position
        self.ell_pos = ell_pos
        self.template = template
        self.c_nnz = c_nnz
        self.a_nnz = a_nnz
        self.b_nnz = b_nnz

    @classmethod
    def plan(cls, A_host, B_host, dtype=None, device=None) -> "SpGEMMPlan":
        dev = resolve_device(device)
        A = _csr_entry_index(A_host)
        B = _csr_entry_index(B_host)
        C = _csr_entry_index((A @ B).tocsr())
        a_rows = np.repeat(np.arange(A.shape[0]), np.diff(A.indptr))
        # contributions: for each A entry (i,k) x each B entry (k,j)
        reps = np.diff(B.indptr)[A.indices]
        a_idx = np.repeat(np.arange(A.nnz), reps)
        b_idx = _segment_arange(B.indptr[A.indices], reps)
        ci = np.repeat(a_rows, reps)
        cj = B.indices[b_idx]
        c_idx = _lookup(C, ci, cj)
        classes, inv = _size_class_tables(c_idx, int(C.nnz), a_idx, b_idx)
        tmpl = aij_from_scipy(C, dtype=dtype, device=dev)
        return cls([_table(t[0], A.nnz, dev) for _, t in classes],
                   [_table(t[1], B.nnz, dev) for _, t in classes],
                   torch.from_numpy(inv).to(dev),
                   torch.from_numpy(_ell_positions(C, tmpl)).to(dev),
                   tmpl, int(C.nnz), int(A.nnz), int(B.nnz))

    def numeric_data(self, a_data: torch.Tensor, b_data: torch.Tensor):
        """C's sorted-CSR data array (for chaining into further plans)."""
        ap = _with_zero(a_data, a_data.dtype)
        bp = _with_zero(b_data, a_data.dtype)
        parts = [torch.sum(_take(ap, ai) * _take(bp, bi), dim=1)
                 for ai, bi in zip(self.cls_ai, self.cls_bi)]
        if not parts:
            return a_data.new_zeros(0)
        return torch.cat(parts)[self.inv]

    def numeric(self, a_data: torch.Tensor, b_data: torch.Tensor) -> AIJ:
        return _fill_template(self.template, self.ell_pos,
                              self.numeric_data(a_data, b_data))


class PtAPPlan:
    """Numeric Ac = Pᵀ·A·P with frozen patterns (P values also frozen —
    the common Galerkin case where only A's coefficients change). Same
    scatter-free size-classed layout as SpGEMMPlan."""

    def __init__(self, cls_ai, cls_w, inv, ell_pos, template, c_nnz,
                 a_nnz=0):
        self.cls_ai = tuple(cls_ai)   # per class: int32 [n_cls, W] into a
        self.cls_w = tuple(cls_w)     # per class: [n_cls, W] P-weight products
        self.inv = inv
        self.ell_pos = ell_pos
        self.template = template
        self.c_nnz = c_nnz
        self.a_nnz = a_nnz

    @classmethod
    def plan(cls, A_host, P_host, dtype=None, device=None) -> "PtAPPlan":
        dev = resolve_device(device)
        A = _csr_entry_index(A_host)
        P = _csr_entry_index(P_host)
        C = _csr_entry_index((P.T @ A @ P).tocsr())
        # contributions: A entry (k,l); P row k entries (k,i); P row l (l,j)
        a_rows = np.repeat(np.arange(A.shape[0]), np.diff(A.indptr))
        ks, ls = a_rows, A.indices
        cnt_k = np.diff(P.indptr)[ks]
        cnt_l = np.diff(P.indptr)[ls]
        reps = cnt_k * cnt_l
        a_idx = np.repeat(np.arange(A.nnz), reps)
        # contribution q under A-entry t maps to P-row-k slot
        # (local // cnt_l) and P-row-l slot (local % cnt_l)
        total = int(reps.sum())
        t_of = np.repeat(np.arange(A.nnz), reps)
        first = np.zeros(A.nnz + 1, np.int64)
        np.cumsum(reps, out=first[1:])
        local = np.arange(total, dtype=np.int64) - first[t_of]
        denom = np.maximum(cnt_l[t_of], 1)
        pk_idx = P.indptr[ks[t_of]] + local // denom
        pl_idx = P.indptr[ls[t_of]] + local % denom
        ci = P.indices[pk_idx].astype(np.int64)
        cj = P.indices[pl_idx].astype(np.int64)
        w = P.data[pk_idx] * P.data[pl_idx]
        c_idx = _lookup(C, ci, cj)
        tmpl = aij_from_scipy(C, dtype=dtype, device=dev)
        wi = np.arange(len(w))
        classes, inv = _size_class_tables(c_idx, int(C.nnz), a_idx, wi)
        wpad = np.concatenate([w, [0.0]])
        cls_w = [torch.from_numpy(wpad[t[1]]).to(dev, tmpl.dtype)
                 for _, t in classes]
        return cls([_table(t[0], A.nnz, dev) for _, t in classes], cls_w,
                   torch.from_numpy(inv).to(dev),
                   torch.from_numpy(_ell_positions(C, tmpl)).to(dev), tmpl,
                   int(C.nnz), int(A.nnz))

    def numeric(self, a_data: torch.Tensor) -> AIJ:
        ap = _with_zero(a_data, a_data.dtype)
        parts = [torch.sum(_take(ap, ai) * w, dim=1)
                 for ai, w in zip(self.cls_ai, self.cls_w)]
        cdata = torch.cat(parts)[self.inv] if parts else \
            a_data.new_zeros(0)
        return _fill_template(self.template, self.ell_pos, cdata)


def _ell_positions(C: sp.csr_matrix, tmpl: AIJ) -> np.ndarray:
    """Flat ELL slot of each CSR data entry (row-major slot order)."""
    K = tmpl.vals.shape[1]
    row_nnz = np.diff(C.indptr)
    rows = np.repeat(np.arange(C.shape[0]), row_nnz)
    slot = np.arange(C.nnz) - np.repeat(C.indptr[:-1], row_nnz)
    return rows.astype(np.int64) * K + slot


def _fill_template(tmpl: AIJ, ell_pos: torch.Tensor,
                   cdata: torch.Tensor) -> AIJ:
    """tmpl's ELL pattern with the sorted-CSR data cdata (ell_pos holds
    distinct slots, so the write is one deterministic scatter)."""
    flat = cdata.new_zeros(tmpl.vals.numel())
    flat[ell_pos] = cdata
    return AIJ(tmpl.cols, flat.view(tmpl.vals.shape), tmpl.shape, tmpl.nnz)


def csr_data_of(A_host) -> np.ndarray:
    """Sorted-CSR data array matching plan index conventions."""
    M = _csr_entry_index(A_host)
    return M.data
