"""Implicit-operator wrappers (matrix-free composition) and host
helpers: the counterpart of petsctpu/mat/base.py.

Any object with `.shape` and `.mult(x)` is an operator; `.multT(x)` is
optional. The wrappers hold other operators (or tensors) and compose
their products as PyTorch ops; a hand kernel runs only inside the
operators they wrap. `Shell` (MATSHELL), `Transpose` (MATTRANSPOSE),
`Normal` (AᵀA), `NormalHermitian` (AAᵀ, with no conjugate, as
petsctpu's), `ShiftScale` (αA + βI), `Composite` (MATCOMPOSITE, a sum
or a product), `LRC` (A + U C Vᵀ, its small products `torch.matmul`),
`Diagonal`, `Identity`, `ScatterMat` (MATSCATTER: a gather, its
transpose a scatter-add folded through mat/fold.py in petsctpu's slot
order, so two calls on the card give the same bits), `BlockMat`
(MATBLOCKMAT: its blocks' products added into their slices in the
sorted (i, j) order `block_mat` gives) and `LocalRef` (MATLOCALREF).
The host helpers (scipy CSR in and out): `csr_submatrix_keep_zeros`,
`mat_zero_rows` and `mat_axpy` (MatAXPY's three structures).
"""

from __future__ import annotations

import numpy as np
import scipy.sparse as sp
import torch


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


class _Wraps:
    """dtype and device of the wrapped operator A."""

    @property
    def dtype(self):
        return self.A.dtype

    @property
    def device(self):
        return self.A.device


class Transpose(_Wraps):
    """Implicit Aᵀ (MatCreateTranspose): mult ↔ multT."""

    def __init__(self, A):
        self.A = A

    @property
    def shape(self):
        return self.A.shape[::-1]

    def mult(self, x):
        return self.A.multT(x)

    def multT(self, x):
        return self.A.mult(x)


class Normal(_Wraps):
    """Implicit AᵀA (MATNORMAL, src/mat/impls/normal)."""

    def __init__(self, A):
        self.A = A

    @property
    def shape(self):
        n = self.A.shape[1]
        return (n, n)

    def mult(self, x):
        return self.A.multT(self.A.mult(x))

    multT = mult


class NormalHermitian(_Wraps):
    """Implicit AAᵀ: A.mult(A.multT(x)), with no conjugate (petsctpu's
    NormalHermitian, kept as it is)."""

    def __init__(self, A):
        self.A = A

    @property
    def shape(self):
        m = self.A.shape[0]
        return (m, m)

    def mult(self, x):
        return self.A.mult(self.A.multT(x))

    multT = mult


class ShiftScale(_Wraps):
    """alpha·A + beta·I, implicit (MatShift/MatScale composed); alpha
    and beta numbers or 0-d tensors."""

    def __init__(self, A, alpha, beta):
        self.A, self.alpha, self.beta = A, alpha, beta

    @property
    def shape(self):
        return self.A.shape

    def mult(self, x):
        return self.alpha * self.A.mult(x) + self.beta * x

    def multT(self, x):
        return self.alpha * self.A.multT(x) + self.beta * x

    def diagonal(self):
        return self.alpha * self.A.diagonal() + self.beta


class Composite:
    """Sum ("additive") or product ("multiplicative", A1·A2·…·Ak applied
    right to left) of operators (MATCOMPOSITE)."""

    def __init__(self, ops, mode: str = "additive"):
        self.ops = tuple(ops)
        self.mode = mode

    @property
    def shape(self):
        if self.mode == "additive":
            return self.ops[0].shape
        return (self.ops[0].shape[0], self.ops[-1].shape[1])

    @property
    def dtype(self):
        return self.ops[0].dtype

    @property
    def device(self):
        return self.ops[0].device

    def mult(self, x):
        if self.mode == "additive":
            y = self.ops[0].mult(x)
            for op in self.ops[1:]:
                y = y + op.mult(x)
            return y
        y = x
        for op in reversed(self.ops):
            y = op.mult(y)
        return y


class LRC(_Wraps):
    """Low-rank correction A + U C Vᵀ, implicit (MATLRC): U [m, k], C
    [k, k], V [n, k] tensors."""

    def __init__(self, A, U, C, V):
        self.A, self.U, self.C, self.V = A, U, C, V

    @property
    def shape(self):
        return self.A.shape

    def mult(self, x):
        return self.A.mult(x) + self.U @ (self.C @ (self.V.T @ x))


class Diagonal:
    """diag(d) as an operator."""

    def __init__(self, d: torch.Tensor):
        self.d = d

    @property
    def shape(self):
        n = self.d.shape[0]
        return (n, n)

    @property
    def dtype(self):
        return self.d.dtype

    @property
    def device(self):
        return self.d.device

    def mult(self, x):
        return self.d * x

    multT = mult

    def diagonal(self):
        return self.d


class Identity:
    """I, an operator and a PC (apply) at once."""

    def __init__(self, shape):
        self.shape = tuple(shape)

    def mult(self, x):
        return x

    multT = mult

    def apply(self, x):
        return x


class ScatterMat:
    """MATSCATTER: y[i] = x[idx[i]] (a selection matrix applied as a
    gather); multT is the scatter-reverse ADD, folded through
    mat/fold.py in petsctpu's slot order (deterministic on the card)."""

    def __init__(self, idx, shape, device=None):
        from petsctpu_torch.device import resolve_device

        dev = resolve_device(device)
        self.idx = torch.as_tensor(np.asarray(idx), dtype=torch.int64).to(dev)
        self.shape = tuple(shape)
        self._fold = None

    @property
    def device(self):
        return self.idx.device

    def mult(self, x):
        return x[self.idx]

    def multT(self, y):
        from petsctpu_torch.mat.fold import fold_plan

        if self._fold is None:
            self._fold = fold_plan(self.idx)
        return self._fold.fold(y.new_zeros(self.shape[1]), y)

    def diagonal(self):
        m = min(self.shape)
        rows = torch.arange(m, device=self.idx.device)
        return (self.idx[:m] == rows).to(torch.float64)


class BlockMat:
    """MATBLOCKMAT: a sparse block matrix whose stored blocks are
    operators, as a COO of (block row, block column, op) with the row and
    column offsets of the (ragged) block layout. Each product adds the
    blocks' results into their slices in the stored order."""

    def __init__(self, ops, bi, bj, row_offsets, col_offsets):
        self.ops = tuple(ops)
        self.bi, self.bj = tuple(bi), tuple(bj)
        self.row_offsets = tuple(row_offsets)
        self.col_offsets = tuple(col_offsets)

    @property
    def shape(self):
        return (self.row_offsets[-1], self.col_offsets[-1])

    def _product(self, x, transpose: bool):
        ro, co = self.row_offsets, self.col_offsets
        if transpose:
            ro, co = co, ro
        y = x.new_zeros(ro[-1])
        for op, i, j in zip(self.ops, self.bi, self.bj):
            if transpose:
                i, j = j, i
            xs = x[co[j]:co[j + 1]]
            y[ro[i]:ro[i + 1]] = y[ro[i]:ro[i + 1]] + (
                op.multT(xs) if transpose else op.mult(xs))
        return y

    def mult(self, x):
        return self._product(x, False)

    def multT(self, x):
        return self._product(x, True)

    def diagonal(self):
        d = None
        for op, i, j in zip(self.ops, self.bi, self.bj):
            if i == j:
                di = op.diagonal()
                if d is None:
                    d = torch.zeros(self.shape[0], dtype=torch.float64,
                                    device=di.device)
                d[self.row_offsets[i]:self.row_offsets[i + 1]] = di
        return d if d is not None else torch.zeros(self.shape[0],
                                                   dtype=torch.float64)


def block_mat(blocks, row_sizes, col_sizes) -> BlockMat:
    """A BlockMat from {(i, j): op} and the block layout's sizes; the
    blocks are stored in sorted (i, j) order."""
    ro = (0,) + tuple(np.cumsum(row_sizes).tolist())
    co = (0,) + tuple(np.cumsum(col_sizes).tolist())
    items = sorted(blocks.items(), key=lambda kv: kv[0])
    return BlockMat(tuple(op for _, op in items),
                    tuple(i for (i, _), _ in items),
                    tuple(j for (_, j), _ in items), ro, co)


class LocalRef:
    """MATLOCALREF: an assembly alias into a parent's builder (anything
    with `.add(rows, cols, vals)`): values added in the local frame land
    in the parent's global COO stream through the index maps."""

    def __init__(self, parent_builder, rmap, cmap=None):
        self.parent = parent_builder
        self.rmap = np.asarray(rmap, np.int64)
        self.cmap = (self.rmap if cmap is None
                     else np.asarray(cmap, np.int64))
        self.shape = (len(self.rmap), len(self.cmap))

    def add_values(self, rows, cols, vals) -> None:
        """MatSetValuesLocal: the parent's global adds."""
        self.parent.add(self.rmap[np.asarray(rows, np.int64)],
                        self.cmap[np.asarray(cols, np.int64)],
                        np.asarray(vals))


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


def mat_axpy(Y, a, X, structure: str = "different") -> sp.csr_matrix:
    """MatAXPY (src/mat/utils/axpy.c): Y + a·X as host scipy CSR.

    structure "same" or "subset": X's slots land in Y's, one at a time in
    X's COO order (an exact zero sum leaves the pattern, as petsctpu's
    LIL assignment does); "different": the union pattern, slots of either
    operand kept even where the sum is an exact zero (a factorization
    sees the union, as in the reference)."""
    Y = sp.csr_matrix(Y, copy=True)
    X = sp.csr_matrix(X)
    if structure in ("same", "subset"):
        Yl = Y.tolil()
        Xc = X.tocoo()
        for r, c, v in zip(Xc.row, Xc.col, Xc.data):
            Yl[r, c] = Yl[r, c] + a * v
        out = Yl.tocsr()
        out.sort_indices()
        return out
    ones_Y = sp.csr_matrix((np.ones_like(Y.data), Y.indices, Y.indptr),
                           shape=Y.shape)
    ones_X = sp.csr_matrix((np.ones_like(X.data), X.indices, X.indptr),
                           shape=X.shape)
    pat = (ones_Y + ones_X).tocsr()
    pat.sort_indices()
    S = sp.csr_matrix(Y + a * X)
    S.sort_indices()
    # S's slots (a subset of the union) by their place in pat: both
    # sorted by (row, column), so one search over flat keys
    ncol = Y.shape[1]
    key = lambda M: (np.repeat(np.arange(M.shape[0], dtype=np.int64),
                               np.diff(M.indptr)) * ncol
                     + M.indices.astype(np.int64))
    out_data = np.zeros(pat.nnz, dtype=S.dtype)
    out_data[np.searchsorted(key(pat), key(S))] = S.data
    return sp.csr_matrix((out_data, pat.indices, pat.indptr), shape=Y.shape)
