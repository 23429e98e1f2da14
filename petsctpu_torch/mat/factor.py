"""Factorizations and the level-scheduled triangular solve.

Counterpart of petsctpu/mat/factor.py (reference: MatILUFactorSymbolic/
MatLUFactorNumeric_SeqAIJ, src/mat/impls/aij/seq/aijfact.c:122,285,461;
MatCholeskyFactorNumeric_SeqAIJ :2076; MatSolve_SeqAIJ :603). The
numeric factorizations run on the host at PCSetUp time: ILU(0), the
ILU(k)/IC(k) patterns, IC numerics and the triangular levels in the
port's own C++ (csrc/host_factor.cpp, through mat/host_factor.py),
complete LU in scipy's SuperLU. The numpy `*_plain` functions here are
those routines' plain versions, which the tests hold them to.

The triangular solves run on the device by level scheduling: rows are
grouped into dependency levels (wavefronts), and all rows of a level
solve together. SpTRSVPlan.solve is one launch of the SpTRSV kernel
(ops/sptrsv.py) for a plan or for nb stacked plans (bjacobi/ASM
subdomains); lu_solve solves an L and a U plan in one launch where
their x fits the card's shared memory. DenseTRSVPlan is the reference's
small dense fallback (torch.linalg.solve_triangular, as the reference
maps it to XLA's).
The reference's banded plans are here too (BandTRSVPlan, the tiled
back-substitution, and BandTRSVHierPlan, its two-phase form), as
PyTorch products; tri=auto keeps levels on every device, and their
viability probe (band_solve_viable) serves the reference's choice of
the dense plan.

Setup is logged under four events (core/logging.py): MatFactorNumeric
(ILU(0), IC and LU numerics), MatSolveLevels (the triangles' levels),
MatSolveSegments (a plan's (level, rank) segments, where it derives
them) and MatSolvePlan (building plans, their levels and segments
included).
"""

from __future__ import annotations

import numpy as np
import scipy.sparse as sp
import scipy.sparse.linalg as spla
import torch

from petsctpu_torch.core.logging import log_event
from petsctpu_torch.device import np_dtype, resolve_device
from petsctpu_torch.mat import host_factor
from petsctpu_torch.ops.sptrsv import (CLUSTER, SMEM_SHAPES, device_shape,
                                      level_order, segments, sptrsv,
                                      sptrsv_lu, with_slack)


# ---------------------------------------------------------------------------
# numeric factorizations (host)
# ---------------------------------------------------------------------------
def ilu0(A) -> tuple:
    """ILU(0): LU restricted to the pattern of A (stored zeros kept).

    Returns (L, U) scipy CSR in A's dtype, L strictly lower (the unit
    diagonal not stored), U upper with the diagonal. The numeric loop
    runs in fp64 in the host library and is cast back, as the
    reference's native route does."""
    with log_event("MatFactorNumeric"):
        A = sp.csr_matrix(A, copy=True)
        A.sort_indices()
        av64 = np.ascontiguousarray(A.data, np.float64)
        host_factor.ilu0_csr_inplace(A.indptr, A.indices, av64)
        F = sp.csr_matrix((av64.astype(A.data.dtype), A.indices, A.indptr),
                          shape=A.shape)
        return (sp.tril(F, k=-1, format="csr"),
                sp.triu(F, k=0, format="csr"))


def ilu0_plain(A) -> tuple:
    """ilu0 in numpy (IKJ over the sorted pattern, in fp64): the host
    library's plain version."""
    A = sp.csr_matrix(A, copy=True)
    A.sort_indices()
    n = A.shape[0]
    ai, aj = A.indptr, A.indices
    av = np.asarray(A.data, np.float64).copy()
    diag_ptr = np.zeros(n, dtype=np.int64)
    for i in range(n):
        row = aj[ai[i]:ai[i + 1]]
        d = np.searchsorted(row, i)
        if d >= len(row) or row[d] != i:
            raise ValueError(f"ILU(0): missing diagonal in row {i}")
        diag_ptr[i] = ai[i] + d
    for i in range(n):
        for p in range(ai[i], diag_ptr[i]):
            k = aj[p]
            av[p] /= av[diag_ptr[k]]
            kj = aj[diag_ptr[k] + 1:ai[k + 1]]
            kv = av[diag_ptr[k] + 1:ai[k + 1]]
            ij = aj[p + 1:ai[i + 1]]
            pos = np.searchsorted(ij, kj)
            ok = pos < len(ij)
            hit = ij[pos[ok]] == kj[ok]
            tgt = p + 1 + pos[ok][hit]
            av[tgt] -= av[p] * kv[ok][hit]
    F = sp.csr_matrix((av.astype(A.data.dtype), aj, ai), shape=A.shape)
    return sp.tril(F, k=-1, format="csr"), sp.triu(F, k=0, format="csr")


def iluk_pattern(A, k: int) -> list:
    """Symbolic ILU(k) pattern (Saad §10.3.3; the reference's
    MatILUFactorSymbolic level rule, aijfact.c:122): a sorted int64
    column array per row, diagonal included."""
    A = sp.csr_matrix(A)
    A.sort_indices()
    indptr, cols = host_factor.iluk_pattern(A.indptr, A.indices, k)
    return np.split(cols, indptr[1:-1])


def iluk_pattern_plain(A, k: int) -> list:
    """iluk_pattern in Python: the host library's plain version."""
    import bisect

    A = sp.csr_matrix(A)
    A.sort_indices()
    rowpat, out = [], []
    for i in range(A.shape[0]):
        lev = {int(j): 0 for j in A.indices[A.indptr[i]:A.indptr[i + 1]]}
        wl = sorted(c for c in lev if c < i)
        idx = 0
        while idx < len(wl):
            kk = wl[idx]
            idx += 1
            lk = lev[kk]
            if lk >= k:
                continue
            for jc, lj in rowpat[kk]:
                if jc <= kk:
                    continue
                nl = lk + lj + 1
                if nl <= k:
                    cur = lev.get(jc)
                    if cur is None:
                        lev[jc] = nl
                        if jc < i:
                            bisect.insort(wl, jc)
                    elif nl < cur:
                        lev[jc] = nl
        row = sorted(lev.items())
        rowpat.append(row)
        out.append(np.asarray([c for c, _ in row], np.int64))
    return out


def icc_pattern(A, levels: int) -> list:
    """Symbolic IC(k) pattern (MatICCFactorSymbolic_SeqAIJ,
    aijfact.c:2405): column-driven level rule over the upper triangle,
    PetscICCLLAddSorted semantics. Returns per-row sorted strict-upper
    column arrays."""
    A = sp.csr_matrix(A)
    A.sort_indices()
    indptr, cols = host_factor.icck_pattern(A.indptr, A.indices, levels)
    return np.split(cols, indptr[1:-1])


def icc_pattern_plain(A, levels: int) -> list:
    """icc_pattern in Python: the host library's plain version."""
    A = sp.csr_matrix(A)
    A.sort_indices()
    n = A.shape[0]
    ai, aj = A.indptr, A.indices
    out_cols, out_lvls = [], []
    il = np.zeros(n, np.int64)
    bucket = [[] for _ in range(n)]
    for k in range(n):
        row = aj[ai[k]:ai[k + 1]]
        lnk = {int(j): 0 for j in row[row >= k]}
        lnk.setdefault(k, 0)
        for prow in bucket[k]:
            p0 = il[prow]
            cols_p, lvls_p = out_cols[prow], out_lvls[prow]
            lev_pk = int(lvls_p[p0])
            for t in range(p0 + 1, len(cols_p)):
                inc = int(lvls_p[t]) + lev_pk + 1
                if inc > levels:
                    continue
                j = int(cols_p[t])
                if j not in lnk or lnk[j] > inc:
                    lnk[j] = inc
            nxt = p0 + 1
            if nxt < len(cols_p):
                il[prow] = nxt
                bucket[int(cols_p[nxt])].append(prow)
        bucket[k] = []
        items = sorted((j, lv) for j, lv in lnk.items() if j > k)
        out_cols.append(np.asarray([j for j, _ in items], np.int64))
        out_lvls.append(np.asarray([lv for _, lv in items], np.int64))
        if items:
            il[k] = 0
            bucket[items[0][0]].append(k)
    return out_cols


def _upper_pattern(A, pattern_rows):
    """(ui, uj) strict-upper CSR of IC(0) (None) or of the given rows."""
    n = A.shape[0]
    if pattern_rows is None:
        rows = np.repeat(np.arange(n), np.diff(A.indptr))
        up = A.indices > rows
        uj = A.indices[up].astype(np.int64)
        counts = np.bincount(rows[up], minlength=n)
    else:
        strict = [np.asarray(r)[np.asarray(r) > i]
                  for i, r in enumerate(pattern_rows)]
        counts = [len(r) for r in strict]
        uj = (np.concatenate(strict).astype(np.int64) if n
              else np.zeros(0, np.int64))
    ui = np.zeros(n + 1, np.int64)
    ui[1:] = np.cumsum(counts)
    return ui, uj


def icc_factor(A, pattern_rows=None, shift_type: str = "positive_definite",
               zeropivot: float = None, shift_amount: float = None,
               numeric=None):
    """Incomplete Cholesky A + shift·I ≈ (I+Ustrict)ᵀ·diag(d)·(I+Ustrict)
    on an upper-triangular pattern, with the reference's MatPivotCheck
    shift loop (positive_definite = Manteuffel, the PCICC default;
    nonzero; inblocks; none raises on a zero pivot).

    pattern_rows: per-row sorted upper column arrays, None for IC(0).
    numeric: the routine that fills the factor, the host library's
    (default) or icc_numeric_plain.
    Returns (Ustrict CSR, d, nshift, shift_used)."""
    A = sp.csr_matrix(A)
    A.sort_indices()
    n = A.shape[0]
    eps = float(np.finfo(np.float64).eps)
    zeropivot = 100.0 * eps if zeropivot is None else float(zeropivot)
    shift_amount = 100.0 * eps if shift_amount is None \
        else float(shift_amount)
    ui, uj = _upper_pattern(A, pattern_rows)
    with log_event("MatFactorNumeric"):
        uv, d, nshift, shift = (numeric or host_factor.icc_numeric)(
            A.indptr, A.indices, np.asarray(A.data, np.float64), ui, uj,
            shift_type, zeropivot, shift_amount)
    return sp.csr_matrix((uv, uj, ui), shape=(n, n)), d, nshift, shift


def _seqsum(v) -> float:
    """A left-to-right sum (np.sum sums pairwise), as a C loop adds."""
    return float(np.cumsum(v)[-1]) if len(v) else 0.0


def icc_numeric_plain(ai, aj, aa, ui, uj, shift_type: str, zeropivot: float,
                      shift_amount: float):
    """host_factor.icc_numeric in numpy, the same adds in the same order
    (the c2r/il column buckets of aijfact.c:2076-2230)."""
    n = len(ai) - 1
    uv = np.zeros(int(ui[-1]), np.float64)
    d = np.zeros(n, np.float64)
    shift_top = 0.0
    if shift_type == "positive_definite":
        shift_top = zeropivot
        for i in range(n):
            row, cols = aa[ai[i]:ai[i + 1]], aj[ai[i]:ai[i + 1]]
            dval = row[cols == i][-1] if (cols == i).any() else 0.0
            shift_top = max(shift_top,
                            _seqsum(np.abs(row)) - (abs(dval) + dval))
        shift_top *= 1.1
    nshift, nshift_max = 0, 5
    shift_lo, shift_hi, shift_fraction = 0.0, 1.0, 0.0
    cur_shift = 0.0
    rtmp = np.zeros(n, np.float64)
    while True:
        newshift = False
        il = np.zeros(n, np.int64)
        bucket = [[] for _ in range(n)]
        for k in range(n):
            cols_k = uj[ui[k]:ui[k + 1]]
            rtmp[cols_k] = 0.0
            arow = slice(ai[k], ai[k + 1])
            acols, avals = aj[arow], aa[arow]
            dk = cur_shift
            if (acols == k).any():
                dk += avals[acols == k][-1]
            up = acols > k
            rtmp[acols[up]] = avals[up]
            for i in bucket[k]:
                ili = il[i]
                stored = uv[ili]
                uikdi = -stored / d[i]
                dk += uikdi * stored
                uv[ili] = uikdi
                nxt = ili + 1
                if nxt < ui[i + 1]:
                    sl = slice(nxt, ui[i + 1])
                    rtmp[uj[sl]] += uikdi * uv[sl]
                    il[i] = nxt
                    bucket[uj[nxt]].append(i)
            bucket[k] = []
            sl = slice(ui[k], ui[k + 1])
            uv[sl] = rtmp[cols_k]
            rs = _seqsum(np.abs(uv[sl]))
            if len(cols_k):
                il[k] = ui[k]
                bucket[cols_k[0]].append(k)
            if shift_type == "positive_definite":
                if dk <= zeropivot * rs:
                    if nshift == nshift_max:
                        shift_fraction = shift_hi
                    else:
                        shift_lo = shift_fraction
                        shift_fraction = (shift_hi + shift_lo) / 2.0
                    cur_shift = shift_fraction * shift_top
                    nshift += 1
                    newshift = True
                    break
            elif shift_type == "nonzero":
                if abs(dk) <= zeropivot * rs:
                    cur_shift = (shift_amount if nshift == 0
                                 else cur_shift * 2.0)
                    nshift += 1
                    newshift = True
                    break
            elif shift_type == "inblocks":
                if abs(dk) <= zeropivot:
                    dk += shift_amount
                    nshift += 1
            elif abs(dk) <= zeropivot:
                raise ZeroDivisionError(f"icc: zero pivot row {k}")
            d[k] = dk
        if not newshift:
            break
    return -uv, d, nshift, cur_shift


def lu_factor(A):
    """Complete sparse LU via SuperLU with permutations, as (L, U,
    perm_r, perm_c): x = Pc U⁻¹ L⁻¹ Pr b."""
    A = sp.csc_matrix(A)
    with log_event("MatFactorNumeric"):
        lu = spla.splu(A, permc_spec="COLAMD",
                       options=dict(Equil=False, IterRefine="NOREFINE"))
    L = sp.csr_matrix(lu.L)          # unit lower (diag stored = 1)
    U = sp.csr_matrix(lu.U)
    return L, U, lu.perm_r, lu.perm_c


def cholesky_factor(A):
    """Sparse Cholesky via LU of an SPD matrix (no pivoting needed)."""
    return lu_factor(A)


# ---------------------------------------------------------------------------
# level-scheduled triangular solve
# ---------------------------------------------------------------------------
def _levels(T: sp.csr_matrix, lower: bool) -> np.ndarray:
    """Dependency level of each row for a triangular solve (host library)."""
    with log_event("MatSolveLevels"):
        return host_factor.tri_levels(T.indptr, T.indices, lower)


def levels_plain(T: sp.csr_matrix, lower: bool) -> np.ndarray:
    """_levels in Python: the host library's plain version."""
    n = T.shape[0]
    lev = np.zeros(n, dtype=np.int64)
    ai, aj = T.indptr, T.indices
    for i in (range(n) if lower else range(n - 1, -1, -1)):
        deps = aj[ai[i]:ai[i + 1]]
        deps = deps[deps < i] if lower else deps[deps > i]
        if len(deps):
            lev[i] = lev[deps].max() + 1
    return lev


class SpTRSVPlan:
    """Level-scheduled triangular solve x = T⁻¹ b, or nb of them stacked
    (a leading axis on every array, one launch for all).

    In the reference's layout, numpy arrays kept on the host:
    level_rows: int32 [(nb,) nlev, rmax] rows per level, each level's
                rows first and in ascending order, padding = n (sentinel)
    cols/vals : ELL off-diagonal entries per row [(nb,) n+1, K] (padding
                col = n, val 0; row n is the sentinel's)
    dinv      : 1/diag per row [(nb,) n] (1 for a unit diagonal)

    On the device, what the solve reads, derived once here, where the
    layout it relies on is checked: `order`, the plans in level order
    (ops/sptrsv.level_order: lstart, lrows, lcols, lvals, ldinv), nlevs
    [nb] (each plan's levels before its padded ones), rmax, the most
    rows a level holds, and lseg (each level's segment of each rank of a
    cluster, ops/sptrsv.segments) where the plan's x fits a cluster's
    shared memory (its solve, or a fused solve with it, may then take
    the cluster-smem shape, the one that reads lseg), else None.
    """

    def __init__(self, level_rows, cols, vals, dinv, n: int, nlev: int,
                 device=None):
        self.level_rows = np.asarray(level_rows)
        self.cols = np.asarray(cols)
        self.vals = np.asarray(vals)
        self.dinv = np.asarray(dinv)
        self.n = n
        self.nlev = nlev
        *order, nlevs = level_order(
            *(a.reshape(-1, *a.shape[-2:]) for a in
              (self.level_rows, self.cols, self.vals)),
            self.dinv.reshape(-1, self.dinv.shape[-1]))
        self.rmax = max(int(np.diff(order[0], axis=1).max()), 1)
        dev = resolve_device(device)
        n_ = self.dinv.shape[-1]
        shape = device_shape(len(nlevs), n_, self.rmax, order[3].dtype, dev)
        self.order = tuple(with_slack(torch.from_numpy(a).to(dev))
                           for a in order)
        self.nlevs = torch.from_numpy(nlevs).to(dev)
        # a wider pair only grows the ring: a plan whose own solve takes
        # no shared shape takes none in a pair either
        self.lseg = None
        if shape in SMEM_SHAPES:
            with log_event("MatSolveSegments"):
                self.lseg = torch.from_numpy(segments(
                    order[0], order[1], n_, CLUSTER)).to(dev)
        self._fuse = None            # (upper, whether the pair fuses)

    @property
    def stacked(self) -> bool:
        return self.level_rows.ndim == 3

    @property
    def nb(self) -> int:
        return self.nlevs.shape[0]

    @property
    def dtype(self):
        return self.order[3].dtype

    @property
    def device(self):
        return self.order[3].device

    def solve(self, b: torch.Tensor) -> torch.Tensor:
        """x = T⁻¹ b; b [n], or [nb, n] for a stacked plan."""
        x = sptrsv(*self.order, b if self.stacked else b[None],
                   nlevs=self.nlevs, lseg=self.lseg, rmax=self.rmax)
        return x if self.stacked else x[0]

    def fuses(self, upper) -> bool:
        """Whether this plan (L) and `upper` (U, the same subdomains)
        solve in one sptrsv_lu launch: both level plans of one size, type
        and device whose pair takes a shared shape on that device
        (ops/sptrsv.device_shape for the wider level; every pair on the
        CPU, where the plain version runs). Decided once a pair: a PC
        asks at every apply."""
        if self._fuse is not None and self._fuse[0] is upper:
            return self._fuse[1]
        ok = (isinstance(upper, SpTRSVPlan)
              and self.stacked == upper.stacked
              and tuple(self.dinv.shape) == tuple(upper.dinv.shape)
              and self.dtype == upper.dtype
              and self.device == upper.device
              and device_shape(self.nb, self.n, max(self.rmax, upper.rmax),
                               self.dtype, self.device)
              in SMEM_SHAPES + ("plain",))
        self._fuse = (upper, ok)
        return ok


def lu_solve(Lplan, Uplan, b: torch.Tensor) -> torch.Tensor:
    """x = U⁻¹ L⁻¹ b (b [n], or [nb, n] for stacked plans): one sptrsv_lu
    launch where Lplan.fuses(Uplan), y = L⁻¹ b kept in shared memory,
    else Lplan's solve and then Uplan's (two launches, or the dense
    plans)."""
    if not (isinstance(Lplan, SpTRSVPlan) and Lplan.fuses(Uplan)):
        return Uplan.solve(Lplan.solve(b))
    x = sptrsv_lu(Lplan.order, Uplan.order, b if Lplan.stacked else b[None],
                  nlevs=(Lplan.nlevs, Uplan.nlevs),
                  lseg=(Lplan.lseg, Uplan.lseg),
                  rmax=(Lplan.rmax, Uplan.rmax))
    return x if Lplan.stacked else x[0]


def make_sptrsv_plan(T, lower: bool, unit_diag: bool, dtype=None,
                     pad_to: tuple = None, device=None) -> SpTRSVPlan:
    """Build a device plan from a scipy triangular matrix.

    pad_to=(nlev, rmax, K) forces at-least shapes so that plans of
    different subdomains stack (bjacobi/ASM)."""
    with log_event("MatSolvePlan"):
        return SpTRSVPlan(*sptrsv_arrays(T, lower, unit_diag, dtype, pad_to),
                          device=device)


def sptrsv_arrays(T, lower: bool, unit_diag: bool, dtype=None,
                  pad_to: tuple = None) -> tuple:
    """The plan's numpy arrays (level_rows, cols, vals, dinv) and (n,
    nlev), equal to the reference's make_sptrsv_plan byte for byte."""
    T = sp.csr_matrix(T)
    T.sort_indices()
    n = T.shape[0]
    lev = _levels(T, lower)
    nlev = int(lev.max()) + 1 if n > 0 else 1
    dtype = np_dtype(dtype) or T.dtype

    # group rows by level, padded with sentinel n: a stable argsort by
    # level gives each level's rows in ascending row order
    counts = np.bincount(lev, minlength=nlev)
    rmax = max(int(counts.max()), 1)
    if pad_to is not None:
        nlev = max(nlev, pad_to[0])
        rmax = max(rmax, pad_to[1])
        counts = np.bincount(lev, minlength=nlev)
    level_rows = np.full((nlev, rmax), n, dtype=np.int32)
    order = np.argsort(lev, kind="stable") if n else np.zeros(0, np.int64)
    starts = np.zeros(nlev + 1, np.int64)
    starts[1:] = np.cumsum(counts)
    pos = np.arange(n) - starts[lev[order]] if n else order
    level_rows[lev[order], pos] = order.astype(np.int32)

    # off-diagonal ELL (padding col = n → reads the sentinel slot, val 0)
    ai, aj, av = T.indptr, T.indices, T.data
    diag = np.ones(n, dtype=dtype)
    rows_all = np.repeat(np.arange(n), np.diff(ai))
    is_diag = aj == rows_all
    if not unit_diag and is_diag.any():
        diag[rows_all[is_diag]] = av[is_diag]
    keep = ~is_diag
    rk = rows_all[keep]
    off_counts = np.bincount(rk, minlength=n)
    K = max(int(off_counts.max()) if n else 0, 1)
    if pad_to is not None:
        K = max(K, pad_to[2])
    cols = np.full((n + 1, K), n, dtype=np.int32)
    vals = np.zeros((n + 1, K), dtype=dtype)
    row_start = np.zeros(n + 1, np.int64)
    row_start[1:] = np.cumsum(off_counts)
    slot = np.arange(len(rk)) - row_start[rk] if len(rk) else rk
    cols[rk, slot] = aj[keep]
    vals[rk, slot] = av[keep]
    dinv = (1.0 / diag).astype(dtype)
    return level_rows, cols, vals, dinv, n, nlev


def stacked_sptrsv_plan(tris, lower: bool, unit_diag: bool, dtype=None,
                        device=None) -> SpTRSVPlan:
    """One stacked plan of same-size triangles, each padded to the common
    (nlev, rmax, K): petsctpu/pc/parallel.py::_stacked_tri_plans, whose
    vmap over subdomains becomes the plan's leading axis."""
    with log_event("MatSolvePlan"):
        nlev = rmax = K = 1
        for T in tris:
            T = sp.csr_matrix(T)
            lev = _levels(T, lower)
            nl = int(lev.max()) + 1 if T.shape[0] else 1
            rm = max(int(np.bincount(lev, minlength=nl).max()), 1)
            offk = max(int((np.diff(T.indptr) - (0 if unit_diag else 1))
                           .max()) if T.nnz else 0, 1)
            nlev, rmax, K = max(nlev, nl), max(rmax, rm), max(K, offk + 1)
        parts = [sptrsv_arrays(T, lower, unit_diag, dtype, (nlev, rmax, K))
                 for T in tris]
        return SpTRSVPlan(*(np.stack([p[i] for p in parts])
                            for i in range(4)), parts[0][4], parts[0][5],
                          device=device)


class DenseTRSVPlan:
    """Dense triangular solve: the reference's fallback for small
    factors (n ≤ 4096) whose fill is neither band-viable nor shallow in
    levels (SuperLU ILUT factors)."""

    def __init__(self, T: torch.Tensor, lower: bool = True,
                 unit: bool = False):
        self.T = T
        self.lower = lower
        self.unit = unit

    def solve(self, b: torch.Tensor) -> torch.Tensor:
        return torch.linalg.solve_triangular(
            self.T, b[:, None], upper=not self.lower,
            unitriangular=self.unit)[:, 0]


def make_dense_trsv_plan(T, lower: bool, unit_diag: bool, dtype=None,
                         device=None) -> DenseTRSVPlan:
    D = np.asarray(sp.csr_matrix(T).toarray(), np_dtype(dtype) or T.dtype)
    if unit_diag:
        np.fill_diagonal(D, 1.0)
    return DenseTRSVPlan(torch.from_numpy(D).to(resolve_device(device)),
                         lower, unit_diag)


def band_dims(T, lower: bool, tile: int = 128) -> tuple:
    """(nt, W) the reference's banded plans would use for T."""
    T = sp.csr_matrix(T)
    nt = max(-(-T.shape[0] // tile), 1)
    coo = T.tocoo()
    toff = coo.col - (coo.row // tile) * tile
    outside = (toff < 0) if lower else (toff >= tile)
    B = int(np.abs(toff[outside] - (0 if lower else tile - 1)).max()) \
        if outside.any() else 1
    return nt, max(-(-B // tile), 1) * tile


def band_solve_viable(tris_lower, tris_upper, dtype,
                      mem_cap_bytes: int = 2 * 1024 * 1024 * 1024,
                      tile: int = 128) -> bool:
    """The reference's probe for its banded two-phase plan
    (petsctpu/pc/parallel.py::band_solve_viable): fp32 factors whose
    dense band storage fits the cap. The port solves those by levels;
    the probe keeps the reference's choice of the dense plan for the
    others."""
    if (np_dtype(dtype) or np.dtype(np.float64)) != np.float32:
        return False
    total = 0
    for tris, lower in ((tris_lower, True), (tris_upper, False)):
        for T in tris:
            nt, W = band_dims(T, lower, tile)
            L = max(int(np.ceil(np.sqrt(nt))), 1)
            G = -(-nt // L)
            total += (2 * L * G * tile * W + G * W * W
                      + L * G * tile * tile) * 4
    return total <= mem_cap_bytes


# ---------------------------------------------------------------------------
# Banded triangular solves (petsctpu's BandTRSVPlan, BandTRSVHierPlan)
# ---------------------------------------------------------------------------

class BandTRSVPlan:
    """Blocked banded back-substitution x = T⁻¹ b: each [T, T] diagonal
    tile inverted densely at setup, then one step a tile,

        x_t = Dinv_t (b_t − Off_t @ x_window),

    two small dense products a step; Off_t covers the W = ⌈B/T⌉·T
    columns left of (lower) or right of (upper) the tile, and the window
    carries them. petsctpu scans the tiles in one lax.scan; here it is
    a Python loop of PyTorch products (TF32 off, device.py)."""

    def __init__(self, dinv_tiles: torch.Tensor, off_tiles: torch.Tensor,
                 lower: bool = True, tile: int = 128, n: int = 0):
        self.dinv_tiles = dinv_tiles         # [nt, T, T]
        self.off_tiles = off_tiles           # [nt, T, W]
        self.lower = lower
        self.tile = int(tile)
        self.n = int(n)

    def solve(self, b: torch.Tensor) -> torch.Tensor:
        T = self.tile
        nt, _, W = self.off_tiles.shape
        bt = torch.zeros(nt * T, dtype=b.dtype, device=b.device)
        bt[:self.n] = b
        bt = bt.reshape(nt, T)
        win = torch.zeros(W, dtype=b.dtype, device=b.device)
        xs = [None] * nt
        steps = range(nt) if self.lower else range(nt - 1, -1, -1)
        for t in steps:
            xt = self.dinv_tiles[t] @ (bt[t] - self.off_tiles[t] @ win)
            win = (torch.cat([win[T:], xt]) if self.lower
                   else torch.cat([xt, win[:W - T]]))
            xs[t] = xt
        return torch.cat(xs)[:self.n]


class BandTRSVHierPlan:
    """Two-phase blocked banded solve, sequential depth O(L + G) rather
    than O(nt): the window recurrence w_t = A_t w_{t-1} + c_t has
    propagators fixed by the factors, so the groups' products P_g and
    the prefix rows R are precomputed. A solve: (1) particular
    solutions of all G groups at once from a zero window (L steps of
    batched products); (2) the boundary recurrence over the groups
    ([W, W] products); (3) one batched correction x += R · v_g. The
    upper triangle's reversal is baked in at setup."""

    def __init__(self, dinv_tiles, off_tiles, Pg, R, lower: bool = True,
                 tile: int = 128, n: int = 0, nt: int = 0):
        self.dinv_tiles = dinv_tiles         # [L, G, T, T]
        self.off_tiles = off_tiles           # [L, G, T, W]
        self.Pg = Pg                         # [G, W, W]
        self.R = R                           # [L, G, T, W]
        self.lower = lower
        self.tile = int(tile)
        self.n = int(n)
        self.nt = int(nt)

    def solve(self, b: torch.Tensor) -> torch.Tensor:
        L, G, T, W = self.off_tiles.shape
        bt = torch.zeros(self.nt * T, dtype=b.dtype, device=b.device)
        bt[:self.n] = b
        bt = bt.reshape(self.nt, T)
        if not self.lower:
            bt = bt.flip(0)
        bb = torch.cat([bt, bt.new_zeros(L * G - self.nt, T)])
        bb = bb.reshape(G, L, T).transpose(0, 1)           # [L, G, T]
        # phase 1: particular solutions, all groups at once
        win = bb.new_zeros(G, W)
        x0 = []
        for l in range(L):
            acc = torch.bmm(self.off_tiles[l], win[:, :, None])[..., 0]
            xt = torch.bmm(self.dinv_tiles[l],
                           (bb[l] - acc)[:, :, None])[..., 0]
            win = torch.cat([win[:, T:], xt], dim=1)
            x0.append(xt)
        # phase 2: each group's entry window
        v = bb.new_zeros(W)
        vs = []
        for g in range(G):
            vs.append(v)
            v = self.Pg[g] @ v + win[g]
        vs = torch.stack(vs)                               # [G, W]
        # phase 3: the batched correction
        x = torch.stack(x0) + torch.einsum("lgtw,gw->lgt", self.R, vs)
        x = x.transpose(0, 1).reshape(-1)[:self.nt * T]
        if not self.lower:
            x = x.reshape(self.nt, T).flip(0).reshape(-1)
        return x[:self.n]


def _hier_propagators(dinv_gl: torch.Tensor, off_gl: torch.Tensor):
    """The group propagators Pg [G, W, W] and prefix rows R [L, G, T, W]:
    with M_t = −Dinv_t Off_t, Q ← [Q[T:], M_t Q] over a group's L steps
    from the identity, R_t = M_t Q."""
    G, L, T, W = off_gl.shape
    M = -torch.einsum("glij,gljw->gliw", dinv_gl, off_gl)
    Q = torch.eye(W, dtype=off_gl.dtype, device=off_gl.device) \
        .expand(G, W, W)
    R = []
    for l in range(L):
        Rl = torch.bmm(M[:, l], Q)
        Q = torch.cat([Q[:, T:, :], Rl], dim=1)
        R.append(Rl)
    return Q, torch.stack(R)


def make_band_trsv_plan(Tmat, lower: bool, unit_diag: bool, dtype=None,
                        tile: int = None, pad_to: tuple = None,
                        device=None) -> BandTRSVPlan:
    """A banded back-substitution plan of a scipy triangle, petsctpu's
    tiles byte for byte. tile None: 256 but for small systems (128 at
    n ≤ 1536). pad_to=(nt, W) forces at-least dimensions (identity
    diagonal tiles, zero off columns on the window's far side)."""
    dtiles, otiles, T, n = band_trsv_tiles(Tmat, lower, unit_diag, dtype,
                                           tile, pad_to)
    dev = resolve_device(device)
    return BandTRSVPlan(torch.from_numpy(dtiles).to(dev),
                        torch.from_numpy(otiles).to(dev), lower, T, n)


def band_trsv_tiles(Tmat, lower: bool, unit_diag: bool, dtype=None,
                    tile: int = None, pad_to: tuple = None):
    """The host tiles (inverted diagonal tiles [nt, T, T], off tiles
    [nt, T, W]), T and n of make_band_trsv_plan."""
    Tmat = sp.csr_matrix(Tmat)
    n = Tmat.shape[0]
    coo = Tmat.tocoo()
    T = tile if tile is not None else (256 if n > 1536 else 128)
    nt, W = band_dims(Tmat, lower, T)
    if pad_to is not None:
        nt, W = max(nt, pad_to[0]), max(W, pad_to[1])
    dt = np_dtype(dtype) or Tmat.dtype
    dtiles = np.zeros((nt, T, T), dt)
    otiles = np.zeros((nt, T, W), dt)
    t_of, i_of = coo.row // T, coo.row % T
    base = t_of * T
    in_diag = (coo.col >= base) & (coo.col < base + T)
    dtiles[t_of[in_diag], i_of[in_diag],
           (coo.col - base)[in_diag]] = coo.data[in_diag]
    off = ~in_diag
    ocol = (coo.col - (base - W)) if lower else (coo.col - (base + T))
    otiles[t_of[off], i_of[off], ocol[off]] = coo.data[off]
    diag_view = np.einsum("tkk->tk", dtiles)     # a writable view
    if unit_diag:
        diag_view[:] = 1.0
    else:
        # rows past n get the identity, so the tile is invertible
        diag_view[diag_view == 0] = 1.0
    eye = np.broadcast_to(np.eye(T, dtype=dtiles.dtype), dtiles.shape)
    return np.linalg.solve(dtiles, eye), otiles, T, n


def make_band_trsv_hier_plan(Tmat, lower: bool, unit_diag: bool, dtype=None,
                             tile: int = None, group_len: int = None,
                             pad_to: tuple = None,
                             device=None) -> BandTRSVHierPlan:
    """The two-phase plan: the flat plan's tiles (tile 128 by default,
    petsctpu's), grouped by L = ⌈√nt⌉ steps, with the propagators
    computed on the device."""
    dinv, off, T, n = band_trsv_tiles(Tmat, lower, unit_diag, dtype,
                                      tile or 128, pad_to)
    nt, _, W = off.shape
    if not lower:
        # bake the upper chain's reversal in: the window holds the
        # produced tiles in reversed order, so the off columns' T-blocks
        # flip too
        dinv = dinv[::-1].copy()
        off = off[::-1].reshape(nt, T, W // T, T)[:, :, ::-1, :] \
            .reshape(nt, T, W).copy()
    L = group_len or max(int(np.ceil(np.sqrt(nt))), 1)
    G = -(-nt // L)
    pad = L * G - nt
    if pad:
        # identity steps producing x = 0, appended
        dinv = np.concatenate([dinv, np.tile(np.eye(T, dtype=dinv.dtype),
                                             (pad, 1, 1))])
        off = np.concatenate([off, np.zeros((pad, T, W), off.dtype)])
    dev = resolve_device(device)
    dinv_gl = torch.from_numpy(dinv.reshape(G, L, T, T)).to(dev)
    off_gl = torch.from_numpy(off.reshape(G, L, T, W)).to(dev)
    Pg, R = _hier_propagators(dinv_gl, off_gl)
    return BandTRSVHierPlan(dinv_gl.transpose(0, 1).contiguous(),
                            off_gl.transpose(0, 1).contiguous(), Pg, R,
                            lower, T, n, nt)


class StackedPlans:
    """nb plans of one shape solving b [nb, n] one after another (the
    bjacobi/ASM subdomains on a banded route; petsctpu vmaps them)."""

    def __init__(self, plans):
        self.plans = tuple(plans)

    def solve(self, b: torch.Tensor) -> torch.Tensor:
        return torch.stack([p.solve(bi) for p, bi in zip(self.plans, b)])


def stacked_band_hier_plans(tris, lower: bool, unit_diag: bool, dtype=None,
                            device=None, tile: int = 128) -> StackedPlans:
    """Two-phase banded plans of the subdomain triangles, padded to a
    common (nt, W) as petsctpu's _stacked_band_hier_plans does."""
    nt = W = 1
    for T in tris:
        nti, Wi = band_dims(T, lower, tile)
        nt, W = max(nt, nti), max(W, Wi)
    return StackedPlans(make_band_trsv_hier_plan(
        T, lower=lower, unit_diag=unit_diag, dtype=dtype, tile=tile,
        pad_to=(nt, W), device=device) for T in tris)
