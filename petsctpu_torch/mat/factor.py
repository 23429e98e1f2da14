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
subdomains). DenseTRSVPlan is the reference's small dense fallback
(torch.linalg.solve_triangular, as the reference maps it to XLA's).
The band plans of the reference (BandTRSVPlan, BandTRSVHierPlan) are
ROADMAP queue 1 item 9; only their cheap viability probe
(band_solve_viable) is here, for the reference's tri=auto rule.

Setup is logged under three events (core/logging.py): MatFactorNumeric
(ILU(0), IC and LU numerics), MatSolveLevels (the triangles' levels)
and MatSolvePlan (building plans, their levels included).
"""

from __future__ import annotations

import numpy as np
import scipy.sparse as sp
import scipy.sparse.linalg as spla
import torch

from petsctpu_torch.core.logging import log_event
from petsctpu_torch.device import np_dtype, resolve_device
from petsctpu_torch.mat import host_factor
from petsctpu_torch.ops.sptrsv import level_order, sptrsv


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
    [nb] (each plan's levels before its padded ones) and rmax, the most
    rows a level holds.
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
        self.order = tuple(torch.from_numpy(a).to(dev) for a in order)
        self.nlevs = torch.from_numpy(nlevs).to(dev)

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
                   nlevs=self.nlevs, rmax=self.rmax)
        return x if self.stacked else x[0]


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
