"""Factorization preconditioners: LU, ILU(k), ILUTP and ICC(k).

Counterpart of petsctpu/pc/factor.py (reference:
src/ksp/pc/impls/factor/{ilu,lu,cholesky,icc}). The numeric
factorization happens on the host at setup, as in the reference
(mat/factor.py); the apply is two level-scheduled triangular solves on
the device, one SpTRSV launch each (ops/sptrsv.py).

The triangular-solve policy `tri` on the GPU: "auto" is the reference's
rule with its MXU band route (band2) replaced by levels: ILU(k) and
ICC(k) solve by levels, and ILUTP factors take the dense plan where the
reference does (n ≤ 4096, not band-viable, or tri "dense"). "band" and
"band2" (the reference's banded plans) are ROADMAP queue 1 item 9.
`-pc_factor_drop_solver petsc` takes the reference's native ILUDT
(make_iludt, a host Python loop as in the reference).
"""

from __future__ import annotations

import numpy as np
import scipy.sparse as sp
import scipy.sparse.linalg as spla
import torch

from petsctpu_torch.device import np_dtype, resolve_device
from petsctpu_torch.mat.factor import (
    band_solve_viable, icc_factor, icc_pattern, ilu0, iluk_pattern,
    lu_factor, make_dense_trsv_plan, make_sptrsv_plan)


def _tri_policy(tri: str) -> None:
    if tri in ("band", "band2"):
        raise NotImplementedError(
            f"pc_factor_tri_solve {tri}: the reference's banded triangular "
            "plans are not ported yet (ROADMAP queue 1 item 9)")


class ILUPC:
    """x = U⁻¹ L⁻¹ b with L unit lower, U upper."""

    def __init__(self, Lplan, Uplan):
        self.Lplan = Lplan
        self.Uplan = Uplan

    def apply(self, b):
        return self.Uplan.solve(self.Lplan.solve(b))


class ILUPCT(ILUPC):
    """ILU with true transpose solves (-pc_factor_transpose_solves):
    apply = U⁻¹L⁻¹b, apply_transpose = L⁻ᵀU⁻ᵀb through plans of Uᵀ
    (lower) and Lᵀ (upper), PCApplyTranspose → MatSolveTranspose."""

    has_transpose = True

    def __init__(self, Lplan, Uplan, LTplan, UTplan):
        super().__init__(Lplan, Uplan)
        self.LTplan = LTplan
        self.UTplan = UTplan

    def apply_transpose(self, b):
        return self.LTplan.solve(self.UTplan.solve(b))


class LUPC:
    """Exact sparse LU (SuperLU factors, device triangular solves):
    x = Pc U⁻¹ L⁻¹ Pr b."""

    def __init__(self, Lplan, Uplan, perm_r: torch.Tensor,
                 perm_c: torch.Tensor):
        self.Lplan = Lplan
        self.Uplan = Uplan
        self.perm_r = perm_r
        self.perm_c = perm_c

    def apply(self, b):
        # scipy splu convention: x = Pc U⁻¹ L⁻¹ Pr b with
        # (Pr b)[perm_r[i]] = b[i] (scatter) and (Pc z)[i] = z[perm_c[i]]
        # (gather), as in scipy.sparse.linalg.SuperLU's documentation
        pb = torch.zeros_like(b)
        pb[self.perm_r] = b
        z = self.Uplan.solve(self.Lplan.solve(pb))
        return z[self.perm_c]


class PermutedPC:
    """Apply an inner PC in a symmetric permutation: M⁻¹ = Pᵀ M̃⁻¹ P
    (-pc_factor_mat_ordering_type). perm maps new → old."""

    def __init__(self, inner, perm: torch.Tensor):
        self.inner = inner
        self.perm = perm

    @property
    def has_transpose(self):
        return getattr(self.inner, "has_transpose",
                       hasattr(self.inner, "apply_transpose"))

    def apply(self, b):
        z = self.inner.apply(b[self.perm])
        out = torch.zeros_like(b)
        out[self.perm] = z
        return out

    def apply_transpose(self, b):
        # (Pᵀ M̃⁻¹ P)ᵀ = Pᵀ M̃⁻ᵀ P for a symmetric permutation
        z = self.inner.apply_transpose(b[self.perm])
        out = torch.zeros_like(b)
        out[self.perm] = z
        return out


class ICCPC:
    """Incomplete Cholesky apply x = U⁻¹ D⁻¹ U⁻ᵀ b with U unit upper
    (A ≈ UᵀDU from mat/factor.icc_factor; the reference's SBAIJ-form
    MatSolve_SeqSBAIJ_1_NaturalOrdering)."""

    def __init__(self, Lplan, Uplan, dinv: torch.Tensor):
        self.Lplan = Lplan             # solves Uᵀ y = b (unit lower)
        self.Uplan = Uplan             # solves U x = z (unit upper)
        self.dinv = dinv

    def apply(self, b):
        return self.Uplan.solve(self.dinv * self.Lplan.solve(b))


def _perm_tensor(p, dev) -> torch.Tensor:
    return torch.as_tensor(np.asarray(p), dtype=torch.int64).to(dev)


def lupc_from_factors(L, U, perm_r, perm_c, dtype=None, transpose=False,
                      device=None) -> LUPC:
    """An LUPC from SuperLU's factors. transpose=True gives the
    PCApplyTranspose operator of the same factors: apply(b) = A⁻ᵀ b =
    Prᵀ L⁻ᵀ U⁻ᵀ Pcᵀ b — the permutations swap scatter and gather roles
    and the triangular factors swap order."""
    dev = resolve_device(device)
    if transpose:
        L, U = sp.csr_matrix(U.T), sp.csr_matrix(L.T)
        perm_r, perm_c = perm_c, perm_r
    return LUPC(make_sptrsv_plan(L, lower=True, unit_diag=False,
                                 dtype=dtype, device=dev),
                make_sptrsv_plan(U, lower=False, unit_diag=False,
                                 dtype=dtype, device=dev),
                _perm_tensor(perm_r, dev), _perm_tensor(perm_c, dev))


def make_lu(A_host, dtype=None, transpose: bool = False,
            device=None) -> LUPC:
    """LU of a scipy matrix; transpose=True builds the PCApplyTranspose
    operator from the same factorization (precon.c PCApplyTranspose →
    MatSolveTranspose)."""
    return lupc_from_factors(*lu_factor(A_host), dtype=dtype,
                             transpose=transpose, device=device)


def make_ilu(A_host, dtype=None, levels: int = 0, ordering: str = "natural",
             tri: str = "auto", drop_tol: float = 0.0,
             fill_factor: float = 10.0, transpose_solves: bool = False,
             device=None):
    """ILU(k) in an ordering, or with drop_tol > 0 drop-tolerance ILU
    (ILUTP via SuperLU's spilu, x = Pc U⁻¹ L⁻¹ Pr b)."""
    _tri_policy(tri)
    dev = resolve_device(device)
    if drop_tol > 0.0:
        ilu = spla.spilu(sp.csc_matrix(A_host).astype(np.float64),
                         drop_tol=drop_tol, fill_factor=fill_factor)
        L = sp.csr_matrix(ilu.L)             # unit lower, stored diag 1
        U = sp.csr_matrix(ilu.U)
        Lstrict = sp.tril(L, k=-1, format="csr")
        if tri == "auto":
            # the reference: band-viable fp32 factors take its band
            # route (levels here), other small ones the dense plan
            tri = ("level" if band_solve_viable([Lstrict], [U], dtype)
                   or L.shape[0] > 4096 else "dense")
        if tri == "dense":
            Lp = make_dense_trsv_plan(Lstrict + sp.eye(L.shape[0]),
                                      lower=True, unit_diag=True,
                                      dtype=dtype, device=dev)
            Up = make_dense_trsv_plan(U, lower=False, unit_diag=False,
                                      dtype=dtype, device=dev)
        else:
            Lp = make_sptrsv_plan(Lstrict, lower=True, unit_diag=True,
                                  dtype=dtype, device=dev)
            Up = make_sptrsv_plan(U, lower=False, unit_diag=False,
                                  dtype=dtype, device=dev)
        return LUPC(Lp, Up, _perm_tensor(ilu.perm_r, dev),
                    _perm_tensor(ilu.perm_c, dev))
    if ordering not in ("natural", ""):
        from petsctpu_torch.mat.order import get_ordering, permute_symmetric
        perm = get_ordering(A_host, ordering)
        inner = make_ilu(permute_symmetric(A_host, perm), dtype=dtype,
                         levels=levels, tri=tri,
                         transpose_solves=transpose_solves, device=dev)
        return PermutedPC(inner, _perm_tensor(perm, dev))
    return _make_ilu_natural(A_host, dtype, levels, tri, transpose_solves,
                             device=dev)


def widen_to_pattern(A_host, rows) -> sp.csr_matrix:
    """A on a wider sorted pattern (one column array a row, a superset
    of A's), the new entries stored zeros: the ILU(k) input of ilu0."""
    A = sp.csr_matrix(A_host)
    A.sort_indices()
    n = A.shape[0]
    indptr = np.zeros(n + 1, np.int64)
    indptr[1:] = np.cumsum([len(r) for r in rows])
    indices = np.concatenate(rows) if n else np.zeros(0, np.int64)
    arow = np.repeat(np.arange(n), np.diff(A.indptr))
    # an entry's position in its wider row: a search per row, vectorized
    # as a search of (row, col) keys in the row-major key order
    keys = arow * np.int64(n) + A.indices
    wide = np.repeat(np.arange(n), np.diff(indptr)) * np.int64(n) + indices
    data = np.zeros(indices.shape[0])
    data[np.searchsorted(wide, keys)] = A.data
    return sp.csr_matrix((data, indices, indptr), shape=(n, n))


def _make_ilu_natural(A_host, dtype=None, levels: int = 0, tri: str = "auto",
                      transpose_solves: bool = False, device=None) -> ILUPC:
    if levels != 0:
        # symbolic ILU(k) (the reference's MatILUFactorSymbolic level
        # rule), numeric = ILU(0) on the widened pattern
        L, U = ilu0(widen_to_pattern(A_host, iluk_pattern(A_host, levels)))
    else:
        L, U = ilu0(A_host)
    Lp = make_sptrsv_plan(L, lower=True, unit_diag=True, dtype=dtype,
                          device=device)
    Up = make_sptrsv_plan(U, lower=False, unit_diag=False, dtype=dtype,
                          device=device)
    if transpose_solves:
        return ILUPCT(Lp, Up,
                      make_sptrsv_plan(sp.csr_matrix(L.T), lower=False,
                                       unit_diag=True, dtype=dtype,
                                       device=device),
                      make_sptrsv_plan(sp.csr_matrix(U.T), lower=True,
                                       unit_diag=False, dtype=dtype,
                                       device=device))
    return ILUPC(Lp, Up)


def make_icc(A_host, dtype=None, levels: int = 0, ordering: str = "natural",
             tri: str = "auto", shift_type: str = "positive_definite",
             shift_amount: float = None, zeropivot: float = None,
             device=None):
    """ICC(k): the IC(k) level pattern and the reference's UᵀDU numeric
    incomplete Cholesky with its shift (MatCholeskyFactorNumeric_SeqAIJ
    aijfact.c:2076; the PCICC default is the Manteuffel shift,
    icc.c:198)."""
    _tri_policy(tri)
    dev = resolve_device(device)
    if ordering not in ("natural", ""):
        from petsctpu_torch.mat.order import get_ordering, permute_symmetric
        perm = get_ordering(A_host, ordering)
        inner = make_icc(permute_symmetric(A_host, perm), dtype=dtype,
                         levels=levels, tri=tri, shift_type=shift_type,
                         shift_amount=shift_amount, zeropivot=zeropivot,
                         device=dev)
        return PermutedPC(inner, _perm_tensor(perm, dev))
    pattern = (None if levels == 0
               else icc_pattern(sp.csr_matrix(A_host), levels))
    Ustrict, d, _, _ = icc_factor(A_host, pattern_rows=pattern,
                                  shift_type=shift_type, zeropivot=zeropivot,
                                  shift_amount=shift_amount)
    Lp = make_sptrsv_plan(sp.csr_matrix(Ustrict.T), lower=True,
                          unit_diag=True, dtype=dtype, device=dev)
    Up = make_sptrsv_plan(Ustrict, lower=False, unit_diag=True, dtype=dtype,
                          device=dev)
    dt = np_dtype(dtype) or np.dtype(np.float64)
    return ICCPC(Lp, Up, torch.from_numpy((1.0 / d).astype(dt)).to(dev))


def iludt_factor_host(A, dt: float = 0.005, dtcount: int = None,
                      shift: float = 0.0):
    """The reference's NATIVE drop-tolerance ILU, MatILUDTFactor_SeqAIJ
    (aijfact.c:3230), replicated exactly on host numpy — including the
    PetscLLAddSortedLU incremental fill scan (the persistent im[] scan
    limits), the multiplier-magnitude update-dropping rule
    (|m| > dt applies the pivot-row update; m is KEPT in L either
    way), the (nzi_l + dtcount)-largest-magnitude row cut selected by
    the PetscSortSplit quickselect VERBATIM (its tie-handling decides
    which equal-magnitude entries survive), and the zero-pivot
    dt+shift substitution. Returns (L_strict, U) scipy CSR with U
    carrying the TRUE (non-inverted) diagonal.

    Defaults follow the reference: dt=0.005, dtcount=1.5·max row nnz.
    A copy of petsctpu's pure-Python routine (ROADMAP: a host-library
    port when it is on a measured path).
    """
    A = sp.csr_matrix(A)
    A.sort_indices()
    n = A.shape[0]
    rmax = int(np.diff(A.indptr).max())
    if dtcount is None:
        dtcount = int(1.5 * rmax)
    dtcount = min(dtcount, n - 1)

    def sort_split(ncut, v, idx):
        """PetscSortSplit verbatim (sorti.c quickselect partition)."""
        first, last = 0, len(v) - 1
        if ncut < first or ncut > last:
            return
        while True:
            mid = first
            abskey = abs(v[mid])
            for j in range(first + 1, last + 1):
                if abs(v[j]) >= abskey:
                    mid += 1
                    v[mid], v[j] = v[j], v[mid]
                    idx[mid], idx[j] = idx[j], idx[mid]
            v[mid], v[first] = v[first], v[mid]
            idx[mid], idx[first] = idx[first], idx[mid]
            if mid == ncut:
                return
            if mid > ncut:
                last = mid - 1
            else:
                first = mid + 1

    Lrows = [None] * n              # per row: (cols list, vals list)
    Urows = [None] * n              # per row: (cols list incl diag first,
    #                                 vals list; diag NOT inverted here)
    im = np.zeros(n, np.int64)
    ai, aj, aa = A.indptr, A.indices, A.data
    adiag = np.zeros(n, np.int64)
    for i in range(n):
        s, e = ai[i], ai[i + 1]
        d = np.searchsorted(aj[s:e], i)
        assert aj[s + d] == i, f"missing diagonal in row {i}"
        adiag[i] = s + d

    rtmp = np.zeros(n, np.float64)          # PERSISTENT dense work row:
    # the reference only zeroes the jtmp positions after each row, so
    # values written by pivot updates at columns OUTSIDE the kept
    # pattern LEAK into later rows' fill positions — replicated.
    import bisect
    for i in range(n):
        s, e = ai[i], ai[i + 1]
        cols0 = [int(c) for c in aj[s:e]]
        nzi_al = int(adiag[i] - s)
        nzi_au = int(e - adiag[i] - 1)
        jset = sorted(cols0)
        inset = set(jset)
        for c, v in zip(cols0, aa[s:e]):
            rtmp[c] = v                      # overwrite (load)
        # symbolic: walk pivot rows in (dynamic) sorted order
        pos = 0
        while pos < len(jset) and jset[pos] < i:
            row = jset[pos]
            nzbd = len(Lrows[row][0]) + 1
            nidx = int(im[row]) - nzbd
            ucols = Urows[row][0][1:]        # exclude diagonal
            for k in range(nidx):
                entry = ucols[k]
                nzbd += 1
                if entry == i:
                    im[row] = nzbd
                if entry not in inset:
                    inset.add(entry)
                    bisect.insort(jset, entry)
            pos += 1
        jtmp = jset
        # numeric elimination
        for row in jtmp:
            if row >= i:
                break
            multiplier = rtmp[row] * Urows[row][1][0]   # inverted diag
            rtmp[row] = multiplier
            if abs(multiplier) > dt:
                for uc, uv in zip(Urows[row][0][1:], Urows[row][1][1:]):
                    rtmp[uc] -= multiplier * uv
        diag_tmp = rtmp[i]
        vtmp = [rtmp[c] for c in jtmp]
        for c in jtmp:
            rtmp[c] = 0.0
        nzi_bl = sum(1 for c in jtmp if c < i)
        nzi_bu = len(jtmp) - nzi_bl - 1
        jl = list(jtmp[:nzi_bl])
        vl = vtmp[:nzi_bl]
        ncut = nzi_al + dtcount
        if ncut < nzi_bl:
            sort_split(ncut, vl, jl)
            pair = sorted(zip(jl[:ncut], vl[:ncut]))
            jl = [p[0] for p in pair]
            vl = [p[1] for p in pair]
        else:
            ncut = nzi_bl
        Lrows[i] = (jl[:ncut], vl[:ncut])
        nzi = ncut + 1
        ju = list(jtmp[nzi_bl + 1:])
        vu = vtmp[nzi_bl + 1:]
        ncut = nzi_au + dtcount
        if ncut < nzi_bu:
            sort_split(ncut, vu, ju)
            pair = sorted(zip(ju[:ncut], vu[:ncut]))
            ju = [p[0] for p in pair]
            vu = [p[1] for p in pair]
        else:
            ncut = nzi_bu
        nzi += ncut
        if diag_tmp == 0.0:
            diag_tmp = dt + shift
        Urows[i] = ([i] + ju[:ncut], [1.0 / diag_tmp] + vu[:ncut])
        im[i] = nzi

    Lr, Lc, Lv, Ur, Uc, Uv = [], [], [], [], [], []
    for i in range(n):
        for c, v in zip(*Lrows[i]):
            Lr.append(i)
            Lc.append(c)
            Lv.append(v)
        cols, vals = Urows[i]
        Ur.append(i)
        Uc.append(i)
        Uv.append(1.0 / vals[0])             # back to the true diagonal
        for c, v in zip(cols[1:], vals[1:]):
            Ur.append(i)
            Uc.append(c)
            Uv.append(v)
    L = sp.csr_matrix((Lv, (Lr, Lc)), shape=(n, n))
    U = sp.csr_matrix((Uv, (Ur, Uc)), shape=(n, n))
    return L, U


def make_iludt(A_host, dt: float = 0.005, dtcount: int = None,
               dtype=None, device=None) -> ILUPC:
    """PCILU with the reference's native drop-tolerance factorization
    (-pc_factor_drop_tolerance dt,dtcol,maxrowcount with
    -pc_factor_drop_solver petsc -> MatILUDTFactor; ksp ex2_7). Apply =
    the usual level-scheduled L/U solves."""
    L, U = iludt_factor_host(A_host, dt=dt, dtcount=dtcount)
    return ILUPC(
        make_sptrsv_plan(sp.csr_matrix(L), lower=True, unit_diag=True,
                         dtype=dtype, device=device),
        make_sptrsv_plan(sp.csr_matrix(U), lower=False, unit_diag=False,
                         dtype=dtype, device=device))


__all__ = ["ILUPC", "ILUPCT", "LUPC", "PermutedPC", "ICCPC", "make_ilu",
           "make_icc", "make_iludt", "make_lu", "lupc_from_factors"]
