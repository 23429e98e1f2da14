"""Device-side GAMG re-setup: the algebraic hierarchy refreshed on the
card, and the dense LU coarse solve of the packed algebraic MG.

The port's copy of petsctpu/pc/gamg_device.py. Every Newton or TS
operator refresh re-runs PCSetUp_GAMG in the reference
(src/ksp/pc/impls/gamg/gamg.c:533): graph, aggregation, prolongator
smoothing (agg.c:1110) and Galerkin MatPtAP (gamg.c:156), all host
work. Here the symbolic side is frozen once (aggregates, the tentative
P0, every product pattern: the matmatmult.c:29 symbolic/numeric split)
and the numeric hierarchy is rebuilt on the plan's device from the
fine operator's sorted-CSR data:

    per level:  dinv, λmax(D⁻¹A) by power iteration,
                P = P0 − ω D⁻¹A P0        (frozen union pattern)
                A_{l+1} = Pᵀ A_l P        (chained SpGEMM plans, or
                                           colored probes)
    coarsest:   dense LU (torch.linalg.lu_factor_ex)

Two routes: GAMGDevicePlan multiplies through mat/spgemm.py's plans;
GAMGProbePlan probes the products with colored SpMVs (distance-2
colorings of the product patterns, mat/host_graph.py::greedy_color),
on SELL (kernel K2) where a square fp32 pattern is SELL-viable on a
CUDA device, else on ELL. `refresh(a_data)` is a plain function on
tensors: its scatters write distinct slots (checked at plan time), so
it is deterministic on the card, and it reads the host once, for the
levels' λ (the Chebyshev bounds are Python numbers, pc/mg.py).
"""

from __future__ import annotations

import numpy as np
import scipy.sparse as sp
import torch

from petsctpu_torch.device import np_dtype, resolve_device
from petsctpu_torch.mat.ell import AIJ, aij_from_scipy
from petsctpu_torch.mat.spgemm import (SpGEMMPlan, _csr_entry_index,
                                       _ell_positions, _fill_template)
from petsctpu_torch.pc.gamg import (smooth_prolongator, strength_graph,
                                    tentative_prolongator)
from petsctpu_torch.pc.mg import ChebySmoother, MGLevel, MGPC


class DenseLUPC:
    """Coarse exact solve from scipy.linalg.lu_factor's (lu, piv).

    piv is scipy's: 0-based row interchanges (row i was swapped with row
    piv[i], in order). torch.linalg.lu_solve takes LAPACK's 1-based
    pivots, so the apply uses piv + 1; from_lu_factor takes
    torch.linalg.lu_factor's, which are LAPACK's already."""

    def __init__(self, lu: torch.Tensor, piv: torch.Tensor):
        self.lu = lu
        self.pivots = (piv + 1).to(torch.int32)

    @classmethod
    def from_lu_factor(cls, lu: torch.Tensor, pivots: torch.Tensor):
        self = cls.__new__(cls)
        self.lu = lu
        self.pivots = pivots.to(torch.int32)
        return self

    def apply(self, b):
        return torch.linalg.lu_solve(self.lu, self.pivots, b[:, None])[:, 0]


def _i32(a, dev) -> torch.Tensor:
    a = np.asarray(a)
    if a.size and int(a.max()) >= 2 ** 31:
        raise ValueError("index beyond int32, the reference's index width")
    return torch.from_numpy(a.astype(np.int32)).to(dev)


def _distinct(idx, what: str) -> None:
    """A scatter's slots must be distinct: a scatter-add is then one add
    a slot, deterministic on the card."""
    idx = np.asarray(idx)
    if np.unique(idx).size != idx.size:
        raise ValueError(f"{what}: repeated slots in a scatter")


def _jacobi(A):
    d = A.diagonal()
    one = torch.ones((), dtype=d.dtype, device=d.device)
    nz = d != 0
    return torch.where(nz, 1.0 / torch.where(nz, d, one), one)


def _power_lambda_device(A, dinv, v0, iters: int):
    """λmax(D⁻¹A) by `iters` power steps from v0, on the device (a 0-d
    tensor; no host read)."""
    v = v0
    lam = torch.ones((), dtype=dinv.dtype, device=dinv.device)
    for _ in range(iters):
        w = dinv * A.mult(v)
        lam = torch.linalg.vector_norm(w)
        v = w / torch.clamp_min(lam, 1e-30)
    return lam


def _omega(lam):
    return 4.0 / (3.0 * torch.clamp_min(lam, 1e-12))


def _finish(pending, lams, a_data, coarse_rows, coarse_cols, nc, sm_its,
            cycles) -> MGPC:
    """The refreshed MGPC: the dense coarse LU on the device, and the
    levels' Chebyshev bounds [0.1, 1.1]·λ in the solve's dtype, read
    from the device in one copy (the refresh's one host sync)."""
    dense = a_data.new_zeros((nc, nc))
    dense[coarse_rows, coarse_cols] = a_data
    lu, piv, _ = torch.linalg.lu_factor_ex(dense)
    dt = np_dtype(a_data.dtype).type
    lam_h = torch.stack(lams).cpu().numpy() if lams else ()
    levels = [MGLevel(A, P, ChebySmoother(dinv, dt(0.1) * lam,
                                          dt(1.1) * lam, sm_its))
              for (A, P, dinv), lam in zip(pending, lam_h)]
    return MGPC(tuple(levels), DenseLUPC.from_lu_factor(lu, piv), None,
                cycles)


def _p0_in_pu(lp) -> torch.Tensor:
    """The level's frozen P0 values in its union pattern Pu's CSR slots."""
    pu0 = lp.p0_data.new_zeros(lp.pu_nnz)
    pu0[lp.p0_slot] = lp.p0_data
    return pu0


class GAMGLevelPlan:
    """Frozen symbolic plan for one level transition (A_l -> A_{l+1})."""

    def __init__(self, p0_data, p0_slot, prod_plan, prod_slot, ap_plan,
                 ptap_plan, c_sel, pt_perm, a_rows, a_tmpl, a_ell_pos,
                 p_tmpl, p_ell_pos, v0, pu_nnz=0):
        self.p0_data = p0_data      # tentative prolongator values (CSR)
        self.p0_slot = p0_slot      # P0 entry -> slot in the union Pu
        self.prod_plan = prod_plan  # (D⁻¹A) @ P0
        self.prod_slot = prod_slot  # product entry -> slot in Pu
        self.ap_plan = ap_plan      # A @ Pu
        self.ptap_plan = ptap_plan  # Puᵀ @ (A Pu)
        self.c_sel = c_sel          # ptap slot -> next operator's pattern
        self.pt_perm = pt_perm      # Pu CSR data -> Puᵀ CSR data
        self.a_rows = a_rows        # row of each A data slot
        self.a_tmpl = a_tmpl        # ELL template of A_l
        self.a_ell_pos = a_ell_pos
        self.p_tmpl = p_tmpl        # ELL template of Pu
        self.p_ell_pos = p_ell_pos
        self.v0 = v0                # fixed power-iteration start
        self.pu_nnz = pu_nnz

    def p0(self) -> AIJ:
        """The frozen tentative prolongator, on Pu's ELL pattern."""
        return _fill_template(self.p_tmpl, self.p_ell_pos, _p0_in_pu(self))


class GAMGDevicePlan:
    """refresh(a_data) -> MGPC, on the plan's device."""

    def __init__(self, levels, coarse_rows, coarse_cols, csr_from_ell,
                 nc=0, sm_its=2, power_its=12, cycles=1):
        self.levels = tuple(levels)
        self.coarse_rows = coarse_rows  # coarsest CSR entry -> (i, j)
        self.coarse_cols = coarse_cols
        self.csr_from_ell = csr_from_ell  # fine ELL slot of each CSR entry
        self.nc = nc
        self.sm_its = sm_its
        self.power_its = power_its
        self.cycles = cycles

    def refresh(self, a_data: torch.Tensor) -> MGPC:
        pending, lams = [], []
        for lp in self.levels:
            A = _fill_template(lp.a_tmpl, lp.a_ell_pos, a_data)
            dinv = _jacobi(A)
            lam = _power_lambda_device(A, dinv, lp.v0, self.power_its)
            da = dinv[lp.a_rows] * a_data
            prod = lp.prod_plan.numeric_data(da, lp.p0_data)
            pu = _p0_in_pu(lp).index_add_(0, lp.prod_slot,
                                          -_omega(lam) * prod)
            P = _fill_template(lp.p_tmpl, lp.p_ell_pos, pu)
            ap = lp.ap_plan.numeric_data(a_data, pu)
            a_data = lp.ptap_plan.numeric_data(pu[lp.pt_perm], ap)[lp.c_sel]
            pending.append((A, P, dinv))
            lams.append(lam)
        return _finish(pending, lams, a_data, self.coarse_rows,
                       self.coarse_cols, self.nc, self.sm_its, self.cycles)

    def refresh_from_ell(self, A: AIJ) -> MGPC:
        """Refresh from a device AIJ whose pattern matches the plan's
        fine template (e.g. a colored-FD Jacobian on the same
        sparsity)."""
        return self.refresh(A.vals.reshape(-1)[self.csr_from_ell])


def _pattern(M) -> sp.csr_matrix:
    """Boolean (value-independent) sparsity of M."""
    M = sp.csr_matrix(M).copy()
    M.data = np.ones_like(M.data)
    return M


def _slot_in(U: sp.csr_matrix, M: sp.csr_matrix) -> np.ndarray:
    """CSR data slot in U of every entry of M (pattern(M) ⊆ pattern(U))."""
    U = _csr_entry_index(U)
    M = _csr_entry_index(M)
    ncols = U.shape[1]
    u_rows = np.repeat(np.arange(U.shape[0], dtype=np.int64),
                       np.diff(U.indptr))
    ukeys = u_rows * ncols + U.indices
    m_rows = np.repeat(np.arange(M.shape[0], dtype=np.int64),
                       np.diff(M.indptr))
    return np.searchsorted(ukeys, m_rows * ncols + M.indices)


def _transpose_perm(P: sp.csr_matrix) -> np.ndarray:
    """perm with Pt.data == P.data[perm] for sorted-CSR P and Pt=P.T."""
    P = _csr_entry_index(P)
    rows = np.repeat(np.arange(P.shape[0], dtype=np.int64),
                     np.diff(P.indptr))
    cols = P.indices.astype(np.int64)
    return np.lexsort((rows, cols))      # Pt's sorted order: (col, row)


def _level_p0(Al_num, n, theta, p0s, nlev, dt):
    """The level's tentative prolongator: p0s[nlev] (the blocked/RBM
    route), or the aggregation of the numeric operator; None where the
    hierarchy stops."""
    from petsctpu_torch.mat.host_graph import aggregate

    if p0s is not None:
        if nlev >= len(p0s):
            return None
        P0 = _csr_entry_index(sp.csr_matrix(p0s[nlev]).astype(dt))
        return None if P0.shape[1] >= P0.shape[0] else P0
    agg = aggregate(strength_graph(Al_num, theta))
    if int(agg.max()) + 1 >= n:
        return None
    return _csr_entry_index(tentative_prolongator(agg).astype(dt))


def _coarse_index(Al, dev):
    c_rows = np.repeat(np.arange(Al.shape[0], dtype=np.int64),
                       np.diff(Al.indptr))
    return _i32(c_rows, dev), _i32(Al.indices, dev)


def gamg_device_plan(A_host, theta: float = 0.0, coarse_n: int = 64,
                     max_levels: int = 10, sm_its: int = 2,
                     cycles: int = 1, dtype=np.float32,
                     p0s=None, device=None) -> GAMGDevicePlan:
    """Build the frozen symbolic plan from the initial operator.

    Aggregation runs once on the initial values (as the reference
    re-uses the graph under -pc_gamg_reuse_interpolation); every later
    refresh reuses the aggregates and patterns.

    p0s: optional precomputed tentative prolongators per level (host
    CSR) — the blocked/rigid-body-mode route (pc/asa.asa_tentatives for
    elasticity); aggregation is skipped."""
    dev = resolve_device(device)
    A = _csr_entry_index(sp.csr_matrix(A_host).astype(dtype))
    dt = np.dtype(dtype).type
    rng = np.random.default_rng(11)
    tmplA = aij_from_scipy(A, dtype=dt, device=dev)
    posA = _ell_positions(A, tmplA)

    levels = []
    Al = A            # pattern-superset operator (plan structure)
    Al_num = A        # numeric operator (drives aggregation quality)
    tmpl_l, pos_l = tmplA, posA
    while Al.shape[0] > coarse_n and len(levels) < max_levels - 1:
        P0 = _level_p0(Al_num, Al.shape[0], theta, p0s, len(levels), dt)
        if P0 is None:
            break
        Apat = _pattern(Al)
        prod_pat = _csr_entry_index((Apat @ _pattern(P0)).tocsr())
        Pu_pat = _csr_entry_index(
            ((_pattern(P0) + prod_pat) > 0).astype(dt).tocsr())
        # plan on patterns only: planning with P0's values would let
        # scipy prune exact cancellations and desync the slot maps
        prod_plan = SpGEMMPlan.plan(Apat, _pattern(P0), dtype=dt, device=dev)
        ap_plan = SpGEMMPlan.plan(Apat, Pu_pat, dtype=dt, device=dev)
        APu_pat = _csr_entry_index((Apat @ Pu_pat).tocsr())
        PuT_pat = _csr_entry_index(Pu_pat.T.tocsr())
        ptap_plan = SpGEMMPlan.plan(PuT_pat, APu_pat, dtype=dt, device=dev)
        C_sup = _csr_entry_index((PuT_pat @ APu_pat).tocsr())
        # the numeric hierarchy (host, once): the next aggregation and
        # the next level's pattern (chaining C_sup would compound density)
        P_num = smooth_prolongator(Al_num, P0)
        Al_num = _csr_entry_index((P_num.T @ Al_num @ P_num).tocsr())
        Anext = _csr_entry_index(_pattern(Al_num))
        p0_slot = _slot_in(Pu_pat, P0)
        prod_slot = _slot_in(Pu_pat, prod_pat)
        _distinct(p0_slot, "P0 -> Pu")
        _distinct(prod_slot, "(D⁻¹A)P0 -> Pu")
        a_rows = np.repeat(np.arange(Al.shape[0], dtype=np.int64),
                           np.diff(Al.indptr))
        v0 = rng.standard_normal(Al.shape[0]).astype(dt)
        v0 /= np.linalg.norm(v0)
        p_tmpl = aij_from_scipy(Pu_pat, dtype=dt, device=dev)
        levels.append(GAMGLevelPlan(
            torch.from_numpy(P0.data.astype(dt)).to(dev),
            _i32(p0_slot, dev), prod_plan, _i32(prod_slot, dev),
            ap_plan, ptap_plan, _i32(_slot_in(C_sup, Anext), dev),
            _i32(_transpose_perm(Pu_pat), dev), _i32(a_rows, dev),
            tmpl_l, torch.from_numpy(pos_l).to(dev), p_tmpl,
            torch.from_numpy(_ell_positions(Pu_pat, p_tmpl)).to(dev),
            torch.from_numpy(v0).to(dev), int(Pu_pat.nnz)))
        Al = Anext
        tmpl_l = aij_from_scipy(Al, dtype=dt, device=dev)
        pos_l = _ell_positions(Al, tmpl_l)

    rows, cols = _coarse_index(Al, dev)
    return GAMGDevicePlan(levels, rows, cols, torch.from_numpy(posA).to(dev),
                          int(Al.shape[0]), sm_its, 12, cycles)


def csr_data_of_matching(A_host, dtype=np.float32) -> np.ndarray:
    A = _csr_entry_index(sp.csr_matrix(A_host).astype(dtype))
    return A.data


# ---------------------------------------------------------------------------
# comb-probe Galerkin refresh (colored-SpMV probing)
# ---------------------------------------------------------------------------
class PPair:
    """Prolongation with an explicit transpose operator (restriction
    runs Pt.mult instead of P.multT's scatter-add)."""

    def __init__(self, P, Pt):
        self.P = P
        self.Pt = Pt

    def mult(self, x):
        return self.P.mult(x)

    def multT(self, x):
        return self.Pt.mult(x)

    @property
    def shape(self):
        return self.P.shape

    @property
    def vals(self):
        return self.P.vals


def sell_templates_on(dev: torch.device) -> bool:
    """Whether FillTemplate takes SELL on this device: on a CUDA device
    (the reference takes SELL only on the TPU; its CPU run is ELL, as
    the port's)."""
    return dev.type == "cuda"


class FillTemplate:
    """Frozen-pattern operator whose numerics refill on the device.

    SELL (kernel K2, mat/sell.py::sell_fill) for an fp32 square pattern
    that is SELL-viable, where sell_templates_on(device), else ELL.
    Probing multiplies a block of vectors through mult_block."""

    def __init__(self, ell_tmpl, ell_pos, sell_tmpl=None, sell_pos=None,
                 sell_diag=None, use_sell=False):
        self.ell_tmpl = ell_tmpl
        self.ell_pos = ell_pos
        self.sell_tmpl = sell_tmpl
        self.sell_pos = sell_pos
        self.sell_diag = sell_diag
        self.use_sell = use_sell

    @classmethod
    def plan(cls, M: sp.csr_matrix, dtype=np.float32,
             device=None) -> "FillTemplate":
        from petsctpu_torch.mat.sell import sell_template, sell_viable

        dev = resolve_device(device)
        M = _csr_entry_index(sp.csr_matrix(M).astype(dtype))
        tmpl = aij_from_scipy(M, dtype=dtype, device=dev)
        pos = torch.from_numpy(_ell_positions(M, tmpl)).to(dev)
        if (sell_templates_on(dev) and np.dtype(dtype) == np.float32
                and M.shape[0] == M.shape[1] and sell_viable(M)):
            return cls(tmpl, pos, *sell_template(M, device=dev),
                       use_sell=True)
        return cls(tmpl, pos)

    def fill(self, data: torch.Tensor):
        if self.use_sell:
            from petsctpu_torch.mat.sell import sell_fill
            return sell_fill(self.sell_tmpl, self.sell_pos, self.sell_diag,
                             data)
        return _fill_template(self.ell_tmpl, self.ell_pos, data)

    def fill_ell(self, data: torch.Tensor) -> AIJ:
        return _fill_template(self.ell_tmpl, self.ell_pos, data)


def mult_block(op, X: torch.Tensor) -> torch.Tensor:
    """Y[v] = op.mult(X[v]) for a block of vectors X [NV, m]: one SpMV a
    vector on SELL (one K2 launch each), one row-gather SpMM on ELL."""
    from petsctpu_torch.mat.sell import SellMat
    if isinstance(op, SellMat):
        return torch.stack([op.mult(x) for x in X])
    cols, vals = op.cols, op.vals               # [n, K]
    NV = X.shape[0]
    n, K = cols.shape
    Xt = X.T.contiguous()                       # [m, NV]
    chunk = max(1, int(256e6 // max(n * NV * 4, 1)))
    out = X.new_zeros((n, NV))
    for k0 in range(0, K, chunk):
        c = cols[:, k0:k0 + chunk]
        v = vals[:, k0:k0 + chunk]
        out = out + torch.einsum("rk,rkc->rc", v.to(X.dtype), Xt[c])
    return out.T


class GAMGProbeLevelPlan:
    """One level transition of the comb-probe refresh."""

    def __init__(self, a, p, pt, p0_data, p0_slot, prod_slot, prod_pick,
                 p0v, vc, c_pick, pt_perm, v0, pu_nnz=0):
        self.a = a                  # FillTemplate of A_l
        self.p = p                  # FillTemplate of Pu
        self.pt = pt                # FillTemplate of Puᵀ
        self.p0_data = p0_data      # frozen tentative prolongator values
        self.p0_slot = p0_slot      # -> slot in Pu (CSR order)
        self.prod_slot = prod_slot  # (D⁻¹A)P0 entries -> slot in Pu
        self.prod_pick = prod_pick  # flat (color·n + row) picks into W
        self.p0v = p0v              # [ncp, n] = (P0 · color indicators)ᵀ
        self.vc = vc                # [ncc, nc] coarse probe indicators
        self.c_pick = c_pick        # flat (color·nc + row) picks into Y
        self.pt_perm = pt_perm
        self.v0 = v0
        self.pu_nnz = pu_nnz

    def p0(self) -> AIJ:
        """The frozen tentative prolongator, on Pu's ELL pattern."""
        return self.p.fill_ell(_p0_in_pu(self))


class GAMGProbePlan:
    """Device GAMG refresh by comb-probe Galerkin: the three SpGEMM
    numerics of GAMGDevicePlan become ncp + 3·ncc colored SpMVs a level
    and small extraction gathers. Reference being replaced:
    PCSetUp_GAMG's MatPtAP/MatMatMult host chain
    (src/ksp/pc/impls/gamg/agg.c:1110, gamg.c:156)."""

    def __init__(self, levels, coarse_rows, coarse_cols, csr_from_ell,
                 nc=0, sm_its=2, power_its=12, cycles=1):
        self.levels = tuple(levels)
        self.coarse_rows = coarse_rows
        self.coarse_cols = coarse_cols
        self.csr_from_ell = csr_from_ell
        self.nc = nc
        self.sm_its = sm_its
        self.power_its = power_its
        self.cycles = cycles

    def refresh(self, a_data: torch.Tensor) -> MGPC:
        pending, lams = [], []
        for lp in self.levels:
            A = lp.a.fill(a_data)
            dinv = _jacobi(A)
            lam = _power_lambda_device(A, dinv, lp.v0, self.power_its)
            # probe (D⁻¹A)·P0 by prod-pattern column colors
            W = mult_block(A, lp.p0v) * dinv[None, :]     # [ncp, n]
            prod = W.reshape(-1)[lp.prod_pick]
            pu = _p0_in_pu(lp).index_add_(0, lp.prod_slot,
                                          -_omega(lam) * prod)
            P = lp.p.fill(pu)
            Pt = lp.pt.fill(pu[lp.pt_perm])
            # probe Pᵀ A P by coarse-pattern column colors
            X1 = mult_block(P, lp.vc)                     # [ncc, n]
            X2 = mult_block(A, X1)
            Y = mult_block(Pt, X2)                        # [ncc, nc]
            a_data = Y.reshape(-1)[lp.c_pick]
            pending.append((A, PPair(P, Pt), dinv))
            lams.append(lam)
        return _finish(pending, lams, a_data, self.coarse_rows,
                       self.coarse_cols, self.nc, self.sm_its, self.cycles)

    def refresh_from_ell(self, A: AIJ) -> MGPC:
        return self.refresh(A.vals.reshape(-1)[self.csr_from_ell])


def gamg_probe_plan(A_host, theta: float = 0.0, coarse_n: int = 64,
                    max_levels: int = 10, sm_its: int = 2,
                    cycles: int = 1, dtype=np.float32,
                    p0s=None, device=None) -> GAMGProbePlan:
    """Comb-probe refresh plan: the same symbolic hierarchy as
    gamg_device_plan (aggregates and patterns frozen from the initial
    values), with distance-2 column colorings of the product patterns
    (the native greedy_color, MatFDColoring's machinery) instead of
    SpGEMM contribution tables. The flat picks color·n + row stay below
    2³¹, the reference's int32."""
    from petsctpu_torch.mat.host_graph import greedy_color

    dev = resolve_device(device)
    A = _csr_entry_index(sp.csr_matrix(A_host).astype(dtype))
    dt = np.dtype(dtype).type
    rng = np.random.default_rng(11)
    tmplA = aij_from_scipy(A, dtype=dt, device=dev)
    posA = _ell_positions(A, tmplA)

    levels = []
    Al = A
    Al_num = A
    while Al.shape[0] > coarse_n and len(levels) < max_levels - 1:
        n = Al.shape[0]
        P0 = _level_p0(Al_num, n, theta, p0s, len(levels), dt)
        if P0 is None:
            break
        nc = P0.shape[1]
        Apat = _pattern(Al)
        prod_pat = _csr_entry_index((Apat @ _pattern(P0)).tocsr())
        Pu_pat = _csr_entry_index(
            ((_pattern(P0) + prod_pat) > 0).astype(dt).tocsr())
        C_sup = _csr_entry_index((Pu_pat.T @ (Apat @ Pu_pat)).tocsr())
        # numeric hierarchy (host, once) for aggregation + next pattern
        P_num = smooth_prolongator(Al_num, P0)
        Al_num = _csr_entry_index((P_num.T @ Al_num @ P_num).tocsr())
        Anext = _csr_entry_index(_pattern(Al_num))

        # prod probe: color prod_pat columns; W = (D⁻¹A)·(P0·1_color)
        col_p = greedy_color(prod_pat)
        ncp = int(col_p.max()) + 1
        Vp = np.zeros((nc, ncp), dt)
        Vp[np.arange(nc), col_p] = 1.0
        p0v = np.ascontiguousarray(np.asarray(P0 @ Vp).T)  # [ncp, n]
        pr_rows = np.repeat(np.arange(n, dtype=np.int64),
                            np.diff(prod_pat.indptr))
        prod_pick = col_p[prod_pat.indices].astype(np.int64) * n + pr_rows

        # coarse probe: color C_sup columns; extract Anext entries
        col_c = greedy_color(C_sup)
        ncc = int(col_c.max()) + 1
        Vc = np.zeros((nc, ncc), dt)
        Vc[np.arange(nc), col_c] = 1.0
        cn_rows = np.repeat(np.arange(nc, dtype=np.int64),
                            np.diff(Anext.indptr))
        c_pick = col_c[Anext.indices].astype(np.int64) * nc + cn_rows

        p0_slot = _slot_in(Pu_pat, P0)
        prod_slot = _slot_in(Pu_pat, prod_pat)
        _distinct(p0_slot, "P0 -> Pu")
        _distinct(prod_slot, "(D⁻¹A)P0 -> Pu")
        v0 = rng.standard_normal(n).astype(dt)
        v0 /= np.linalg.norm(v0)
        levels.append(GAMGProbeLevelPlan(
            FillTemplate.plan(Al, dt, dev),
            FillTemplate.plan(Pu_pat, dt, dev),
            FillTemplate.plan(Pu_pat.T.tocsr(), dt, dev),
            torch.from_numpy(P0.data.astype(dt)).to(dev),
            _i32(p0_slot, dev), _i32(prod_slot, dev), _i32(prod_pick, dev),
            torch.from_numpy(p0v).to(dev),
            torch.from_numpy(np.ascontiguousarray(Vc.T)).to(dev),
            _i32(c_pick, dev), _i32(_transpose_perm(Pu_pat), dev),
            torch.from_numpy(v0).to(dev), int(Pu_pat.nnz)))
        Al = Anext

    rows, cols = _coarse_index(Al, dev)
    return GAMGProbePlan(levels, rows, cols, torch.from_numpy(posA).to(dev),
                         int(Al.shape[0]), sm_its, 12, cycles)
