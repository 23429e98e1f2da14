"""PCMG — geometric multigrid on a DA hierarchy.

Counterpart of the geometric part of petsctpu/pc/mg.py (reference:
src/ksp/pc/impls/mg/mg.c — PCMGMCycle_Private :10, PCSetUp_MG :529,
PCApply_MG :296): a level hierarchy with Chebyshev+Jacobi smoothers,
matrix-free Q1 transfers and an exact LU coarse solve; V and W cycles,
full, kaskade and additive MG.

  * Chebyshev bounds come from a power iteration at setup, [0.1, 1.1]·λmax
    of D⁻¹A. They are rounded in the solve's dtype as petsctpu rounds
    them, and the smoother holds them, and every scalar of its
    recurrence, as Python numbers: a scalar times a vector then takes
    PyTorch's fast scalar path, not the broadcast of a 0-d tensor.
  * Galerkin coarse operators: the host setup (make_geometric_mg) uses
    scipy PtAP like the reference's MatPtAP; the device setup
    (make_geometric_mg_device) coarsens a StencilMat on its own device
    by comb probing (mat/stencil.galerkin_coarsen) and reads only λ (one
    number per level) and the coarsest operator back to the host.

GAMG and the packed/stored-transfer variants (PackedMGPC, the SELL
restriction of kernel K3) are ROADMAP queue 1 item 8.
"""

from __future__ import annotations

from typing import Any, Tuple

import numpy as np
import scipy.sparse as sp
import torch

from petsctpu_torch.core.options import Options
from petsctpu_torch.device import np_dtype
from petsctpu_torch.pc.factor import LUPC, make_lu


class ChebySmoother:
    """Fixed-iteration Chebyshev smoother with the Jacobi preconditioner
    (dinv). emin and emax are Python numbers, already rounded in the
    solve's dtype; the recurrence's scalars are computed once, here, in
    that dtype, in petsctpu's order of operations."""

    def __init__(self, dinv: torch.Tensor, emin: float, emax: float,
                 its: int = 2):
        self.dinv = dinv
        self.emin = float(emin)
        self.emax = float(emax)
        self.its = int(its)
        dt = np_dtype(dinv.dtype).type
        emin, emax = dt(emin), dt(emax)
        half, one, two = dt(0.5), dt(1.0), dt(2.0)
        theta = half * (emax + emin)
        delta = half * (emax - emin)
        sigma = theta / delta
        rho = one / sigma
        steps = []
        for _ in range(self.its):
            rho_new = one / (two * sigma - rho)
            steps.append((float(rho_new * rho), float(two * rho_new / delta)))
            rho = rho_new
        self.theta = float(theta)
        self.steps = tuple(steps)

    def smooth(self, A, b, x):
        # KSPSolve_Chebyshev semantics: the scale·M⁻¹r step happens
        # before the max_it-counted loop, so its=k applies k+1
        # corrections in all (cheby.c pre-loop VecAYPX + k updates)
        r = b - A.mult(x)
        d = self.dinv * r / self.theta
        for c_d, c_r in self.steps:
            x = x + d
            r = r - A.mult(d)
            d = c_d * d + c_r * (self.dinv * r)
        return x + d


class MGLevel:
    def __init__(self, A, P, smoother: ChebySmoother, R=None):
        self.A = A                  # operator on this level
        self.P = P                  # prolongation coarser → this level
        self.smoother = smoother
        self.R = R                  # explicit restriction, else P.multT

    def restrict(self, r):
        return self.R.mult(r) if self.R is not None else self.P.multT(r)


class MGPC:
    """Apply one multigrid cycle as a preconditioner: x = MG(b)."""

    def __init__(self, levels: Tuple[MGLevel, ...], coarse: LUPC,
                 coarse_A: Any, cycles: int = 1,
                 mg_type: str = "multiplicative"):
        self.levels = tuple(levels)  # fine .. second-coarsest
        self.coarse = coarse         # exact solve on the coarsest grid
        self.coarse_A = coarse_A
        self.cycles = cycles         # 1 = V, 2 = W
        # PCMGType: multiplicative | additive | full | kaskade
        self.mg_type = mg_type

    def apply(self, b):
        if self.mg_type == "full":
            return self._full(0, b)
        if self.mg_type == "kaskade":
            return self._kaskade(0, b)
        if self.mg_type == "additive":
            return self._additive(b)
        return self._cycle(0, b)

    def _cycle(self, l, b):
        if l == len(self.levels):
            return self.coarse.apply(b)
        lev = self.levels[l]
        x = lev.smoother.smooth(lev.A, b, torch.zeros_like(b))
        for _ in range(self.cycles):
            r = b - lev.A.mult(x)
            xc = self._cycle(l + 1, lev.restrict(r))
            x = x + lev.P.mult(xc)
        return lev.smoother.smooth(lev.A, b, x)

    def _full(self, l, b):
        """F-cycle (PCMGFCycle_Private): solve coarse first, take the
        interpolant as the initial guess, then one V-cycle."""
        if l == len(self.levels):
            return self.coarse.apply(b)
        lev = self.levels[l]
        x = lev.P.mult(self._full(l + 1, lev.restrict(b)))
        x = lev.smoother.smooth(lev.A, b, x)
        r = b - lev.A.mult(x)
        x = x + lev.P.mult(self._cycle(l + 1, lev.restrict(r)))
        return lev.smoother.smooth(lev.A, b, x)

    def _kaskade(self, l, b):
        """Kaskade (PCMGKCycle_Private): coarse solve, interpolate up,
        post-smooth only — no downward residual correction."""
        if l == len(self.levels):
            return self.coarse.apply(b)
        lev = self.levels[l]
        x = lev.P.mult(self._kaskade(l + 1, lev.restrict(b)))
        return lev.smoother.smooth(lev.A, b, x)

    def _additive(self, b):
        """Additive MG (PCApply_MG additive branch): every level smooths
        the restricted right-hand side on its own; corrections sum."""
        rs = [b]
        for lev in self.levels:
            rs.append(lev.restrict(rs[-1]))
        x = self.coarse.apply(rs[-1])
        for l in range(len(self.levels) - 1, -1, -1):
            lev = self.levels[l]
            s = lev.smoother.smooth(lev.A, rs[l], torch.zeros_like(rs[l]))
            x = s + lev.P.mult(x)
        return x


# ---------------------------------------------------------------------------
# setup
# ---------------------------------------------------------------------------
def _power_lambda_max(A: sp.csr_matrix, dinv: np.ndarray,
                      iters: int = 20) -> float:
    """Host power iteration for λmax(D⁻¹A)."""
    rng = np.random.default_rng(11)
    v = rng.standard_normal(A.shape[0])
    v /= np.linalg.norm(v)
    lam = 1.0
    for _ in range(iters):
        w = dinv * (A @ v)
        lam = np.linalg.norm(w)
        if lam == 0:
            return 1.0
        v = w / lam
    return float(lam)


def _cheby_smoother(Ah: sp.csr_matrix, dtype, its: int,
                    pc_type: str = "jacobi", device=None) -> ChebySmoother:
    if pc_type != "jacobi":
        raise NotImplementedError(
            f"mg_levels_pc_type={pc_type} is not ported yet (SOR/SSOR "
            "smoothers: ROADMAP queue 1 item 5)")
    d = Ah.diagonal()
    d = np.where(d != 0, d, 1.0)
    dinv = (1.0 / d).astype(dtype)
    lam = _power_lambda_max(Ah, dinv)
    return ChebySmoother(torch.from_numpy(dinv).to(device),
                         dtype(0.1 * lam), dtype(1.1 * lam), its)


def _mg_options(opts: Options):
    return dict(max_levels=opts.get_int("pc_mg_levels", 0),
                coarse_n=opts.get_int("pc_mg_coarse_size", 65),
                sm_its=opts.get_int("mg_levels_ksp_max_it", 2),
                sm_pc=opts.get_str("mg_levels_pc_type", "jacobi"),
                cycles=2 if opts.get_str("pc_mg_cycle_type", "v") == "w"
                else 1,
                mg_type=opts.get_str("pc_mg_type", "multiplicative"))


def make_geometric_mg(A_host, da, dtype=None, options: Options = None,
                      device=None) -> MGPC:
    """Geometric MG on a DA grid hierarchy with Galerkin PᵀAP coarse
    operators (scipy, on the host) and matrix-free Q1 transfers
    (PCSetUp_MG analog)."""
    from petsctpu_torch.dm.da import q1_interp_scipy
    from petsctpu_torch.mat.stencil import stencil_from_scipy

    o = _mg_options(options or Options())
    dtype = (np_dtype(dtype) or np.dtype(A_host.dtype)).type
    levels = []
    Ah = sp.csr_matrix(A_host)
    cur = da
    while cur.can_coarsen() and Ah.shape[0] > o["coarse_n"] and \
            (o["max_levels"] == 0 or len(levels) < o["max_levels"] - 1):
        coarse = cur.coarsen()
        Ad = stencil_from_scipy(Ah, cur.grid, dtype=dtype, device=device)
        levels.append(MGLevel(Ad, cur.interpolation(coarse),
                              _cheby_smoother(Ah, dtype, o["sm_its"],
                                              o["sm_pc"], Ad.device)))
        Ps = q1_interp_scipy(cur.grid, coarse.grid)
        Ah = (Ps.T @ Ah @ Ps).tocsr()
        cur = coarse
    coarse_A = stencil_from_scipy(Ah, cur.grid, dtype=dtype, device=device)
    coarse_pc = make_lu(Ah, dtype=dtype, device=coarse_A.device)
    return MGPC(tuple(levels), coarse_pc, coarse_A, o["cycles"],
                o["mg_type"])


def _lambda_max_device(A, dinv, v0, iters: int = 20) -> torch.Tensor:
    """Device power iteration for λmax(D⁻¹A), the recurrence of the host
    _power_lambda_max; λ stays on the device (no host read per step)."""
    v, lam = v0, torch.ones((), dtype=v0.dtype, device=v0.device)
    one = torch.ones((), dtype=v0.dtype, device=v0.device)
    for _ in range(iters):
        w = dinv * A.mult(v)
        nrm = torch.linalg.vector_norm(w)
        safe = nrm > 0.0
        v = torch.where(safe, w / torch.where(safe, nrm, one), v)
        lam = torch.where(safe, nrm, one)
    return lam


def mg_device_setup(A, Ps, grids, v0s):
    """The hierarchy setup on A's device: per level the Jacobi
    diagonal, the power-iteration Chebyshev bounds (rounded in the
    dtype, read to the host once) and the comb-probe Galerkin operator
    that feeds the next level. Returns ([(A, dinv, emin, emax)], Ac)."""
    from petsctpu_torch.mat.stencil import galerkin_coarsen

    dt = np_dtype(A.dtype).type
    out = []
    for l, P in enumerate(Ps):
        d = A.diagonal()
        one = torch.ones((), dtype=d.dtype, device=d.device)
        nz = d != 0
        dinv = torch.where(nz, 1.0 / torch.where(nz, d, one), one)
        v0 = v0s[l] / torch.linalg.vector_norm(v0s[l])
        lam_t = _lambda_max_device(A, dinv, v0)
        Ac = galerkin_coarsen(A, P, grids[l + 1])
        lam = dt(lam_t.item())
        out.append((A, dinv, float(dt(0.1) * lam), float(dt(1.1) * lam)))
        A = Ac
    return out, A


def make_geometric_mg_device(Ad, da, dtype=None,
                             options: Options = None) -> MGPC:
    """Geometric MG with Galerkin coarse operators built on the device
    of the fine StencilMat `Ad`.

    Smoother semantics are those of the host path (Chebyshev+Jacobi,
    bounds [0.1, 1.1]·λmax of D⁻¹A); the only host transfers are λ per
    level and the small coarsest operator for its exact LU."""
    from petsctpu_torch.mat.stencil import stencil_to_scipy

    o = _mg_options(options or Options())
    dtype = (np_dtype(dtype) or np_dtype(Ad.dtype)).type
    if o["sm_pc"] != "jacobi":
        raise ValueError("device MG setup supports the Chebyshev+Jacobi "
                         "smoother; use the host path for SSOR smoothers")
    das = [da]
    while das[-1].can_coarsen() and das[-1].n > o["coarse_n"] and \
            (o["max_levels"] == 0 or len(das) < o["max_levels"]):
        das.append(das[-1].coarsen())
    Ps = [das[l].interpolation(das[l + 1]) for l in range(len(das) - 1)]
    rng = np.random.default_rng(11)
    v0s = [torch.from_numpy(rng.standard_normal(d.n).astype(dtype))
           .to(Ad.device) for d in das[:-1]]
    out, Acoarse = mg_device_setup(Ad, Ps, [d.grid for d in das], v0s)
    levels = [MGLevel(A, P, ChebySmoother(dinv, emin, emax, o["sm_its"]))
              for (A, dinv, emin, emax), P in zip(out, Ps)]
    coarse_pc = make_lu(stencil_to_scipy(Acoarse), dtype=dtype,
                        device=Ad.device)
    return MGPC(tuple(levels), coarse_pc, Acoarse, o["cycles"],
                o["mg_type"])
