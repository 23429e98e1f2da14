"""PCMG — multigrid on a DA hierarchy or on an explicit algebraic one.

Counterpart of petsctpu/pc/mg.py (reference:
src/ksp/pc/impls/mg/mg.c — PCMGMCycle_Private :10, PCSetUp_MG :529,
PCApply_MG :296): a level hierarchy with Chebyshev+Jacobi (or SSOR)
smoothers, matrix-free Q1 transfers and an exact LU coarse solve; V and
W cycles, full, kaskade and additive MG.

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

  * Algebraic hierarchies (make_algebraic_mg_from_hierarchy, which GAMG
    calls): each level's operator and transfers take the format
    petsctpu chooses (SELL through K2, dense, slant-band or ELL), and a
    chunk-mode SELL prolongator restricts through P.multT, kernel K3.

With mg_levels_pc_type sor (the host setups) each level smooths with
Chebyshev around an SSOR SORPC, its bounds from a host Arnoldi estimate,
as the reference. The MXU band format (pc_gamg_mat_type band) is ROADMAP
queue 1 item 9.

The reference-exact stacks of the oracle examples, built from Python
(no option routes them, as in petsctpu): make_full_mg_ref (Chebyshev +
SSOR with cheby.c's ω/c recurrence, RefChebySmoother, and bounds from
the est-GMRES replayed on the host; a pseudo-inverse coarse solve on
singular Neumann levels: ksp ex34, ex29, ex50),
make_full_mg_gmres_ilu (GMRES(1) + ILU(0): ksp ex28, the exotic PC's
oracle), make_mg_selfscale_richardson (snes ex35_7) and
make_mg_richardson_ilu (ksp ex45_2 run serially).
"""

from __future__ import annotations

from typing import Any, Tuple

import numpy as np
import scipy.sparse as sp
import torch

from petsctpu_torch.core.logging import log_event
from petsctpu_torch.core.options import Options
from petsctpu_torch.device import np_dtype, resolve_device
from petsctpu_torch.pc.factor import LUPC, PermutedPC, make_lu


class ChebySmoother:
    """Fixed-iteration Chebyshev smoother with the Jacobi preconditioner
    (dinv), or any PC given as `pc` (an SSOR SORPC: the reference's MG
    default smoother is Chebyshev + SOR local_symmetric, mg.c:220-224).
    emin and emax are Python numbers, already rounded in the solve's
    dtype; the recurrence's scalars are computed once, here, in that
    dtype, in petsctpu's order of operations."""

    def __init__(self, dinv: torch.Tensor, emin: float, emax: float,
                 its: int = 2, pc=None):
        self.dinv = dinv
        self.pc = pc
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
        d = self._prec(r) / self.theta
        for c_d, c_r in self.steps:
            x = x + d
            r = r - A.mult(d)
            d = c_d * d + c_r * self._prec(r)
        return x + d

    def _prec(self, r):
        return self.pc.apply(r) if self.pc is not None else self.dinv * r


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

    @property
    def formats(self):
        """Per level, the formats of (A, P, R) as op_format gives them;
        R is None when the level restricts through P.multT."""
        return [(op_format(lv.A), op_format(lv.P),
                 None if lv.R is None else op_format(lv.R))
                for lv in self.levels]

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


def _arnoldi_lambda_max(matvec, n: int, iters: int = 10) -> float:
    """Host Arnoldi Ritz estimate of max Re λ(M⁻¹A): the reference's
    Chebyshev eigenvalue estimate (10 GMRES steps, cheby.c:77) for SSOR
    smoothers, where power iteration converges slowly."""
    rng = np.random.default_rng(11)
    v = rng.standard_normal(n)
    v /= np.linalg.norm(v)
    m = min(iters, n)
    V = np.zeros((m + 1, n))
    H = np.zeros((m + 1, m))
    V[0] = v
    k = m
    for j in range(m):
        w = matvec(V[j])
        h = V[:j + 1] @ w
        w = w - V[:j + 1].T @ h
        H[:j + 1, j] = h
        hj1 = np.linalg.norm(w)
        H[j + 1, j] = hj1
        if hj1 == 0:
            k = j + 1
            break
        V[j + 1] = w / hj1
    lam = float(np.linalg.eigvals(H[:k, :k]).real.max())
    return lam if lam > 0 else 1.0


def _cheby_smoother(Ah: sp.csr_matrix, dtype, its: int,
                    pc_type: str = "jacobi", device=None) -> ChebySmoother:
    """Chebyshev + Jacobi, or + SSOR (ω = 1, one symmetric sweep) for
    mg_levels_pc_type sor; any other type takes Jacobi, as in the
    reference."""
    d = Ah.diagonal()
    d = np.where(d != 0, d, 1.0)
    dinv = (1.0 / d).astype(dtype)
    if pc_type == "sor":
        import scipy.sparse.linalg as spla

        from petsctpu_torch.pc.sor import make_sor
        ssor = make_sor(Ah, omega=1.0, sweeps=1, symmetric=True,
                        dtype=dtype, device=device)
        Lm = sp.tril(Ah, k=0).tocsr()
        Um = sp.triu(Ah, k=0).tocsr()

        def m_inv(r):                  # host SSOR: (D+U)⁻¹ D (D+L)⁻¹
            y = spla.spsolve_triangular(Lm, r, lower=True)
            return spla.spsolve_triangular(Um, d * y, lower=False)

        lam = _arnoldi_lambda_max(lambda v: m_inv(Ah @ v), Ah.shape[0])
        return ChebySmoother(torch.from_numpy(dinv).to(device),
                             dtype(0.1 * lam), dtype(1.1 * lam), its, ssor)
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


# ---------------------------------------------------------------------------
# algebraic MG from an explicit hierarchy (GAMG)
# ---------------------------------------------------------------------------
DENSE_MAX_BYTES = 64 * 1024 * 1024


def op_format(op) -> tuple:
    """("sell", G, mode), ("rectband", s, off, W), ("dense",) or ("ell",)
    for the algebraic formats; the class name for any other operator."""
    from petsctpu_torch.mat.dense import Dense
    from petsctpu_torch.mat.ell import AIJ
    from petsctpu_torch.mat.rectband import RectBandMat
    from petsctpu_torch.mat.sell import SellMat

    if isinstance(op, SellMat):
        return ("sell", op.G, op.mode)
    if isinstance(op, RectBandMat):
        return ("rectband", op.s, op.off, op.B.shape[1])
    if isinstance(op, Dense):
        return ("dense",)
    if isinstance(op, AIJ):
        return ("ell",)
    return (type(op).__name__,)


def pack_hierarchy(As, Ps, dtype, use_sell: bool):
    """The packed branch's host side, a copy of petsctpu/pc/mg.py's:
    every level's operator, prolongation and restriction in the format
    petsctpu chooses, laid into one float buffer and one int32 buffer.

    Returns (fbuf, ibuf, metas, coarse_meta), equal to the fields of
    petsctpu's PackedMGPC for the same input; convert.mg_from_packed
    builds the MGPC from them. Formats: an operator packs as SELL (K2)
    when use_sell and the cost test pass, else dense when small, else
    ELL; a restriction R = Pᵀ packs dense when small, else slant-band
    when its fill is at most 8, else None when P packed as chunk-mode
    SELL (the cycle then restricts through P.multT, K3), else like an
    operator. The coarsest level is ELL with a dense LU."""
    import scipy.linalg as sla

    from petsctpu_torch.mat.ell import aij_pack
    from petsctpu_torch.mat.rectband import rectband_pack
    from petsctpu_torch.mat.sell import sell_pack_cheapest

    fbuf, ibuf, metas = [], [], []
    fo = io = 0

    def putf(a):
        nonlocal fo
        fbuf.append(np.asarray(a, dtype).ravel())
        fo += fbuf[-1].size
        return fo - fbuf[-1].size, a.shape

    def puti(a):
        nonlocal io
        ibuf.append(np.asarray(a, np.int32).ravel())
        io += ibuf[-1].size
        return io - ibuf[-1].size, a.shape

    def pack_dense_or_none(M):
        m_, n_ = M.shape
        if (m_ * n_ * np.dtype(dtype).itemsize <= DENSE_MAX_BYTES
                and min(m_, n_) <= 4096):
            D = np.asarray(sp.csr_matrix(M).toarray(), dtype)
            return ("dense", putf(D), (m_, n_), int(sp.csr_matrix(M).nnz))
        return None

    def pack_op(M):
        if use_sell:
            pack = sell_pack_cheapest(M, ((16, "diag"), (16, "chunk"),
                                          (8, "chunk")))
            if pack is not None:
                arrs, st = pack
                # the int8 idx rides the int32 buffer (4 entries a word)
                return ("sell", putf(arrs["vals"]),
                        puti(arrs["idx"].ravel().view(np.int32)),
                        puti(arrs["qs"]), puti(arrs["winstart"]),
                        putf(arrs["diag"]), st["shape"], st["nnz"],
                        st["G"], st["S"], st["Lp"],
                        tuple(arrs["vals"].shape), st["mode"])
        dref = pack_dense_or_none(M)
        if dref is not None:
            return dref
        ca, va, sha, nza = aij_pack(M, dtype=dtype)
        return ("ell", puti(ca), putf(va), sha, nza)

    def pack_restrict(RT, pref):
        dref = pack_dense_or_none(RT)
        if dref is not None:
            return dref
        band = rectband_pack(RT, dtype)
        if band is not None:
            B, s_, off_ = band
            return ("rectband", putf(B), s_, off_, RT.shape, int(RT.nnz),
                    B.shape)
        if pref[0] == "sell" and pref[-1] == "chunk":
            return None
        return pack_op(RT)

    for l in range(len(Ps)):
        amref = pack_op(As[l])
        Pl = sp.csr_matrix(Ps[l])
        Pl.sum_duplicates()
        Pl.sort_indices()
        pref = pack_op(Pl)
        rref = pack_restrict(Pl.T.tocsr(), pref)
        d = As[l].diagonal()
        d = np.where(d != 0, d, 1.0)
        dinv = (1.0 / d).astype(dtype)
        lam = _power_lambda_max(As[l], dinv)
        metas.append((amref, pref, rref, putf(dinv)[0], float(lam)))
    ca, va, shc, nzc = aij_pack(As[-1], dtype=dtype)
    lu, piv = sla.lu_factor(As[-1].toarray().astype(dtype))
    coarse_meta = (puti(ca), putf(va), shc, nzc, putf(lu), puti(piv)[0])
    return (np.concatenate(fbuf), np.concatenate(ibuf), tuple(metas),
            coarse_meta)


def make_algebraic_mg_from_hierarchy(As, Ps, dtype=None, sm_its: int = 2,
                                     cycles: int = 1,
                                     mg_type: str = "multiplicative",
                                     sm_pc: str = "jacobi",
                                     fmt: str = "auto", device=None):
    """An MGPC from explicit (A_l, P_l) scipy hierarchies — GAMG's
    (pc/gamg.py), or a rediscretized grid hierarchy.

    fmt="auto" (default) and "ell" as in petsctpu; fmt="sell" adds the
    RCM conjugation of every level and returns the MGPC inside a
    PermutedPC that applies it in the caller's ordering; fmt="band" does
    the same with every level operator a BandMat (mat/band.py).

    The `auto` policy on the card: petsctpu takes SELL operators and
    transfers only when its backend is the TPU, and ELL elsewhere. The
    port takes the TPU's decisions for fp32 on every device: K2 is the
    fast product on the H100 too (0.0525 ms against 0.0934 ms for
    torch.sparse CSR at ex45 128³, PERF.md), and the CPU tests then
    build the same structure that the card runs.

    With Jacobi smoothing and a coarsest level of at most 192 rows the
    hierarchy is packed on the host (pack_hierarchy) and moved to the
    device in one float and one int32 buffer (convert.mg_from_packed),
    under the log events PCMGPack and PCMGTransfer; otherwise each level
    is built on its own (its operator and transfers, packed and moved,
    under PCMGLevelOps; its Chebyshev bounds under PCMGSmoother), with an
    exact sparse LU coarse solve (PCMGCoarseLU). Either way a level that
    restricts through P.multT builds P's transpose plan (kernel K3's)
    under the log event PCMGTransposePlan."""
    from petsctpu_torch.convert import mg_from_packed, sell_from_arrays
    from petsctpu_torch.mat.dense import Dense
    from petsctpu_torch.mat.ell import aij_from_scipy
    from petsctpu_torch.mat.sell import sell_if_viable, sell_pack_cheapest

    dev = resolve_device(device)
    dtype = (np_dtype(dtype) or np.dtype(As[0].dtype)).type
    fp32 = np.dtype(dtype) == np.float32
    if fmt in ("band", "sell"):
        from petsctpu_torch.mat.order import get_ordering
        perms = [get_ordering(sp.csr_matrix(A), "rcm") for A in As]
        As = [sp.csr_matrix(A)[p][:, p].tocsr() for A, p in zip(As, perms)]
        Ps = [sp.csr_matrix(P)[perms[l]][:, perms[l + 1]].tocsr()
              for l, P in enumerate(Ps)]

    def permuted(pc):
        if fmt not in ("band", "sell"):
            return pc
        return PermutedPC(pc, torch.as_tensor(perms[0]).to(dev))

    if fmt in ("ell", "auto", "sell") and sm_pc == "jacobi" \
            and As[-1].shape[0] <= 192:
        with log_event("PCMGPack"):
            packed = pack_hierarchy(As, Ps, dtype,
                                    use_sell=fp32 and fmt != "ell")
        with log_event("PCMGTransfer"):
            pc = mg_from_packed(*packed, sm_its, cycles, mg_type, device=dev)
        return permuted(pc)

    def level_op(Ah):
        if fmt == "band":
            from petsctpu_torch.mat.band import band_from_scipy
            return band_from_scipy(Ah, dtype=dtype, device=dev)
        if fmt in ("sell", "auto") and fp32:
            M = sell_if_viable(Ah, device=dev)
            if M is not None:
                return M
        n_ = sp.csr_matrix(Ah).shape[0]
        if fmt == "auto" and fp32 and n_ <= 4096 \
                and n_ * n_ * 4 <= DENSE_MAX_BYTES:
            return Dense(torch.from_numpy(
                sp.csr_matrix(Ah).toarray().astype(dtype)).to(dev))
        return aij_from_scipy(Ah, dtype=dtype, device=dev)

    def transfer_ops(Pl):
        """(P, R or None): chunk-mode SELL P restricting through
        P.multT (its transpose plan built here), else dense P and Pᵀ
        when small, else ELL."""
        Pl = sp.csr_matrix(Pl)
        Pl.sum_duplicates()
        Pl.sort_indices()
        m_, n_ = Pl.shape
        if fp32:
            pack = sell_pack_cheapest(Pl, ((8, "chunk"), (16, "chunk")))
            if pack is not None:
                P = sell_from_arrays(*pack, device=dev)
                with log_event("PCMGTransposePlan"):
                    P.transpose_plan()
                return P, None
        if fp32 and m_ * n_ * 4 <= DENSE_MAX_BYTES and min(m_, n_) <= 4096:
            D = np.asarray(Pl.toarray(), dtype)
            return (Dense(torch.from_numpy(D).to(dev)),
                    Dense(torch.from_numpy(np.ascontiguousarray(D.T))
                          .to(dev)))
        return aij_from_scipy(Pl, dtype=dtype, device=dev), None

    levels = []
    for l in range(len(Ps)):
        with log_event("PCMGLevelOps"):
            Pd, Rd = transfer_ops(Ps[l])
            Ad = level_op(As[l])
        with log_event("PCMGSmoother"):
            sm = _cheby_smoother(As[l], dtype, sm_its, sm_pc, dev)
        levels.append(MGLevel(Ad, Pd, sm, Rd))
    with log_event("PCMGCoarseLU"):
        coarse_pc = make_lu(As[-1], dtype=dtype, device=dev)
        coarse_A = aij_from_scipy(As[-1], dtype=dtype, device=dev)
    return permuted(MGPC(tuple(levels), coarse_pc, coarse_A, cycles,
                         mg_type))


# ---------------------------------------------------------------------------
# reference-exact level smoothers and the MG stacks of the oracle examples
# ---------------------------------------------------------------------------
class RefChebySmoother:
    """KSPSolve_Chebyshev's ω/c recurrence verbatim (cheby.c: scale =
    2/(emax+emin), the pre-loop p₁ = p₀ + scale·B⁻¹r, then `its` steps of
    p⁺ = ω(p + scale·B⁻¹r) + (1−ω)p⁻); not ChebySmoother's θ/δ form,
    which rounds otherwise. `denull` removes the constant null space
    after every preconditioner application (KSP_PCApply →
    MatNullSpaceRemove on a singular Neumann level, kspimpl.h:185), on
    the device.

    emin and emax are rounded in the solve's dtype (`dtype`); scale and
    each step's ω and 1 − ω are computed once, here, in that dtype and
    in petsctpu's order of operations, and held as Python numbers."""

    def __init__(self, pc, emin: float, emax: float, its: int = 2,
                 denull: bool = False, dtype=np.float64):
        self.pc = pc
        self.its = int(its)
        self.denull = bool(denull)
        dt = np.dtype(dtype).type
        emin, emax = dt(emin), dt(emax)
        self.emin, self.emax = float(emin), float(emax)
        one, two = dt(1.0), dt(2.0)
        scale = two / (emax + emin)
        alpha = one - scale * emin
        mu = one / alpha
        omegaprod = two / alpha
        ckm1, ck = one, mu
        steps = []
        for _ in range(self.its):
            ckp1 = two * mu * ck - ckm1
            omega = omegaprod * ck / ckp1
            steps.append((float(omega), float(one - omega)))
            ckm1, ck = ck, ckp1
        self.scale = float(scale)
        self.steps = tuple(steps)

    def _prec(self, r):
        z = self.pc.apply(r)
        return z - z.mean() if self.denull else z

    def smooth(self, A, b, x):
        pkm1 = x
        pk = pkm1 + self.scale * self._prec(b - A.mult(pkm1))
        for omega, rest in self.steps:
            z = self._prec(b - A.mult(pk))
            pkm1, pk = pk, omega * (pk + self.scale * z) + rest * pkm1
        return pk


class PinvCoarsePC:
    """Dense pseudo-inverse coarse solve with the constant null space
    removed before and after: the reference's shifted LU +
    MatNullSpaceRemove coarse stack on a singular Neumann coarse grid
    (the component in range(A) is the same; the null component is
    projected out either way). Ainv is taken on the host (np.linalg.pinv);
    the apply is one dense product on the device."""

    def __init__(self, Ainv: torch.Tensor, denull: bool = True):
        self.Ainv = Ainv
        self.denull = bool(denull)

    def apply(self, r):
        if self.denull:
            r = r - r.mean()
        y = torch.mv(self.Ainv, r)
        return y - y.mean() if self.denull else y


def _ssor_minv_host(Ah: sp.csr_matrix):
    """Host SSOR(ω=1) preconditioner apply: (D+U)⁻¹ D (D+L)⁻¹ —
    MatSOR SOR_LOCAL_SYMMETRIC_SWEEP, the mg.c default smoother PC."""
    import scipy.sparse.linalg as spla

    L = sp.tril(Ah, 0).tocsr()
    U = sp.triu(Ah, 0).tocsr()
    d = Ah.diagonal()

    def m_inv(r):
        y = spla.spsolve_triangular(L, r, lower=True)
        return spla.spsolve_triangular(U, d * y, lower=False)

    return m_inv


def _est_hessenberg_host(Ah: sp.csr_matrix, m_inv, b: np.ndarray,
                         iters: int = 10) -> np.ndarray:
    """The Chebyshev smoother's est-GMRES Krylov process replayed on the
    host (cheby.c's estimate on first application): `iters` classical
    Gram-Schmidt Arnoldi steps of the left-SSOR-preconditioned operator
    from M⁻¹b, without null-space removal (the est KSP shares the PC
    object but not the operators, cheby.c:68, so KSP_RemoveNullSpace
    never fires inside it). Returns the (k+1)×k Hessenberg."""
    v = m_inv(np.asarray(b, np.float64))
    beta = np.linalg.norm(v)
    n = v.shape[0]
    m = min(iters, n)
    H = np.zeros((m + 1, m))
    if beta == 0.0:
        return H[:1, :0]
    V = np.zeros((m + 1, n))
    V[0] = v / beta
    for j in range(m):
        w = m_inv(Ah @ V[j])
        h = V[:j + 1] @ w
        w = w - V[:j + 1].T @ h
        H[:j + 1, j] = h
        H[j + 1, j] = np.linalg.norm(w)
        if H[j + 1, j] == 0.0:
            return H[:j + 2, :j + 1]
        V[j + 1] = w / H[j + 1, j]
    return H


def _est_sigma_max_host(Ah: sp.csr_matrix, m_inv, b: np.ndarray,
                        iters: int = 10,
                        convention: str = "svd") -> float:
    """The extreme estimate from the replayed est-GMRES Hessenberg, in
    either of the reference's two conventions:

    * "svd": σmax of H̄ (KSPComputeExtremeSingularValues_GMRES, gesvd of
      the triangularized R, gmreig.c), the convention the checked-in
      golden outputs were made with (ksp ex34_1's level bounds);
    * "eigen": the largest real part of the Ritz values of the square H
      (KSPComputeEigenvalues' geev path), what the tree's cheby.c:329
      calls (ksp ex29 and ex50's oracle streams)."""
    H = _est_hessenberg_host(Ah, m_inv, b, iters)
    k = H.shape[1]
    if k == 0:
        return 1.0
    if convention == "eigen":
        return float(np.linalg.eigvals(H[:k, :k]).real.max())
    return float(np.linalg.svd(H, compute_uv=False).max())


def make_full_mg_ref(As, Ps, b, dtype=None, sm_its: int = 2,
                     mg_type: str = "full", cycles: int = 1,
                     nullspace: bool = False, est_its: int = 10,
                     est_convention: str = "svd", device=None) -> MGPC:
    """MG with the reference's default smoother configuration exactly:
    Chebyshev + SSOR on every level, its bounds estimated at setup by
    replaying cheby.c's estimate on first application on the host. Level
    l's est input is the outer right-hand side restricted down the
    F-cycle's chain (PCMGFCycle_Private restricts b through all levels
    before any smoothing), with the bounds transform [0, 0.1; 0, 1.1].

    nullspace=True: singular Neumann levels. The smoothers remove the
    constant after each SSOR apply and the coarse solve is a
    null-space-projected pseudo-inverse (ksp ex34's configuration).

    The SSOR is pc/sor.py's SORPC (two SpTRSV launches an apply), the
    operators and transfers ELL (mat/ell.py), the coarse solve make_lu's
    or the pseudo-inverse. Setup by part under the log events
    PCMGEst[l] (level l's host est), PCMGSOR (the SSOR plans), PCMGPinv
    or PCMGCoarseLU, and PCMGUpload (the operators and transfers)."""
    from petsctpu_torch.mat.ell import aij_from_scipy
    from petsctpu_torch.pc.sor import make_sor

    dev = resolve_device(device)
    dtype = (np_dtype(dtype) or np.dtype(As[0].dtype)).type
    # restrict the outer rhs down the chain (the est inputs a level)
    bs = [np.asarray(b, np.float64)]
    for P in Ps:
        bs.append(P.T @ bs[-1])

    levels = []
    for l in range(len(Ps)):
        Ah = sp.csr_matrix(As[l])
        with log_event(f"PCMGEst[{l}]"):
            smax = _est_sigma_max_host(Ah, _ssor_minv_host(Ah), bs[l],
                                       est_its, est_convention)
        with log_event("PCMGSOR"):
            ssor = make_sor(Ah, omega=1.0, sweeps=1, symmetric=True,
                            dtype=dtype, device=dev)
        sm = RefChebySmoother(ssor, dtype(0.1 * smax), dtype(1.1 * smax),
                              sm_its, nullspace, dtype)
        with log_event("PCMGUpload"):
            levels.append(MGLevel(aij_from_scipy(As[l], dtype=dtype,
                                                 device=dev),
                                  aij_from_scipy(Ps[l], dtype=dtype,
                                                 device=dev), sm))
    Ac = sp.csr_matrix(As[-1])
    if nullspace:
        with log_event("PCMGPinv"):
            Ainv = np.linalg.pinv(Ac.toarray()).astype(dtype)
            coarse_pc = PinvCoarsePC(torch.from_numpy(Ainv).to(dev))
    else:
        with log_event("PCMGCoarseLU"):
            coarse_pc = make_lu(Ac, dtype=dtype, device=dev)
    with log_event("PCMGUpload"):
        coarse_A = aij_from_scipy(Ac, dtype=dtype, device=dev)
    return MGPC(tuple(levels), coarse_pc, coarse_A, cycles, mg_type)


class GmresSmoother:
    """KSPGMRES as an MG level smoother: `its` Arnoldi steps of
    left-preconditioned GMRES with classical Gram-Schmidt and Givens
    least squares (KSPSolve_GMRES/KSPGMRESCycle gmres.c:118,213 with
    max_it = its and a nonzero initial guess; ksp ex28's
    -mg_levels_ksp_type gmres -mg_levels_ksp_max_it 1). Its rtol test
    cannot fire before max_it at these counts, so the fixed-step loop is
    iteration-exact. The guards (β > 0, ρ > 0, a nonzero pivot) are
    torch.where on 0-d device tensors: a smooth reads nothing back to
    the host."""

    def __init__(self, pc, its: int = 1):
        self.pc = pc
        self.its = int(its)

    def smooth(self, A, b, x):
        z = self.pc.apply(b - A.mult(x))
        beta = torch.linalg.vector_norm(z)
        one, zero = torch.ones_like(beta), torch.zeros_like(beta)

        def safe_inv(t):
            ok = t > 0.0
            return torch.where(ok, 1.0 / torch.where(ok, t, one), zero)

        safe = beta > 0.0
        V = [z * safe_inv(beta)]
        g = [beta] + [zero] * self.its
        cs, sn, Hcols = [], [], []
        for j in range(self.its):
            w = self.pc.apply(A.mult(V[j]))
            col = [torch.vdot(V[i], w) for i in range(j + 1)]
            for i in range(j + 1):
                w = w - col[i] * V[i]
            hj1 = torch.linalg.vector_norm(w)
            V.append(w * safe_inv(hj1))
            col = col + [hj1]
            for i in range(j):
                t = cs[i] * col[i] + sn[i] * col[i + 1]
                col[i + 1] = -sn[i] * col[i] + cs[i] * col[i + 1]
                col[i] = t
            rho = torch.hypot(col[j], col[j + 1])
            ok = rho > 0.0
            rho_safe = torch.where(ok, rho, one)
            c = torch.where(ok, col[j] / rho_safe, one)
            s = torch.where(ok, col[j + 1] / rho_safe, zero)
            cs.append(c)
            sn.append(s)
            col[j] = rho
            g[j + 1] = -s * g[j]
            g[j] = c * g[j]
            Hcols.append(col[:j + 1])
        # back substitution on the triangularized Hessenberg
        y = [None] * self.its
        for i in reversed(range(self.its)):
            t = g[i]
            for k in range(i + 1, self.its):
                t = t - Hcols[k][i] * y[k]
            di = Hcols[i][i]
            ok = di != 0.0
            y[i] = torch.where(ok, t / torch.where(ok, di, one), zero)
        dx = x
        for j in range(self.its):
            dx = dx + y[j] * V[j]
        return torch.where(safe, dx, x)


class SelfScaleRichardsonSmoother:
    """KSPRichardson with -ksp_richardson_self_scale as an MG level
    smoother (rich.c:59-92, the self-scale branch): a step's damping
    ss = zᵀ(Az)/(Az)ᵀ(Az) with z updated in place (snes ex35_7's
    -mg_levels_ksp_type richardson -mg_levels_pc_type none
    -mg_levels_ksp_richardson_self_scale). pc None is B = I; with a PC,
    y = B·A·z. ss stays a 0-d device tensor: no host read."""

    def __init__(self, pc=None, its: int = 2):
        self.pc = pc
        self.its = int(its)

    def _prec(self, r):
        return self.pc.apply(r) if self.pc is not None else r

    def smooth(self, A, b, x):
        r = b - A.mult(x)
        z = self._prec(r)
        for _ in range(self.its):
            w = A.mult(z)
            y = self._prec(w)
            ss = torch.vdot(z, y) / torch.vdot(y, y)
            x = x + ss * z
            r = r - ss * w
            z = z - ss * y
        return x


class RichardsonSmoother:
    """KSPRichardson as an MG smoother (KSPSolve_Richardson with no norm
    test: exactly `its` applications of x += scale·B⁻¹(b − Ax), rich.c)."""

    def __init__(self, pc, scale: float = 1.0, its: int = 1):
        self.pc = pc
        self.scale = float(scale)
        self.its = int(its)

    def smooth(self, A, b, x):
        for _ in range(self.its):
            x = x + self.scale * self.pc.apply(b - A.mult(x))
        return x


def _mg_with_smoothers(As, Ps, make_smoother, dtype, cycles, mg_type,
                       device) -> MGPC:
    """An MGPC over a given hierarchy: ELL operators and transfers, the
    smoother make_smoother(A_l host) on each level, exact LU coarse."""
    from petsctpu_torch.mat.ell import aij_from_scipy

    dev = resolve_device(device)
    dtype = (np_dtype(dtype) or np.dtype(As[0].dtype)).type
    levels = []
    for l in range(len(Ps)):
        sm = make_smoother(sp.csr_matrix(As[l]), dtype, dev)
        levels.append(MGLevel(aij_from_scipy(As[l], dtype=dtype, device=dev),
                              aij_from_scipy(Ps[l], dtype=dtype, device=dev),
                              sm))
    Ac = sp.csr_matrix(As[-1])
    return MGPC(tuple(levels), make_lu(Ac, dtype=dtype, device=dev),
                aij_from_scipy(Ac, dtype=dtype, device=dev), cycles, mg_type)


def make_mg_selfscale_richardson(As, Ps, dtype=None, sm_its: int = 2,
                                 mg_type: str = "multiplicative",
                                 cycles: int = 1, device=None) -> MGPC:
    """MG with self-scaled Richardson (pc none) level smoothers and an
    exact LU coarse solve: snes ex35_7's preconditioner."""
    return _mg_with_smoothers(
        As, Ps, lambda Ah, dt, dev: SelfScaleRichardsonSmoother(None, sm_its),
        dtype, cycles, mg_type, device)


def make_full_mg_gmres_ilu(As, Ps, dtype=None, sm_its: int = 1,
                           mg_type: str = "full", cycles: int = 1,
                           device=None) -> MGPC:
    """MG with GMRES(its) + ILU(0) level smoothers and an exact LU coarse
    solve: ksp ex28's -pc_type mg -pc_mg_type full -mg_levels_ksp_type
    gmres -mg_levels_ksp_max_it 1 -mg_levels_pc_type ilu, on the
    caller's (rediscretized) As."""
    from petsctpu_torch.pc.factor import make_ilu

    return _mg_with_smoothers(
        As, Ps, lambda Ah, dt, dev: GmresSmoother(
            make_ilu(Ah, dtype=dt, device=dev), sm_its),
        dtype, cycles, mg_type, device)


def make_mg_richardson_ilu(As, Ps, dtype=None, sm_its: int = 1,
                           mg_type: str = "multiplicative",
                           cycles: int = 1, device=None) -> MGPC:
    """MG with Richardson + ILU(0) level smoothers and an exact LU coarse
    solve: ksp ex45's -mg_levels_ksp_type richardson
    -mg_levels_ksp_max_it 1 -mg_levels_pc_type bjacobi run serially
    (block Jacobi of one block = ILU(0) of the level operator)."""
    from petsctpu_torch.pc.factor import make_ilu

    return _mg_with_smoothers(
        As, Ps, lambda Ah, dt, dev: RichardsonSmoother(
            make_ilu(Ah, dtype=dt, device=dev), 1.0, sm_its),
        dtype, cycles, mg_type, device)
