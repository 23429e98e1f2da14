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
"""

from __future__ import annotations

from typing import Any, Tuple

import numpy as np
import scipy.sparse as sp
import torch

from petsctpu_torch.core.logging import log_event
from petsctpu_torch.core.options import Options
from petsctpu_torch.device import np_dtype
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


def _sell_choice(M, candidates):
    """(G, mode) of the SELL pack of M with the fewest padded slots among
    `candidates`, or None when none keeps its window within 8192 rows or
    the cheapest pads more than 8 slots per average row — petsctpu's
    cost test, shared by its packed and non-packed branches."""
    from petsctpu_torch.mat.sell import sell_plan_stats

    best = None
    for G, mode in candidates:
        if M.shape[0] < G * 128:
            continue
        npass, _, S, _ = sell_plan_stats(M, G=G, mode=mode)
        cost = -(-M.shape[0] // (G * 128)) * npass * G * 128
        if S <= 8192 and (best is None or cost < best[1]):
            best = ((G, mode), cost)
    avg = M.nnz / max(M.shape[0], 1)
    if best is not None and best[1] <= 8 * max(avg, 1e-9) * M.shape[0]:
        return best[0]
    return None


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
    from petsctpu_torch.mat.sell import sell_pack

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
            Ml = sp.csr_matrix(M).astype(np.float32)
            Ml.sum_duplicates()
            choice = _sell_choice(Ml, ((16, "diag"), (16, "chunk"),
                                       (8, "chunk")))
            if choice is not None:
                arrs, st = sell_pack(Ml, G=choice[0], mode=choice[1])
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
    PermutedPC that applies it in the caller's ordering. fmt="band" (the
    TPU's MXU band format) raises.

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
    is built on its own, with an exact sparse LU coarse solve. Either
    way a level that restricts through P.multT builds P's transpose plan
    (kernel K3's) under the log event PCMGTransposePlan."""
    from petsctpu_torch.convert import mg_from_packed
    from petsctpu_torch.device import resolve_device
    from petsctpu_torch.mat.dense import Dense
    from petsctpu_torch.mat.ell import aij_from_scipy
    from petsctpu_torch.mat.sell import sell_from_scipy, sell_viable

    if fmt == "band":
        raise NotImplementedError(
            "pc_gamg_mat_type band (the MXU band format) is not ported yet "
            "(ROADMAP queue 1 item 9)")
    dev = resolve_device(device)
    dtype = (np_dtype(dtype) or np.dtype(As[0].dtype)).type
    fp32 = np.dtype(dtype) == np.float32
    if fmt == "sell":
        from petsctpu_torch.mat.order import get_ordering
        perms = [get_ordering(sp.csr_matrix(A), "rcm") for A in As]
        As = [sp.csr_matrix(A)[p][:, p].tocsr() for A, p in zip(As, perms)]
        Ps = [sp.csr_matrix(P)[perms[l]][:, perms[l + 1]].tocsr()
              for l, P in enumerate(Ps)]

    def permuted(pc):
        if fmt != "sell":
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
        if fmt in ("sell", "auto") and fp32:
            Ah2 = sp.csr_matrix(Ah).astype(np.float32)
            Ah2.sum_duplicates()
            if sell_viable(Ah2):
                return sell_from_scipy(Ah2, device=dev)
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
            P32 = Pl.astype(np.float32)
            choice = _sell_choice(P32, ((8, "chunk"), (16, "chunk")))
            if choice is not None:
                P = sell_from_scipy(P32, G=choice[0], mode="chunk",
                                    device=dev)
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
        Pd, Rd = transfer_ops(Ps[l])
        levels.append(MGLevel(level_op(As[l]), Pd,
                              _cheby_smoother(As[l], dtype, sm_its, sm_pc,
                                              dev), Rd))
    coarse_pc = make_lu(As[-1], dtype=dtype, device=dev)
    coarse_A = aij_from_scipy(As[-1], dtype=dtype, device=dev)
    return permuted(MGPC(tuple(levels), coarse_pc, coarse_A, cycles,
                         mg_type))
