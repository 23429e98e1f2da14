"""Distributed multigrid: a level hierarchy sharded over a World's ranks,
agglomerated onto every rank below a size.

Counterpart of petsctpu/pc/distmg.py (reference: GAMG's coarse-grid
agglomeration onto fewer ranks, src/ksp/pc/impls/gamg/gamg.c:131-198
createLevel with -pc_gamg_repartition / proc reduction). Every level
with more than `pc_mg_repl_size` true unknowns stays sharded: Chebyshev
+ Jacobi smoothing with the operator's halo only (ppermute for a
ShardedStencil, its plan's all_to_all for a ShardedAIJ) and sharded
transfers (ShardedQ1Interp, one boundary-row ppermute each; or a
ShardedRectAIJ prolongator). Below it ONE all_gather brings the residual
to every rank and the rest of the hierarchy runs replicated, the same
work on every rank (the PCREDUNDANT idea), or re-sharded onto the ici
axis of a two-axis World (make_dist_mg_hier).

The sharded levels run as PyTorch ops on each rank (RankStencil.mult, as
petsctpu's XLA code); the replicated hierarchy is the serial MGPC, whose
StencilMat levels launch K1 and whose coarse LU launches sptrsv_lu on
every rank. `rank(comm)` gives the rank's PC; `A` is the fine sharded
operator the outer KSP applies.

Layout, as petsctpu's: a level's leading grid axis is padded to
nshards·mloc with identity rows, mloc doubling from the coarsest sharded
level up (so fine row 2i lives on the rank of coarse row i). Where the
coarsest sharded level is small, the finest's padding can take whole
ranks: 129³ over 4 ranks shards 129, 65, 33, 17, 9 with mloc 48, 24,
12, 6, 3, and rank 3 holds only identity rows (ROADMAP queue 3).
"""

from __future__ import annotations

from typing import Any, Tuple

import numpy as np
import scipy.sparse as sp
import torch

from petsctpu_torch.core.logging import log_event
from petsctpu_torch.core.options import Options
from petsctpu_torch.device import np_dtype, resolve_device
from petsctpu_torch.dm.da import DA, q1_interp_scipy
from petsctpu_torch.pc.mg import ChebySmoother, _power_lambda_max, \
    make_geometric_mg


class DistMGLevel:
    """A sharded level: its operator and each rank's smoother."""

    def __init__(self, A, smoothers):
        self.A = A                   # ShardedStencil or ShardedAIJ
        self.smoothers = smoothers   # ChebySmoother a rank


class DistMGPC:
    """One MG cycle, sharded down to the agglomeration level.

    levels[l] lives on grids[l] (the true grid; padded with identity
    rows); transfers[l] connects levels l and l+1; P_t and coarse handle
    everything below the coarsest sharded level, replicated on every
    rank, or `inner` (another DistMGPC over the ici axis) re-shards it.
    axis: "rows" (the flat World), ("dcn", "ici") (both axes of a
    two-axis World: its flat Comm) or "ici" (the row of a two-axis
    World)."""

    def __init__(self, levels: Tuple, transfers: Tuple, P_t, coarse: Any,
                 grids: tuple, axis="rows", nshards: int = 1,
                 cycles: int = 1, inner: "DistMGPC" = None):
        self.levels = tuple(levels)
        self.transfers = tuple(transfers)
        self.P_t = P_t
        self.coarse = coarse
        self.grids = tuple(grids)
        self.axis = axis
        self.nshards = nshards
        self.cycles = cycles
        self.inner = inner
        self.timings = {}

    @property
    def A(self):
        """The fine sharded operator (what the outer KSP applies)."""
        return self.levels[0].A

    def rank(self, comm) -> "RankDistMG":
        return RankDistMG(self, comm)


class RankDistMG:
    """One rank's view of a DistMGPC, bound to its Comm (the Comm of the
    PC's axis for the sharded levels, the ici Comm for `inner`)."""

    def __init__(self, pc: DistMGPC, comm):
        self.pc = pc
        self.comm = c = comm.sub(pc.axis)
        self.As = [lev.A.rank(c) for lev in pc.levels]
        self.smoothers = [lev.smoothers[c.rank] for lev in pc.levels]
        self.transfers = [T.rank(c) for T in pc.transfers]
        self.inner = None if pc.inner is None else pc.inner.rank(comm)

    def apply(self, b: torch.Tensor) -> torch.Tensor:
        return self._cycle(0, b)

    def _cycle(self, l: int, b: torch.Tensor) -> torch.Tensor:
        A, sm = self.As[l], self.smoothers[l]
        x = sm.smooth(A, b, torch.zeros_like(b))
        for _ in range(self.pc.cycles):
            r = b - A.mult(x)
            if l + 1 < len(self.As):
                xc = self._cycle(l + 1, self.transfers[l].multT(r))
                x = x + self.transfers[l].mult(xc)
            else:
                x = x + self._agglomerated(r)
        return sm.smooth(A, b, x)

    def _agglomerated(self, r: torch.Tensor) -> torch.Tensor:
        """Gather the coarsest sharded residual once, solve the next
        coarser grid (replicated, or re-sharded onto the ici axis) and
        take this rank's slice of the correction. On a two-axis World
        the gather is the one collective across rows a cycle."""
        pc = self.pc
        rfull = self.comm.all_gather(r)                    # padded global
        ntrue = int(np.prod(pc.grids[-1]))
        rc = pc.P_t.multT(rfull[:ntrue])
        xc = (pc.coarse.apply(rc) if self.inner is None
              else self._inner_apply(rc))
        xf = pc.P_t.mult(xc)
        xf = torch.cat([xf, xf.new_zeros(rfull.shape[0] - ntrue)])
        nloc = r.shape[0]
        me = self.comm.rank
        return xf[me * nloc:(me + 1) * nloc]

    def _inner_apply(self, rc: torch.Tensor) -> torch.Tensor:
        """The re-sharded continuation: this rank's ici slice of the
        (replicated) coarse residual, a cycle over the ici axis, the
        correction gathered back over it (a collective within the row;
        every row computes the same correction)."""
        inner = self.inner
        n_in = inner.pc.levels[0].A.shape[0]              # inner padding
        rin = torch.cat([rc, rc.new_zeros(n_in - rc.shape[0])])
        nloc = n_in // inner.pc.nshards
        ci = inner.comm.rank
        x_in = inner.apply(rin[ci * nloc:(ci + 1) * nloc])
        return inner.comm.all_gather(x_in)[:rc.shape[0]]


def _stacked_cheby(Ah: sp.csr_matrix, npad: int, dtype, its: int,
                   nshards: int, device) -> list:
    """Chebyshev + Jacobi smoothers, one a rank (its slice of dinv); the
    identity pad rows take dinv = 1 (their residual stays zero)."""
    d = np.ones(npad, dtype)
    d[: Ah.shape[0]] = Ah.diagonal()
    d = np.where(d != 0, d, 1.0)
    lam = _power_lambda_max(Ah, 1.0 / d[: Ah.shape[0]])
    dinv = (1.0 / d).reshape(nshards, -1)
    emin, emax = dtype(0.1 * lam), dtype(1.1 * lam)
    return [ChebySmoother(torch.from_numpy(np.ascontiguousarray(dinv[p]))
                          .to(device), emin, emax, its)
            for p in range(nshards)]


def _sharded_stage(Ah, da, nshards, repl_n, max_levels, sm_its, dtype,
                   device, timings):
    """The sharded part of a hierarchy: the Galerkin chain (host, scipy)
    while the NEXT level still has more than repl_n true unknowns, the
    ranks' leading sizes chosen bottom-up so that boundaries stay 2:1
    aligned (mloc_f = 2·mloc_c). Returns (levels, transfers, das, Ahs);
    das[-1]/Ahs[-1] is the coarsest sharded level."""
    import time

    from petsctpu_torch.mat.stencil import stencil_from_scipy
    from petsctpu_torch.parallel.pstencil import sharded_q1_interp, \
        sharded_stencil_from

    t0 = time.perf_counter()
    das, Ahs = [da], [Ah]
    while das[-1].can_coarsen():
        nxt = das[-1].coarsen()
        if int(np.prod(nxt.grid)) <= repl_n or not nxt.can_coarsen():
            break
        if max_levels and len(das) >= max_levels - 1:
            break
        Ps = q1_interp_scipy(das[-1].grid, nxt.grid)
        Ahs.append((Ps.T @ Ahs[-1] @ Ps).tocsr())
        das.append(nxt)
    if not das[-1].can_coarsen():
        raise ValueError(f"grid {da.grid} has no 2x-1 coarsening")
    L = len(das)
    timings["galerkin"] = time.perf_counter() - t0

    mlocs = [0] * L
    mlocs[L - 1] = -(-das[L - 1].grid[0] // nshards)
    for l in range(L - 2, -1, -1):
        mlocs[l] = 2 * mlocs[l + 1]

    levels, transfers = [], []
    t_ops = t_sm = 0.0
    for l in range(L):
        t = time.perf_counter()
        S = stencil_from_scipy(Ahs[l], das[l].grid, dtype=dtype,
                               device="cpu")
        Sh = sharded_stencil_from(S, nshards, mloc=mlocs[l], device=device)
        t_ops += time.perf_counter() - t
        t = time.perf_counter()
        levels.append(DistMGLevel(Sh, _stacked_cheby(
            Ahs[l], Sh.shape[0], dtype, sm_its, nshards, device)))
        t_sm += time.perf_counter() - t
        if l + 1 < L:
            transfers.append(sharded_q1_interp(
                das[l].grid, das[l + 1].grid, nshards, mlocs[l],
                dtype=dtype, device=device))
    timings["level operators"] = t_ops
    timings["smoothers"] = t_sm
    return levels, transfers, das, Ahs


def _options(opts: Options):
    return (opts.get_int("pc_mg_repl_size", 512),
            opts.get_int("mg_levels_ksp_max_it", 2),
            2 if opts.get_str("pc_mg_cycle_type", "v") == "w" else 1)


def make_dist_mg(A_host, grid, nshards: int, dtype=None,
                 options: Options = None, axis="rows",
                 device=None) -> DistMGPC:
    """The sharded Galerkin hierarchy (PCSetUp_MG with GAMG's
    agglomeration): levels with more than `pc_mg_repl_size` (default
    512, the -pc_gamg_process_eq_limit idea) true unknowns stay sharded;
    everything below runs replicated (make_geometric_mg). Host setup;
    pc.timings splits it by part."""
    import time

    dev = resolve_device(device)
    opts = options or Options()
    dtype = (np_dtype(dtype) or np.dtype(A_host.dtype)).type
    repl_n, sm_its, cycles = _options(opts)
    max_levels = opts.get_int("pc_mg_levels", 0)
    timings = {}
    with log_event("PCDistMGSetup"):
        levels, transfers, das, Ahs = _sharded_stage(
            sp.csr_matrix(A_host).astype(dtype), DA(tuple(grid)), nshards,
            repl_n, max_levels, sm_its, dtype, dev, timings)
        t = time.perf_counter()
        coarse_da = das[-1].coarsen()
        Pt = das[-1].interpolation(coarse_da)
        Ps = q1_interp_scipy(das[-1].grid, coarse_da.grid)
        Ac = (Ps.T @ Ahs[-1] @ Ps).tocsr()
        coarse = make_geometric_mg(Ac, coarse_da, dtype=dtype, options=opts,
                                   device=dev)
        timings["replicated MG"] = time.perf_counter() - t
    pc = DistMGPC(tuple(levels), tuple(transfers), Pt, coarse,
                  tuple(d.grid for d in das), axis, nshards, cycles)
    pc.timings = timings
    return pc


def make_dist_gamg(A_host, nshards: int, dtype=None,
                   options: Options = None, axis="rows",
                   theta: float = 0.0, coarsen: str = "mis",
                   hierarchy=None, device=None) -> DistMGPC:
    """Distributed algebraic multigrid: the GAMG hierarchy (smoothed
    aggregation, pc/gamg.py) built on the host, applied sharded. Levels
    with more than `pc_mg_repl_size` unknowns are ShardedAIJ operators
    with Chebyshev + Jacobi smoothing, the transfers ShardedRectAIJ
    prolongators (the reference stores P as an MPIAIJ; MatMultTranspose's
    scatter-reverse restricts), and the small tail runs replicated after
    one all_gather (gamg.c:174-198). -pc_gamg_mat_type sell sends each
    rank's diagonal block through K2 (fp32); the default ("auto") is
    ELL, petsctpu's choice off the TPU. hierarchy: (As, Ps) of
    gamg_hierarchy, made here when None."""
    import time

    from petsctpu_torch.mat.ell import aij_from_scipy
    from petsctpu_torch.parallel.pmat import sharded_aij_from_scipy, \
        sharded_rect_from_scipy
    from petsctpu_torch.pc.factor import make_lu
    from petsctpu_torch.pc.gamg import gamg_hierarchy
    from petsctpu_torch.pc.mg import make_algebraic_mg_from_hierarchy

    dev = resolve_device(device)
    opts = options or Options()
    dtype = (np_dtype(dtype) or np.dtype(A_host.dtype)).type
    repl_n, sm_its, cycles = _options(opts)
    coarse_n = opts.get_int("pc_gamg_coarse_eq_limit", 64)
    fmt = opts.get_str("pc_gamg_mat_type", "auto")
    fmt = "ell" if fmt == "auto" else fmt
    timings = {}
    with log_event("PCDistMGSetup"):
        t = time.perf_counter()
        As, Ps = hierarchy or gamg_hierarchy(
            sp.csr_matrix(A_host).astype(dtype), theta=theta,
            coarse_n=coarse_n, coarsen=coarsen)
        timings["hierarchy"] = time.perf_counter() - t
        # how many levels stay sharded (the NEXT one must still be big)
        L = 1
        while L < len(As) - 1 and As[L].shape[0] > repl_n:
            L += 1
        if L >= len(As):          # hierarchy too shallow: keep 1 sharded
            L = max(1, len(As) - 1)
        levels, transfers = [], []
        t_ops = t_sm = 0.0
        for l in range(L):
            t = time.perf_counter()
            Sh, _ = sharded_aij_from_scipy(As[l], nshards, dtype=dtype,
                                           fmt=fmt, device=dev)
            if l + 1 < L:
                transfers.append(sharded_rect_from_scipy(
                    Ps[l], nshards, dtype=dtype, device=dev))
            t_ops += time.perf_counter() - t
            t = time.perf_counter()
            levels.append(DistMGLevel(Sh, _stacked_cheby(
                sp.csr_matrix(As[l]), Sh.shape[0], dtype, sm_its, nshards,
                dev)))
            t_sm += time.perf_counter() - t
        timings["level operators"] = t_ops
        timings["smoothers"] = t_sm
        # the replicated tail: P_t bridges the coarsest sharded level to it
        t = time.perf_counter()
        Pt = aij_from_scipy(Ps[L - 1], dtype=dtype, device=dev)
        if L < len(As) - 1:
            coarse = make_algebraic_mg_from_hierarchy(
                As[L:], Ps[L:], dtype=dtype, sm_its=sm_its, cycles=cycles,
                device=dev)
        else:
            coarse = make_lu(sp.csr_matrix(As[-1]), dtype=dtype, device=dev)
        timings["replicated MG"] = time.perf_counter() - t
    pc = DistMGPC(tuple(levels), tuple(transfers), Pt, coarse,
                  tuple((A.shape[0],) for A in As[:L]), axis, nshards, cycles)
    pc.timings = timings
    return pc


def make_dist_mg_hier(A_host, grid, H: int, C: int, dtype=None,
                      options: Options = None, device=None) -> DistMGPC:
    """The hierarchy of an (H x C) two-axis World (GAMG's createLevel
    rank-reduction ladder, gamg.c:174-198, on the two-level fabric):

      * levels above `pc_mg_dcn_repl_size` unknowns: sharded over all H·C
        ranks (the flat Comm; the halo ppermutes cross rows at one
        boundary row a pair);
      * then ONE all_gather over all ranks a cycle, re-sharded onto the
        C ranks of each row (the "ici" axis, the same on every row);
      * levels at or below `pc_mg_repl_size`: replicated."""
    import time

    dev = resolve_device(device)
    opts = options or Options()
    dtype = (np_dtype(dtype) or np.dtype(A_host.dtype)).type
    dcn_repl_n = opts.get_int("pc_mg_dcn_repl_size", 2048)
    repl_n, sm_its, cycles = _options(opts)
    timings = {}
    with log_event("PCDistMGSetup"):
        levels, transfers, das, Ahs = _sharded_stage(
            sp.csr_matrix(A_host).astype(dtype), DA(tuple(grid)), H * C,
            max(dcn_repl_n, repl_n), 0, sm_its, dtype, dev, timings)
        t = time.perf_counter()
        coarse_da = das[-1].coarsen()
        Pt = das[-1].interpolation(coarse_da)
        Ps = q1_interp_scipy(das[-1].grid, coarse_da.grid)
        Ac = (Ps.T @ Ahs[-1] @ Ps).tocsr()
        if int(np.prod(coarse_da.grid)) > repl_n and coarse_da.can_coarsen():
            inner = make_dist_mg(Ac, coarse_da.grid, C, dtype=dtype,
                                 options=opts, axis="ici", device=dev)
            coarse = None
        else:
            inner = None
            coarse = make_geometric_mg(Ac, coarse_da, dtype=dtype,
                                       options=opts, device=dev)
        timings["inner stage"] = time.perf_counter() - t
    pc = DistMGPC(tuple(levels), tuple(transfers), Pt, coarse,
                  tuple(d.grid for d in das), ("dcn", "ici"), H * C, cycles,
                  inner)
    pc.timings = timings
    return pc
