"""Distributed nonlinear solves: SNES / TS on every rank of a World.

Counterpart of petsctpu/parallel/psnes.py (reference: SNESSolve
src/snes/interface/snes.c:3585 evaluating residuals through DMDA ghost
scatters, src/dm/interface/dm.c:1620, the Jacobian assembled by FD
coloring, SNESDefaultComputeJacobianColor src/snes/snesj2.c:36 ->
MatFDColoringApply, and J dx = F solved by a distributed KSP + PC).
The axis-parametric `snes_solve` / `ts_solve` run unchanged on each
rank with axis = its Comm: residual halos are Comm.ppermute, reductions
psum, and the colored-FD assembly gives each rank its slab of a
sharded stencil Jacobian (parallel/pstencil.py).

A user's sharded residual takes the rank's Comm where petsctpu's
names the mesh axis: F(u_local, comm) for SNES, rhs(t, u_local, comm)
for TS, each on a batch [..., nloc] as well (the FD assembly
evaluates every color at once).
"""

from __future__ import annotations

from dataclasses import replace
from typing import Callable, Optional

import numpy as np
import torch

from petsctpu_torch.device import np_dtype, resolve_device
from petsctpu_torch.ksp.common import KSPConfig
from petsctpu_torch.parallel.api import rank_view, split_vector
from petsctpu_torch.parallel.pstencil import RankStencil
from petsctpu_torch.snes.api import SNESConfig, SNESResult, snes_solve
from petsctpu_torch.ts.steppers import TSConfig, TSResult, ts_solve


class ShardedFDJac:
    """Colored-FD Jacobian plan of a sharded grid residual (petsctpu's
    ShardedFDJac): a greedy distance-2 coloring of the TRUE-grid pattern
    (mat/coloring.greedy_color), built once on the host; each rank's
    color of its columns, the color of each offset's target column and
    the in-grid mask. Rows past the true grid (leading-axis padding)
    must have the identity residual F(x) = x there: the FD then
    reproduces the identity pad rows of the sharded operators.
    rank(comm) gives the rank's plan, whose `assemble` the Newton loop
    calls."""

    def __init__(self, color, colj, ok, offsets, grid, nshards: int,
                 halo: int, ncolors: int):
        self.color, self.colj, self.ok = color, colj, ok
        self.offsets = offsets
        self.grid = grid
        self.nshards = nshards
        self.halo = halo
        self.ncolors = ncolors

    @property
    def n_pad(self) -> int:
        return int(np.prod(self.grid))

    def rank(self, comm) -> "RankFDJac":
        return RankFDJac(self, comm)

    @classmethod
    def plan(cls, grid_true, offsets, nshards: int, mloc: int = None,
             device=None) -> "ShardedFDJac":
        """grid_true: the TRUE global grid (its leading axis padded to
        nshards·mloc); offsets: nd-tuples covering every dependency of
        the residual, the diagonal included."""
        import scipy.sparse as sp

        from petsctpu_torch.mat.coloring import greedy_color

        dev = resolve_device(device)
        grid_true = tuple(grid_true)
        m = grid_true[0]
        rest = grid_true[1:]
        if mloc is None:
            mloc = -(-m // nshards)
        assert mloc * nshards >= m, (mloc, nshards, m)
        grid = (mloc * nshards,) + rest
        n_pad = int(np.prod(grid))
        nd = len(grid)
        offsets = tuple(tuple(int(o) for o in off) for off in offsets)
        assert any(all(o == 0 for o in off) for off in offsets), \
            "offsets must include the diagonal"
        halo = max(abs(off[0]) for off in offsets) or 1

        multi = np.stack(np.unravel_index(np.arange(n_pad), grid), axis=1)
        strides = np.array([int(np.prod(grid[k + 1:])) for k in range(nd)])
        true_row = multi[:, 0] < m
        gb = np.array(grid_true)
        D = len(offsets)
        colj = np.zeros((D, n_pad), np.int32)
        ok = np.zeros((D, n_pad), bool)
        rows_p, cols_p = [], []
        diag_d = next(d for d, off in enumerate(offsets)
                      if all(o == 0 for o in off))
        for d, off in enumerate(offsets):
            tgt = multi + np.array(off)
            inside = np.all((tgt >= 0) & (tgt < gb), axis=1) & true_row
            ok[d] = inside
            col = np.where(inside, tgt @ strides, 0)
            colj[d] = col
            rows_p.append(np.arange(n_pad)[inside])
            cols_p.append(col[inside])
        ok[diag_d] |= ~true_row
        colj[diag_d] = np.where(true_row, colj[diag_d], np.arange(n_pad))
        rows_p.append(np.arange(n_pad)[~true_row])
        cols_p.append(np.arange(n_pad)[~true_row])
        r = np.concatenate(rows_p)
        c = np.concatenate(cols_p)
        pattern = sp.coo_matrix((np.ones(len(r)), (r, c)),
                                shape=(n_pad, n_pad)).tocsr()
        colors = greedy_color(pattern).astype(np.int32)
        colj = colors[colj]
        nloc = n_pad // nshards

        def rows(a, p):
            return torch.from_numpy(np.ascontiguousarray(
                a[..., p * nloc:(p + 1) * nloc]).astype(
                    np.int64 if a.dtype != bool else bool)).to(dev)

        return cls([rows(colors, p) for p in range(nshards)],
                   [rows(colj, p) for p in range(nshards)],
                   [rows(ok, p) for p in range(nshards)],
                   offsets, grid, nshards, halo, int(colors.max()) + 1)


class RankFDJac:
    """One rank's FD-coloring plan; assemble(F, x, Fx) evaluates F on
    every color's perturbation at once (one halo exchange for all) and
    returns the rank's stencil Jacobian slab."""

    def __init__(self, J: ShardedFDJac, comm):
        p = comm.rank
        self.J, self.comm = J, comm
        self.color, self.colj, self.ok = J.color[p], J.colj[p], J.ok[p]

    def assemble(self, F: Callable, x: torch.Tensor, Fx: torch.Tensor,
                 h: float = None) -> RankStencil:
        J = self.J
        dtype = x.dtype
        hval = h if h is not None else float(np.sqrt(np.finfo(
            np_dtype(dtype)).eps))
        hval = torch.tensor(hval, dtype=dtype, device=x.device)
        nloc = x.shape[0]
        mloc = J.grid[0] // J.nshards
        Dm = (self.color[None, :] == torch.arange(
            J.ncolors, device=x.device)[:, None]).to(dtype)
        Fb = F(x[None, :] + hval * Dm)                     # [C, nloc]
        rows = torch.arange(nloc, device=x.device)
        zero = torch.zeros((), dtype=dtype, device=x.device)
        coeffs = torch.stack([
            torch.where(self.ok[d], (Fb[self.colj[d], rows] - Fx) / hval,
                        zero).reshape((mloc,) + tuple(J.grid[1:]))
            for d in range(len(J.offsets))])
        return RankStencil(coeffs, J.offsets, J.grid, self.comm, J.halo)


def par_snes_solve(world, F_local: Callable, x0, jac=None, pc=None,
                   cfg: SNESConfig = None, ksp_cfg: KSPConfig = None,
                   n_pad: int = None, solver: Callable = None,
                   solver_kw: dict = None, **kw) -> SNESResult:
    """Distributed Newton-Krylov solve of F(x) = 0 over the World.

    F_local(u_local, comm): the rank's residual (halos through comm);
    x0: the TRUE global vector (host) or per-rank pieces;
    jac: a ShardedFDJac plan, "jvp" or "fd" (matrix-free), or a
         callable (x, Fx) -> operator;
    pc: a distributed PC (RankPCs, a DistMGPC, ...), lagged: built once,
        reused every Newton step (-snes_lag_preconditioner);
    solver: another nonlinear solver of the axis-parametric signature
        solver(F, x0, cfg=, axis=, **solver_kw) in Newton's place
        (snes_anderson, snes_ngmres, snes_nasm, ...); jac, pc and
        ksp_cfg are then unused."""
    cfg = replace(cfg or SNESConfig(), **kw) if kw else (cfg or SNESConfig())
    ksp_cfg = ksp_cfg or KSPConfig(ksp_type="gmres", rtol=1e-5, maxits=200)
    if n_pad is None:
        n_pad = jac.n_pad if isinstance(jac, ShardedFDJac) else None
    P = world.size
    xs = split_vector(world, x0, n_pad, P)

    def body(comm, x0_loc):
        F = (lambda u: F_local(u, comm))
        if solver is not None:
            return solver(F, x0_loc, cfg=cfg, axis=comm,
                          **(solver_kw or {}))
        pc_loc = rank_view(pc, comm)
        pb = (lambda J: pc_loc) if pc_loc is not None else None
        return snes_solve(F, x0_loc, jac=rank_view(jac, comm),
                          pc_builder=pb, ksp_cfg=ksp_cfg, cfg=cfg, axis=comm)

    res = world.run(body, [(x,) for x in xs])
    its = {int(r.its) for r in res}
    if len(its) != 1:
        raise RuntimeError(f"ranks disagree on the Newton count: {its}")
    r0 = res[0]
    return SNESResult(torch.cat([r.x for r in res]), r0.its, r0.reason,
                      r0.fnorm, r0.history)


def par_ts_solve(world, rhs: Optional[Callable], u0, cfg: TSConfig = None,
                 jac=None, pc=None, ifunc: Callable = None,
                 n_pad: int = None, **kw) -> TSResult:
    """Distributed time integration (TSSolve ts.c:2388 over a
    communicator): ts_solve on every rank, rhs(t, u_local, comm) and
    ifunc(t, u, udot, comm) the rank's; implicit steppers' Newton
    solves assemble each rank's colored stage Jacobian (the plan's
    offsets must include the diagonal)."""
    cfg = replace(cfg or TSConfig(), **kw) if kw else (cfg or TSConfig())
    if n_pad is None:
        n_pad = jac.n_pad if isinstance(jac, ShardedFDJac) else None
    us = split_vector(world, u0, n_pad, world.size)

    def body(comm, u0_loc):
        pc_loc = rank_view(pc, comm)
        pb = (lambda J: pc_loc) if pc_loc is not None else None
        r = (None if rhs is None else
             (lambda t, u: rhs(t, u, comm)))
        f = (None if ifunc is None else
             (lambda t, u, ud: ifunc(t, u, ud, comm)))
        return ts_solve(r, u0_loc, cfg=cfg, jac=rank_view(jac, comm),
                        pc_builder=pb, ifunc=f, axis=comm)

    res = world.run(body, [(u,) for u in us])
    steps = {int(r.steps) for r in res}
    if len(steps) != 1:
        raise RuntimeError(f"ranks disagree on the step count: {steps}")
    r0 = res[0]
    return r0._replace(u=torch.cat([r.u for r in res]))


def pad_shard(world, x, n_pad: int) -> list:
    """A true global vector padded to the sharded size (pad entries
    zero), as per-rank pieces on the world's device."""
    return split_vector(world, x, n_pad, world.size)
