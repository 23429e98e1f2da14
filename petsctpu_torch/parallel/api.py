"""Distributed solves: the axis-parametric KSP on every rank of a World.

Counterpart of petsctpu/parallel/api.py, whose shard_map runs the same
solver code that runs serially, with collectives only through vec.ops
and the operators' halos (SURVEY.md §2.10 P1-P4: the identical source
under real MPI and under mpiuni). Here `world.run` runs the solver on
every rank's thread with `axis` = the rank's Comm; the sharded operator
and PC hand each rank its own piece (`rank(comm)`).

A vector of a distributed solve is a list of per-rank tensors on the
world's device (shard_vector), or a host vector padded to the layout.
"""

from __future__ import annotations

from dataclasses import replace

import numpy as np
import torch

from petsctpu_torch.core import commaudit
from petsctpu_torch.core import logging as plog
from petsctpu_torch.core.layout import Layout
from petsctpu_torch.device import np_dtype
from petsctpu_torch.ksp.common import KSPConfig, SolveResult


def rank_view(obj, comm):
    """The rank's piece of a sharded object (its `rank(comm)`); None and
    objects that are not sharded pass through."""
    if obj is None:
        return None
    r = getattr(obj, "rank", None)
    return r(comm) if callable(r) else obj


def shard_vector(world, x, layout: Layout) -> list:
    """A host global vector, padded to the layout, as per-rank tensors
    on the world's device."""
    xp = layout.pad_vector(np.asarray(x))
    s = layout.shard_size
    return [torch.from_numpy(np.ascontiguousarray(xp[p * s:(p + 1) * s]))
            .to(world.device) for p in range(layout.nshards)]


def unshard_vector(x, layout) -> np.ndarray:
    """The true (unpadded) global host vector of per-rank pieces or of a
    padded global tensor. layout: the operator's Layout (a ShardedAIJ's,
    flat or two-axis), or the true size n where the padding trails the
    true entries (a DistMGPC's grid, padded along its leading axis)."""
    if isinstance(x, (list, tuple)):
        x = torch.cat([t.reshape(-1) for t in x])
    n = layout if isinstance(layout, (int, np.integer)) else layout.n
    return np.asarray(x.detach().cpu().numpy())[:n]


def split_vector(world, v, npad: int, nshards: int, dtype=None) -> list:
    """v as per-rank tensors: a list as it is, else a host or device
    global vector zero-padded to npad (in `dtype`, else its own) and cut
    into nshards pieces."""
    if isinstance(v, (list, tuple)):
        return list(v)
    if isinstance(v, torch.Tensor):
        v = v.detach().cpu().numpy()
    vh = np.asarray(v)
    vp = np.zeros(npad, dtype=dtype or vh.dtype)
    vp[: len(vh)] = vh
    s = npad // nshards
    return [torch.from_numpy(vp[p * s:(p + 1) * s].copy()).to(world.device)
            for p in range(nshards)]


def gather_result(res: list) -> SolveResult:
    """One SolveResult of the ranks' results: x the concatenation of
    their pieces, the rest rank 0's, which every rank must share."""
    its = {int(r.its) for r in res}
    if len(its) != 1:
        raise RuntimeError(f"ranks disagree on the iteration count: {its}")
    r0 = res[0]
    x = torch.cat([r.x for r in res]) if len(res) > 1 else r0.x
    return SolveResult(x, r0.its, r0.reason, r0.rnorm, r0.history)


def _config(cfg, kw) -> KSPConfig:
    return replace(cfg or KSPConfig(), **kw) if (kw or cfg is None) else cfg


def par_ksp_solve(world, A, b, x0=None, pc=None, cfg: KSPConfig = None,
                  **kw) -> SolveResult:
    """Distributed KSP solve of a sharded operator A (ShardedAIJ,
    ShardedBAIJ, ShardedStencil, or a two-axis World's ShardedAIJHier)
    with a sharded PC (RankPCs, a DistMGPC, ...) or None. b, x0: host
    global vectors (padded here) or per-rank tensors. The result's x is
    the padded global vector on the device (this process's ranks'
    pieces, in rank order)."""
    from petsctpu_torch.ksp.api import KSP_REGISTRY

    cfg = _config(cfg, kw)
    npad, P = A.shape[0], A.nshards
    dt = np_dtype(A.dtype)
    bs = split_vector(world, b, npad, P, dt)
    x0s = (split_vector(world, x0, npad, P, dt) if x0 is not None
           else [torch.zeros_like(t) for t in bs])
    fn = KSP_REGISTRY[cfg.ksp_type]

    def body(comm, b_loc, x0_loc):
        return fn(A.rank(comm), b_loc, x0_loc, rank_view(pc, comm), cfg,
                  comm)

    if not plog.log_enabled():
        return gather_result(world.run(body, list(zip(bs, x0s))))
    # the -log_summary Mess ledger (core/logging.log_comm): the
    # collectives rank 0 made in this solve, counted at run time
    before = _totals(world.comms[0].counts)
    res = gather_result(world.run(body, list(zip(bs, x0s))))
    after = _totals(world.comms[0].counts)
    plog.log_comm(f"KSPSolve_{cfg.ksp_type}", after[0] - before[0],
                  after[1] - before[1])
    return res


def _totals(counts: dict) -> tuple:
    """(calls, bytes) summed over a Comm's counts."""
    return (sum(c[0] for c in counts.values()),
            sum(c[1] for c in counts.values()))


class ParKSP:
    """Stateful distributed KSP (mirrors KSP, over a World)."""

    def __init__(self, world, options=None, prefix: str = ""):
        from petsctpu_torch.core.options import Options
        self.world = world
        self.opts = (options or Options()).prefixed(prefix)
        self.A = None
        self.part = None
        self.pc = None

    def set_operators(self, A, part=None):
        self.A = A
        self.part = part
        return self

    def solve(self, b, x0=None) -> SolveResult:
        from petsctpu_torch.ksp.api import config_from_options
        cfg = config_from_options(self.opts)
        if self.pc is None:
            from petsctpu_torch.pc.parallel import make_par_pc
            pc_type = self.opts.get_str("pc_type", "bjacobi")
            self.pc = make_par_pc(pc_type, self.A, self.part,
                                  options=self.opts)
        return par_ksp_solve(self.world, self.A, b, x0=x0, pc=self.pc,
                             cfg=cfg)


def audit_par_ksp(world, A, b, x0=None, pc=None, cfg: KSPConfig = None,
                  its: tuple = (2, 4), key: str = None,
                  **kw) -> commaudit.CommAudit:
    """Collective audit of a distributed KSP program (the -log_summary
    Mess columns, plog.c:1264): the program run twice, to its[0] and
    its[1] iterations (rtol = atol = 0, so both stop at their maxits),
    counted by rank 0's Comm and split by core/commaudit.audit_runs.
    Registered in commaudit.COMM_AUDITS under `key` (default
    ksp:<type>[<ranks>]/n<local rows>)."""
    cfg = replace(_config(cfg, kw), rtol=0.0, atol=0.0,
                  divtol=float("inf"))
    counts = []
    for k in its:
        world.reset_counts()
        r = par_ksp_solve(world, A, b, x0=x0, pc=pc,
                          cfg=replace(cfg, maxits=k))
        if int(r.its) != k:
            raise RuntimeError(f"audit run stopped at {int(r.its)} of {k} "
                               "iterations")
        counts.append({lab: list(v) for lab, v in
                       world.comms[0].counts.items()})
    audit = commaudit.audit_runs(counts[0], its[0], counts[1], its[1])
    key = key or f"ksp:{cfg.ksp_type}[{A.nshards}]/n{A.shape[0] // A.nshards}"
    commaudit.COMM_AUDITS[key] = audit
    return audit
