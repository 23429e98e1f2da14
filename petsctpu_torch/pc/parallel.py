"""Distributed preconditioners: one local PC a rank.

Counterpart of petsctpu/pc/parallel.py (reference: the default
parallel PC is block Jacobi with one ILU(0) block per rank,
PCSetUp_BJacobi src/ksp/pc/impls/bjacobi/bjacobi.c:14). A "block" is a
rank's diagonal block. Setup is host work, as in petsctpu: each rank's
ILU(0) or LU factor comes from the host numerics (mat/factor.py), and
its triangular plans are padded to the common (nlev, rmax, K) of all
ranks, so rank p's plan arrays are row p of petsctpu's stacked plans.
An apply on a rank is the fused L+U SpTRSV kernel (`sptrsv_lu`, one
launch per apply per rank where the pair fuses).

A sharded PC is a RankPCs: `rank(comm)` gives the rank's local PC.
"""

from __future__ import annotations

import time
import weakref

import numpy as np
import scipy.sparse as sp
import torch

from petsctpu_torch.core.options import Options
from petsctpu_torch.device import np_dtype, resolve_device
from petsctpu_torch.mat.factor import (common_pad, ilu0, lu_factor,
                                       make_sptrsv_plan)
from petsctpu_torch.pc.factor import ILUPC, LUPC
from petsctpu_torch.pc.simple import JacobiPC


class RankPCs:
    """Per-rank local PCs (rank p's is pcs[p]); timings: host seconds of
    the setup by part."""

    def __init__(self, pcs, timings=None):
        self.pcs = list(pcs)
        self.timings = timings or {}

    def rank(self, comm):
        return self.pcs[comm.rank]


def _tri_plans(tris, lower: bool, unit_diag: bool, dtype, dev) -> list:
    pad = common_pad(tris, lower, unit_diag)
    return [make_sptrsv_plan(T, lower=lower, unit_diag=unit_diag,
                             dtype=dtype, pad_to=pad, device=dev)
            for T in tris]


def _perm(p, dev) -> torch.Tensor:
    return torch.as_tensor(np.asarray(p), dtype=torch.int64).to(dev)


def lu_pcs(blocks, dtype, dev) -> tuple:
    """Per-block LUPCs (SuperLU factors, plans of common size) and the
    setup's (numerics, plans) seconds."""
    t0 = time.perf_counter()
    fs = [lu_factor(D) for D in blocks]
    t1 = time.perf_counter()
    Lp = _tri_plans([f[0] for f in fs], True, False, dtype, dev)
    Up = _tri_plans([f[1] for f in fs], False, False, dtype, dev)
    pcs = [LUPC(L, U, _perm(f[2], dev), _perm(f[3], dev))
           for L, U, f in zip(Lp, Up, fs)]
    return pcs, (t1 - t0, time.perf_counter() - t1)


def make_bjacobi(part, sub_pc: str = "ilu", dtype=None,
                 device=None) -> RankPCs:
    """Block Jacobi over the ranks' diagonal blocks; sub_pc: ilu | lu."""
    dev = resolve_device(device)
    dtype = np_dtype(dtype)
    if sub_pc == "ilu":
        t0 = time.perf_counter()
        fs = [ilu0(D) for D in part.diag_blocks]
        t1 = time.perf_counter()
        Lp = _tri_plans([f[0] for f in fs], True, True, dtype, dev)
        Up = _tri_plans([f[1] for f in fs], False, False, dtype, dev)
        return RankPCs([ILUPC(L, U) for L, U in zip(Lp, Up)],
                       {"ILU numerics": t1 - t0,
                        "SpTRSV plans": time.perf_counter() - t1})
    if sub_pc == "lu":
        pcs, (tn, tp) = lu_pcs(part.diag_blocks, dtype, dev)
        return RankPCs(pcs, {"LU numerics": tn, "SpTRSV plans": tp})
    raise ValueError(f"bjacobi sub_pc {sub_pc!r} not supported")


def make_par_jacobi(part, dtype=None, device=None) -> RankPCs:
    dev = resolve_device(device)
    pcs = []
    for D in part.diag_blocks:
        d = D.diagonal()
        d = np.where(d != 0, d, 1.0)
        pcs.append(JacobiPC(torch.from_numpy(
            (1.0 / d).astype(np_dtype(dtype) or d.dtype)).to(dev)))
    return RankPCs(pcs)


def make_par_pc(pc_type: str, A, part=None, options: Options = None):
    """Factory for distributed PCs (PCSetUp analog, parallel), built on
    the operator's device in its dtype."""
    opts = options or Options()
    dtype = getattr(A, "dtype", None)
    dev = getattr(A, "device", None)
    if pc_type == "none":
        return None
    if pc_type == "jacobi":
        _need_part(part, "jacobi")
        return make_par_jacobi(part, dtype, dev)
    if pc_type == "bjacobi":
        _need_part(part, "bjacobi")
        return make_bjacobi(part, sub_pc=opts.get_str("sub_pc_type", "ilu"),
                            dtype=dtype, device=dev)
    raise ValueError(f"unknown parallel pc_type {pc_type!r}")


def _need_part(part, name):
    if part is None:
        raise ValueError(f"parallel pc {name} needs the PartitionedCSR "
                         "(returned by sharded_aij_from_scipy)")


# ---------------------------------------------------------------------------
# Block Jacobi with per-block inner KSPs (PCBJacobiGetSubKSP)
# ---------------------------------------------------------------------------

class BJacobiKSPPC:
    """Block Jacobi whose sub-blocks are solved by their OWN inner KSP,
    each with its own solver type, preconditioner and tolerances — the
    PCBJacobiGetSubKSP customization surface of ksp ex7.c:136-160
    (per-block PCSetType/KSPSetType/KSPSetTolerances). Serial."""

    def __init__(self, blocks, pcs, cfgs, offsets):
        self.blocks = tuple(blocks)     # device diag-block operators
        self.pcs = tuple(pcs)           # per-block inner PC (or None)
        self.cfgs = tuple(cfgs)         # per-block KSPConfig
        self.offsets = tuple(offsets)   # row ranges [(s,e), ...]

    def apply(self, x):
        from petsctpu_torch.ksp.api import KSP_REGISTRY
        outs = []
        for Ab, pc, cfg, (s, e) in zip(self.blocks, self.pcs, self.cfgs,
                                       self.offsets):
            seg = x[s:e]
            r = KSP_REGISTRY[cfg.ksp_type](Ab, seg, torch.zeros_like(seg),
                                           pc, cfg, None)
            outs.append(r.x)
        return torch.cat(outs)


def make_bjacobi_ksp(A_host, blocks, cfgs, sub_pcs, dtype=None,
                     device=None) -> BJacobiKSPPC:
    """blocks: list of (start, end) row ranges; cfgs: per-block
    KSPConfig; sub_pcs: per-block pc_type ("none"/"jacobi"/"ilu"/"lu")."""
    from petsctpu_torch.mat.ell import aij_from_scipy
    from petsctpu_torch.pc.api import make_pc

    A = sp.csr_matrix(A_host)
    ops, pcs = [], []
    for (s, e), pct in zip(blocks, sub_pcs):
        D = A[s:e][:, s:e].tocsr()
        Dd = aij_from_scipy(D, dtype=dtype, device=device)
        ops.append(Dd)
        pcs.append(None if pct == "none"
                   else make_pc(pct, A=Dd, A_host=D))
    return BJacobiKSPPC(ops, pcs, cfgs, blocks)


# ---------------------------------------------------------------------------
# Distributed overlapping ASM
# ---------------------------------------------------------------------------
class DistASMPC:
    """Restricted additive Schwarz over DISTRIBUTED overlapping
    subdomains: per-rank overlap-k row sets grown by matrix
    connectivity (MatIncreaseOverlap, mpiov.c:17), ghost residual values
    fetched with a dedicated halo plan (all_to_all), a sparse LU on each
    padded overlapped submatrix, and RESTRICTED prolongation (owned rows
    only — asm.c PC_ASM_RESTRICT). rank(comm) gives the rank's PC."""

    def __init__(self, lups, send_idx, ghost_src, s: int, nshards: int,
                 timings=None):
        self.lups = lups
        self.send_idx = send_idx
        self.ghost_src = ghost_src
        self.s = s
        self.nshards = nshards
        self.timings = timings or {}

    def rank(self, comm) -> "RankDistASM":
        return RankDistASM(self, comm)


class RankDistASM:
    def __init__(self, M: DistASMPC, comm):
        p = comm.rank
        self.comm = comm
        self.lup = M.lups[p]
        self.send, self.gsrc = M.send_idx[p], M.ghost_src[p]
        self.s = M.s

    def apply(self, r):
        recv = self.comm.all_to_all(r[self.send])
        g = recv.reshape(-1)[self.gsrc]
        z = self.lup.apply(torch.cat([r, g]))
        return z[: self.s]


def dist_asm_blocks(A_host, layout, overlap: int = 1) -> tuple:
    """petsctpu's overlapped subdomain matrices (padded to s + gmax with
    identity) and their halo plan."""
    from petsctpu_torch.parallel.plan import _build_halo

    P, s = layout.nshards, layout.shard_size
    A = sp.csr_matrix(A_host)
    n = A.shape[0]
    npad = layout.n_padded
    if npad > n:
        A = sp.bmat([[A, None], [None, sp.eye(npad - n, format="csr")]],
                    format="csr")
    A.sort_indices()
    garrays, locals_ = [], []
    for p in range(P):
        own = np.arange(p * s, (p + 1) * s)
        idx = own
        for _ in range(overlap):
            idx = np.union1d(idx, A[idx].indices)
        remote = np.setdiff1d(idx, own)
        garrays.append(remote.astype(np.int64))
        locals_.append((own, remote))
    halo = _build_halo(layout, garrays, P)
    nsub = s + halo.gmax
    subs = []
    for own, remote in locals_:
        rows = np.concatenate([own, remote])
        Sub = A[rows][:, rows].tocsr()
        k = Sub.shape[0]
        if k < nsub:
            Sub = sp.bmat([[Sub, None],
                           [None, sp.eye(nsub - k, format="csr")]],
                          format="csr")
        subs.append(Sub)
    return subs, halo


def make_dist_asm(A_host, part, overlap: int = 1, dtype=None,
                  device=None) -> DistASMPC:
    """Distributed restricted ASM with overlap-k subdomains (the serial
    pc/asm.make_asm with the same explicit subdomains gives the same
    iteration counts)."""
    dev = resolve_device(device)
    lay = part.layout
    subs, halo = dist_asm_blocks(A_host, lay, overlap)
    lups, (tn, tp) = lu_pcs(subs, np_dtype(dtype), dev)
    P = lay.nshards
    return DistASMPC(
        lups, [torch.from_numpy(halo.send_idx[p].astype(np.int64)).to(dev)
               for p in range(P)],
        [torch.from_numpy(halo.ghost_src[p].astype(np.int64)).to(dev)
         for p in range(P)], lay.shard_size, P,
        {"LU numerics": tn, "SpTRSV plans": tp})


# ---------------------------------------------------------------------------
# PCHMPI — outer-sequential user, inner-parallel solve
# ---------------------------------------------------------------------------
class HMPIPC:
    """PCHMPI analog (src/ksp/pc/impls/openmp): the OUTER solver runs as
    ordinary serial code; each preconditioner application solves
    M z = r with an INNER distributed KSP over a World of rank threads.
    A World the PC made itself (`owns_world`) is closed by close(), or
    when the PC is collected."""

    def __init__(self, world, Ash, pc_inner, n: int, cfg,
                 owns_world: bool = False):
        self.world = world
        self.Ash = Ash
        self.pc_inner = pc_inner
        self.n = n
        self.cfg = cfg
        self._close = weakref.finalize(self, world.close) if owns_world \
            else None

    def close(self) -> None:
        """Close the World this PC made (nothing if the caller gave it)."""
        if self._close is not None:
            self._close()

    def apply(self, b):
        from petsctpu_torch.parallel.api import par_ksp_solve
        res = par_ksp_solve(self.world, self.Ash, b, pc=self.pc_inner,
                            cfg=self.cfg)
        return res.x[: self.n].to(b.device)


def make_hmpi(A_host, world=None, options=None, dtype=None,
              device=None) -> HMPIPC:
    """Partition A over `world` (default: a World of -pc_hmpi_size rank
    threads, 2, on `device`, which the PC owns and closes); the inner
    bjacobi(ILU) + KSP take the reference's -hmpi_ option prefix
    (ksp_type, ksp_rtol, ksp_max_it, sub_pc_type)."""
    from petsctpu_torch.ksp.common import KSPConfig
    from petsctpu_torch.parallel.comm import World
    from petsctpu_torch.parallel.pmat import sharded_aij_from_scipy

    base = options or Options()
    opts = base.prefixed("hmpi_")
    owns = world is None
    if owns:
        world = World(base.get_int("pc_hmpi_size", 2), device)
    A = sp.csr_matrix(A_host)
    Ash, part = sharded_aij_from_scipy(A, world.size, dtype=dtype,
                                       style="alltoall",
                                       device=world.device)
    pc_inner = make_bjacobi(part, sub_pc=opts.get_str("sub_pc_type", "ilu"),
                            dtype=dtype, device=world.device)
    cfg = KSPConfig(ksp_type=opts.get_str("ksp_type", "gmres"),
                    rtol=opts.get_real("ksp_rtol", 1e-8),
                    maxits=opts.get_int("ksp_max_it", 200))
    return HMPIPC(world, Ash, pc_inner, A.shape[0], cfg, owns_world=owns)
