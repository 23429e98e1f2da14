"""Sharded sparse matrix: the MPIAIJ analog.

Counterpart of petsctpu/parallel/pmat.py (reference: MPIAIJ,
src/mat/impls/aij/mpi/mpiaij.c — struct mpiaij.h:77, MatMult_MPIAIJ
:1102). Each rank holds a diagonal block A (local columns) and an
off-diagonal block B with compressed ghost columns (garray), plus its
row of the halo plan. petsctpu stacks these with a leading shard axis
and strips it inside shard_map; here the host plan builds every rank's
piece once, and `rank(comm)` gives the rank's operator, bound to its
Comm, which the same solver code then drives on that rank's thread.

The local diagonal-block product runs the port's kernels:
  * fmt="ell":  the ELL kernel (ops/ell_spmv.py) on the block's ELL pack;
  * fmt="sell": K2 (ops/sell_spmv.py) on the block's SELL pack, fp32,
                the packs of all ranks forced to common (passes, S, Lp)
                as petsctpu's diag_sell stacks them, byte for byte;
  * fmt="auto": petsctpu's rule for its accelerator (pmat.py's TPU
    branch), on every device: "sell" when the dtype is fp32 and every
    rank's diag block is SELL-viable, else "ell".
The off-diagonal ghost product and the halo's pack and unpack are
PyTorch gathers (XLA code in petsctpu); the transposed product's
scatter-adds fold through mat/fold.py in petsctpu's slot order.

Halo styles (the collective issued before the local product, which
does not depend on it, as mpiaij.c:1111-1114 overlaps them):
  * "alltoall":  per-destination send buffers, one all_to_all;
  * "allgather": all_gather the whole vector, gather by global index;
  * "ppermute":  one ring shift per plan offset (O(neighbours) payload),
                 picked by "auto" when a row split has 1 to 4 offsets.
"""

from __future__ import annotations

import time

import numpy as np
import scipy.sparse as sp
import torch

from petsctpu_torch.core.logging import log_event
from petsctpu_torch.device import np_dtype, resolve_device
from petsctpu_torch.mat.fold import fold_plan
from petsctpu_torch.parallel.plan import ell_pack, partition_csr


def _t(a, dev, dtype=None) -> torch.Tensor:
    return torch.from_numpy(np.array(a)).to(dev, dtype)


def halo_fetch(x, comm, style, send_idx, ghost_src, ghost_gidx, offsets):
    """My ghost values (the plan row's gmax slots) of the distributed
    vector whose local piece is x [nloc, ...] (ShardedAIJ.ghosts)."""
    P, me = comm.size, comm.rank
    if style == "allgather":
        return comm.all_gather(x)[ghost_gidx]
    if style == "ppermute":
        rbuf = x.new_zeros((P,) + tuple(send_idx.shape[1:]) + x.shape[1:])
        recvs = comm.ppermutes([(x[send_idx[(me + d) % P]],
                                 [(p, (p + d) % P) for p in range(P)])
                                for d in offsets])
        for d, recv in zip(offsets, recvs):
            rbuf[(me - d) % P] = recv
        return rbuf.reshape(-1, *x.shape[1:])[ghost_src]
    recv = comm.all_to_all(x[send_idx])
    return recv.reshape(-1, *x.shape[1:])[ghost_src]


class ShardedAIJ:
    """Row-partitioned operator: rank p's diag/off ELL blocks, halo-plan
    row and local product operator, for every p (see the module
    docstring). shape is the padded global shape."""

    def __init__(self, diag_cols, diag_vals, off_cols, off_vals, send_idx,
                 ghost_src, ghost_gidx, shape, nshards: int,
                 style: str = "alltoall", nnz: int = 0, offsets=(),
                 diag_ops=None, fmt: str = "ell"):
        self.diag_cols, self.diag_vals = diag_cols, diag_vals
        self.off_cols, self.off_vals = off_cols, off_vals
        self.send_idx, self.ghost_src = send_idx, ghost_src
        self.ghost_gidx = ghost_gidx
        self.shape = tuple(shape)
        self.nshards = nshards
        self.style = style
        self.nnz = nnz
        self.offsets = tuple(offsets)
        self.diag_ops = diag_ops
        self.fmt = fmt
        self._folds = {}

    @property
    def nloc(self) -> int:
        return self.diag_cols[0].shape[-2]

    @property
    def dtype(self):
        return self.diag_vals[0].dtype

    @property
    def device(self):
        return self.diag_vals[0].device

    def rank(self, comm) -> "RankAIJ":
        assert comm.size == self.nshards, (comm.size, self.nshards)
        return RankAIJ(self, comm)

    def flops_per_mult(self) -> float:
        return 2.0 * self.nnz - self.shape[0]


def real_slots(targets: torch.Tensor) -> torch.Tensor:
    """keep-mask of a plan's index table [..., n] whose rows are padded
    with trailing zeros and whose real entries are distinct within a row
    (a halo plan's send_idx, ghost_src): every nonzero and the first zero
    of each row. It keeps the real entries and drops the padding, whose
    contributions are zeros; folded, each would be one more rank of the
    plan (thousands where ranks' ghost counts differ)."""
    t = targets.reshape(-1, targets.shape[-1])
    z = t == 0
    return (~z | (z & (torch.cumsum(z, dim=1) == 1))).reshape(targets.shape)


class RankAIJ:
    """One rank's view of a ShardedAIJ, bound to its Comm: the operator
    the solvers call (petsctpu's ShardedAIJ.local())."""

    def __init__(self, M: ShardedAIJ, comm):
        p = comm.rank
        self.M, self.comm, self.p = M, comm, p
        self.shape = (M.nloc, M.nloc)
        self.dtype = M.dtype
        self.device = M.device
        self.diag_op = M.diag_ops[p]
        self.off_cols, self.off_vals = M.off_cols[p], M.off_vals[p]

    def ghosts(self, x: torch.Tensor) -> torch.Tensor:
        """Halo exchange: [gmax + 1] remote x values for my ghost slots,
        the last a zero sentinel (the off block's padding column)."""
        M, p = self.M, self.p
        g = halo_fetch(x, self.comm, M.style, M.send_idx[p], M.ghost_src[p],
                       M.ghost_gidx[p], M.offsets)
        return torch.cat([g, g.new_zeros(1)])

    def _diag_mult(self, x):
        return self.diag_op.mult(x).to(x.dtype)

    def mult(self, x: torch.Tensor) -> torch.Tensor:
        """y_local = (A x)_local: halo collective first, then the local
        product, then the ghost product."""
        if self.M.nshards == 1:
            return self._diag_mult(x)
        g = self.ghosts(x)
        y = self._diag_mult(x)
        return y + (self.off_vals * g[self.off_cols]).sum(1)

    def _fold(self, key, targets, keep=None):
        """The cached fold plan of `targets` (keep: a mask, or a function
        of targets giving one, evaluated when the plan is built)."""
        folds = self.M._folds
        k = (self.p, key)
        if k not in folds:
            folds[k] = fold_plan(targets, keep(targets) if callable(keep)
                                 else keep)
        return folds[k]

    def multT(self, x: torch.Tensor) -> torch.Tensor:
        """y_local = (Aᵀ x)_local (MatMultTranspose_MPIAIJ): the diag
        block transposed locally, the off block's contributions to ghost
        slots sent back along the halo plan in reverse (the reference's
        SCATTER_REVERSE), every scatter-add a fold in petsctpu's order."""
        M, p, comm = self.M, self.p, self.comm
        dt, dev = x.dtype, x.device
        dc, dv = M.diag_cols[p], M.diag_vals[p]
        y = self._fold("d", dc, dv != 0).fold(
            torch.zeros(self.shape[1], dtype=dt, device=dev),
            (dv * x[:, None]).reshape(-1))
        if M.nshards == 1:
            return y
        gsrc = M.ghost_src[p]
        gmax = gsrc.shape[-1]
        gbuf = self._fold("o", self.off_cols, self.off_vals != 0).fold(
            torch.zeros(gmax + 1, dtype=dt, device=dev),
            (self.off_vals * x[:, None]).reshape(-1))[:gmax]
        if M.style == "allgather":
            contrib = self._fold("g", M.ghost_gidx[p]).fold(
                torch.zeros(M.shape[0], dtype=dt, device=dev), gbuf)
            tot = comm.psum(contrib)
            return y + tot[p * M.nloc:(p + 1) * M.nloc]
        send = M.send_idx[p]
        P, smax = send.shape
        rbuf = self._fold("r", gsrc, real_slots).fold(
            torch.zeros(P * smax, dtype=dt, device=dev), gbuf)
        if M.style == "ppermute":
            rb = rbuf.reshape(P, smax)
            backs = comm.ppermutes([(rb[(p - d) % P],
                                     [(q, (q - d) % P) for q in range(P)])
                                    for d in M.offsets])
            for d, back in zip(M.offsets, backs):
                dst = (p + d) % P
                y = self._fold(("s", dst), send[dst],
                               real_slots).fold(y, back)
            return y
        back = comm.all_to_all(rbuf.reshape(P, smax))
        return self._fold("s", send, real_slots).fold(
            y, back.reshape(-1))

    def diagonal(self) -> torch.Tensor:
        dc, dv = self.M.diag_cols[self.p], self.M.diag_vals[self.p]
        rows = torch.arange(dc.shape[0], device=dc.device)[:, None]
        return torch.where(dc == rows, dv, torch.zeros_like(dv)).sum(1)

    def flops_per_mult(self) -> float:
        return self.M.flops_per_mult() / self.M.nshards


def _fp32_blocks(blocks) -> list:
    blocks = [sp.csr_matrix(D).astype(np.float32) for D in blocks]
    for D in blocks:
        D.sum_duplicates()
    return blocks


def auto_fmt(blocks, dtype) -> str:
    """fmt="auto"'s choice for these diag blocks: "sell" when dtype is
    fp32 and every block is SELL-viable (all or nothing), else "ell"."""
    from petsctpu_torch.mat.sell import sell_viable

    if np.dtype(dtype) != np.float32:
        return "ell"
    return ("sell" if all(sell_viable(D) for D in _fp32_blocks(blocks))
            else "ell")


def diag_sell_packs(blocks) -> list:
    """SELL packs (sell_pack's (arrays, statics) pairs) of the fp32 diag
    blocks with common (passes, S, Lp) and the largest block's nnz, as
    petsctpu stacks its diag_sell; raises where a block is not
    SELL-viable."""
    from petsctpu_torch.mat.sell import sell_pack, sell_plan_stats, \
        sell_viable

    blocks = _fp32_blocks(blocks)
    if not all(sell_viable(D) for D in blocks):
        raise ValueError("fmt='sell': a diag block is not SELL-viable; "
                         "use fmt='ell'")
    npass = S = 1
    for D in blocks:
        Pp, _, Ss, _ = sell_plan_stats(D)
        npass, S = max(npass, Pp), max(S, Ss)
    packs = [sell_pack(D, force=(npass, S, 1)) for D in blocks]
    Lp = max(st["Lp"] for _, st in packs)
    if Lp != min(st["Lp"] for _, st in packs):
        packs = [sell_pack(D, force=(npass, S, Lp)) for D in blocks]
    nz = max(int(D.nnz) for D in blocks)
    for _, st in packs:
        st["nnz"] = nz
    return packs


def sharded_aij_from_stacked(dc, dv, oc, ov, send_idx, ghost_src,
                             ghost_gidx, shape, nshards: int,
                             style: str = "alltoall", nnz: int = 0,
                             offsets=(), fmt: str = "ell", sell_packs=None,
                             device=None) -> ShardedAIJ:
    """A ShardedAIJ from petsctpu's stacked [P, ...] host arrays (row p
    is rank p's); fmt "sell" takes `sell_packs` (diag_sell_packs)."""
    from petsctpu_torch.convert import aij_from_arrays, sell_from_arrays

    dev = resolve_device(device)
    P = nshards
    local = (dc.shape[1], shape[1] // P)
    if fmt == "sell":
        ops = [sell_from_arrays(a, st, device=dev) for a, st in sell_packs]
    else:
        ops = [aij_from_arrays(dc[p], dv[p], local,
                               int(np.count_nonzero(dv[p])), device=dev)
               for p in range(P)]
    return ShardedAIJ(
        [_t(dc[p], dev, torch.int64) for p in range(P)],
        [_t(dv[p], dev) for p in range(P)],
        [_t(oc[p], dev, torch.int64) for p in range(P)],
        [_t(ov[p], dev) for p in range(P)],
        [_t(send_idx[p], dev, torch.int64) for p in range(P)],
        [_t(ghost_src[p], dev, torch.int64) for p in range(P)],
        [_t(ghost_gidx[p], dev, torch.int64) for p in range(P)],
        shape, P, style, nnz, offsets, ops, fmt)


def stacked_ell(blocks, off_blocks, gmax: int, s: int, dtype):
    """petsctpu's stacked ELL arrays (dc, dv, oc, ov) of per-rank diag
    and off blocks: common widths K1, K2; off padding col = gmax."""
    P = len(blocks)
    K1 = max(max(int(np.diff(D.indptr).max()) if D.nnz else 0
                 for D in blocks), 1)
    K2 = max(max(int(np.diff(O.indptr).max()) if O.nnz else 0
                 for O in off_blocks), 1)
    dc = np.zeros((P, s, K1), np.int32)
    dv = np.zeros((P, s, K1), dtype)
    oc = np.full((P, s, K2), gmax, np.int32)
    ov = np.zeros((P, s, K2), dtype)
    for p in range(P):
        c, v = ell_pack(blocks[p], K1)
        dc[p], dv[p] = c, v.astype(dtype)
        c, v = ell_pack(off_blocks[p], K2)
        oc[p], ov[p] = c, v.astype(dtype)
    return dc, dv, oc, ov


def sharded_aij_from_scipy(A, nshards: int, dtype=None,
                           style: str = "auto", perm=None,
                           fmt: str = "ell", device=None) -> tuple:
    """Build a ShardedAIJ and its PartitionedCSR (the host blocks the
    PC setups factor): (mat, part).

    perm: a row/column permutation applied before the contiguous row
    split (MatPartitioning -> distribution), or a partitioner name,
    "kway" or "rcm", computed here; vectors must then be permuted the
    same way (x_perm = x[part.perm])."""
    if fmt not in ("ell", "sell", "auto"):
        raise ValueError(f"fmt {fmt!r}: 'ell', 'sell' or 'auto'")
    with log_event("MatPartitioning"):
        t0 = time.perf_counter()
        if isinstance(perm, str):
            from petsctpu_torch.mat.partition import (partition_kway,
                                                      partition_rcm)
            pfun = {"kway": partition_kway, "rcm": partition_rcm}[perm]
            perm = np.argsort(pfun(sp.csr_matrix(A), nshards), kind="stable")
        if perm is not None:
            perm = np.asarray(perm)
            A = sp.csr_matrix(A)[perm][:, perm]
        t_perm = time.perf_counter() - t0
        part = partition_csr(A, nshards)
        part.perm = perm
    timings = part.timings
    timings["partition"] = t_perm
    lay = part.layout
    dtype = np_dtype(dtype) or np.asarray(A.data[:1]).dtype
    if fmt == "auto":
        fmt = auto_fmt(part.diag_blocks, dtype)
    if fmt == "sell" and dtype != np.float32:
        raise ValueError("fmt='sell' needs dtype=float32 (K2's dtype)")
    t0 = time.perf_counter()
    with log_event("MatPack"):
        dc, dv, oc, ov = stacked_ell(part.diag_blocks, part.off_blocks,
                                     part.halo.gmax, lay.shard_size, dtype)
        packs = diag_sell_packs(part.diag_blocks) if fmt == "sell" else None
    timings["pack"] = time.perf_counter() - t0
    if style == "auto":
        noff = len(part.halo.offsets)
        style = "ppermute" if 0 < noff <= 4 else "alltoall"
    t0 = time.perf_counter()
    h = part.halo
    mat = sharded_aij_from_stacked(
        dc, dv, oc, ov, h.send_idx, h.ghost_src, h.ghost_gidx,
        (lay.n_padded, lay.n_padded), nshards, style,
        int(sp.csr_matrix(A).nnz), h.offsets, fmt, packs, device)
    timings["upload"] = time.perf_counter() - t0
    part.timings = timings
    return mat, part


class ShardedRectAIJ:
    """Row-partitioned RECTANGULAR operator — the sharded form of a
    prolongator P: coarse → fine (petsctpu's ShardedRectAIJ). Rows
    follow the fine layout, columns the coarse layout; `mult` halos the
    COARSE vector over the column-space plan (all_to_all), `multT` runs
    the plan in reverse. rank(comm) gives the rank's operator."""

    def __init__(self, M: ShardedAIJ, ncloc: int):
        self.M = M
        self.ncloc = ncloc
        self.shape = M.shape
        self.nshards = M.nshards

    def rank(self, comm) -> "RankRectAIJ":
        return RankRectAIJ(self, comm)


class RankRectAIJ(RankAIJ):
    """One rank's rows of a ShardedRectAIJ: its local coarse columns are
    ncloc (RankAIJ's products, over the all_to_all plan)."""

    def __init__(self, R: ShardedRectAIJ, comm):
        super().__init__(R.M, comm)
        self.ncloc = R.ncloc
        self.shape = (R.M.nloc, R.ncloc)


def sharded_rect_from_scipy(A, nshards: int, dtype=None,
                            device=None) -> ShardedRectAIJ:
    """Partition a rectangular scipy matrix (a prolongator) over the
    ranks; see parallel/plan.py::partition_rect_csr."""
    from petsctpu_torch.parallel.plan import partition_rect_csr

    A = sp.csr_matrix(A)
    rlay, clay, Ds, Os, gars, halo = partition_rect_csr(A, nshards)
    dtype = np_dtype(dtype) or A.dtype
    dc, dv, oc, ov = stacked_ell(Ds, Os, halo.gmax, rlay.shard_size, dtype)
    M = sharded_aij_from_stacked(
        dc, dv, oc, ov, halo.send_idx, halo.ghost_src, halo.ghost_gidx,
        (rlay.n_padded, clay.n_padded), nshards, "alltoall", int(A.nnz),
        halo.offsets, "ell", None, device)
    return ShardedRectAIJ(M, clay.shard_size)


def sharded_aij_from_decomp(A, dec, dtype=None, style: str = "alltoall",
                            fmt: str = "ell", device=None) -> tuple:
    """Shard a matrix assembled in NATURAL ordering over the ranks of a
    DADecomp2D (dm/decomp.py): each rank's 2-D patch is a contiguous
    row range of the rank-major PETSc ordering, padded to the largest
    patch with identity rows. Returns (mat, part, q) with q the
    natural -> padded-slot map: x_padded[q] = x_natural."""
    p = dec.natural_to_petsc()
    ranges = dec.petsc_row_ranges()
    P = dec.size
    S = max(e - s for s, e in ranges)
    nt = P * S
    tgt = np.empty(p.size, np.int64)
    for r, (s, e) in enumerate(ranges):
        tgt[s:e] = r * S + np.arange(e - s)
    q = tgt[p]
    A = sp.csr_matrix(A).tocoo()
    used = np.zeros(nt, bool)
    used[q] = True
    pad = np.flatnonzero(~used)
    Ap = sp.coo_matrix(
        (np.concatenate([A.data, np.ones(pad.size, A.data.dtype)]),
         (np.concatenate([q[A.row], pad]),
          np.concatenate([q[A.col], pad]))), shape=(nt, nt)).tocsr()
    mat, part = sharded_aij_from_scipy(Ap, P, dtype=dtype, style=style,
                                       fmt=fmt, device=device)
    return mat, part, q
