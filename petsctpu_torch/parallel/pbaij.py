"""ShardedBAIJ — distributed blocked sparse matrix (MPIBAIJ analog).

Counterpart of petsctpu/parallel/pbaij.py (reference:
src/mat/impls/baij/mpi/mpibaij.c — row-partitioned BSR with per-rank
diag/offdiag blocks and a block-compressed garray; MatMult overlaps the
scatter with the local product as MPIAIJ does but moves bs-sized value
blocks). The halo plan works at BLOCK granularity: each exchanged unit
is one bs-vector. The host plan's arrays are petsctpu's, byte for
byte; rank p takes row p of each. The products are batched bs×bs
einsums (PyTorch ops, as XLA code in petsctpu).
"""

from __future__ import annotations

import numpy as np
import scipy.sparse as sp
import torch

from petsctpu_torch.core.layout import Layout
from petsctpu_torch.device import resolve_device


class ShardedBAIJ:
    """Per-rank block-ELL pieces: diag_bcols[p] [sb, K1], diag_bvals[p]
    [sb, K1, bs, bs], off_bcols[p] [sb, K2] (padding = gmax, a zero
    block), off_bvals[p], send_idx[p] [P, smax], ghost_src[p] [gmax];
    shape is the padded global scalar shape. rank(comm) gives the
    rank's operator."""

    def __init__(self, diag_bcols, diag_bvals, off_bcols, off_bvals,
                 send_idx, ghost_src, shape, bs: int, nshards: int,
                 nnzb: int = 0):
        self.diag_bcols, self.diag_bvals = diag_bcols, diag_bvals
        self.off_bcols, self.off_bvals = off_bcols, off_bvals
        self.send_idx, self.ghost_src = send_idx, ghost_src
        self.shape = tuple(shape)
        self.bs = bs
        self.nshards = nshards
        self.nnzb = nnzb

    @property
    def nloc_b(self) -> int:
        return self.diag_bcols[0].shape[0]

    @property
    def dtype(self):
        return self.diag_bvals[0].dtype

    def rank(self, comm) -> "RankBAIJ":
        return RankBAIJ(self, comm)

    def flops_per_mult(self) -> float:
        return 2.0 * self.nnzb * self.bs * self.bs


class RankBAIJ:
    def __init__(self, M: ShardedBAIJ, comm):
        p = comm.rank
        self.M, self.comm = M, comm
        self.bs = M.bs
        self.dc, self.dv = M.diag_bcols[p], M.diag_bvals[p]
        self.oc, self.ov = M.off_bcols[p], M.off_bvals[p]
        self.send, self.gsrc = M.send_idx[p], M.ghost_src[p]
        n = M.nloc_b * M.bs
        self.shape = (n, n)
        self.dtype = M.dtype
        self.device = self.dv.device

    def ghosts(self, xb: torch.Tensor) -> torch.Tensor:
        """Remote x BLOCKS for my ghost slots: [gmax + 1, bs], the last
        a zero block."""
        recv = self.comm.all_to_all(xb[self.send])          # [P, smax, bs]
        g = recv.reshape(-1, self.bs)[self.gsrc]
        return torch.cat([g, g.new_zeros((1, self.bs))])

    def mult(self, x: torch.Tensor) -> torch.Tensor:
        xb = x.reshape(-1, self.bs)
        if self.comm.size == 1:
            y = torch.einsum("rkij,rkj->ri", self.dv, xb[self.dc])
            return y.reshape(x.shape)
        g = self.ghosts(xb)                    # collective issued first
        y = torch.einsum("rkij,rkj->ri", self.dv, xb[self.dc])
        y = y + torch.einsum("rkij,rkj->ri", self.ov, g[self.oc])
        return y.reshape(x.shape)

    def diagonal(self) -> torch.Tensor:
        rows = torch.arange(self.dc.shape[0], device=self.device)[:, None]
        own = (self.dc == rows)[..., None, None]
        D = torch.where(own, self.dv, torch.zeros_like(self.dv)).sum(1)
        return torch.diagonal(D, dim1=-2, dim2=-1).reshape(-1)


def baij_plan(A, nshards: int, bs: int, dtype=None) -> dict:
    """petsctpu's stacked host arrays of sharded_baij_from_scipy (block
    rows split contiguously, block-aligned padding): dc, dv, oc, ov,
    send_idx, ghost_src, shape, nnzb."""
    Ab = sp.bsr_matrix(sp.csr_matrix(A), blocksize=(bs, bs))
    nb = Ab.shape[0] // bs
    lay = Layout(nb, nshards)
    P, sb = nshards, lay.shard_size
    dtype = dtype or Ab.data.dtype
    indptr, indices, data = Ab.indptr, Ab.indices, Ab.data

    rows_of = [[[] for _ in range(sb)] for _ in range(P)]
    gsets = [set() for _ in range(P)]
    for br in range(nb):
        p, rl = divmod(br, sb)
        lo, hi = p * sb, (p + 1) * sb
        for k in range(indptr[br], indptr[br + 1]):
            bc = indices[k]
            if lo <= bc < hi:
                rows_of[p][rl].append(("d", bc - lo, data[k]))
            else:
                rows_of[p][rl].append(("o", bc, data[k]))
                gsets[p].add(bc)
    garrays = [np.array(sorted(g), np.int64) for g in gsets]
    gmax = max(1, max(len(g) for g in garrays))

    K1 = max(1, max(sum(1 for e in r if e[0] == "d")
                    for rs in rows_of for r in rs))
    K2 = max(1, max(sum(1 for e in r if e[0] == "o")
                    for rs in rows_of for r in rs))
    dc = np.zeros((P, sb, K1), np.int32)
    dv = np.zeros((P, sb, K1, bs, bs), dtype)
    oc = np.full((P, sb, K2), gmax, np.int32)
    ov = np.zeros((P, sb, K2, bs, bs), dtype)
    for p in range(P):
        gmap = {g: i for i, g in enumerate(garrays[p])}
        for rl in range(sb):
            i1 = i2 = 0
            for kind, c, blk in rows_of[p][rl]:
                if kind == "d":
                    dc[p, rl, i1] = c
                    dv[p, rl, i1] = blk
                    i1 += 1
                else:
                    oc[p, rl, i2] = gmap[c]
                    ov[p, rl, i2] = blk
                    i2 += 1

    # block-level send plan: owner p sends rank q the local blocks that
    # are q's ghosts
    sends = [[[] for _ in range(P)] for _ in range(P)]   # [owner][dest]
    for q in range(P):
        for g in garrays[q]:
            owner = g // sb
            sends[owner][q].append(g - owner * sb)
    smax = max(1, max(len(s) for row in sends for s in row))
    send_idx = np.zeros((P, P, smax), np.int32)
    for p in range(P):
        for q in range(P):
            for j, loc in enumerate(sends[p][q]):
                send_idx[p, q, j] = loc
    ghost_src = np.zeros((P, gmax), np.int32)
    for q in range(P):
        for i, g in enumerate(garrays[q]):
            p = g // sb
            j = sends[p][q].index(g - p * sb)
            ghost_src[q, i] = p * smax + j
    return dict(dc=dc, dv=dv, oc=oc, ov=ov, send_idx=send_idx,
                ghost_src=ghost_src,
                shape=(lay.n_padded * bs, lay.n_padded * bs),
                nnzb=int(Ab.indptr[-1]))


def sharded_baij_from_arrays(dc, dv, oc, ov, send_idx, ghost_src, shape,
                             bs: int, nnzb: int = 0,
                             device=None) -> ShardedBAIJ:
    """A ShardedBAIJ from petsctpu's stacked [P, ...] arrays."""
    dev = resolve_device(device)
    P = dc.shape[0]

    def rows(a, dtype=None):
        return [torch.from_numpy(np.array(a[p])).to(dev, dtype)
                for p in range(P)]

    return ShardedBAIJ(rows(dc, torch.int64), rows(dv), rows(oc, torch.int64),
                       rows(ov), rows(send_idx, torch.int64),
                       rows(ghost_src, torch.int64), shape, bs, P, nnzb)


def sharded_baij_from_scipy(A, nshards: int, bs: int, dtype=None,
                            device=None) -> ShardedBAIJ:
    """Build from a global scipy matrix; block rows are split
    contiguously with block-aligned padding."""
    return sharded_baij_from_arrays(**baij_plan(A, nshards, bs, dtype),
                                    bs=bs, device=device)
