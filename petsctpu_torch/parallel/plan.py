"""Host-side communication planning: partition + ghost discovery.

The replacement for the reference's VecScatterCreate
analysis (src/vec/vec/utils/vscat.c:920) and MatSetUpMultiply_MPIAIJ
garray/lvec construction (src/mat/impls/aij/mpi/mmaij.c:8): given a
global sparse matrix and a row Layout, compute per-shard

  * the diagonal block (columns owned locally, local indices),
  * the off-diagonal block (columns owned remotely, compressed to
    ghost slots — the garray),
  * a halo-exchange plan: which local entries each shard sends to
    each other shard, and where received values land in the ghost
    buffer.

All plan arrays are padded to uniform shapes across ranks and stacked
with a leading rank axis, byte for byte as petsctpu's
(petsctpu/parallel/plan.py); rank p's operator takes row p of each.
Plan-time is host numpy; run-time is the Comm's collectives.
"""

from __future__ import annotations

import time
from dataclasses import dataclass

import numpy as np
import scipy.sparse as sp

from petsctpu_torch.core.layout import Layout


@dataclass
class HaloPlan:
    """Stacked (leading axis = shard) halo-exchange plan arrays."""

    send_idx: np.ndarray    # int32 [P, P, smax] local indices sent to rank d
    ghost_src: np.ndarray   # int32 [P, gmax] slot in flattened recv [P*smax]
    ghost_gidx: np.ndarray  # int32 [P, gmax] global index of each ghost
                            # (the allgather style)
    n_ghost: np.ndarray     # int64 [P] true ghost counts
    smax: int
    gmax: int
    # distinct sender->receiver ring offsets with traffic ((p-d) mod P):
    # a banded row partition has only {1, P-1}; the "ppermute" halo
    # style unrolls one shift per offset, making the per-shard payload
    # O(neighbors), not O(P) like the dense all_to_all layout
    offsets: tuple = ()


@dataclass
class PartitionedCSR:
    """Per-shard pieces of a row-partitioned matrix (host numpy)."""

    layout: Layout
    diag_blocks: list       # scipy CSR [nloc, nloc] a rank (pad rows = I)
    off_blocks: list        # scipy CSR [nloc, ngh_s] per shard (ghost cols)
    garrays: list           # global col index per ghost slot, per shard
    halo: HaloPlan
    perm: object = None     # row/col permutation applied pre-split (or None)
    timings: dict = None    # host seconds by setup part


def partition_csr(A, nshards: int) -> PartitionedCSR:
    """Split a global scipy matrix into diag/offdiag shards + halo plan."""
    t0 = time.perf_counter()
    A = sp.csr_matrix(A)
    n = A.shape[0]
    lay = Layout(n, nshards)
    s = lay.shard_size

    diag_blocks, off_blocks, garrays = [], [], []
    for p in range(nshards):
        r0, r1 = p * s, min((p + 1) * s, n)
        c0, c1 = p * s, min((p + 1) * s, n)
        if r0 >= n:
            rows = sp.csr_matrix((0, A.shape[1]))
        else:
            rows = A[r0:r1]
        nreal = rows.shape[0]
        # diagonal block: columns in [c0, c1)
        mask_d = (rows.indices >= c0) & (rows.indices < c1)
        coo = rows.tocoo()
        md = (coo.col >= c0) & (coo.col < c1)
        dd, dr, dc = coo.data[md], coo.row[md], coo.col[md] - c0
        # pad rows get identity so local factorizations stay
        # nonsingular (concatenated into the COO — csr ADDITION would
        # prune the pattern's explicit zeros)
        if nreal < s:
            pad_rows = np.arange(nreal, s)
            dd = np.concatenate([dd, np.ones(len(pad_rows), dd.dtype)])
            dr = np.concatenate([dr, pad_rows])
            dc = np.concatenate([dc, pad_rows])
        D = sp.coo_matrix((dd, (dr, dc)), shape=(s, s)).tocsr()
        # off-diagonal: remote columns compressed via garray
        mo = ~md
        gcols = coo.col[mo]
        garray, inv = np.unique(gcols, return_inverse=True)
        O = sp.coo_matrix((coo.data[mo], (coo.row[mo], inv)),
                          shape=(s, max(len(garray), 1))).tocsr()
        diag_blocks.append(D)
        off_blocks.append(O)
        garrays.append(garray.astype(np.int64))

    t_halo = time.perf_counter()
    halo = _build_halo(lay, garrays, nshards)
    t_end = time.perf_counter()
    return PartitionedCSR(lay, diag_blocks, off_blocks, garrays, halo,
                          timings={"split": t_halo - t0,
                                   "halo plan": t_end - t_halo})


def _build_halo(lay: Layout, garrays, P: int) -> HaloPlan:
    s = lay.shard_size
    # per (recv shard p, owner shard d): which ghosts come from d
    send_lists = [[[] for _ in range(P)] for _ in range(P)]  # [src][dst]
    recv_slot = []  # per shard: (owner, position-in-that-send) per ghost
    for p in range(P):
        owners = garrays[p] // s
        pos_in_owner = {}
        slots = np.zeros((len(garrays[p]), 2), dtype=np.int64)
        for k, (g, d) in enumerate(zip(garrays[p], owners)):
            lidx = g - d * s
            send_lists[d][p].append(lidx)
            slots[k] = (d, len(send_lists[d][p]) - 1)
        recv_slot.append(slots)

    smax = max((len(send_lists[d][p]) for d in range(P) for p in range(P)),
               default=1) or 1
    gmax = max((len(g) for g in garrays), default=1) or 1

    send_idx = np.zeros((P, P, smax), dtype=np.int32)
    for d in range(P):
        for p in range(P):
            li = send_lists[d][p]
            send_idx[d, p, :len(li)] = li

    # after all_to_all: recv[src, k] on shard p = value send by shard src at
    # slot (p, k) → ghost j of shard p lives at flattened (owner*smax + pos)
    ghost_src = np.zeros((P, gmax), dtype=np.int32)
    ghost_gidx = np.zeros((P, gmax), dtype=np.int32)
    n_ghost = np.zeros(P, dtype=np.int64)
    for p in range(P):
        sl = recv_slot[p]
        n_ghost[p] = len(garrays[p])
        if len(sl):
            ghost_src[p, :len(sl)] = sl[:, 0] * smax + sl[:, 1]
            ghost_gidx[p, :len(garrays[p])] = garrays[p]
    offsets = tuple(sorted({(dst - src) % P
                            for src in range(P) for dst in range(P)
                            if src != dst and send_lists[src][dst]}))
    return HaloPlan(send_idx, ghost_src, ghost_gidx, n_ghost, smax, gmax,
                    offsets)


def ell_pack(M: sp.csr_matrix, K: int, pad_col: int = 0):
    """Pack a scipy CSR into ELL arrays with fixed width K."""
    M = sp.csr_matrix(M)
    M.sort_indices()
    m = M.shape[0]
    row_nnz = np.diff(M.indptr)
    cols = np.full((m, K), pad_col, dtype=np.int32)
    vals = np.zeros((m, K), dtype=M.dtype)
    slot = np.arange(M.nnz) - np.repeat(M.indptr[:-1], row_nnz)
    rr = np.repeat(np.arange(m), row_nnz)
    cols[rr, slot] = M.indices
    vals[rr, slot] = M.data
    return cols, vals


def partition_rect_csr(A, nshards: int):
    """Row-partition a RECTANGULAR matrix (e.g. a GAMG prolongator
    P: coarse → fine) with the column space partitioned by its own
    Layout: per shard a diag block (my coarse columns) + off block
    (ghost coarse columns, garray-compressed) + the same halo plan
    machinery as square MPIAIJ (mmaij.c garray/lvec for a non-square
    operator — the reference stores P as an ordinary MPIAIJ).

    Pad rows are ZERO (a prolongator's pad fine rows must stay 0, not
    identity). Returns (row_layout, col_layout, diag_blocks,
    off_blocks, garrays, halo)."""
    A = sp.csr_matrix(A)
    nr, nc = A.shape
    rlay = Layout(nr, nshards)
    clay = Layout(nc, nshards)
    sr, sc = rlay.shard_size, clay.shard_size

    diag_blocks, off_blocks, garrays = [], [], []
    for p in range(nshards):
        r0, r1 = p * sr, min((p + 1) * sr, nr)
        c0, c1 = p * sc, min((p + 1) * sc, nc)
        rows = (A[r0:r1] if r0 < nr
                else sp.csr_matrix((0, nc)))
        coo = rows.tocoo()
        md = (coo.col >= c0) & (coo.col < c1)
        D = sp.coo_matrix((coo.data[md], (coo.row[md], coo.col[md] - c0)),
                          shape=(sr, sc)).tocsr()
        mo = ~md
        garray, inv = np.unique(coo.col[mo], return_inverse=True)
        O = sp.coo_matrix((coo.data[mo], (coo.row[mo], inv)),
                          shape=(sr, max(len(garray), 1))).tocsr()
        diag_blocks.append(D)
        off_blocks.append(O)
        garrays.append(garray.astype(np.int64))

    halo = _build_halo(clay, garrays, nshards)
    return rlay, clay, diag_blocks, off_blocks, garrays, halo
