"""Two-level (dcn, ici) halo plans: the hierarchical MPIAIJ of a two-axis
World.

Counterpart of petsctpu/parallel/hier.py (reference: flat MPI VecScatter,
vpscat.c; the hierarchical shape is PCHMPI / GAMG proc agglomeration,
SURVEY §5.7). The World's ranks form an (H, C) mesh, rank p = h·C + c
(`World(H*C, device, mesh=(H, C))`); a ghost travels from its owner
(h_o, c_o) to its requester (h_r, c_r) in two phases:

  phase 1 (ici): the owner sends it to the gateway (h_o, c_r), one
     all_to_all over the owner's row (buckets keyed by destination c);
  phase 2 (dcn): the gateway forwards it to (h_r, c_r), one
     all_to_all over the column (only same-c ranks talk across rows).

Ghosts within a row end after phase 1. The transposed product runs the
two all_to_alls backward, each scatter-add a fold (mat/fold.py) in
petsctpu's slot order. The plan is host numpy, byte for byte
petsctpu's; it reuses plan.partition_csr for the diag/off/garray split,
and the rank's diagonal-block product is the ELL kernel, as ShardedAIJ's.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import scipy.sparse as sp
import torch

from petsctpu_torch.device import np_dtype, resolve_device
from petsctpu_torch.parallel.plan import ell_pack, partition_csr
from petsctpu_torch.parallel.pmat import RankAIJ, ShardedAIJ, _t, \
    real_slots, stacked_ell


@dataclass
class HierHaloPlan:
    """Stacked (leading axis = rank, p = h·C + c) two-level plan."""

    send1_idx: np.ndarray   # int32 [P, C, s1max] local x idx -> dest chip
    send2_src: np.ndarray   # int32 [P, H, s2max] recv1-flat idx -> dest host
    ghost_src: np.ndarray   # int32 [P, gmax] into concat(recv1, recv2)
    n_ghost: np.ndarray     # int64 [P]
    s1max: int
    s2max: int
    gmax: int


def build_hier_halo(lay, garrays, H: int, C: int) -> HierHaloPlan:
    """The two-phase route of every rank's ghosts (petsctpu's
    build_hier_halo, the same arrays)."""
    P = H * C
    s = lay.shard_size
    send1 = [[[] for _ in range(C)] for _ in range(P)]
    send2 = [[[] for _ in range(H)] for _ in range(P)]
    notes = []                     # per rank: one routing note a ghost
    for p_r in range(P):
        h_r, c_r = divmod(p_r, C)
        rows = []
        for g in garrays[p_r]:
            q = int(g) // s
            h_o, c_o = divmod(q, C)
            lidx = int(g) - q * s
            pos1 = len(send1[q][c_r])
            send1[q][c_r].append(lidx)
            if h_o == h_r:
                rows.append(("intra", c_o, pos1))
            else:
                gw = h_o * C + c_r
                pos2 = len(send2[gw][h_r])
                send2[gw][h_r].append((c_o, pos1))
                rows.append(("inter", h_o, pos2))
        notes.append(rows)

    s1max = max((len(b) for sh in send1 for b in sh), default=1) or 1
    s2max = max((len(b) for sh in send2 for b in sh), default=1) or 1
    gmax = max((len(g) for g in garrays), default=1) or 1

    send1_idx = np.zeros((P, C, s1max), np.int32)
    send2_src = np.zeros((P, H, s2max), np.int32)
    ghost_src = np.zeros((P, gmax), np.int32)
    n_ghost = np.zeros(P, np.int64)
    for p in range(P):
        for c in range(C):
            b = send1[p][c]
            send1_idx[p, c, :len(b)] = b
        for h in range(H):
            for j, (c_o, pos1) in enumerate(send2[p][h]):
                send2_src[p, h, j] = c_o * s1max + pos1
        n_ghost[p] = len(notes[p])
        for k, note in enumerate(notes[p]):
            if note[0] == "intra":
                _, c_o, pos1 = note
                ghost_src[p, k] = c_o * s1max + pos1
            else:
                _, h_o, pos2 = note
                ghost_src[p, k] = C * s1max + h_o * s2max + pos2
    return HierHaloPlan(send1_idx, send2_src, ghost_src, n_ghost,
                        s1max, s2max, gmax)


class ShardedAIJHier(ShardedAIJ):
    """Row-partitioned ELL operator with the two-level halo: ShardedAIJ's
    diag/off blocks and local products, the exchange over the mesh's
    ici and dcn Comms. rank(comm) takes a rank's Comm of a two-axis World
    (comm.axes); its reductions are the flat Comm's (both axes)."""

    def __init__(self, diag_cols, diag_vals, off_cols, off_vals, send1_idx,
                 send2_src, ghost_src, shape, H: int, C: int, nnz: int = 0,
                 diag_ops=None):
        super().__init__(diag_cols, diag_vals, off_cols, off_vals, None,
                         ghost_src, None, shape, H * C, "hier", nnz, (),
                         diag_ops, "ell")
        self.send1_idx, self.send2_src = send1_idx, send2_src
        self.H, self.C = H, C

    def rank(self, comm) -> "RankAIJHier":
        assert comm.size == self.nshards, (comm.size, self.nshards)
        if "ici" not in comm.axes:
            raise ValueError("ShardedAIJHier needs a rank of a two-axis "
                             "World (World(P, device, mesh=(H, C)))")
        return RankAIJHier(self, comm)


class RankAIJHier(RankAIJ):
    """One rank's view of a ShardedAIJHier, bound to its Comms."""

    def __init__(self, M: ShardedAIJHier, comm):
        super().__init__(M, comm)
        self.ici, self.dcn = comm.axes["ici"], comm.axes["dcn"]

    def _bufs(self, x: torch.Tensor):
        M, p = self.M, self.p
        recv1 = self.ici.all_to_all(x[M.send1_idx[p]])      # [C, s1max]
        r1 = recv1.reshape(-1)
        recv2 = self.dcn.all_to_all(r1[M.send2_src[p]])     # [H, s2max]
        return r1, recv2.reshape(-1)

    def ghosts(self, x: torch.Tensor) -> torch.Tensor:
        """[gmax + 1]: my ghost values after both phases, then the zero
        sentinel of the off block's padding column."""
        r1, r2 = self._bufs(x)
        g = torch.cat([r1, r2])[self.M.ghost_src[self.p]]
        return torch.cat([g, g.new_zeros(1)])

    def multT(self, x: torch.Tensor) -> torch.Tensor:
        """Scatter-reverse: both all_to_alls run backward with adds, each
        a fold in petsctpu's slot order."""
        M, p = self.M, self.p
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
        send1, send2 = M.send1_idx[p], M.send2_src[p]
        C, s1max = send1.shape
        H, s2max = send2.shape
        buf = self._fold("g", gsrc, real_slots).fold(
            torch.zeros(C * s1max + H * s2max, dtype=dt, device=dev), gbuf)
        back2 = self.dcn.all_to_all(buf[C * s1max:].reshape(H, s2max))
        buf1 = self._fold("2", send2, real_slots).fold(
            buf[:C * s1max], back2.reshape(-1))
        back1 = self.ici.all_to_all(buf1.reshape(C, s1max))
        # a row of send1 serves every row of the mesh, so a local index
        # can repeat in it: no real_slots mask here
        return self._fold("1", send1).fold(y, back1.reshape(-1))


def sharded_aij_hier_from_scipy(A, H: int, C: int, dtype=None,
                                device=None) -> tuple:
    """Partition a scipy matrix over an (H x C) mesh of ranks:
    (ShardedAIJHier, PartitionedCSR). The PartitionedCSR carries the flat
    path's diag/off/garray split, so the per-rank PC setups (bjacobi,
    ILU, ...) take it unchanged."""
    from petsctpu_torch.convert import aij_from_arrays

    dev = resolve_device(device)
    P = H * C
    part = partition_csr(A, P)
    lay = part.layout
    plan = build_hier_halo(lay, part.garrays, H, C)
    dt = np_dtype(dtype) or sp.csr_matrix(A).dtype
    s = lay.shard_size
    dc, dv, oc, ov = stacked_ell(part.diag_blocks, part.off_blocks,
                                 plan.gmax, s, dt)
    for p in range(P):              # petsctpu pads the off block with gmax
        oc[p] = ell_pack(part.off_blocks[p], oc.shape[2],
                         pad_col=plan.gmax)[0]
    ops = [aij_from_arrays(dc[p], dv[p], (s, s), int(np.count_nonzero(dv[p])),
                           device=dev) for p in range(P)]
    M = ShardedAIJHier(
        [_t(dc[p], dev, torch.int64) for p in range(P)],
        [_t(dv[p], dev) for p in range(P)],
        [_t(oc[p], dev, torch.int64) for p in range(P)],
        [_t(ov[p], dev) for p in range(P)],
        [_t(plan.send1_idx[p], dev, torch.int64) for p in range(P)],
        [_t(plan.send2_src[p], dev, torch.int64) for p in range(P)],
        [_t(plan.ghost_src[p], dev, torch.int64) for p in range(P)],
        (s * P, s * P), H, C, nnz=int(sp_nnz(A)), diag_ops=ops)
    M.plan = plan
    return M, part


def sp_nnz(A) -> int:
    return sp.csr_matrix(A).nnz
