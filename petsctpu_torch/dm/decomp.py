"""DMDA 2-D process-grid decomposition + PETSc global ordering.

Counterpart of petsctpu/dm/decomp.py (host numpy, the port's own copy).

The reference's DMDA is inherently distributed: nodes are partitioned
over an m×n process grid (squarish split, da2.c DMSetUp_DA_2D:
m ≈ √(M·size/N), lx[i] = M/m + (M%m > i)), and the PETSc global
ordering is *rank-major*: each rank's patch is numbered natural-within-
patch (x fastest), ranks ordered pi = rank % m, pj = rank / m
(da2.c:301-332). The application (natural) ordering relates to it
through an AO permutation.

This is the layout a 2-D-block row split wants: the permuted matrix
has contiguous per-rank row ranges whose halo surface is O(patch
perimeter) instead of the O(M) of 1-D strips
(parallel/pmat.py::sharded_aij_from_decomp).

Also emulated here, for golden parity with multi-rank reference runs:
- element ownership for per-rank FEM assembly loops (the ex49.c
  DMDAGetElementCorners rule: a rank assembles elements whose
  lower-left node it owns, minus the global last row/col)
- MatStash fp summation order: duplicate (row, col) contributions sum
  owner-rank-first (chronological), then off-rank senders ascending
  (matstash.c rendezvous drain)
- MatMult_MPIAIJ fp order: per row, diag-block entries (local column
  order) then off-diag entries (ascending global column, the sorted
  garray of mmaij.c:8).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Tuple

import numpy as np
import scipy.sparse as sp


def da_proc_grid(M: int, N: int, size: int) -> Tuple[int, int]:
    """The reference's squarish processor split (da2.c:,'try for
    squarish distribution'): m = round-half-up of √(M·size/N), lowered
    until it divides size; swapped when M > N would leave m < n."""
    m = int(0.5 + np.sqrt(float(M) * size / float(N)))
    if m == 0:
        m = 1
    while m > 0:
        n = size // m
        if m * n == size:
            break
        m -= 1
    if M > N and m < n:
        m, n = n, m
    if m * n != size:
        raise ValueError(f"cannot partition {size} ranks")
    if M < m or N < n:
        raise ValueError("partition too fine")
    return m, n


def da_ownership(M: int, m: int) -> np.ndarray:
    """lx[i] = M/m + (M%m > i) (da2.c)."""
    return (M // m + ((M % m) > np.arange(m))).astype(np.int64)


@dataclass(frozen=True)
class DADecomp2D:
    """A 2-D DMDA decomposition: M×N nodes, dof components per node,
    m×n process grid with per-axis ownership lx/ly."""

    M: int
    N: int
    dof: int
    m: int
    n: int
    lx: np.ndarray
    ly: np.ndarray

    @classmethod
    def create(cls, M: int, N: int, dof: int = 1,
               size: int = 1) -> "DADecomp2D":
        m, n = da_proc_grid(M, N, size)
        return cls(M, N, dof, m, n, da_ownership(M, m),
                   da_ownership(N, n))

    @property
    def size(self) -> int:
        return self.m * self.n

    @property
    def xstarts(self) -> np.ndarray:
        return np.concatenate([[0], np.cumsum(self.lx)])

    @property
    def ystarts(self) -> np.ndarray:
        return np.concatenate([[0], np.cumsum(self.ly)])

    def patch(self, rank: int) -> Tuple[int, int, int, int]:
        """(xs, xm, ys, ym) of a rank's owned node box."""
        pi, pj = rank % self.m, rank // self.m
        return (int(self.xstarts[pi]), int(self.lx[pi]),
                int(self.ystarts[pj]), int(self.ly[pj]))

    def rank_of_node(self, i, j):
        """Owning rank of node (i, j) (vectorized)."""
        pi = np.searchsorted(self.xstarts, np.asarray(i), "right") - 1
        pj = np.searchsorted(self.ystarts, np.asarray(j), "right") - 1
        return pj * self.m + pi

    def natural_to_petsc(self) -> np.ndarray:
        """Permutation p with p[natural_index] = petsc_index over the
        dof-expanded M·N·dof space (the DMDA AO)."""
        M, N, dof = self.M, self.N, self.dof
        jj, ii = np.meshgrid(np.arange(N), np.arange(M), indexing="ij")
        rank = self.rank_of_node(ii, jj)            # [N, M]
        sizes = np.array([self.lx[r % self.m] * self.ly[r // self.m]
                          for r in range(self.size)], np.int64)
        base = np.concatenate([[0], np.cumsum(sizes)])[:-1]
        pi = rank % self.m
        pj = rank // self.m
        xl = ii - self.xstarts[pi]
        yl = jj - self.ystarts[pj]
        local = yl * self.lx[pi] + xl
        node_p = base[rank] + local                  # [N, M] petsc node
        p = (node_p[..., None] * dof
             + np.arange(dof)[None, None, :]).reshape(-1)
        return p.astype(np.int64)

    def petsc_row_ranges(self) -> list:
        """[(start, end)) of each rank's contiguous petsc dof rows."""
        sizes = np.array([self.lx[r % self.m] * self.ly[r // self.m]
                          for r in range(self.size)], np.int64) * self.dof
        ends = np.cumsum(sizes)
        starts = ends - sizes
        return list(zip(starts.tolist(), ends.tolist()))

    def element_owner(self) -> np.ndarray:
        """Assembling rank of each Q1 element, elements numbered
        ej·(M−1)+ei. ex49.c DMDAGetElementCorners: rank (pi,pj) owns
        elements ei ∈ [xs, xs+xm) clipped to M−1 (same in y) — i.e.
        the owner of the element's lower-left node assembles it."""
        Mel, Nel = self.M - 1, self.N - 1
        ei = np.tile(np.arange(Mel), Nel)
        ej = np.repeat(np.arange(Nel), Mel)
        return np.asarray(self.rank_of_node(ei, ej), np.int64)

    def element_order(self) -> np.ndarray:
        """Chronological assembly sequence number of each element
        within its assembling rank (ej outer, ei inner — the reference
        element loops, ex49.c:673)."""
        own = self.element_owner()
        Mel = self.M - 1
        ei = np.arange(own.size) % Mel
        ej = np.arange(own.size) // Mel
        seq = np.zeros(own.size, np.int64)
        for r in range(self.size):
            mask = own == r
            # already in ej-outer / ei-inner order for a fixed rank box
            order = np.lexsort((ei[mask], ej[mask]))
            s = np.empty(mask.sum(), np.int64)
            s[order] = np.arange(mask.sum())
            seq[mask] = s
        return seq


def coo_sum_parallel(rows, cols, vals, contrib_rank, contrib_seq,
                     row_owner, n) -> sp.csr_matrix:
    """CSR with duplicates summed in the reference's PARALLEL assembly
    order: for each (row, col), first the row-owner rank's own
    contributions in chronological order (direct MatSetValues_SeqAIJ
    `ap += v` adds), then off-owner contributions grouped by sender
    rank ascending (the MatStash drain, matstash.c:601), chronological
    within each sender."""
    rows = np.asarray(rows)
    cols = np.asarray(cols)
    vals = np.asarray(vals)
    contrib_rank = np.asarray(contrib_rank)
    contrib_seq = np.asarray(contrib_seq)
    owner = np.asarray(row_owner)[rows]
    phase = (contrib_rank != owner).astype(np.int64)
    order = np.lexsort((contrib_seq, contrib_rank, phase, cols, rows))
    r, c, v = rows[order], cols[order], vals[order]
    new = np.ones(len(r), bool)
    new[1:] = (r[1:] != r[:-1]) | (c[1:] != c[:-1])
    gid = np.cumsum(new) - 1
    sums = np.zeros(int(gid[-1]) + 1)
    np.add.at(sums, gid, v)           # unbuffered, strictly sequential
    starts = np.flatnonzero(new)
    return sp.csr_matrix((sums, (r[starts], c[starts])), shape=(n, n))


def mpiaij_matmult(A: sp.csr_matrix, x: np.ndarray,
                   row_owner: np.ndarray,
                   col_owner: np.ndarray = None) -> np.ndarray:
    """y = A·x with the fp accumulation order of MatMult_MPIAIJ
    (mpiaij.c:1102): per row, first the diag-block entries (columns
    owned by the row's rank, in column order), then the off-diag
    entries (ascending column — the sorted garray)."""
    A = sp.csr_matrix(A)
    A.sort_indices()
    row_owner = np.asarray(row_owner)
    col_owner = row_owner if col_owner is None else np.asarray(col_owner)
    y = np.zeros(A.shape[0], dtype=np.result_type(A.dtype, x.dtype))
    ai, aj, av = A.indptr, A.indices, A.data
    for i in range(A.shape[0]):
        j = aj[ai[i]:ai[i + 1]]
        v = av[ai[i]:ai[i + 1]]
        local = col_owner[j] == row_owner[i]
        s = 0.0
        for vv in v[local] * x[j[local]]:
            s += vv
        for vv in v[~local] * x[j[~local]]:
            s += vv
        y[i] = s
    return y
