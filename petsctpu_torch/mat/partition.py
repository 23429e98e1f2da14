"""MatPartitioning — graph partitioning for load balance.

Counterpart of petsctpu/mat/partition.py (reference: src/mat/partition,
the MatPartitioning interface partition.c with its ParMetis/Chaco/
Party/Scotch wrappers; MPIAdj adjacency input src/mat/impls/adj). Three
plan-time methods, host numpy, each returning a part id a vertex as
MatPartitioningApply returns its IS:

  * "kway" — multilevel k-way (the ParMetis analog, pmetis.c): the
             port's copy of petsctpu's C++ (csrc/host_graph.cpp,
             bound by mat/host_graph.py), so the partitions are equal
             for the same seed; a missing g++ raises.
  * "rcm"  — contiguous chunks of the reverse Cuthill-McKee order.
  * "rcb"  — recursive coordinate bisection of vertex coordinates.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import numpy as np
import scipy.sparse as sp


def partition_rcm(adj, nparts: int) -> np.ndarray:
    """Contiguous split of the RCM ordering (equal-size parts)."""
    A = sp.csr_matrix(adj)
    n = A.shape[0]
    from scipy.sparse.csgraph import reverse_cuthill_mckee
    order = reverse_cuthill_mckee(A, symmetric_mode=True)
    part = np.empty(n, np.int32)
    bounds = np.linspace(0, n, nparts + 1).astype(int)
    for p in range(nparts):
        part[order[bounds[p]:bounds[p + 1]]] = p
    return part


def partition_rcb(coords: np.ndarray, nparts: int) -> np.ndarray:
    """Recursive coordinate bisection (nparts should be a power of 2;
    other counts give uneven final splits)."""
    coords = np.asarray(coords, float)
    n = coords.shape[0]
    part = np.zeros(n, np.int32)

    def rec(idx, k, base):
        if k == 1:
            part[idx] = base
            return
        spread = coords[idx].max(axis=0) - coords[idx].min(axis=0)
        ax = int(np.argmax(spread))
        order = idx[np.argsort(coords[idx, ax], kind="stable")]
        k_lo = k // 2
        cut = (len(order) * k_lo) // k
        rec(order[:cut], k_lo, base)
        rec(order[cut:], k - k_lo, base + k_lo)

    rec(np.arange(n), nparts, 0)
    return part


def partition_kway(adj, nparts: int, seed: int = 1) -> np.ndarray:
    """Multilevel k-way partition of the symmetrized pattern of adj."""
    from petsctpu_torch.mat.host_graph import kway_partition
    A = sp.csr_matrix(adj)
    P = (A != 0).astype(np.int64)             # symmetrized PATTERN —
    A = ((P + P.T) != 0).astype(np.int64)     # entry signs are values,
    A.setdiag(0)                              # not graph structure
    A.eliminate_zeros()
    return kway_partition(A.indptr, A.indices, nparts, seed=seed)[0]


def edge_cut(adj, part: np.ndarray) -> int:
    A = sp.coo_matrix(sp.csr_matrix(adj))
    mask = (A.row < A.col) & (part[A.row] != part[A.col])
    return int(np.count_nonzero(mask))


@dataclass
class MatPartitioning:
    """Interface object (MatPartitioningCreate/SetAdjacency/Apply)."""

    adjacency: Optional[object] = None       # scipy graph (MPIAdj analog)
    coordinates: Optional[np.ndarray] = None
    nparts: int = 2
    ptype: str = "rcm"                       # kway | rcm | rcb

    def set_adjacency(self, adj):
        self.adjacency = adj
        return self

    def set_coordinates(self, coords):
        self.coordinates = coords
        return self

    def set_n_parts(self, n: int):
        self.nparts = n
        return self

    def set_type(self, t: str):
        self.ptype = t
        return self

    def apply(self) -> np.ndarray:
        if self.ptype == "rcb":
            if self.coordinates is None:
                raise ValueError("rcb partitioning needs coordinates")
            return partition_rcb(self.coordinates, self.nparts)
        if self.adjacency is None:
            raise ValueError("partitioning needs an adjacency graph")
        if self.ptype == "kway":
            return partition_kway(self.adjacency, self.nparts)
        return partition_rcm(self.adjacency, self.nparts)

    def counts(self, part: np.ndarray) -> np.ndarray:
        return np.bincount(part, minlength=self.nparts)
