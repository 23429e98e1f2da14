"""Inode detection (the part of petsctpu/mat/coloring.py on the SOR path).

Reference: Mat_CheckInode (src/mat/impls/aij/seq/inode.c) and the
compressed supernode pattern of MatGetRowIJ_SeqAIJ_Inode, which
MatSOR_SeqAIJ_Inode's block sweep (pc/sor.py::make_inode_sor) is built
on. The colorings themselves are ROADMAP queue 1 item 11.
"""

from __future__ import annotations

import numpy as np
import scipy.sparse as sp


def inode_groups(A, limit: int = 5):
    """Mat_CheckInode: consecutive rows with identical column lists in
    groups of at most `limit`. Returns the int64 group sizes (sum =
    nrows), or None when every group has size 1. petsctpu's greedy row
    walk, vectorized: runs of equal consecutive rows cut into pieces of
    `limit`."""
    A = sp.csr_matrix(A)
    A.sort_indices()
    n = A.shape[0]
    if n == 0:
        return None
    lens = np.diff(A.indptr)
    same = np.zeros(n, bool)                 # row i equals row i - 1
    cand = np.flatnonzero(lens[1:] == lens[:-1]) + 1
    if cand.size:
        # compare candidate rows entry by entry: an entry differs where
        # its column differs from the previous row's column at its slot
        ln = lens[cand]
        row = np.repeat(cand, ln)
        k = np.arange(row.size) - np.repeat(np.cumsum(ln) - ln, ln)
        diff = A.indices[A.indptr[row] + k] != A.indices[A.indptr[row - 1] + k]
        bad = np.zeros(n, bool)
        bad[row[diff]] = True
        same[cand] = ~bad[cand]
    if not same.any():
        return None
    run_start = np.flatnonzero(~same)
    run_len = np.diff(np.append(run_start, n))
    pieces = -(-run_len // limit)
    run = np.repeat(np.arange(run_len.size), pieces)
    j = np.arange(run.size) - np.repeat(np.cumsum(pieces) - pieces, pieces)
    ns = np.minimum(limit, run_len[run] - j * limit).astype(np.int64)
    if len(ns) == n:
        return None
    return ns


def inode_compress_pattern(A, ns) -> sp.csr_matrix:
    """The supernode pattern (MatGetRowIJ_SeqAIJ_Inode): rows and
    columns mapped to inode ids, deduplicated, values 1."""
    A = sp.csr_matrix(A)
    m = len(ns)
    row2node = np.repeat(np.arange(m), ns)
    coo = A.tocoo()
    C = sp.coo_matrix((np.ones(coo.nnz), (row2node[coo.row],
                                          row2node[coo.col])),
                      shape=(m, m)).tocsr()
    C.sum_duplicates()
    C.data[:] = 1.0
    return C
