"""Matrix coloring: inode detection, greedy, MINPACK and stencil
colorings (the counterpart of petsctpu/mat/coloring.py).

Reference: Mat_CheckInode (src/mat/impls/aij/seq/inode.c) and the
compressed supernode pattern of MatGetRowIJ_SeqAIJ_Inode, which
MatSOR_SeqAIJ_Inode's block sweep (pc/sor.py::make_inode_sor) is built
on; the greedy distance-2 coloring of MatColoring (src/mat/color), which
the GAMG probe refresh (pc/gamg_device.py::gamg_probe_plan) colors its
product patterns with. greedy_color here is the plain Python loop; the
setup path runs its native copy, mat/host_graph.py::greedy_color. The
MINPACK DSM orderings (the reference's -mat_coloring_type sl|lf|id),
their inode-compressed pipeline and the closed-form stencil coloring
came with SNES: they color the FD Jacobians of snes/fdjac.py.
"""

from __future__ import annotations

import numpy as np
import scipy.sparse as sp


def greedy_color(A) -> np.ndarray:
    """Color columns so no two columns sharing a row get one color.

    Returns int32 color[ncols]; ncolors = color.max()+1. Equivalent to
    greedy coloring of the graph of AᵀA (distance-2 in the bipartite
    row-col graph)."""
    A = sp.csc_matrix(A)
    n = A.shape[1]
    Acsr = A.tocsr()
    color = np.full(n, -1, dtype=np.int32)
    # column j conflicts with all columns appearing in rows of column j
    for j in range(n):
        rows = A.indices[A.indptr[j]:A.indptr[j + 1]]
        used = set()
        for r in rows:
            cols = Acsr.indices[Acsr.indptr[r]:Acsr.indptr[r + 1]]
            for c in cols:
                if color[c] >= 0:
                    used.add(color[c])
        c = 0
        while c in used:
            c += 1
        color[j] = c
    return color


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


def stencil_coloring(grid, offsets) -> np.ndarray:
    """Closed-form distance-2 coloring for stencil patterns: color =
    position modulo the stencil bounding box (what fdda.c exploits for
    DMDA matrices — O(stencil volume) colors independent of n)."""
    grid = tuple(grid)
    widths = []
    nd = len(grid)
    for k in range(nd):
        w = 2 * max(abs(o[k]) for o in offsets) + 1
        widths.append(w)
    idx = np.indices(grid)        # [nd, *grid]
    color = np.zeros(grid, dtype=np.int32)
    mult = 1
    for k in range(nd - 1, -1, -1):
        color += (idx[k] % widths[k]) * mult
        mult *= widths[k]
    return color.reshape(-1)


# ---------------------------------------------------------------------------
# MINPACK DSM colorings (the reference's SL/LF/ID MatColoringTypes)
# ---------------------------------------------------------------------------
# Behavior-exact ports of the reference's f2c'd MINPACK kernels
# (src/mat/color/{degr,slo,ido,numsrt,seq}.c — Coleman/Garbow/Moré
# DSM): same orderings including every tie-break (bucket LIFO linked
# lists, largest-first descending-index ties, ido's bounded maximal-
# degree search), so FD-Jacobian color COUNTS and group assignments
# match the reference's `-mat_coloring_type sl|lf|id` digit streams.

def _col_adjacency(A):
    """(jpntr, indrow, ipntr, indcol): CSC and CSR index pairs of the
    pattern (MatGetColumnIJ / MatGetRowIJ, symmetric=FALSE)."""
    C = sp.csc_matrix(A)
    R = sp.csr_matrix(A)
    C.sort_indices()
    R.sort_indices()
    return C.indptr, C.indices, R.indptr, R.indices


def _minpack_degr(n, jpntr, indrow, ipntr, indcol):
    """Distance-2 column degrees (degr.c)."""
    ndeg = np.zeros(n, np.int64)
    mark = np.full(n, -1, np.int64)
    for jcol in range(1, n):
        mark[jcol] = n
        for r in indrow[jpntr[jcol]:jpntr[jcol + 1]]:
            for ic in indcol[ipntr[r]:ipntr[r + 1]]:
                if mark[ic] < jcol:
                    mark[ic] = jcol
                    ndeg[ic] += 1
                    ndeg[jcol] += 1
    return ndeg


def _minpack_seq(n, jpntr, indrow, ipntr, indcol, order):
    """Sequential greedy coloring in `order` (seq.c). Returns
    (ngrp 0-based colors, maxgrp)."""
    ngrp = np.full(n, n, np.int64)          # sentinel "uncolored"
    mark = np.full(n + 1, -1, np.int64)     # mark[g] = j when g seen
    maxgrp = 0
    for j, jcol in enumerate(order):
        for r in indrow[jpntr[jcol]:jpntr[jcol + 1]]:
            for ic in indcol[ipntr[r]:ipntr[r + 1]]:
                mark[ngrp[ic]] = j
        g = 0
        while g < maxgrp and mark[g] == j:
            g += 1
        if g == maxgrp:
            maxgrp += 1
        ngrp[jcol] = g
    return ngrp.astype(np.int32), maxgrp


def _minpack_numsrt_desc(num, nmax):
    """numsrt.c mode=-1: order indices by value descending; within a
    value, DESCENDING index (bucket LIFO)."""
    last = np.full(nmax + 1, -1, np.int64)
    nxt = np.full(len(num), -1, np.int64)
    for k, v in enumerate(num):
        nxt[k] = last[v]
        last[v] = k
    out = []
    for v in range(nmax, -1, -1):
        k = last[v]
        while k >= 0:
            out.append(k)
            k = nxt[k]
    return np.asarray(out, np.int64)


class _DegList:
    """The MINPACK doubly-linked bucket lists (iwa1/iwa2/iwa3)."""

    def __init__(self, nbuckets, n):
        self.head = np.full(nbuckets, -1, np.int64)
        self.prev = np.full(n, -1, np.int64)
        self.nxt = np.full(n, -1, np.int64)

    def push(self, b, ic):
        self.prev[ic] = -1
        self.nxt[ic] = self.head[b]
        if self.head[b] >= 0:
            self.prev[self.head[b]] = ic
        self.head[b] = ic

    def remove(self, b, ic):
        if self.prev[ic] < 0:
            self.head[b] = self.nxt[ic]
        else:
            self.nxt[self.prev[ic]] = self.nxt[ic]
        if self.nxt[ic] >= 0:
            self.prev[self.nxt[ic]] = self.prev[ic]


def _minpack_slo(n, jpntr, indrow, ipntr, indcol, ndeg):
    """Smallest-last ordering (slo.c). Returns the column order."""
    deg = ndeg.copy()
    lists = _DegList(n + 1, n)
    for jp in range(n):                     # push in INDEX order
        lists.push(deg[jp], jp)
    mindeg = int(deg.min()) if n else 0
    pos = np.zeros(n, np.int64)             # smallest-last position
    tag = np.full(n, n, np.int64)           # iwa4
    numord = n
    while True:
        while lists.head[mindeg] < 0:
            mindeg += 1
        jcol = lists.head[mindeg]
        pos[jcol] = numord - 1
        numord -= 1
        if numord == 0:
            break
        lists.remove(mindeg, jcol)
        tag[jcol] = 0
        for r in indrow[jpntr[jcol]:jpntr[jcol + 1]]:
            for ic in indcol[ipntr[r]:ipntr[r + 1]]:
                if tag[ic] > numord:
                    tag[ic] = numord
                    d = deg[ic]
                    lists.remove(d, ic)
                    deg[ic] = d - 1
                    mindeg = min(mindeg, d - 1)
                    lists.push(d - 1, ic)
    order = np.empty(n, np.int64)
    order[pos] = np.arange(n)
    return order


def _minpack_ido(n, m, jpntr, indrow, ipntr, indcol, ndeg):
    """Incidence-degree ordering (ido.c). Returns the column order."""
    by_deg = _minpack_numsrt_desc(ndeg, max(n - 1, 0))
    lists = _DegList(n + 1, n)
    # initial incidence-0 list: columns pushed in ASCENDING degree
    # (the reference walks the sorted array backwards), so the list
    # head ends at the max-degree column
    for jp in range(n - 1, -1, -1):
        lists.push(0, by_deg[jp])
    inc = np.zeros(n, np.int64)             # incidence of unordered cols
    # maximal search length (ido.c maxlst)
    rl = np.diff(ipntr)
    maxlst = int((rl.astype(np.int64) ** 2).sum() // max(n, 1))
    tag = np.full(n, -1, np.int64)          # iwa4 (ordered marker)
    pos = np.zeros(n, np.int64)
    maxinc = 0
    numord = 0
    ncomp = 0
    while True:
        while lists.head[maxinc] < 0:
            maxinc -= 1
        # column of maximal DEGREE among (up to maxlst) columns of
        # maximal incidence
        jp = lists.head[maxinc]
        numwgt = -1
        jcol = jp
        for _ in range(max(maxlst, 1)):
            if ndeg[jp] > numwgt:
                numwgt = ndeg[jp]
                jcol = jp
            jp = lists.nxt[jp]
            if jp < 0:
                break
        pos[jcol] = numord
        if maxinc == 0:
            ncomp = 0
        ncomp += 1
        numord += 1
        if numord >= n:
            break
        lists.remove(maxinc, jcol)
        tag[jcol] = n
        for r in indrow[jpntr[jcol]:jpntr[jcol + 1]]:
            for ic in indcol[ipntr[r]:ipntr[r + 1]]:
                if tag[ic] < numord:
                    tag[ic] = numord
                    b = inc[ic]
                    lists.remove(b, ic)
                    inc[ic] = b + 1
                    maxinc = max(maxinc, b + 1)
                    lists.push(b + 1, ic)
    order = np.empty(n, np.int64)
    order[pos] = np.arange(n)
    return order


def minpack_coloring(A, kind: str = "sl"):
    """-mat_coloring_type sl|lf|id (color.c drivers): returns int32
    0-based column colors matching the reference's group assignment."""
    A = sp.csr_matrix(A)
    n = A.shape[1]
    jpntr, indrow, ipntr, indcol = _col_adjacency(A)
    ndeg = _minpack_degr(n, jpntr, indrow, ipntr, indcol)
    if kind == "sl":
        order = _minpack_slo(n, jpntr, indrow, ipntr, indcol, ndeg)
    elif kind == "lf":
        order = _minpack_numsrt_desc(ndeg, max(n - 1, 0))
    elif kind == "id":
        order = _minpack_ido(n, A.shape[0], jpntr, indrow, ipntr,
                             indcol, ndeg)
    else:
        raise ValueError(f"unknown minpack coloring {kind!r} (sl|lf|id)")
    colors, _ = _minpack_seq(n, jpntr, indrow, ipntr, indcol, order)
    return colors


def get_coloring(A, kind: str = "sl") -> np.ndarray:
    """MatGetColoring analog: sl|lf|id (Minpack-exact) or greedy
    (natural-order greedy distance-2, the round-1 native path)."""
    if kind in ("sl", "lf", "id"):
        return minpack_coloring(A, kind)
    if kind in ("greedy", "natural"):
        return greedy_color(A)
    raise ValueError(f"unknown -mat_coloring_type {kind!r}")


def minpack_coloring_inode(A, kind: str = "sl", limit: int = 5):
    """The reference's FULL coloring pipeline: MatGetRowIJ/ColumnIJ
    with inodecompressed=TRUE (color.c drivers) colors the supernode
    graph, then MatColoringPatch_SeqAIJ_Inode (inode.c:2715) expands —
    column j of inode i gets coloring[i] + j*ncolors, compacted by
    usage. Identical to minpack_coloring when no inodes exist."""
    A = sp.csr_matrix(A)
    ns = inode_groups(A, limit)
    if ns is None:
        return minpack_coloring(A, kind)
    C = inode_compress_pattern(A, ns)
    sup = minpack_coloring(C, kind).astype(np.int64)
    nc = int(sup.max()) + 1
    newcolor = np.concatenate(
        [sup[i] + np.arange(sz) * nc for i, sz in enumerate(ns)])
    used = np.zeros(limit * nc, np.int64)
    used[newcolor] = 1
    remap = np.cumsum(used) - 1
    return remap[newcolor].astype(np.int32)
