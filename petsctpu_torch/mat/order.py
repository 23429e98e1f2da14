"""Bandwidth orderings (the part of petsctpu/mat/order.py on the solve path).

Reference: src/mat/order (MatGetOrdering sorder.c:182; RCM genrcm.c).
Provided: natural, rcm (SPARSPAK genrcm, behavior-exact) and rcm_fast
(scipy csgraph: same bandwidth class, different tie-breaking). The
fill-reducing orderings (nd, ndrb, qmd, md, 1wd) come with the ILU
slice (ROADMAP queue 1 item 5).
"""

from __future__ import annotations

import numpy as np
import scipy.sparse as sp

_LATER = ("nd", "ndrb", "qmd", "md", "1wd")


def get_ordering(A, kind: str = "natural") -> np.ndarray:
    """Returns perm such that A[perm][:, perm] is the reordered matrix
    (row permutation = column permutation, symmetric ordering)."""
    A = sp.csr_matrix(A)
    n = A.shape[0]
    if kind in ("natural", ""):
        return np.arange(n)
    if kind == "rcm":
        # the reference's SPARSPAK genrcm, behavior-exact (root
        # selection, neighbor ordering, tie-breaking)
        S = ((A + A.T) != 0).astype(np.int8).tocsr()
        S.sort_indices()
        return genrcm(S)
    if kind == "rcm_fast":
        # locality-only RCM (scipy csgraph; same bandwidth class,
        # different tie-breaking)
        from scipy.sparse.csgraph import reverse_cuthill_mckee
        S = ((A + A.T) != 0).astype(np.int8).tocsr()
        return np.asarray(reverse_cuthill_mckee(S), dtype=np.int64)
    if kind in _LATER:
        raise NotImplementedError(
            f"ordering {kind!r} is not ported yet (ROADMAP queue 1 item 5)")
    raise ValueError(f"unknown ordering {kind!r} "
                     "(natural|rcm|rcm_fast|nd|ndrb|qmd|md|1wd)")


def _sprootls(indptr, indices, mask, root):
    """Rooted level structure (SPARSPAK rootls): BFS levels from root
    over masked nodes, each level in discovery (adjacency) order."""
    levels = []
    mask[root] = 0
    frontier = [root]
    while frontier:
        levels.append(frontier)
        nxt = []
        for node in frontier:
            for nbr in indices[indptr[node]:indptr[node + 1]]:
                if mask[nbr]:
                    mask[nbr] = 0
                    nxt.append(nbr)
        frontier = nxt
    # restore mask (SPARSPAK's rootls marks visits by negating xadj;
    # emulate by resetting)
    for lv in levels:
        for node in lv:
            mask[node] = 1
    return levels


def _masked_degree(indptr, indices, mask, node):
    return int(np.count_nonzero(mask[indices[indptr[node]:
                                             indptr[node + 1]]]))


def _spfnroot(indptr, indices, mask, root):
    """SPARSPAK fnroot: pseudo-peripheral node via level structures."""
    levels = _sprootls(indptr, indices, mask, root)
    nlvl = len(levels)
    ccsize = sum(len(lv) for lv in levels)
    if nlvl == 1 or nlvl == ccsize:
        return root
    while True:
        last = levels[-1]
        root = last[0]
        if len(last) > 1:
            mindeg = ccsize
            for node in last:
                ndeg = _masked_degree(indptr, indices, mask, node)
                if ndeg < mindeg:
                    root = node
                    mindeg = ndeg
        levels = _sprootls(indptr, indices, mask, root)
        if len(levels) <= nlvl:
            return root
        nlvl = len(levels)
        if nlvl >= ccsize:
            return root


def _rcm_component(indptr, indices, mask, root, deg):
    """SPARSPAK rcm: Cuthill-McKee from root (per-node neighbor spans
    stable-sorted by masked-at-start degree), then reversed."""
    # component degrees at start (SPARSPAK degree())
    comp = _sprootls(indptr, indices, mask, root)
    for lv in comp:
        for node in lv:
            deg[node] = _masked_degree(indptr, indices, mask, node)
    perm = [root]
    mask[root] = 0
    i = 0
    while i < len(perm):
        node = perm[i]
        fnbr = len(perm)
        for nbr in indices[indptr[node]:indptr[node + 1]]:
            if mask[nbr]:
                mask[nbr] = 0
                perm.append(nbr)
        if len(perm) - fnbr > 1:
            span = np.asarray(perm[fnbr:], np.int64)
            order = np.argsort(deg[span], kind="stable")
            perm[fnbr:] = span[order].tolist()
        i += 1
    perm.reverse()
    return perm


def genrcm(S: sp.csr_matrix) -> np.ndarray:
    """General reverse Cuthill-McKee, SPARSPAK-exact (the reference's
    MatOrdering rcm: genrcm.c/rcm.c/fnroot.c/rootls.c/degree.c —
    components in node order, fnroot pseudo-peripheral start, per-node
    neighbor spans insertion-sorted by component degree)."""
    n = S.shape[0]
    indptr, indices = S.indptr, S.indices
    mask = np.ones(n, bool)
    deg = np.zeros(n, np.int64)
    out = []
    for i in range(n):
        if not mask[i]:
            continue
        root = _spfnroot(indptr, indices, mask, i)
        out.extend(_rcm_component(indptr, indices, mask, root, deg))
        if len(out) >= n:
            break
    return np.asarray(out, np.int64)


def bandwidth(A) -> int:
    A = sp.coo_matrix(A)
    if A.nnz == 0:
        return 0
    return int(np.abs(A.row - A.col).max())
