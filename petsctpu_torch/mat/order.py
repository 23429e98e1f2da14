"""Fill-reducing and bandwidth orderings (petsctpu/mat/order.py).

Reference: src/mat/order (MatGetOrdering sorder.c:182; SPARSPAK genrcm,
gennd, gen1wd, genqmd). Provided: natural, rcm (SPARSPAK genrcm,
behavior-exact), rcm_fast (csrc/host_graph.cpp: same bandwidth class,
different tie-breaking), nd (SPARSPAK gennd), ndrb (recursive RCM-band
bisection), qmd (SPARSPAK genqmd, behavior-exact), md (greedy minimum
degree) and 1wd (SPARSPAK gen1wd): the port's copies of petsctpu's, so
the permutations are equal.
"""

from __future__ import annotations

import numpy as np
import scipy.sparse as sp


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
        # locality-only RCM (csrc/host_graph.cpp, petsctpu's native rcm:
        # same bandwidth class as genrcm, different tie-breaking)
        from petsctpu_torch.mat.host_graph import rcm
        S = ((A + A.T) != 0).astype(np.int8).tocsr()
        return rcm(S)
    S = ((A + A.T) != 0).astype(np.int8).tocsr()
    if kind == "nd":
        return gennd(S)
    if kind == "ndrb":
        return nested_dissection(S)
    if kind == "qmd":
        S.sort_indices()
        return genqmd(S)
    if kind == "md":
        return minimum_degree(S)
    if kind == "1wd":
        return gen1wd(S)
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


def minimum_degree(S: sp.csr_matrix) -> np.ndarray:
    """Greedy minimum-degree elimination ordering (the role of
    SPARSPAK's genqmd, src/mat/order/genqmd.c — quotient-graph
    bookkeeping replaced by explicit elimination-graph sets, adequate
    at plan time). At each step the minimum-degree node is eliminated
    and its neighbors are clique-connected."""
    n = S.shape[0]
    # invariant: adj[u] holds only ALIVE neighbors of u
    adj = [set(S.indices[S.indptr[i]:S.indptr[i + 1]]) - {i}
           for i in range(n)]
    perm = np.empty(n, np.int64)
    deg = np.array([len(a) for a in adj], np.float64)
    for k in range(n):
        i = int(np.argmin(deg))
        perm[k] = i
        deg[i] = np.inf
        nbrs = adj[i]
        for u in nbrs:
            adj[u].discard(i)
        for u in nbrs:
            adj[u] |= nbrs
            adj[u].discard(u)
            deg[u] = len(adj[u])
        adj[i] = set()
    return perm


def _qmd_reach(root, xadj, adjncy, deg, marker):
    """Reachable/neighborhood sets of `root` through eliminated nodes
    in the quotient graph (SPARSPAK QMDRCH, src/mat/order/qmdrch.c).
    Eliminated supernodes store their reach list in chained segments:
    a negative entry links to the next segment, 0 terminates."""
    rchset, nbrhd = [], []
    for i in range(xadj[root], xadj[root + 1]):
        nabor = adjncy[i]
        if nabor == 0:                 # terminator ends the whole scan
            break
        if marker[nabor] != 0:
            continue
        if deg[nabor] >= 0:            # live node -> reachable
            rchset.append(nabor)
            marker[nabor] = 1
            continue
        marker[nabor] = -1             # eliminated: walk its chain
        nbrhd.append(nabor)
        seg, chase = nabor, True
        while chase:
            chase = False
            for j in range(xadj[seg], xadj[seg + 1]):
                node = adjncy[j]
                if node < 0:
                    seg, chase = -node, True
                    break
                if node == 0:
                    break
                if marker[node] == 0:
                    rchset.append(node)
                    marker[node] = 1
    return rchset, nbrhd


def _qmd_qt(root, xadj, adjncy, marker, rchset, nbrhd):
    """Quotient-graph transform after eliminating `root` (QMDQT,
    src/mat/order/qmdqt.c): pack root's reach set into its adjacency
    slots, chaining through the absorbed nbrhd nodes' slots (last word
    of each segment is the link), 0-terminated; then substitute root
    for the first dead neighbor in each reach node's list."""
    irch = inhd = 0
    rchsze = len(rchset)
    node = root
    last_j = xadj[root]
    while True:
        jstrt, jstop = xadj[node], xadj[node + 1] - 2   # reserve link slot
        filled = False
        for j in range(jstrt, jstop + 1):
            adjncy[j] = rchset[irch]
            last_j = j
            irch += 1
            if irch >= rchsze:
                filled = True
                break
        if filled:
            break
        ilink = adjncy[jstop + 1]
        if ilink < 0:
            node = -ilink
            continue
        node = nbrhd[inhd]
        inhd += 1
        adjncy[jstop + 1] = -node
    adjncy[last_j + 1] = 0
    for node in rchset:
        if marker[node] < 0:
            continue
        for j in range(xadj[node], xadj[node + 1]):
            if marker[adjncy[j]] < 0:
                adjncy[j] = root
                break


def _qmd_merge(xadj, adjncy, deg, qsize, qlink, marker, deg0, nbrhd):
    """Merge indistinguishable nodes adjacent to the eliminated
    supernodes in `nbrhd` (QMDMRG, src/mat/order/qmdmrg.c). Nodes of
    the caller's reach set carry marker 1; a reach node all of whose
    live neighbors lie in reach sets joins the merged supernode
    (marker -1, chained on qlink under a head with updated degree)."""
    for root in nbrhd:
        marker[root] = 0
    for root in nbrhd:
        marker[root] = -1
        rchset, ovrlp = [], []
        deg1 = 0
        seg, chase = root, True
        while chase:
            chase = False
            for j in range(xadj[seg], xadj[seg + 1]):
                nabor = adjncy[j]
                if nabor < 0:
                    seg, chase = -nabor, True
                    break
                if nabor == 0:
                    break
                mark = marker[nabor]
                if mark < 0 or mark > 1:
                    continue
                if mark == 0:
                    rchset.append(nabor)
                    deg1 += qsize[nabor]
                    marker[nabor] = 1
                else:                   # mark == 1: in the given set
                    ovrlp.append(nabor)
                    marker[nabor] = 2
        head = mrgsze = 0
        for node in ovrlp:
            mergeable = True
            for j in range(xadj[node], xadj[node + 1]):
                if marker[adjncy[j]] == 0:
                    mergeable = False
                    break
            if not mergeable:
                marker[node] = 1
                continue
            mrgsze += qsize[node]
            marker[node] = -1
            lnode = node
            while qlink[lnode] > 0:
                lnode = qlink[lnode]
            qlink[lnode] = head
            head = node
        if head > 0:
            qsize[head] = mrgsze
            deg[head] = deg0 + deg1 - 1
            marker[head] = 2
        marker[root] = 0
        for node in rchset:
            marker[node] = 0


def _qmd_update(xadj, adjncy, nodes, deg, qsize, qlink, marker):
    """Degree update for the reach set after an elimination (QMDUPD,
    src/mat/order/qmdupd.c): collect dead supernodes adjacent to the
    set, merge indistinguishables, then recompute each survivor's
    quotient degree deg0 + |reach outside the set| - 1."""
    if not nodes:
        return
    deg0 = 0
    nbrhd = []
    for node in nodes:
        deg0 += qsize[node]
        for j in range(xadj[node], xadj[node + 1]):
            nabor = adjncy[j]
            if marker[nabor] == 0 and deg[nabor] < 0:
                marker[nabor] = -1
                nbrhd.append(nabor)
    if nbrhd:
        _qmd_merge(xadj, adjncy, deg, qsize, qlink, marker, deg0, nbrhd)
    for node in nodes:
        mark = marker[node]
        if mark > 1 or mark < 0:
            continue
        marker[node] = 2
        rchset, nbr = _qmd_reach(node, xadj, adjncy, deg, marker)
        deg1 = deg0
        for inode in rchset:
            deg1 += qsize[inode]
            marker[inode] = 0
        deg[node] = deg1 - 1
        for inode in nbr:
            marker[inode] = 0


def genqmd(S: sp.csr_matrix) -> np.ndarray:
    """Quotient-minimum-degree ordering, behavior-exact vs SPARSPAK's
    GENQMD (src/mat/order/genqmd.c, reached via
    -pc_factor_mat_ordering_type qmd, spqmd.c:18): threshold search
    over the evolving perm array, quotient-graph reach sets,
    indistinguishable-supernode merging, and in-place quotient
    transforms — so factor streams match the reference digit-for-digit.
    Expects the symmetrized structure WITH the diagonal (MatGetRowIJ
    symmetric form), 0-based CSR; returns the elimination order."""
    n = S.shape[0]
    if n == 0:
        return np.empty(0, np.int64)
    # 1-based workspace: node ids 1..n, adjacency values 1-based,
    # 0 free for the terminator convention
    xadj = np.empty(n + 2, np.int64)
    xadj[1:] = S.indptr + 1
    adjncy = np.empty(S.nnz + 1, np.int64)
    adjncy[1:] = S.indices + 1
    perm = np.empty(n + 1, np.int64)
    invp = np.empty(n + 1, np.int64)
    perm[1:] = np.arange(1, n + 1)
    invp[1:] = np.arange(1, n + 1)
    marker = np.zeros(n + 1, np.int64)
    qsize = np.ones(n + 1, np.int64)
    qlink = np.zeros(n + 1, np.int64)
    deg = np.empty(n + 1, np.int64)
    deg[1:] = np.diff(S.indptr)
    mindeg = min(int(deg[1:].min()), n)
    num = 0
    thresh = None
    while num < n:
        # threshold search for a node of degree <= thresh, starting at
        # `search` in perm order (genqmd.c L200/L300)
        search = 1
        thresh = mindeg
        mindeg = n
        while num < n:
            search = max(search, num + 1)
            sel = 0
            for j in range(search, n + 1):
                node = int(perm[j])
                if marker[node] < 0:
                    continue
                ndeg = int(deg[node])
                if ndeg <= thresh:
                    sel = node
                    search = j
                    break
                if ndeg < mindeg:
                    mindeg = ndeg
            if not sel:
                break                      # raise the threshold (L200)
            node = sel
            marker[node] = 1
            rchset, nbrhd = _qmd_reach(node, xadj, adjncy, deg, marker)
            # number node and everything merged into it (qlink chain)
            nxnode = node
            while nxnode > 0:
                num += 1
                np_ = int(invp[nxnode])
                ip = int(perm[num])
                perm[np_] = ip
                invp[ip] = np_
                perm[num] = nxnode
                invp[nxnode] = num
                deg[nxnode] = -1
                nxnode = int(qlink[nxnode])
            if rchset:
                _qmd_update(xadj, adjncy, rchset, deg, qsize, qlink,
                            marker)
                marker[node] = 0
                for inode in rchset:
                    if marker[inode] < 0:
                        continue
                    marker[inode] = 0
                    ndeg = int(deg[inode])
                    if ndeg < mindeg:
                        mindeg = ndeg
                    if ndeg <= thresh:
                        mindeg = thresh
                        thresh = ndeg
                        search = int(invp[inode])
                if nbrhd:
                    _qmd_qt(node, xadj, adjncy, marker, rchset, nbrhd)
    return perm[1:] - 1


def _rootls(S: sp.csr_matrix, root: int, mask: np.ndarray):
    """Rooted level structure of the masked component (rootls.f
    behavior): BFS from `root` over mask-true nodes, neighbors taken
    in CSR column order. Returns the list of levels."""
    vis = ~mask
    vis = vis.copy()
    vis[root] = True
    levels = [np.array([root], dtype=np.int64)]
    indptr, indices = S.indptr, S.indices
    while True:
        nxt = []
        for u in levels[-1]:
            for v in indices[indptr[u]:indptr[u + 1]]:
                if not vis[v]:
                    vis[v] = True
                    nxt.append(v)
        if not nxt:
            return levels
        levels.append(np.asarray(nxt, dtype=np.int64))


def _fnroot(S: sp.csr_matrix, root: int, mask: np.ndarray):
    """Pseudo-peripheral node finder (fnroot.f behavior): repeatedly
    re-root at the minimum-masked-degree node of the last level while
    the structure keeps getting taller. Returns (root, levels) of the
    final rooted level structure."""
    indptr, indices = S.indptr, S.indices
    levels = _rootls(S, root, mask)
    ccsize = sum(len(l) for l in levels)
    nlvl = len(levels)
    if nlvl == 1 or nlvl == ccsize:
        return root, levels
    while True:
        last = levels[-1]
        mindeg, root = ccsize, int(last[0])
        for u in last:
            nd = int(np.count_nonzero(mask[indices[indptr[u]:
                                               indptr[u + 1]]]))
            if nd < mindeg:
                mindeg, root = nd, int(u)
        lvl2 = _rootls(S, root, mask)
        if len(lvl2) <= nlvl:
            return root, lvl2
        nlvl, levels = len(lvl2), lvl2
        if nlvl >= ccsize:
            return root, lvl2


def _fndsep(S: sp.csr_matrix, root: int, mask: np.ndarray):
    """Find a small separator of root's masked component (fndsep.f
    behavior): nodes of the middle level of the pseudo-peripheral
    rooted level structure that have a neighbor in the middle+1 level
    (whole component if fewer than 3 levels). Marks them numbered."""
    indptr, indices = S.indptr, S.indices
    root, levels = _fnroot(S, root, mask)
    nlvl = len(levels)
    if nlvl < 3:
        sep = np.concatenate(levels)
        mask[sep] = False
        return sep
    midlvl = (nlvl + 2) // 2                 # 1-based SPARSPAK index
    mid, mid1 = levels[midlvl - 1], levels[midlvl]
    inmid1 = np.zeros(S.shape[0], bool)
    inmid1[mid1] = True
    sep = [int(u) for u in mid
           if inmid1[indices[indptr[u]:indptr[u + 1]]].any()]
    sep = np.asarray(sep, dtype=np.int64)
    mask[sep] = False
    return sep


def gennd(S: sp.csr_matrix) -> np.ndarray:
    """SPARSPAK general nested dissection (gennd.f behavior, the
    reference's MatGetOrdering ND — src/mat/order/gennd.c via
    spnd.c): for each lowest-numbered remaining vertex, peel middle-
    level separators off its component, numbering separator nodes
    consecutively; reverse the whole numbering at the end so
    separators found first are eliminated last. Self-loops in S are
    harmless (uniform degree shift, never in the mid+1 marking).

    Returns perm with perm[k] = old index of new row k — digit-exact
    iteration parity with the reference's `-permute nd` runs (ksp
    ex18_1) depends on this exact separator choice."""
    S = sp.csr_matrix(S)
    n = S.shape[0]
    mask = np.ones(n, bool)
    perm = []
    num = 0
    for i in range(n):
        while mask[i]:
            sep = _fndsep(S, i, mask)
            perm.append(sep)
            num += sep.size
            if num >= n:
                break
        if num >= n:
            break
    out = np.concatenate(perm)[::-1]
    return np.ascontiguousarray(out)


def _fn1wd(S: sp.csr_matrix, root: int, mask: np.ndarray):
    """Find one-way dissectors of root's masked component (fn1wd.f
    behavior, src/mat/order/fn1wd.c): pick parallel level cuts at
    spacing δ+1 = sqrt((3·width + 13)/2) + 1 through the pseudo-
    peripheral level structure; a cut keeps only nodes with a
    neighbor in the next level. Small or long-thin components are
    returned whole. Marks dissector nodes numbered. Returns
    (dissectors, levels-of-the-component)."""
    indptr, indices = S.indptr, S.indices
    root, levels = _fnroot(S, root, mask)
    nlvl = len(levels)
    comp_size = sum(len(l) for l in levels)
    width = comp_size / nlvl
    deltp1 = np.sqrt((3.0 * width + 13.0) / 2.0) + 1.0
    if comp_size < 50 or deltp1 > 0.5 * nlvl:
        sep = np.concatenate(levels)
        mask[sep] = False
        return sep, levels
    sep = []
    i = 0
    while True:
        i += 1
        lvl = int(i * deltp1 + 0.5)                  # 1-based level id
        if lvl >= nlvl:
            break
        mark = np.zeros(S.shape[0], bool)
        mark[levels[lvl]] = True                     # level lvl+1
        for node in levels[lvl - 1]:                 # level lvl, ls order
            if mark[indices[indptr[node]:indptr[node + 1]]].any():
                sep.append(int(node))
                mask[node] = False
    sep = np.asarray(sep, dtype=np.int64)
    return sep, levels


def gen1wd(S: sp.csr_matrix) -> np.ndarray:
    """SPARSPAK general one-way dissection (gen1wd.f behavior, the
    reference's MatGetOrdering 1WD — src/mat/order/gen1wd.c): per
    component, find parallel one-way dissectors (fn1wd), then number
    each remaining connected block by a rooted level structure;
    reverse at the end so dissectors found first are numbered last.

    Returns perm with perm[k] = old index of new row k."""
    S = sp.csr_matrix(S)
    n = S.shape[0]
    mask = np.ones(n, bool)
    perm = []
    for i in range(n):
        if not mask[i]:
            continue
        sep, levels = _fn1wd(S, i, mask)
        perm.append(sep)
        for node in np.concatenate(levels):
            if not mask[node]:
                continue
            blk = np.concatenate(_rootls(S, int(node), mask))
            perm.append(blk)
            mask[blk] = False
    out = np.concatenate([p for p in perm if p.size])[::-1]
    return np.ascontiguousarray(out)


def nested_dissection(S, leaf: int = 24) -> np.ndarray:
    """Recursive nested dissection (gennd.c analog): bisect the graph
    along an RCM-band cut, peel the vertex separator off the second
    half, recurse on the halves, number the separator LAST — the
    ordering whose elimination tree direct solvers want."""
    from scipy.sparse.csgraph import reverse_cuthill_mckee

    S = sp.csr_matrix(S)

    def rec(idx: np.ndarray) -> np.ndarray:
        if idx.size <= leaf:
            sub = S[idx][:, idx]
            return idx[np.asarray(reverse_cuthill_mckee(sub),
                                  dtype=np.int64)]
        sub = S[idx][:, idx].tocsr()
        order = np.asarray(reverse_cuthill_mckee(sub), dtype=np.int64)
        half = idx.size // 2
        a_loc, b_loc = order[:half], order[half:]
        in_a = np.zeros(idx.size, bool)
        in_a[a_loc] = True
        # separator: b-side vertices adjacent to the a side
        rows_b = sub[b_loc]
        touches_a = np.asarray(
            (rows_b[:, a_loc].getnnz(axis=1) > 0)).ravel()
        sep_loc = b_loc[touches_a]
        rest_loc = b_loc[~touches_a]
        parts = [rec(idx[a_loc])]
        if rest_loc.size:
            parts.append(rec(idx[rest_loc]))
        if sep_loc.size:
            parts.append(idx[sep_loc])
        return np.concatenate(parts)

    return rec(np.arange(S.shape[0], dtype=np.int64))


def permute_symmetric(A, perm: np.ndarray):
    """A → A[perm][:, perm] (MatPermute analog)."""
    A = sp.csr_matrix(A)
    return A[perm][:, perm].tocsr()


def bandwidth(A) -> int:
    A = sp.coo_matrix(A)
    if A.nnz == 0:
        return 0
    return int(np.abs(A.row - A.col).max())
