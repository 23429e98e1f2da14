"""PCSupportGraph — Vaidya spanning-tree preconditioner.

Counterpart of petsctpu/pc/supportgraph.py (reference: src/ksp/pc/
impls/supportgraph, support-graph preconditioners for symmetric
diagonally dominant systems). A maximum-weight spanning tree of the
off-diagonal connection graph (plus the full diagonal) is kept and
factored exactly on the host: a tree eliminates leaves first, so its
LU has no fill. Optionally the tree is augmented with the t heaviest
non-tree edges (Vaidya's augmented spanning tree).
"""

from __future__ import annotations

import numpy as np
import scipy.sparse as sp

from petsctpu_torch.core.options import Options


def support_tree(A_host, augment: int = 0):
    """Maximum-weight spanning tree of |offdiag(A)| (+ `augment`
    heaviest non-tree edges), with A's diagonal. Returns scipy CSR."""
    A = sp.csr_matrix(A_host)
    n = A.shape[0]
    coo = sp.triu(A, k=1).tocoo()
    W = sp.coo_matrix((-np.abs(coo.data), (coo.row, coo.col)),
                      shape=(n, n)).tocsr()
    from scipy.sparse.csgraph import minimum_spanning_tree
    T = minimum_spanning_tree(W).tocoo()     # max-|weight| tree
    keep = set(zip(T.row.tolist(), T.col.tolist()))
    if augment > 0:
        order = np.argsort(-np.abs(coo.data))
        added = 0
        for t in order:
            e = (int(coo.row[t]), int(coo.col[t]))
            if e not in keep:
                keep.add(e)
                added += 1
                if added >= augment:
                    break
    rows, cols, vals = [], [], []
    Ac = A.tocoo()
    entry = {(int(r), int(c)): v
             for r, c, v in zip(Ac.row, Ac.col, Ac.data)}
    for (i, j) in keep:
        if (i, j) in entry:
            rows += [i, j]
            cols += [j, i]
            vals += [entry[(i, j)], entry.get((j, i), entry[(i, j)])]
    d = A.diagonal()
    rows += list(range(n))
    cols += list(range(n))
    vals += list(d)
    return sp.coo_matrix((vals, (rows, cols)), shape=(n, n)).tocsr()


def make_supportgraph(A_host, dtype=None, options: Options = None,
                      device=None):
    """Factor the (augmented) spanning-tree matrix exactly; the apply
    is the LU's two zero-fill triangular solves (SpTRSV) on the device."""
    from petsctpu_torch.pc.factor import make_lu

    opts = options or Options()
    augment = opts.get_int("pc_supportgraph_augment", 0)
    T = support_tree(A_host, augment=augment)
    return make_lu(T, dtype=dtype, device=device)
