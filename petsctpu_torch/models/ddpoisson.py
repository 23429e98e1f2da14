"""The Q1 Poisson MATIS of tests/test_bddc.py::matis_poisson_2d.

The unit square in ncell × ncell square cells, vertex (i, j) numbered
i·(ncell+1) + j and cells i-major with CCW vertices (petsctpu's
PlexQuad.create_box_mesh), Dirichlet vertices eliminated, the free ones
numbered in vertex order; the cells split into sub × sub blocks, each a
subdomain with its unassembled local Neumann matrix (the input of NN
and BDDC). On a square cell the Q1 Laplacian's element matrix is the
constant (1/6)[[4,-1,-2,-1],...]; `jump` scales a block's.
"""

from __future__ import annotations

import numpy as np
import scipy.sparse as sp

# the Q1 Laplacian of a square cell, vertices CCW from (0, 0)
Q1_LAPLACE = np.array([[4.0, -1.0, -2.0, -1.0], [-1.0, 4.0, -1.0, -2.0],
                       [-2.0, -1.0, 4.0, -1.0], [-1.0, -2.0, -1.0, 4.0]]) / 6


def matis_poisson_2d(ncell: int = 16, sub: int = 4, jump=None, dtype=None,
                     device=None):
    from petsctpu_torch.mat.matis import matis_from_subdomains

    n1 = ncell + 1
    i, j = np.divmod(np.arange(ncell * ncell), ncell)
    cells = np.stack([i * n1 + j, (i + 1) * n1 + j, (i + 1) * n1 + j + 1,
                      i * n1 + j + 1], axis=1)
    vi, vj = np.divmod(np.arange(n1 * n1), n1)
    free = (vi > 0) & (vi < ncell) & (vj > 0) & (vj < ncell)
    gnum = np.full(n1 * n1, -1)
    gnum[free] = np.arange(int(free.sum()))
    bsz = ncell // sub
    block = (i // bsz) * sub + (j // bsz)
    locs, l2gs = [], []
    for b in range(sub * sub):
        cb = cells[block == b]
        kap = 1.0 if jump is None else float(np.asarray(jump).ravel()[b])
        verts = np.unique(cb)
        verts = verts[gnum[verts] >= 0]
        lmap = np.full(n1 * n1, -1)
        lmap[verts] = np.arange(len(verts))
        r = np.repeat(cb, 4, axis=1).ravel()
        c = np.tile(cb, (1, 4)).ravel()
        v = np.tile(kap * Q1_LAPLACE.ravel(), len(cb))
        keep = (gnum[r] >= 0) & (gnum[c] >= 0)
        locs.append(sp.coo_matrix((v[keep], (lmap[r[keep]], lmap[c[keep]])),
                                  shape=(len(verts), len(verts))).tocsr())
        l2gs.append(gnum[verts])
    return matis_from_subdomains(locs, l2gs, int(free.sum()), dtype=dtype,
                                 device=device)
