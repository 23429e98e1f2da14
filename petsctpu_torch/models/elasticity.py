"""Linear elasticity models (Q1 elements), the multi-dof problems GAMG
was built for.

The port's copy of petsctpu/models/elasticity.py. PCGAMG's headline use
is elasticity (PCSetCoordinates_AGG, agg.c:246, builds rigid-body modes
from node coordinates):

  * elasticity_2d: a plane-strain bs = 2 cantilever (left edge clamped,
    downward traction on the right edge);
  * ex55_system: ksp ex55, 2-D Q1 elasticity with a soft circular
    inclusion (ex55.c:30-200);
  * ex56_system: ksp ex56, 3-D Q1 elasticity with a soft spherical
    inclusion, whose 24×24 element stiffness is a data file of the
    reference's tutorials (data/elem_3d_elast_v_25.txt), looked for
    under this package's models/data/ by default.

ex55_system builds the same COO arrays as petsctpu's per-element loop,
vectorised, in the same element-major order, so scipy sums duplicates in
the same order and the two CSR matrices are equal byte for byte.
"""

from __future__ import annotations

from pathlib import Path

import numpy as np
import scipy.sparse as sp

ELEM_FILE = Path(__file__).resolve().parent / "data" / \
    "elem_3d_elast_v_25.txt"


def _q1_element_stiffness(E=1.0, nu=0.3, h=1.0):
    """8×8 plane-strain Q1 stiffness on an h×h square (2×2 Gauss)."""
    lam = E * nu / ((1 + nu) * (1 - 2 * nu))
    mu = E / (2 * (1 + nu))
    D = np.array([[lam + 2 * mu, lam, 0],
                  [lam, lam + 2 * mu, 0],
                  [0, 0, mu]])
    gp = np.array([-1, 1]) / np.sqrt(3.0)
    Ke = np.zeros((8, 8))
    for xi in gp:
        for eta in gp:
            # dN/dxi for N ordered (0,0),(1,0),(1,1),(0,1)
            dN = 0.25 * np.array([
                [-(1 - eta), (1 - eta), (1 + eta), -(1 + eta)],
                [-(1 - xi), -(1 + xi), (1 + xi), (1 - xi)]])
            J = h / 2.0
            dNdx = dN / J
            B = np.zeros((3, 8))
            B[0, 0::2] = dNdx[0]
            B[1, 1::2] = dNdx[1]
            B[2, 0::2] = dNdx[1]
            B[2, 1::2] = dNdx[0]
            Ke += (B.T @ D @ B) * (J * J)
    return Ke


def elasticity_2d(mx: int, my: int, E=1.0, nu=0.3, traction=-0.1):
    """Cantilever: (mx+1)×(my+1) nodes, left edge clamped, uniform
    downward traction on the right edge. Returns (A_csr, coords, b)
    with free dofs only (clamped dofs eliminated)."""
    nx, ny = mx + 1, my + 1
    h = 1.0 / mx
    Ke = _q1_element_stiffness(E, nu, h)

    def nid(i, j):
        return i * ny + j

    rows, cols, vals = [], [], []
    for i in range(mx):
        for j in range(my):
            nodes = [nid(i, j), nid(i + 1, j), nid(i + 1, j + 1),
                     nid(i, j + 1)]
            dofs = np.array([[2 * n, 2 * n + 1] for n in nodes]).ravel()
            r, c = np.meshgrid(dofs, dofs, indexing="ij")
            rows.append(r.ravel())
            cols.append(c.ravel())
            vals.append(Ke.ravel())
    n_dof = 2 * nx * ny
    K = sp.coo_matrix((np.concatenate(vals),
                       (np.concatenate(rows), np.concatenate(cols))),
                      shape=(n_dof, n_dof)).tocsr()

    X, Y = np.meshgrid(np.linspace(0, 1, nx), np.linspace(0, 1, ny),
                       indexing="ij")
    coords_all = np.stack([X.ravel(), Y.ravel()], axis=1)

    b = np.zeros(n_dof)
    for j in range(ny):                       # right-edge traction (uy)
        w = h if 0 < j < ny - 1 else h / 2.0
        b[2 * nid(mx, j) + 1] = traction * w

    clamped = np.zeros(n_dof, bool)           # the left edge
    for j in range(ny):
        clamped[2 * nid(0, j)] = clamped[2 * nid(0, j) + 1] = True
    free = ~clamped
    A = K[free][:, free].tocsr()
    coords = coords_all[free[::2]]   # both dofs of a node share status
    return A, coords, b[free]


def _ex55_elements():
    """ex55's two 8×8 element matrices: DD1, and DD2 for the bottom row
    (rows and columns < 4 diagonalised ×0.1)."""
    t = 1.0 / 3.0
    DD1 = np.array([
        [8 / 15, .2, -t, 0.0, -4 / 15, -.2, 1 / 15, 0.0],
        [.2, 8 / 15, 0.0, 1 / 15, -.2, -4 / 15, 0.0, -t],
        [-t, 0.0, 8 / 15, -.2, 1 / 15, 0.0, -4 / 15, .2],
        [0.0, 1 / 15, -.2, 8 / 15, 0.0, -t, .2, -4 / 15],
        [-4 / 15, -.2, 1 / 15, 0.0, 8 / 15, .2, -t, 0.0],
        [-.2, -4 / 15, 0.0, -t, .2, 8 / 15, 0.0, 1 / 15],
        [1 / 15, 0.0, -4 / 15, .2, -t, 0.0, 8 / 15, -.2],
        [0.0, -t, .2, -4 / 15, 0.0, 1 / 15, -.2, 8 / 15]])
    DD2 = DD1.copy()
    for i in range(8):
        for j in range(8):
            if i < 4 or j < 4:
                DD2[i, j] = 0.1 * DD1[i, j] if i == j else 0.0
    return DD1, DD2


def ex55_system(ne: int = 4, soft_alpha: float = 1e-3, dtype=np.float64):
    """ksp ex55: 2-D Q1 elasticity (2 dof/node, interleaved) on an
    ne×ne element grid with a soft circular inclusion and the
    bottom-row BC element (ex55.c:30-200; the hardwired 8×8 element).
    Load h² in the x-direction on all non-bottom nodes. Returns
    (A, b, coords[nnode, 2])."""
    n1 = ne + 1
    nn = n1 * n1
    h = 1.0 / ne
    DD1, DD2 = _ex55_elements()
    # the elements in petsctpu's loop order: node Ii = j·n1 + i with
    # i, j < ne, Ii ascending
    jj, ii = np.divmod(np.arange(ne * ne, dtype=np.int64), ne)
    Ii = jj * n1 + ii
    nodes = np.stack([Ii, Ii + 1, Ii + n1 + 1, Ii + n1], axis=1)
    dof = np.stack([2 * nodes, 2 * nodes + 1], axis=2).reshape(-1, 8)
    x, y = h * ii, h * jj
    radius = np.sqrt((x - .5 + h / 2) ** 2 + (y - .5 + h / 2) ** 2)
    alpha = np.where(radius < 0.25, soft_alpha, 1.0)
    DD = alpha[:, None, None] * np.where((jj > 0)[:, None, None], DD1, DD2)
    rows = np.repeat(dof, 8, axis=1).reshape(-1)
    cols = np.tile(dof, (1, 8)).reshape(-1)
    A = sp.csr_matrix((DD.reshape(-1), (rows, cols)),
                      shape=(2 * nn, 2 * nn)).astype(dtype)
    b = np.zeros(2 * nn, dtype)
    jn = np.arange(nn) // n1
    b[2 * np.arange(nn)[jn > 0]] = h * h
    xs = h * (np.arange(nn) % n1)
    ys = h * (np.arange(nn) // n1)
    return A, b, np.stack([xs, ys], axis=1)


def ex56_system(ne: int = 4, soft_alpha: float = 1e-3, elem_file=None,
                dtype=np.float64):
    """ksp ex56: 3-D Q1 elasticity (3 dof/node, interleaved) on an ne³
    element grid with a soft spherical inclusion; the 24×24 element
    stiffness is read from `elem_file` (default ELEM_FILE; a missing
    file raises FileNotFoundError). Bottom-layer (k = 0) elements use
    the BC-modified element (rows/cols < 12 diagonalised ×0.1); element
    loads vv = (h², 2h², 0) per node, bottom elements load only their
    top 4 nodes (ex56.c:93-171, 200-232). Returns (A, b, coords)."""
    DD1 = np.loadtxt(ELEM_FILE if elem_file is None else elem_file) \
        .reshape(24, 24)
    DD2 = DD1.copy()
    for i in range(24):
        for j in range(24):
            if i < 12 or j < 12:
                DD2[i, j] = 0.1 * DD1[i, j] if i == j else 0.0
    vv = np.zeros(24)
    v2 = np.zeros(24)
    h = 1.0 / ne
    for i in range(24):
        if i % 3 == 0:
            vv[i] = h * h
        elif i % 3 == 1:
            vv[i] = 2.0 * h * h
        if i >= 12:
            v2[i] = vv[i]
    nn = ne + 1
    nnode = nn ** 3
    rows, cols, vals = [], [], []
    b = np.zeros(3 * nnode, dtype)
    for k in range(ne):
        for j in range(ne):
            for i in range(ne):
                idn = i + nn * j + nn * nn * k
                nodes = np.array([idn, idn + 1, idn + nn + 1, idn + nn,
                                  idn + nn * nn, idn + 1 + nn * nn,
                                  idn + nn + 1 + nn * nn,
                                  idn + nn + nn * nn])
                dof = (3 * nodes[:, None]
                       + np.arange(3)[None, :]).reshape(-1)
                x, y, z = h * i, h * j, h * k
                radius = np.sqrt((x - .5 + h / 2) ** 2
                                 + (y - .5 + h / 2) ** 2
                                 + (z - .5 + h / 2) ** 2)
                alpha = soft_alpha if radius < 0.25 else 1.0
                DD = alpha * (DD1 if k > 0 else DD2)
                rows.append(np.repeat(dof, 24))
                cols.append(np.tile(dof, 24))
                vals.append(DD.reshape(-1))
                b[dof] += vv if k > 0 else v2
    A = sp.csr_matrix((np.concatenate(vals),
                       (np.concatenate(rows), np.concatenate(cols))),
                      shape=(3 * nnode, 3 * nnode)).astype(dtype)
    ii = np.arange(nnode) % nn
    jj = (np.arange(nnode) // nn) % nn
    kk = np.arange(nnode) // (nn * nn)
    coords = np.stack([h * ii, h * jj, h * kk], axis=1)
    return A, b, coords
