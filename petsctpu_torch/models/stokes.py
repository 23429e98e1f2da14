"""Lid-driven Stokes on a staggered MAC grid — saddle-point model.

Counterpart of petsctpu/models/stokes.py (the same scipy assembly).

The reference exercises saddle-point solvers through its tutorials
(src/ksp/ksp/examples/tutorials ex42/ex43 variable-viscosity Stokes;
SNES ex62) and the PCFieldSplit/PCLSC machinery (SURVEY §2.5). This
model produces the canonical MAC finite-difference Stokes system

    [ A   G ] [u]   [f]
    [ D   0 ] [p] = [g]

on an m×m unit-square grid: A = vector Laplacian on face velocities
(ghost-cell Dirichlet walls, moving lid enters f), G = pressure
gradient, D = −Gᵀ = divergence. The pressure block carries the
constant null space (use petsctpu_torch/mat/nullspace.py). Feeds PCFieldSplit
(Schur), PCLSC, and MINRES block-diagonal preconditioning tests and
examples.
"""

from __future__ import annotations

import numpy as np
import scipy.sparse as sp


def _tv(n, h):
    """Vertex-direction 1-D Laplacian, Dirichlet both ends."""
    return sp.diags([-np.ones(n - 1), 2 * np.ones(n), -np.ones(n - 1)],
                    [-1, 0, 1]) / h ** 2


def _tc(n, h):
    """Cell-direction 1-D Laplacian with ghost-cell Dirichlet walls
    (wall rows get coefficient 3: ghost value = −interior)."""
    d = 2 * np.ones(n)
    d[0] = d[-1] = 3.0
    return sp.diags([-np.ones(n - 1), d, -np.ones(n - 1)], [-1, 0, 1]) \
        / h ** 2


def stokes_mac(m: int, lid_velocity: float = 1.0):
    """Assemble the MAC Stokes system.

    Unknowns: u interior x-face velocities (m−1)×m, v interior y-face
    velocities m×(m−1), p cell pressures m×m. Returns
    (K, b, fields, blocks) with K the full (nu+nv+np) saddle-point CSR,
    b the lid-driven RHS, fields = (velocity_indices, pressure_indices)
    and blocks = dict(A=..., G=..., D=...).
    """
    h = 1.0 / m
    nu = (m - 1) * m
    nv = m * (m - 1)
    npp = m * m

    # velocity Laplacians (x-fast ordering: index = i*m + j for u)
    Au = sp.kron(_tv(m - 1, h), sp.eye(m)) + sp.kron(sp.eye(m - 1), _tc(m, h))
    Av = sp.kron(_tc(m, h), sp.eye(m - 1)) + sp.kron(sp.eye(m), _tv(m - 1, h))
    A = sp.block_diag([Au, Av]).tocsr()

    # gradient: dp/dx at u-face (i=1..m-1, j): (p[i,j] − p[i−1,j])/h
    rows, cols, vals = [], [], []
    for i in range(1, m):
        for j in range(m):
            r = (i - 1) * m + j
            rows += [r, r]
            cols += [i * m + j, (i - 1) * m + j]
            vals += [1.0 / h, -1.0 / h]
    Gx = sp.coo_matrix((vals, (rows, cols)), shape=(nu, npp)).tocsr()
    rows, cols, vals = [], [], []
    for i in range(m):
        for j in range(1, m):
            r = i * (m - 1) + (j - 1)
            rows += [r, r]
            cols += [i * m + j, i * m + j - 1]
            vals += [1.0 / h, -1.0 / h]
    Gy = sp.coo_matrix((vals, (rows, cols)), shape=(nv, npp)).tocsr()
    G = sp.vstack([Gx, Gy]).tocsr()
    D = (-G.T).tocsr()                      # divergence (MAC adjointness)

    # continuity row stored as −div = Gᵀ so K is SYMMETRIC (the
    # Silvester-Wathen saddle form MINRES requires); blocks["D"] is
    # the true divergence for checking the solution
    K = sp.bmat([[A, G], [G.T, None]], format="csr")

    # lid (y = 1 wall moving in +x): ghost contribution to u rows with
    # j = m−1: +2·lid/h²
    b = np.zeros(nu + nv + npp)
    for i in range(m - 1):
        b[i * m + (m - 1)] += 2.0 * lid_velocity / h ** 2
    fields = (np.arange(nu + nv), nu + nv + np.arange(npp))
    return K, b, fields, dict(A=A, G=G, D=D)
