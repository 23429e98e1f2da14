"""1-D first-order wave system on a periodic grid — KSP ex28.

A copy of petsctpu/models/wave1d.py (host numpy/scipy builders).

Reference: src/ksp/ksp/examples/tutorials/ex28.c — "Solves 1D wave
equation using multigrid": a dof=2 periodic DMDA (DMDACreate1d with
DMDA_BOUNDARY_PERIODIC, ex28.c:24) whose ComputeMatrix (ex28.c:107)
assembles, per grid point i with Hx = 2π/mx and λ = 2·Hx, the
interleaved 2×2-block rows

    row (i,0):  Hx·u_i + λ·v_{i-1} − λ·v_{i+1}
    row (i,1):  λ·u_{i-1} + Hx·v_i − λ·u_{i+1}

(periodic wrap), ComputeRHS (ex28.c:88) sets b = Hx·x_app where x_app
is the application-context vector holding the previous solution, and
ComputeInitialSolution (ex28.c:62) seeds both components with
sin(i·Hx).  main() advances the wave by 10 successive KSPSolves of
A·x_new = Hx·x_old (ex28.c:44-47).

State layout: flat [mx*2] interleaved per grid point (the DMDA dof=2
layout), components (u, v).
"""

from __future__ import annotations

import numpy as np
import scipy.sparse as sp


def ex28_matrix(mx: int) -> sp.csr_matrix:
    """ComputeMatrix ex28.c:107 on an mx-point periodic grid."""
    hx = 2.0 * np.pi / mx
    lam = 2.0 * hx
    rows, cols, vals = [], [], []
    for i in range(mx):
        im, ip = (i - 1) % mx, (i + 1) % mx
        rows += [2 * i, 2 * i, 2 * i]
        cols += [2 * i, 2 * im + 1, 2 * ip + 1]
        vals += [hx, lam, -lam]
        rows += [2 * i + 1, 2 * i + 1, 2 * i + 1]
        cols += [2 * im, 2 * i + 1, 2 * ip]
        vals += [lam, hx, -lam]
    return sp.csr_matrix((vals, (rows, cols)), shape=(2 * mx, 2 * mx))


def ex28_initial(mx: int) -> np.ndarray:
    """ComputeInitialSolution ex28.c:62: u_i = v_i = sin(i·Hx)."""
    hx = 2.0 * np.pi / mx
    s = np.sin(np.arange(mx) * hx)
    x = np.empty(2 * mx)
    x[0::2] = s
    x[1::2] = s
    return x


def ex28_rhs(mx: int, x_prev: np.ndarray) -> np.ndarray:
    """ComputeRHS ex28.c:88: b = Hx · x_prev."""
    return (2.0 * np.pi / mx) * np.asarray(x_prev)
