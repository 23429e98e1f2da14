"""Model problems: structured Laplacians (KSP ex2 / ex45 analogs).

A copy of the builders in petsctpu/models/poisson.py; they reproduce
the exact linear systems of the reference tutorials:
  * ex2 (src/ksp/ksp/examples/tutorials/ex2.c:90-100): 2-D 5-point
    Laplacian on an m×n grid, natural ordering Ii = i*n + j, diag 4,
    off-diag -1, exact solution = ones, b = A·1.
  * ex45 (3-D 7-point Poisson, src/ksp/ksp/examples/tutorials/ex45.c):
    built here in the same natural ordering with diag 6.
  * the oracle systems of the reference-exact MG stacks (pc/mg.py's
    make_full_mg_ref and friends): ksp ex34's cell-centred Neumann
    Laplacian, ex29's variable-ρ 2-D Poisson, ex45's exact
    discretization and ex54's Q1 Laplacian with a soft inclusion.
Matrices are built host-side with scipy and converted to device
formats by callers.
"""

from __future__ import annotations

import numpy as np
import scipy.sparse as sp


def laplacian_2d(m: int, n: int, dtype=np.float64):
    """5-point 2-D Laplacian, natural ordering (row-major in i)."""
    N = m * n
    Ii = np.arange(N)
    i = Ii // n
    j = Ii - i * n
    rows, cols, vals = [Ii], [Ii], [np.full(N, 4.0, dtype)]
    for cond, off in ((i > 0, -n), (i < m - 1, n), (j > 0, -1), (j < n - 1, 1)):
        r = Ii[cond]
        rows.append(r)
        cols.append(r + off)
        vals.append(np.full(len(r), -1.0, dtype))
    A = sp.coo_matrix((np.concatenate(vals),
                       (np.concatenate(rows), np.concatenate(cols))),
                      shape=(N, N)).tocsr()
    return A


def poisson_3d(m: int, n: int, p: int, dtype=np.float64):
    """7-point 3-D Laplacian (ex45-style), natural ordering Ii=(k*n+j)*m+i
    flattened as i fastest."""
    N = m * n * p
    Ii = np.arange(N)
    i = Ii % m
    j = (Ii // m) % n
    k = Ii // (m * n)
    rows, cols, vals = [Ii], [Ii], [np.full(N, 6.0, dtype)]
    for cond, off in ((i > 0, -1), (i < m - 1, 1),
                      (j > 0, -m), (j < n - 1, m),
                      (k > 0, -m * n), (k < p - 1, m * n)):
        r = Ii[cond]
        rows.append(r)
        cols.append(r + off)
        vals.append(np.full(len(r), -1.0, dtype))
    A = sp.coo_matrix((np.concatenate(vals),
                       (np.concatenate(rows), np.concatenate(cols))),
                      shape=(N, N)).tocsr()
    return A


def ex2_system(m: int = 8, n: int = 7, dtype=np.float64):
    """The ex2 linear system: A, b = A·1, u_exact = 1 (ex2.c:146-148)."""
    A = laplacian_2d(m, n, dtype)
    u = np.ones(m * n, dtype)
    b = A @ u
    return A, b, u


def ex45_system(m: int = 8, n: int = 8, p: int = 8, dtype=np.float64):
    A = poisson_3d(m, n, p, dtype)
    u = np.ones(m * n * p, dtype)
    b = A @ u
    return A, b, u


def cell_neumann_laplacian_3d(m: int, dtype=np.float64) -> sp.csr_matrix:
    """Cell-centered 7-point Neumann Laplacian on an m³ grid of cells,
    scaled by the face weights Hy·Hz/Hx etc. (ksp ex34.c ComputeMatrix,
    lines 173-267): each cell couples −w to every EXISTING neighbor and
    the diagonal counts only existing neighbors — a singular matrix
    with the constant null space. Row ordering i + m·j + m²·k."""
    H = 1.0 / m
    w = H                                  # Hy*Hz/Hx = H for the cube
    n = m ** 3
    idx = np.arange(n)
    i = idx % m
    j = (idx // m) % m
    k = idx // (m * m)
    rows, cols, vals = [], [], []
    diag = np.zeros(n, dtype)
    for di, dj, dk in ((1, 0, 0), (-1, 0, 0), (0, 1, 0), (0, -1, 0),
                       (0, 0, 1), (0, 0, -1)):
        ii, jj, kk = i + di, j + dj, k + dk
        ok = ((ii >= 0) & (ii < m) & (jj >= 0) & (jj < m)
              & (kk >= 0) & (kk < m))
        rows.append(idx[ok])
        cols.append((ii + m * jj + m * m * kk)[ok])
        vals.append(np.full(ok.sum(), -w, dtype))
        diag[ok] += w
    rows.append(idx)
    cols.append(idx)
    vals.append(diag)
    return sp.csr_matrix((np.concatenate(vals),
                          (np.concatenate(rows), np.concatenate(cols))),
                         shape=(n, n))


def ex34_system(m: int = 12, dtype=np.float64):
    """ksp ex34: cell-centered 3-D Neumann Poisson, forcing
    12π²·cos(2πx)cos(2πy)cos(2πz)·H³ with the mean removed
    (MatNullSpaceRemove — ex34.c ComputeRHS), exact solution
    cos·cos·cos. Returns (A, b, u_exact)."""
    A = cell_neumann_laplacian_3d(m, dtype)
    H = 1.0 / m
    c = np.cos(2 * np.pi * (np.arange(m) + 0.5) * H)
    u = (c[None, None, :] * c[None, :, None]
         * c[:, None, None]).reshape(-1).astype(dtype)
    b = 12 * np.pi ** 2 * u * H ** 3
    b = b - b.mean()
    return A, b, u


def ex29_system(m: int, neumann: bool = False, nu: float = 0.1,
                dtype=np.float64):
    """ksp ex29: vertex-centered 2-D variable-ρ (ρ=1 default) Poisson
    on an m×m grid, Gaussian forcing exp(−x²/ν)exp(−y²/ν)·Hx·Hy
    (ex29.c ComputeRHS). Dirichlet: boundary rows are decoupled
    diag-2ρ(HxdHy+HydHx) rows (ex29.c:169-171); Neumann: diagonal
    counts only existing neighbors (singular, constant null space,
    rhs mean-removed). Returns (A, b)."""
    Hx = Hy = 1.0 / (m - 1)
    HxdHy, HydHx = Hx / Hy, Hy / Hx
    idx = np.arange(m * m)
    i = idx % m
    j = idx // m
    rows, cols, vals = [], [], []
    if neumann:
        diag = np.zeros(m * m, dtype)
        for di, dj, w in ((-1, 0, HydHx), (1, 0, HydHx),
                          (0, -1, HxdHy), (0, 1, HxdHy)):
            ii, jj = i + di, j + dj
            ok = (ii >= 0) & (ii < m) & (jj >= 0) & (jj < m)
            rows.append(idx[ok])
            cols.append((ii + m * jj)[ok])
            vals.append(np.full(ok.sum(), -w, dtype))
            diag[ok] += w
        rows.append(idx)
        cols.append(idx)
        vals.append(diag)
    else:
        interior = (i > 0) & (i < m - 1) & (j > 0) & (j < m - 1)
        rows.append(idx)
        cols.append(idx)
        vals.append(np.full(m * m, 2.0 * (HxdHy + HydHx), dtype))
        for di, dj, w in ((-1, 0, HydHx), (1, 0, HydHx),
                          (0, -1, HxdHy), (0, 1, HxdHy)):
            ii, jj = i + di, j + dj
            rows.append(idx[interior])
            cols.append((ii + m * jj)[interior])
            vals.append(np.full(interior.sum(), -w, dtype))
    A = sp.csr_matrix((np.concatenate(vals),
                       (np.concatenate(rows), np.concatenate(cols))),
                      shape=(m * m, m * m))
    x = np.arange(m) * Hx
    g = np.exp(-x * x / nu)
    b = (g[None, :] * g[:, None] * Hx * Hy).reshape(-1).astype(dtype)
    if neumann:
        b = b - b.mean()
    return A, b


def ex45_true_system(m: int = 7, dtype=np.float64):
    """ksp ex45's EXACT discretization (ex45.c ComputeMatrix/RHS):
    vertex-centered 7-point Laplacian on m³ with face-weights
    HxHy/Hz etc., DECOUPLED boundary rows diag 2(HxHydHz+HxHzdHy+
    HyHzdHx); rhs = same boundary value, Hx·Hy·Hz interior. Returns
    (A, b)."""
    H = 1.0 / (m - 1)
    w = H                                   # HxHy/Hz = H on the cube
    bdiag = 2.0 * 3 * w
    n = m ** 3
    idx = np.arange(n)
    i = idx % m
    j = (idx // m) % m
    k = idx // (m * m)
    interior = ((i > 0) & (i < m - 1) & (j > 0) & (j < m - 1)
                & (k > 0) & (k < m - 1))
    rows = [idx]
    cols = [idx]
    vals = [np.where(interior, 2.0 * 3 * w, bdiag).astype(dtype)]
    for di, dj, dk in ((1, 0, 0), (-1, 0, 0), (0, 1, 0), (0, -1, 0),
                       (0, 0, 1), (0, 0, -1)):
        ii, jj, kk = i + di, j + dj, k + dk
        rows.append(idx[interior])
        cols.append((ii + m * jj + m * m * kk)[interior])
        vals.append(np.full(interior.sum(), -w, dtype))
    A = sp.csr_matrix((np.concatenate(vals),
                       (np.concatenate(rows), np.concatenate(cols))),
                      shape=(n, n))
    b = np.where(interior, H ** 3, bdiag).astype(dtype)
    return A, b


def ex54_system(ne: int = 4, soft_alpha: float = 1e-3,
                dtype=np.float64):
    """ksp ex54: Q1 FEM Laplacian on an ne×ne element grid (nodes
    (ne+1)²) with a soft circular inclusion (α inside radius 0.25) and
    the bottom-row BC applied by the modified element DD2 (ex54.c:
    60-120). Returns (A, b, coords)."""
    n1 = ne + 1
    M = n1 * n1
    h = 1.0 / ne
    DD1 = np.array([
        [0.66666666666666663, -0.16666666666666669,
         -0.33333333333333343, -0.16666666666666666],
        [-0.16666666666666669, 0.66666666666666663,
         -0.16666666666666666, -0.33333333333333343],
        [-0.33333333333333343, -0.16666666666666666,
         0.66666666666666663, -0.16666666666666663],
        [-0.16666666666666666, -0.33333333333333343,
         -0.16666666666666663, 0.66666666666666663]])
    DD2 = DD1.copy()
    for i in range(4):
        for j in range(4):
            if i < 2 or j < 2:
                DD2[i, j] = 0.1 * DD1[i, j] if i == j else 0.0
    rows, cols, vals = [], [], []
    for Ii in range(M):
        j, i = Ii // n1, Ii % n1
        if i < ne and j < ne:
            x, y = h * i, h * j
            idx = np.array([Ii, Ii + 1, Ii + n1 + 1, Ii + n1])
            radius = np.sqrt((x - .5 + h / 2) ** 2 + (y - .5 + h / 2) ** 2)
            alpha = soft_alpha if radius < 0.25 else 1.0
            DD = alpha * (DD1 if j > 0 else DD2)
            rows.append(np.repeat(idx, 4))
            cols.append(np.tile(idx, 4))
            vals.append(DD.reshape(-1))
    A = sp.csr_matrix((np.concatenate(vals),
                       (np.concatenate(rows), np.concatenate(cols))),
                      shape=(M, M)).astype(dtype)
    b = np.zeros(M, dtype)
    jj = np.arange(M) // n1
    b[jj > 0] = h * h
    xs = h * (np.arange(M) % n1)
    ys = h * (np.arange(M) // n1)
    coords = np.stack([xs, ys], axis=1)
    return A, b, coords
