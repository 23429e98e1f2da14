"""Q1 plane-strain elasticity with variable E/nu (ksp ex49 model).

Reference: src/ksp/ksp/examples/tutorials/ex49.c — compressible plane
strain elasticity on the unit square, Q1 elements, 2 dof/node in DMDA
natural ordering (2*(j*(mx+1)+i) + c, c = 0:Ux, 1:Uy). Material
structures (ex49.c:920-1035): 0 = isotropic, 1 = step in x,
2 = checkerboard "brick" pattern, 3 = "sponge" (inclusion of width w
framed by t background elements, tiled).

Compression BCs (ex49.c:1292): Ux = ∓1 on the east/west edges, Uy = 0
there. The default path (ex49_1) is the SYMMETRIC reduction
(DMDABCApplySymmetricCompression ex49.c:1304): zero the BC rows of A
(unit diagonal), lift the Dirichlet values through f = −A·x_bc, and
extract the |x_bc| < 0.1 unconstrained block with MatGetSubMatrix's
keep-stored-zeros semantics (the reduced ILU(0) pattern depends on
them).

Element matrices and assembly reproduce the reference's fp evaluation
order bit-for-bit (see models/q1stokes.py for the shared machinery).
A copy of petsctpu/models/q1elasticity.py on the port's q1stokes,
mat/base and dm/decomp: host numpy/scipy, byte-equal to it.
"""

from __future__ import annotations

import numpy as np

from petsctpu_torch.models.q1stokes import (GP_W, GP_XI,  # noqa: F401
                                            _coo_sum_chronological,
                                            element_geometry, _ni)


def elasticity_stress_operator(GNx, J, E_gp, nu_gp):
    """FormStressOperatorQ1 ex49.c:512 vectorized over elements: full
    3×3 plane-strain D per gauss point. Returns Ke[nel, 8, 8]
    row-major (Ke[8*i+j] → [i, j])."""
    nel = E_gp.shape[0]
    Ke = np.zeros((nel, 8, 8))
    for p in range(4):
        B = np.zeros((3, 8, nel))
        B[0, 0::2] = GNx[p][0]
        B[1, 1::2] = GNx[p][1]
        B[2, 0::2] = GNx[p][1]
        B[2, 1::2] = GNx[p][0]
        E, nu = E_gp[:, p], nu_gp[:, p]
        factor = E / ((1.0 + nu) * (1.0 - 2.0 * nu))
        D0 = [[1.0 - nu, nu, 0.0 * nu],
              [nu, 1.0 - nu, 0.0 * nu],
              [0.0 * nu, 0.0 * nu, 0.5 * (1.0 - 2.0 * nu)]]
        # C order: D[i][j] = factor * D0 * w * J
        D = [[((factor * D0[i][j]) * GP_W[p]) * J[p] for j in range(3)]
             for i in range(3)]
        # C loop nest i,j,k,l: per-(i,j) adds in (k,l) order, p outer
        for k in range(3):
            for l in range(3):
                Ke += np.moveaxis(
                    (B[k][:, None, :] * D[k][l][None, None, :])
                    * B[l][None, :, :], 2, 0)
    return Ke


def ex49_coefficients(mx, my, c_str=3, **params):
    """E/nu per element per gauss point (ex49.c:920-1035). All four
    coefficient structures; body forces are zero in every one."""
    dx, dy = 1.0 / mx, 1.0 / my
    hx = (1.0 - dx) / (mx - 1) if mx > 1 else 1.0
    hy = (1.0 - dy) / (my - 1) if my > 1 else 1.0
    cx = 0.5 * dx + hx * np.arange(mx)
    cy = 0.5 * dy + hy * np.arange(my)
    CX, CY = np.meshgrid(cx, cy)
    X = CX.reshape(-1)
    nel = mx * my
    E = np.empty((nel, 4))
    nu = np.empty((nel, 4))
    if c_str == 0:
        E[:] = params.get("E", 1.0)
        nu[:] = params.get("nu", 0.33)
    elif c_str == 1:
        E0 = params.get("E0", 1.0)
        E1 = params.get("E1", 1.0)
        nu0 = params.get("nu0", 0.333)
        nu1 = params.get("nu1", 0.333)
        xc = params.get("xc", 0.5)
        E[:] = np.where(X > xc, E1, E0)[:, None]
        nu[:] = np.where(X > xc, nu1, nu0)[:, None]
    elif c_str == 2:
        values_E = np.asarray(params["brick_E"], float)
        values_nu = np.asarray(params["brick_nu"], float)
        span = params.get("span", 1)
        nb = len(values_E)
        i = np.tile(np.arange(mx), my)
        j = np.repeat(np.arange(my), mx)
        jj = (j // span) % nb
        idx = (jj + i // span) % nb
        E[:] = values_E[idx][:, None]
        nu[:] = values_nu[idx][:, None]
    elif c_str == 3:
        E0 = params.get("E0", 1.0)
        E1 = params.get("E1", 1.0)
        nu0 = params.get("nu0", 0.333)
        nu1 = params.get("nu1", 0.333)
        t = params.get("t", 1)
        w = params.get("w", 1)
        period = t + w + t
        i = np.tile(np.arange(mx), my)
        j = np.repeat(np.arange(my), mx)
        ci = i - (i // period) * period
        cj = j - (j // period) * period
        inc = ((ci >= t) & (ci < t + w) & (cj >= t) & (cj < t + w))
        E[:] = np.where(inc, E1, E0)[:, None]
        nu[:] = np.where(inc, nu1, nu0)[:, None]
    else:
        raise ValueError(f"unknown c_str {c_str}")
    return E, nu


def ex49_system(mx, my, c_str=3, **params):
    """Assemble the full elasticity operator A (no BCs) — scipy CSR
    with the reference's chronological duplicate summation."""
    Ni, GNx, J = element_geometry(mx, my)
    E, nu = ex49_coefficients(mx, my, c_str, **params)
    nel = mx * my
    nx1 = mx + 1
    n = 2 * nx1 * (my + 1)
    Ke = elasticity_stress_operator(GNx, J, E, nu)
    ei = np.tile(np.arange(mx), my)
    ej = np.repeat(np.arange(my), mx)
    node = np.stack([ej * nx1 + ei, (ej + 1) * nx1 + ei,
                     (ej + 1) * nx1 + ei + 1, ej * nx1 + ei + 1], 1)
    u_eqn = np.stack([2 * node[:, 0], 2 * node[:, 0] + 1,
                      2 * node[:, 1], 2 * node[:, 1] + 1,
                      2 * node[:, 2], 2 * node[:, 2] + 1,
                      2 * node[:, 3], 2 * node[:, 3] + 1], 1)
    rows = np.repeat(u_eqn, 8, axis=1).reshape(-1)
    cols = np.tile(u_eqn, (1, 8)).reshape(-1)
    vals = Ke.reshape(nel, 64).reshape(-1)
    return _coo_sum_chronological(rows, cols, vals, n)


def ex49_reduced_system(mx, my, c_str=3, **params):
    """DMDABCApplySymmetricCompression (ex49.c:1304): returns
    (AA, ff, is_unconstrained, x_bc) — the reduced SPD system the
    runex49 golden solves with default GMRES+ILU(0)."""
    from petsctpu_torch.mat.base import (csr_submatrix_keep_zeros,
                                         mat_zero_rows)

    A = ex49_system(mx, my, c_str, **params).tolil().tocsr()
    nx1 = mx + 1
    n = A.shape[0]
    iy, ix = np.meshgrid(np.arange(my + 1), np.arange(nx1),
                         indexing="ij")
    nid = iy * nx1 + ix
    east = nid[:, -1]
    west = nid[:, 0]
    x = np.zeros(n)
    x[2 * east] = -1.0
    x[2 * east + 1] = 0.0
    x[2 * west] = 1.0
    x[2 * west + 1] = 0.0
    bc = np.concatenate([2 * east, 2 * east + 1, 2 * west, 2 * west + 1])
    A = mat_zero_rows(A, bc, diag=1.0)
    keep = np.flatnonzero(np.abs(x) < 0.1)
    f = -(A @ x)
    AA = csr_submatrix_keep_zeros(A, keep, keep)
    return AA, f[keep], keep, x


def ex49_parallel_reduced_system(mx, my, size, c_str=3, **params):
    """The SAME reduced system as ex49_reduced_system but emulating a
    `size`-rank run of the reference: the DMDA process grid's PETSc
    global ordering (rank-major patches), per-rank element assembly
    with MatStash fp summation order, and MatMult_MPIAIJ diag-then-
    offdiag fp order for the Dirichlet lift.

    Returns (AA, ff, blocks, decomp) where blocks are the per-rank
    (start, end) row ranges of the REDUCED system (what PCASM's
    default one-subdomain-per-rank decomposition sees)."""
    from petsctpu_torch.dm.decomp import (DADecomp2D, coo_sum_parallel,
                                          mpiaij_matmult)
    from petsctpu_torch.mat.base import (csr_submatrix_keep_zeros,
                                         mat_zero_rows)

    nx1, ny1 = mx + 1, my + 1
    dec = DADecomp2D.create(nx1, ny1, dof=2, size=size)
    perm = dec.natural_to_petsc()
    n = 2 * nx1 * ny1

    # element contributions (identical per-element fp to the serial
    # path), tagged with assembling rank + chronological sequence
    Ni, GNx, J = element_geometry(mx, my)
    E, nu = ex49_coefficients(mx, my, c_str, **params)
    nel = mx * my
    Ke = elasticity_stress_operator(GNx, J, E, nu)
    ei = np.tile(np.arange(mx), my)
    ej = np.repeat(np.arange(my), mx)
    node = np.stack([ej * nx1 + ei, (ej + 1) * nx1 + ei,
                     (ej + 1) * nx1 + ei + 1, ej * nx1 + ei + 1], 1)
    u_eqn = np.stack([2 * node[:, 0], 2 * node[:, 0] + 1,
                      2 * node[:, 1], 2 * node[:, 1] + 1,
                      2 * node[:, 2], 2 * node[:, 2] + 1,
                      2 * node[:, 3], 2 * node[:, 3] + 1], 1)
    rows = perm[np.repeat(u_eqn, 8, axis=1).reshape(-1)]
    cols = perm[np.tile(u_eqn, (1, 8)).reshape(-1)]
    vals = Ke.reshape(-1)
    erank = np.repeat(dec.element_owner(), 64)
    eseq = np.repeat(dec.element_order(), 64)

    ranges = dec.petsc_row_ranges()
    row_owner = np.empty(n, np.int64)
    for r, (s, e) in enumerate(ranges):
        row_owner[s:e] = r
    A = coo_sum_parallel(rows, cols, vals, erank, eseq, row_owner, n)

    # BCs in petsc ordering
    iy, ix = np.meshgrid(np.arange(ny1), np.arange(nx1), indexing="ij")
    nid = (iy * nx1 + ix)
    east, west = nid[:, -1].ravel(), nid[:, 0].ravel()
    x = np.zeros(n)
    x[perm[2 * east]] = -1.0
    x[perm[2 * west]] = 1.0
    bc = perm[np.concatenate([2 * east, 2 * east + 1,
                              2 * west, 2 * west + 1])]
    A = mat_zero_rows(A, bc, diag=1.0)
    keep = np.flatnonzero(np.abs(x) < 0.1)
    f = -mpiaij_matmult(A, x, row_owner)
    AA = csr_submatrix_keep_zeros(A, keep, keep)

    # reduced per-rank contiguous blocks (keep is sorted, so rank
    # boundaries stay contiguous in the reduced numbering)
    blocks = []
    pos = 0
    for (s, e) in ranges:
        cnt = int(((keep >= s) & (keep < e)).sum())
        blocks.append((pos, pos + cnt))
        pos += cnt
    return AA, f[keep], blocks, dec
