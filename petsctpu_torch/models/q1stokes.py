"""Q1-Q1 stabilized variable-viscosity Stokes (ksp ex43 model).

Counterpart of petsctpu/models/q1stokes.py: the same host numpy
assembly, whose A, B and f equal the reference's byte for byte.

Reference: src/ksp/ksp/examples/tutorials/ex43.c (contributed by Dave
May) — incompressible Stokes on the unit square, equal-order Q1
velocity/pressure elements stabilized with Bochev's polynomial
projection (FormStabilisationOperatorQ1 ex43.c:631), free-slip on all
four sides (DMDABCApplyFreeSlip ex43.c:1843: normal velocity rows
zeroed with unit diagonal via MatZeroRows). DOF layout is the DMDA
natural ordering: 3*(j*(mx+1)+i) + c with c = 0:Vx, 1:Vy, 2:P.

Two operators are assembled, as in the reference:
  A (AssembleA_Stokes ex43.c:758):   [K  G; D  C]   (C = stabilization)
  B (AssembleA_PCStokes ex43.c:831): [K  G; 0  M/eta] (PC matrix)

Assembly reproduces the reference's floating-point evaluation order
(per-gauss-point accumulation, chronological duplicate summation) so
the ex43 golden monitor streams match digit for digit. Coefficient
structures: c_str 0 = SolCx (analytic; models/solcx.py), 1 = square
sinker, 2 = circular sinker, 3 = circle+rotated-rectangle inclusion
(ex43.c:1308-1450).
"""

from __future__ import annotations

import numpy as np
import scipy.sparse as sp

_G = 0.57735026919           # the reference's truncated Gauss constant
GP_XI = np.array([[-_G, -_G], [-_G, _G], [_G, _G], [_G, -_G]])
GP_W = np.ones(4)


def _ni(xi, eta):
    return np.array([0.25 * (1 - xi) * (1 - eta),
                     0.25 * (1 - xi) * (1 + eta),
                     0.25 * (1 + xi) * (1 + eta),
                     0.25 * (1 + xi) * (1 - eta)])


def _gni(xi, eta):
    return np.array([
        [-0.25 * (1 - eta), -0.25 * (1 + eta),
         0.25 * (1 + eta), 0.25 * (1 - eta)],
        [-0.25 * (1 - xi), 0.25 * (1 - xi),
         0.25 * (1 + xi), -0.25 * (1 + xi)]])


def _gnx(gni, cx, cy):
    """ConstructQ12D_GNx ex43.c:115 — jacobian from the 4 corner
    coords. cx, cy: [4] or [4, nel] (vectorized over elements; the
    4-term jacobian sums accumulate sequentially like the C loop —
    absolute node coordinates make per-element ulp differences that
    the digit-parity tests are sensitive to)."""
    J00 = J01 = J10 = J11 = 0.0
    for i in range(4):
        J00 = J00 + gni[0][i] * cx[i]
        J01 = J01 + gni[0][i] * cy[i]
        J10 = J10 + gni[1][i] * cx[i]
        J11 = J11 + gni[1][i] * cy[i]
    J = (J00 * J11) - (J01 * J10)
    iJ00, iJ01, iJ10, iJ11 = J11 / J, -J01 / J, -J10 / J, J00 / J
    gnx = np.stack([
        np.stack([gni[0][i] * iJ00 + gni[1][i] * iJ01 for i in range(4)]),
        np.stack([gni[0][i] * iJ10 + gni[1][i] * iJ11 for i in range(4)]),
    ])
    return gnx, J


def element_geometry(mx, my):
    """Per-gauss-point Ni [4,4]; per-element GNx [4gp, 2, 4, nel] and
    detJ [4gp, nel] from the DMDA uniform coordinates x_i = i/mx."""
    hx, hy = 1.0 / mx, 1.0 / my
    xs = 0.0 + hx * np.arange(mx + 1)
    ys = 0.0 + hy * np.arange(my + 1)
    ei = np.tile(np.arange(mx), my)
    ej = np.repeat(np.arange(my), mx)
    # local node order (GetElementCoords ex43.c:745): (i,j), (i,j+1),
    # (i+1,j+1), (i+1,j)
    cx = np.stack([xs[ei], xs[ei], xs[ei + 1], xs[ei + 1]])
    cy = np.stack([ys[ej], ys[ej + 1], ys[ej + 1], ys[ej]])
    Ni, GNx, J = [], [], []
    for p in range(4):
        xi, eta = GP_XI[p]
        Ni.append(_ni(xi, eta))
        gnx, j = _gnx(_gni(xi, eta), cx, cy)
        GNx.append(gnx)
        J.append(j)
    return np.array(Ni), np.array(GNx), np.array(J)


def stress_operator(Ni, GNx, J, eta_gp):
    """FormStressOperatorQ1 ex43.c:528 vectorized over elements.
    GNx [4,2,4,nel], J [4,nel], eta_gp [nel,4]. Returns
    Ae[nel, 8, 8] in the reference's Ke[i+8*j] storage (row = j,
    col = i; symmetric anyway)."""
    nel = eta_gp.shape[0]
    Ae = np.zeros((nel, 8, 8))
    for p in range(4):
        B = np.zeros((3, 8, nel))
        B[0, 0::2] = GNx[p][0]
        B[1, 1::2] = GNx[p][1]
        B[2, 0::2] = GNx[p][1]
        B[2, 1::2] = GNx[p][0]
        tDs = 2.0 * GP_W[p] * J[p] * eta_gp[:, p]       # [nel]
        tD = (tDs, tDs, GP_W[p] * J[p] * eta_gp[:, p])
        for k in range(3):
            term = (B[k][:, None, :] * tD[k][None, None, :]
                    ) * B[k][None, :, :]                # [8i, 8j, nel]
            Ae += np.moveaxis(term, 2, 0)
    return Ae


def gradient_operator(Ni, GNx, J):
    """FormGradientOperatorQ1 ex43.c:577. Returns Ge[nel, 8, 4]
    row-major (row = 2*i+di u-dof, col = p node)."""
    nel = J.shape[1]
    Ge = np.zeros((nel, 8, 4))
    for p in range(4):
        fac = GP_W[p] * J[p]                            # [nel]
        for i in range(4):
            for di in range(2):
                Ge[:, 2 * i + di] -= (GNx[p][di][i][:, None]
                                      * Ni[p][None, :]) * fac[:, None]
    return Ge


def stabilisation_operator(Ni, GNx, J, eta_gp, mass_only=False):
    """FormStabilisationOperatorQ1 / FormScaledMassMatrixOperatorQ1
    (ex43.c:631/:673). Returns Ce[nel, 4, 4]."""
    nel = eta_gp.shape[0]
    base = np.zeros((nel, 4, 4))
    for p in range(4):
        fac = (GP_W[p] * J[p])[:, None, None]
        NN = Ni[p][:, None] * Ni[p][None, :]
        if mass_only:
            # C order: fac*Ni_p[i]*Ni_p[j] → (fac*Ni_i)*Ni_j
            base -= (fac * Ni[p][None, :, None]) * Ni[p][None, None, :]
        else:
            # C order: fac*(Ni_i*Ni_j − 0.0625)
            base -= fac * (NN[None] - 0.0625)
    eta_avg = np.zeros(nel)
    for p in range(4):
        eta_avg = eta_avg + eta_gp[:, p]
    fac2 = 1.0 / ((1.0 / 4.0) * eta_avg)
    return fac2[:, None, None] * base


def momentum_rhs(Ni, GNx, J, fx_gp, fy_gp):
    """FormMomentumRhsQ1 ex43.c:715. Returns Fe[nel, 8]."""
    nel = fx_gp.shape[0]
    Fe = np.zeros((nel, 8))
    for p in range(4):
        fac = (GP_W[p] * J[p])[:, None]                 # [nel,1]
        Fe[:, 0::2] += (fac * Ni[p][None, :]) * fx_gp[:, p][:, None]
        Fe[:, 1::2] += (fac * Ni[p][None, :]) * fy_gp[:, p][:, None]
    return Fe


def _coo_sum_chronological(rows, cols, vals, n):
    """CSR with duplicates summed in insertion order — matches
    MatSetValues ADD_VALUES' immediate `ap[i] += v` accumulation.

    One stable argsort of the key row·n + col (below 2⁶³) gives the
    order of petsctpu's three-key lexsort (row, col, insertion); each
    (row, col) group is then summed from 0.0 in that order, one position
    of every group at a time, the same additions as np.add.at's
    sequential ones."""
    key = rows.astype(np.int64) * np.int64(n) + cols
    order = np.argsort(key, kind="stable")
    key, v = key[order], vals[order]
    new = np.ones(len(key), bool)
    new[1:] = key[1:] != key[:-1]
    starts = np.flatnonzero(new)
    counts = np.diff(np.append(starts, len(key)))
    sums = 0.0 + v[starts]                 # the first addition, from 0.0
    for k in range(1, int(counts.max())):
        sel = np.flatnonzero(counts > k)
        sums[sel] += v[starts[sel] + k]
    r, c = np.divmod(key[starts], np.int64(n))
    return sp.csr_matrix((sums, (r, c)), shape=(n, n))


def element_coefficients(mx, my, c_str=0, use_gp_coords=False, **params):
    """eta/fx/fy per element per gauss point (ex43.c:1299-1452).
    Element centroids follow the da_prop uniform coordinates:
    x_i = 0.5*dx + i*(1-dx)/(mx-1)."""
    dx, dy = 1.0 / mx, 1.0 / my
    hx = (1.0 - dx) / (mx - 1) if mx > 1 else 1.0
    hy = (1.0 - dy) / (my - 1) if my > 1 else 1.0
    cx = 0.5 * dx + hx * np.arange(mx)
    cy = 0.5 * dy + hy * np.arange(my)
    CX, CY = np.meshgrid(cx, cy)                       # [my, mx]
    # gauss-point global coords (used when use_gp_coords)
    ex = dx * np.arange(mx)
    ey = dy * np.arange(my)
    nel = mx * my
    X = np.empty((nel, 4))
    Y = np.empty((nel, 4))
    for p in range(4):
        # gp coords by Q1 interpolation of corner coords
        Nip = _ni(*GP_XI[p])
        nx_ = Nip @ np.array([0.0, 0.0, dx, dx])
        ny_ = Nip @ np.array([0.0, dy, dy, 0.0])
        X[:, p] = (ex[None, :] + nx_ + np.zeros((my, 1))).reshape(-1)
        Y[:, p] = (ey[:, None] + ny_ + np.zeros((1, mx))).reshape(-1)
    if not use_gp_coords:
        X = np.repeat(CX.reshape(-1, 1), 4, axis=1)
        Y = np.repeat(CY.reshape(-1, 1), 4, axis=1)

    eta = np.empty((nel, 4))
    fx = np.zeros((nel, 4))
    fy = np.zeros((nel, 4))
    if c_str == 0:
        eta0 = params.get("eta0", 1.0)
        eta1 = params.get("eta1", 1.0)
        xc = params.get("xc", 0.5)
        nz = params.get("nz", 1)
        eta[:] = np.where(X > xc, eta1, eta0)
        fy[:] = np.sin(nz * np.pi * Y) * np.cos(1.0 * np.pi * X)
    elif c_str == 1:
        eta0 = params.get("eta0", 1.0)
        eta1 = params.get("eta1", 1.0)
        bdx = params.get("dx", 0.5)
        bdy = params.get("dy", 0.5)
        inside = ((X > -0.5 * bdx + 0.5) & (X < 0.5 * bdx + 0.5)
                  & (Y > -0.5 * bdy + 0.5) & (Y < 0.5 * bdy + 0.5))
        eta[:] = np.where(inside, eta1, eta0)
        fy[:] = np.where(inside, -1.0, 0.0)
    elif c_str == 2:
        eta0 = params.get("eta0", 1.0)
        eta1 = params.get("eta1", 1.0)
        r = params.get("r", 0.25)
        inside = (X - 0.5) ** 2 + (Y - 0.5) ** 2 < r * r
        eta[:] = np.where(inside, eta1, eta0)
        fy[:] = np.where(inside, -1.0, 0.0)
    elif c_str == 3:
        eta0 = params.get("eta0", 1.0)
        eta1 = params.get("eta1", 1.0)
        r = params.get("r", 0.25)
        c0x = params.get("c0x", 0.35)
        c0y = params.get("c0y", 0.35)
        s0x = params.get("s0x", 0.7)
        s0y = params.get("s0y", 0.7)
        bdx = params.get("dx", 0.25)
        bdy = params.get("dy", 0.25)
        phi = params.get("phi", 25.0) * np.pi / 180
        rad2 = (X - c0x) ** 2 + (Y - c0y) ** 2
        rot_x = (X - s0x) * np.cos(phi) + (Y - s0y) * np.sin(phi)
        rot_y = -(X - s0x) * np.sin(phi) + (Y - s0y) * np.cos(phi)
        inside = ((rad2 < r * r)
                  | ((np.abs(rot_x) < bdx / 2) & (np.abs(rot_y) < bdy / 2)))
        eta[:] = np.where(inside, eta1, eta0)
        fy[:] = np.where(inside, -1.0, -0.2)
    else:
        raise ValueError(f"unknown c_str {c_str}")
    return eta, fx, fy


def q1q1_stokes_system(mx, my, c_str=0, use_gp_coords=False, **params):
    """Assemble (A, B, f) with free-slip BCs applied — the exact
    discrete system of ex43's solve_stokes_2d_coupled. Returns scipy
    CSR A (operator), B (PC matrix) and numpy rhs f."""
    Ni, GNx, J = element_geometry(mx, my)
    eta, fx, fy = element_coefficients(mx, my, c_str, use_gp_coords,
                                       **params)
    nel = mx * my
    nx1 = mx + 1
    n = 3 * nx1 * (my + 1)

    Ae = stress_operator(Ni, GNx, J, eta)              # [nel,8,8]
    Ge = gradient_operator(Ni, GNx, J)                 # [nel,8,4]
    Ce = stabilisation_operator(Ni, GNx, J, eta)       # [nel,4,4]
    Me = stabilisation_operator(Ni, GNx, J, eta, mass_only=True)
    Fe = momentum_rhs(Ni, GNx, J, fx, fy)              # [nel,8]

    # element → global dof maps (DMDAGetElementEqnums_up ex43.c:236)
    ei = np.tile(np.arange(mx), my)
    ej = np.repeat(np.arange(my), mx)
    node = np.stack([ej * nx1 + ei, (ej + 1) * nx1 + ei,
                     (ej + 1) * nx1 + ei + 1, ej * nx1 + ei + 1], 1)
    u_eqn = np.stack([3 * node[:, 0], 3 * node[:, 0] + 1,
                      3 * node[:, 1], 3 * node[:, 1] + 1,
                      3 * node[:, 2], 3 * node[:, 2] + 1,
                      3 * node[:, 3], 3 * node[:, 3] + 1], 1)
    p_eqn = 3 * node + 2                               # [nel,4]

    def emit(matC):
        """COO with entries in the reference's chronological call
        order: per element (ej outer, ei inner) the blocks A, G, [D,]
        C — duplicate-sum order then matches MatSetValues ADD."""
        rblk, cblk, vblk = [], [], []
        # Ae: storage Ke[i+8j] → (row u[j], col u[i], Ae[:, i, j]);
        # flat order (j slow, i fast) = Ae transposed row-major
        rblk.append(np.repeat(u_eqn, 8, axis=1))       # [nel, 64]
        cblk.append(np.tile(u_eqn, (1, 8)))
        vblk.append(np.swapaxes(Ae, 1, 2).reshape(nel, 64))
        # Ge: row-major [8,4] rows u, cols p
        rblk.append(np.repeat(u_eqn, 4, axis=1))       # [nel, 32]
        cblk.append(np.tile(p_eqn, (1, 8)))
        vblk.append(Ge.reshape(nel, 32))
        if matC is not None:
            # De = Geᵀ: rows p, cols u
            rblk.append(np.repeat(p_eqn, 8, axis=1))   # [nel, 32]
            cblk.append(np.tile(u_eqn, (1, 4)))
            vblk.append(np.swapaxes(Ge, 1, 2).reshape(nel, 32))
        # Ce (or scaled mass): row-major [4,4] rows/cols p
        rblk.append(np.repeat(p_eqn, 4, axis=1))       # [nel, 16]
        cblk.append(np.tile(p_eqn, (1, 4)))
        vblk.append((matC if matC is not None else Me).reshape(nel, 16))
        rows = np.concatenate(rblk, axis=1).reshape(-1)
        cols = np.concatenate(cblk, axis=1).reshape(-1)
        vals = np.concatenate(vblk, axis=1).reshape(-1)
        return rows, cols, vals

    rA, cA, vA = emit(Ce)
    A = _coo_sum_chronological(rA, cA, vA, n)
    rB, cB, vB = emit(None)
    B = _coo_sum_chronological(rB, cB, vB, n)

    f = np.zeros(n)
    np.add.at(f, u_eqn.reshape(-1), Fe.reshape(-1))

    # free-slip BCs (DMDABCApplyFreeSlip ex43.c:1843): zero normal-
    # velocity rows, unit diagonal, zero rhs
    iy, ix = np.meshgrid(np.arange(my + 1), np.arange(nx1),
                         indexing="ij")
    nid = iy * nx1 + ix
    bc = np.concatenate([
        3 * nid[-1, :] + 1,       # NORTH: Vy
        3 * nid[:, -1],           # EAST:  Vx
        3 * nid[0, :] + 1,        # SOUTH: Vy
        3 * nid[:, 0],            # WEST:  Vx
    ])
    bc = np.unique(bc)
    for M in (A, B):
        for r in bc:
            M.data[M.indptr[r]:M.indptr[r + 1]] = 0.0
        d = M.diagonal()
        d[bc] = 1.0
        M.setdiag(d)
    f[bc] = 0.0
    return A, B, f


def solcx_nodal_solution(mx, my, eta0=1.0, eta1=1.0, xc=0.5, nz=1):
    """X_analytic on the (mx+1)×(my+1) node grid (DMDACreateSolCx
    ex43.c:996), flat DMDA-ordered [3*(j*(mx+1)+i)+c]."""
    from petsctpu_torch.models.solcx import SolCx

    s = SolCx(eta0, eta1, xc, nz)
    hx, hy = 1.0 / mx, 1.0 / my
    xs = 0.0 + hx * np.arange(mx + 1)
    ys = 0.0 + hy * np.arange(my + 1)
    XX, YY = np.meshgrid(xs, ys)
    u, v, p = s.evaluate(XX.reshape(-1), YY.reshape(-1))
    out = np.empty(3 * (mx + 1) * (my + 1))
    out[0::3], out[1::3], out[2::3] = u, v, p
    return out


def integrate_errors(mx, my, X, X_analytic):
    """DMDAIntegrateErrors ex43.c:1071 verbatim: nodal-difference
    quadrature. Returns (h, p_L2, u_L2, u_H1)."""
    Ni, GNx, J = element_geometry(mx, my)
    nx1 = mx + 1
    ei = np.tile(np.arange(mx), my)
    ej = np.repeat(np.arange(my), mx)
    node = np.stack([ej * nx1 + ei, (ej + 1) * nx1 + ei,
                     (ej + 1) * nx1 + ei + 1, ej * nx1 + ei + 1], 1)
    du = X[3 * node] - X_analytic[3 * node]            # [nel,4]
    dv = X[3 * node + 1] - X_analytic[3 * node + 1]
    dp = X[3 * node + 2] - X_analytic[3 * node + 2]
    p_e = np.zeros(len(node))
    u_e = np.zeros(len(node))
    h1_e = np.zeros(len(node))
    for p in range(4):
        fac = GP_W[p] * J[p]
        for i in range(4):
            p_e = p_e + fac * Ni[p][i] * dp[:, i] * dp[:, i]
            u_e = u_e + fac * Ni[p][i] * (du[:, i] * du[:, i]
                                          + dv[:, i] * dv[:, i])
            h1_e = h1_e + fac * (
                GNx[p][0][i] * du[:, i] * GNx[p][0][i] * du[:, i]
                + GNx[p][1][i] * du[:, i] * GNx[p][1][i] * du[:, i]
                + GNx[p][0][i] * dv[:, i] * GNx[p][0][i] * dv[:, i]
                + GNx[p][1][i] * dv[:, i] * GNx[p][1][i] * dv[:, i])
    # h quirk: divides by the NODE count M = mx+1 (ex43.c:1118)
    h = 1.0 / (mx + 1)
    return (h, float(np.sqrt(np.sum(p_e))), float(np.sqrt(np.sum(u_e))),
            float(np.sqrt(np.sum(h1_e))))
