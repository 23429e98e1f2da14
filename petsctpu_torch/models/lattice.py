"""2-D lattice gauge model (complex scalars).

Counterpart of petsctpu/models/lattice.py, assembled with array
operations in place of its per-site loop (the same entries, in the same
order, so H is byte-equal to the reference's).

Reference: src/ksp/ksp/examples/tutorials/ex39.c — the Wilson-fermion
lattice gauge operator H on a periodic n×n grid with 2 spin dofs per
site: per-site U(1) link phases u1 = exp(iθ1), u2 = exp(iθ2) with
θ ~ N(0, 1/β²) drawn Box-Muller from the reference's rand48 stream,
forward difference couplings in x ("right") and t ("down"), a quark
mass ρ on the spin diagonal, all scaled by 1/(2h). H is Hermitian;
the solve target is the normal-equation operator H² (ex39.c:144
MatMatMult(H, H)).

DOF numbering matches the single-process DMDA: global index
(y·n + x)·2 + c (x fastest within a row of sites, c = spin). The
drand48 stream (core/random.Rand48, PETSc seed 0x12345678) makes the
operator entry-exact equal to the complex oracle's
(tests/data/ex39_H.bin).
"""

from __future__ import annotations

import numpy as np
import scipy.sparse as sp

from petsctpu_torch.core.random import Rand48


def _cmul(ar, ai, br, bi):
    """(a·b).real, (a·b).imag as CPython's complex product computes
    them (numpy's vectorised complex multiply may fuse the two terms)."""
    return ar * br - ai * bi, ar * bi + ai * br


def lattice_gauge_2d(n: int = 6, beta: float = 1.0, rho: float = 1.0,
                     h: float = 1.0, rng: Rand48 = None):
    """Assemble H (complex CSR, shape (2n², 2n²)). Draw order follows
    ex39.c's x-outer / y-inner site loop, two PetscRandomGetValueReal
    draws per site; each site adds its 18 entries in the reference's
    order (centre, right, down)."""
    rng = rng or Rand48()
    rho = rho / (2.0 * h)
    N = 2 * n * n
    v = rng.get_values(2 * n * n)
    r1 = 1.0 - v[0::2]
    r2 = v[1::2]
    R = np.sqrt(-2.0 * np.log(r1))
    cth = np.cos(2.0 * np.pi * r2)
    sth = np.sin(2.0 * np.pi * r2)
    u1 = np.exp(1j * (R * cth / beta))
    u2 = np.exp(1j * (R * sth / beta))

    x, y = np.divmod(np.arange(n * n), n)        # site s = x·n + y

    def gid(xx, yy, c):
        return ((yy % n) * n + (xx % n)) * 2 + c

    # -1j·u2 as the reference's scalar product (-0.0 - 1.0j)·u2
    mr, mi = _cmul(-0.0, -1.0, u2.real, u2.imag)
    miu2 = mr + 1j * mi
    rows, cols, vals = [], [], []

    def add(r, c, val):
        rows.append(r)
        cols.append(c)
        vals.append(np.broadcast_to(np.asarray(val, np.complex128),
                                    (n * n,)))

    add(gid(x, y, 0), gid(x, y, 0), rho)
    add(gid(x, y, 1), gid(x, y, 1), -rho)
    for (a, b, val) in ((0, 0, -u1), (1, 0, -u1), (0, 1, u1), (1, 1, u1)):
        add(gid(x + 1, y, a), gid(x, y, b), val)
        add(gid(x, y, b), gid(x + 1, y, a), np.conj(val))
    for (a, b, val) in ((0, 0, -u2), (1, 0, miu2), (0, 1, miu2),
                        (1, 1, np.conj(u2))):
        add(gid(x, y + 1, a), gid(x, y, b), val)
        add(gid(x, y, b), gid(x, y + 1, a), np.conj(val))

    # [18, sites] -> site-major, the reference's append order
    rows = np.stack(rows).T.reshape(-1)
    cols = np.stack(cols).T.reshape(-1)
    vals = np.stack(vals).T.reshape(-1)
    H = sp.coo_matrix((vals, (rows, cols)), shape=(N, N)).tocsr()
    H.sum_duplicates()
    H = H * (1.0 / (2.0 * h))
    H.sort_indices()
    return H


def lattice_gauge_system(n: int = 6, beta: float = 1.0,
                         rho: float = 1.0):
    """(HtH, Htb, H): the ex39 solve setup — b = e_0,
    Htb = Hᵀb (MatMultTranspose: NON-conjugating), HtH = H·H."""
    H = lattice_gauge_2d(n, beta, rho)
    N = H.shape[0]
    b = np.zeros(N, np.complex128)
    b[0] = 1.0
    Htb = H.T @ b
    HtH = (H @ H).tocsr()
    return HtH, Htb, H
