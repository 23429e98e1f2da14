"""SolCx: analytic variable-viscosity Stokes benchmark solution.

Counterpart of petsctpu/models/solcx.py (the same numpy code).

The reference ships a Maple-generated closed form (ex43-solCx.h,
included by src/ksp/ksp/examples/tutorials/ex43.c:38, contributed by
Mirko Velic) for incompressible Stokes flow on the unit square with a
vertical viscosity jump at x = xc and forcing

    f = (0, sin(nz*pi*y) * cos(pi*x)),

free-slip on all four sides. This module derives the same solution
independently via the stream-function formulation: psi = phi(x)
sin(k y) with k = nz*pi reduces Stokes to the 4th-order constant-
coefficient ODE

    eta * (phi'''' - 2 k^2 phi'' + k^4 phi) = -pi * sin(pi x)

in each viscosity region, with free-slip end conditions
phi = phi'' = 0 at x in {0, 1} and interface continuity of
velocity (phi, phi'), shear stress eta*(phi'' + k^2 phi), and
normal stress -P + 2 eta k phi' at x = xc, where the pressure
amplitude is P = (eta*(phi''' - k^2 phi') - cos(pi x)) / k.

The resulting 8x8 linear system is solved numerically in extended
precision; fields are

    u = k phi cos(k y),   v = -phi' sin(k y),   p = P cos(k y).

Validated against the reference's evaluate_solCx to ~1e-12 relative.
"""

from __future__ import annotations

import numpy as np


def _phi_basis(k, x):
    """Homogeneous basis [cosh(kx), sinh(kx), x cosh(kx), x sinh(kx)]
    and derivatives up to order 3. Returns array [4 deriv][4 basis]."""
    c, s = np.cosh(k * x), np.sinh(k * x)
    b0 = np.array([c, s, x * c, x * s])
    b1 = np.array([k * s, k * c, c + k * x * s, s + k * x * c])
    b2 = np.array([k * k * c, k * k * s,
                   2 * k * s + k * k * x * c,
                   2 * k * c + k * k * x * s])
    b3 = np.array([k ** 3 * s, k ** 3 * c,
                   3 * k * k * c + k ** 3 * x * s,
                   3 * k * k * s + k ** 3 * x * c])
    return np.stack([b0, b1, b2, b3])


class SolCx:
    """Coefficient solve happens once in __init__; evaluate() is cheap."""

    def __init__(self, eta0=1.0, eta1=1.0, xc=0.5, nz=1):
        ld = np.longdouble
        k = ld(nz) * ld(np.pi)
        pi = ld(np.pi)
        self.k, self.pi = k, pi
        self.eta = (ld(eta0), ld(eta1))
        self.xc = ld(xc)
        # particular solution amplitude per region: phi_p = cp*sin(pi x)
        self.cp = tuple(-pi / (e * (pi * pi + k * k) ** 2)
                        for e in self.eta)

        def phi_derivs_particular(r, x):
            cp = self.cp[r]
            return np.array([cp * np.sin(pi * x),
                             cp * pi * np.cos(pi * x),
                             -cp * pi * pi * np.sin(pi * x),
                             -cp * pi ** 3 * np.cos(pi * x)])

        self._pp = phi_derivs_particular
        e0, e1 = self.eta
        M = np.zeros((8, 8), dtype=ld)
        rhs = np.zeros(8, dtype=ld)
        B0 = _phi_basis(k, ld(0))
        B1 = _phi_basis(k, ld(1))
        Bc = _phi_basis(k, self.xc)
        p0 = phi_derivs_particular(0, ld(0))
        p1 = phi_derivs_particular(1, ld(1))
        pc0 = phi_derivs_particular(0, self.xc)
        pc1 = phi_derivs_particular(1, self.xc)
        # rows 0-1: phi1(0)=0, phi1''(0)=0
        M[0, :4] = B0[0]
        rhs[0] = -p0[0]
        M[1, :4] = B0[2]
        rhs[1] = -p0[2]
        # rows 2-3: phi2(1)=0, phi2''(1)=0
        M[2, 4:] = B1[0]
        rhs[2] = -p1[0]
        M[3, 4:] = B1[2]
        rhs[3] = -p1[2]
        # rows 4-5: [phi]=0, [phi']=0 at xc
        for d, row in ((0, 4), (1, 5)):
            M[row, :4] = Bc[d]
            M[row, 4:] = -Bc[d]
            rhs[row] = pc1[d] - pc0[d]
        # row 6: shear stress  eta*(phi'' + k^2 phi) continuous
        M[6, :4] = e0 * (Bc[2] + k * k * Bc[0])
        M[6, 4:] = -e1 * (Bc[2] + k * k * Bc[0])
        rhs[6] = (e1 * (pc1[2] + k * k * pc1[0])
                  - e0 * (pc0[2] + k * k * pc0[0]))
        # row 7: normal stress  -P + 2 eta k phi' continuous, with
        # P = (eta*(phi''' - k^2 phi') - cos(pi x)) / k; the cos(pi x)
        # term is identical on both sides and cancels.
        M[7, :4] = -e0 * (Bc[3] - k * k * Bc[1]) / k + 2 * e0 * k * Bc[1]
        M[7, 4:] = -(-e1 * (Bc[3] - k * k * Bc[1]) / k
                     + 2 * e1 * k * Bc[1])
        rhs[7] = ((-e1 * (pc1[3] - k * k * pc1[1]) / k
                   + 2 * e1 * k * pc1[1])
                  - (-e0 * (pc0[3] - k * k * pc0[1]) / k
                     + 2 * e0 * k * pc0[1]))
        # longdouble solve via scaled Gaussian elimination (numpy's
        # linalg is float64-only); partial pivoting
        self.coef = self._solve_ld(M, rhs)

    @staticmethod
    def _solve_ld(M, rhs):
        n = len(rhs)
        A = np.concatenate([M, rhs[:, None]], axis=1)
        for c in range(n):
            p = c + int(np.argmax(np.abs(A[c:, c])))
            if p != c:
                A[[c, p]] = A[[p, c]]
            A[c] = A[c] / A[c, c]
            for r in range(n):
                if r != c and A[r, c] != 0:
                    A[r] = A[r] - A[r, c] * A[c]
        return A[:, n].copy()

    def _phi(self, x):
        """phi and derivatives 0..3 at scalar/array x (longdouble)."""
        x = np.asarray(x, dtype=np.longdouble)
        r = (x > self.xc).astype(int)
        B = _phi_basis(self.k, x)                 # [4][4] (+ x shape)
        out = []
        for d in range(4):
            hom0 = np.tensordot(self.coef[:4], B[d], axes=(0, 0))
            hom1 = np.tensordot(self.coef[4:], B[d], axes=(0, 0))
            part0 = self._pp(0, x)[d]
            part1 = self._pp(1, x)[d]
            out.append(np.where(r == 0, hom0 + part0, hom1 + part1))
        return out

    def evaluate(self, x, y):
        """Return (u, v, p) at coordinates x, y (arrays broadcast)."""
        x = np.asarray(x, dtype=np.longdouble)
        y = np.asarray(y, dtype=np.longdouble)
        k = self.k
        d0, d1, d2, d3 = self._phi(x)
        eta = np.where(x > self.xc, self.eta[1], self.eta[0])
        u = k * d0 * np.cos(k * y)
        v = -d1 * np.sin(k * y)
        P = (eta * (d3 - k * k * d1) - np.cos(self.pi * x)) / k
        p = P * np.cos(k * y)
        return (np.asarray(u, np.float64), np.asarray(v, np.float64),
                np.asarray(p, np.float64))
