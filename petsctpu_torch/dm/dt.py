"""PetscDT — quadrature rules.

Counterpart of petsctpu/dm/dt.py, host numpy as there.

Reference: src/dm/dt/interface/dt.c (PetscDTGaussQuadrature via
Golub-Welsch, PetscDTGaussJacobiQuadrature for simplices,
PetscDTGaussTensorQuadrature). Returns numpy points and weights.
"""

from __future__ import annotations

import numpy as np
from scipy.special import roots_jacobi


def gauss_quadrature(npoints: int, a: float = -1.0, b: float = 1.0):
    """PetscDTGaussQuadrature: Gauss-Legendre points/weights on [a,b]."""
    x, w = np.polynomial.legendre.leggauss(npoints)
    x = 0.5 * (b - a) * x + 0.5 * (b + a)
    w = 0.5 * (b - a) * w
    return x, w


def gauss_lobatto_quadrature(npoints: int, a: float = -1.0, b: float = 1.0):
    """Gauss-Lobatto-Legendre points/weights on [a,b] (endpoints incl.)."""
    if npoints < 2:
        raise ValueError("lobatto needs >= 2 points")
    # interior points are roots of P'_{n-1} = zeros of Jacobi(1,1)_{n-2}
    if npoints == 2:
        xi = np.array([])
    else:
        xi, _ = roots_jacobi(npoints - 2, 1.0, 1.0)
    x = np.concatenate([[-1.0], xi, [1.0]])
    n = npoints - 1
    Pn = np.polynomial.legendre.Legendre.basis(n)(x)
    w = 2.0 / (n * (n + 1) * Pn ** 2)
    x = 0.5 * (b - a) * x + 0.5 * (b + a)
    w = 0.5 * (b - a) * w
    return x, w


def gauss_jacobi_quadrature(npoints: int, alpha: float, beta: float,
                            a: float = -1.0, b: float = 1.0):
    """PetscDTGaussJacobiQuadrature: points/weights for weight
    (1−x)^α(1+x)^β (simplex quadrature building block)."""
    x, w = roots_jacobi(npoints, alpha, beta)
    x = 0.5 * (b - a) * x + 0.5 * (b + a)
    w = (0.5 * (b - a)) ** (alpha + beta + 1) * w
    return x, w


def gauss_tensor_quadrature(dim: int, npoints: int, a: float = -1.0,
                            b: float = 1.0):
    """PetscDTGaussTensorQuadrature: tensor-product rule on [a,b]^dim.
    Returns points [n^dim, dim] and weights [n^dim]."""
    x1, w1 = gauss_quadrature(npoints, a, b)
    grids = np.meshgrid(*([x1] * dim), indexing="ij")
    pts = np.stack([g.reshape(-1) for g in grids], axis=1)
    wgrids = np.meshgrid(*([w1] * dim), indexing="ij")
    w = np.ones(npoints ** dim)
    for g in wgrids:
        w = w * g.reshape(-1)
    return pts, w
