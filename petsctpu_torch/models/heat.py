"""The heat equation posed as a DAE — TS ex15 (2-D) and ex17 (1-D).

The implicit forms F(t, u, u̇) = 0 of src/ts/examples/tutorials/ex15.c
and ex17.c, as petsctpu's TS tests pose them (tests/test_ts.py::
TestEx15Heat2D, ::TestEx17HeatDAE): u̇ + (−Δ_h u) on the interior rows
(the 5- or 3-point Laplacian, h = 1/(M − 1)), and ALGEBRAIC boundary
rows without u̇ — Dirichlet F = u, or ex15's Neumann rows F = u − u_p
with p the inward neighbour (the diagonal one at a corner,
ex15.c:41-56). Initial condition exp(−30 r³) inside r < 1/8 around the
centre (ex15.c:327-347, ex17.c).

The residuals take u of shape [n] or a batch [B, n] (the FD-coloring
assembly evaluates all colors at once); u̇ broadcasts against u.
"""

from __future__ import annotations

import numpy as np
import torch

from petsctpu_torch.device import np_dtype, resolve_device


def heat2d_initial(M: int, dtype=torch.float64, device=None) -> torch.Tensor:
    """ex15.c FormInitialSolution on the M×M vertex grid, flat [j, i]."""
    h = 1.0 / (M - 1)
    x = np.arange(M) * h
    X, Y = np.meshgrid(x, x, indexing="xy")
    r = np.sqrt((X - .5) ** 2 + (Y - .5) ** 2)
    u0 = np.where(r < .125, np.exp(-30.0 * r ** 3), 0.0).reshape(-1)
    return torch.as_tensor(u0, dtype=dtype, device=resolve_device(device))


def heat1d_initial(M: int, dtype=torch.float64, device=None) -> torch.Tensor:
    """ex17.c's initial condition on M points of [0, 1]."""
    xg = np.arange(M) * (1.0 / (M - 1))
    r = np.abs(xg - 0.5)
    u0 = np.where(r < .125, np.exp(-30.0 * r ** 3), 0.0)
    return torch.as_tensor(u0, dtype=dtype, device=resolve_device(device))


def _neumann_partner(M: int) -> np.ndarray:
    """Each grid point's partner in ex15's Neumann rows (itself inside)."""
    j, i = np.meshgrid(np.arange(M), np.arange(M), indexing="ij")
    pj = np.where(j == 0, 1, np.where(j == M - 1, M - 2, j))
    pi = np.where(i == 0, 1, np.where(i == M - 1, M - 2, i))
    return (pj * M + pi).reshape(-1)


def heat2d_ifunc(M: int, boundary: int = 0, bscale: float = 1.0):
    """ex15's F(t, u, u̇): boundary 0 Dirichlet, 1 Neumann; the boundary
    rows are multiplied by bscale. ex15.c's rows have bscale 1, so an
    interior row's diagonal 1/dt + 4/h² outweighs them by up to 1.7e7 at
    2049². A multigrid PC's Galerkin coarse operators then lose the
    boundary condition (GMRES + MG fails to reach 1e-6 in 200 its from
    257² on); bscale = 4/h², the Laplacian's diagonal (snes ex5's
    Dirichlet rows are weighted so too), keeps it, and GMRES takes 3-4
    its at every size. The solution is the same: the rows say u = 0."""
    h = 1.0 / (M - 1)
    s = 1.0 / h ** 2
    edge = np.zeros((M, M), bool)
    edge[0, :] = edge[-1, :] = edge[:, 0] = edge[:, -1] = True
    cache = {}

    def consts(device):
        key = str(device)
        if key not in cache:
            cache[key] = (torch.from_numpy(edge).to(device),
                          torch.from_numpy(_neumann_partner(M)).to(device))
        return cache[key]

    def ifunc(t, u, udot):
        mask, partner = consts(u.device)
        U = u.reshape(*u.shape[:-1], M, M)                 # [j, i]
        lap = (4 * U - torch.roll(U, 1, -2) - torch.roll(U, -1, -2)
               - torch.roll(U, 1, -1) - torch.roll(U, -1, -1)) * s
        F = torch.broadcast_to(udot, u.shape).reshape(U.shape) + lap
        if boundary == 0:                                  # Dirichlet: F = U
            B = U
        else:                                              # Neumann
            B = (u - u[..., partner]).reshape(U.shape)
        if bscale != 1.0:
            B = bscale * B
        return torch.where(mask, B, F).reshape(*F.shape[:-2], M * M)

    return ifunc


def heat2d_jacobian_template(M: int, boundary: int = 0, dtype=np.float64,
                             device=None):
    """StencilMat pattern donor of ex15's Jacobian on the M×M grid, for
    the FD-coloring assembly: the 5-point star on interior rows, and on
    a boundary row the diagonal (Dirichlet) or the diagonal and its
    Neumann partner (the four diagonal offsets reach a corner's)."""
    from petsctpu_torch.mat.stencil import StencilMat

    offs = [(0, 0), (-1, 0), (1, 0), (0, -1), (0, 1)]
    C = np.zeros((5, M, M), np_dtype(dtype))
    C[0] = 1.0
    C[1:, 1:-1, 1:-1] = 1.0
    if boundary == 1:
        offs += [(-1, -1), (-1, 1), (1, -1), (1, 1)]
        C = np.concatenate([C, np.zeros((4, M, M), C.dtype)])
        partner = _neumann_partner(M).reshape(M, M)
        j, i = np.meshgrid(np.arange(M), np.arange(M), indexing="ij")
        dj, di = partner // M - j, partner % M - i
        for k, (oj, oi) in enumerate(offs[1:], start=1):
            C[k][(dj == oj) & (di == oi)] = 1.0
    return StencilMat(torch.from_numpy(C).to(resolve_device(device)),
                      tuple(offs), (M, M))


def heat1d_ifunc(M: int):
    """ex17's F(t, u, u̇) on M points, Dirichlet rows F = u."""
    sx = 1.0 / (1.0 / (M - 1)) ** 2
    edge = np.zeros(M, bool)
    edge[0] = edge[-1] = True
    cache = {}

    def ifunc(t, u, udot):
        key = str(u.device)
        if key not in cache:
            cache[key] = torch.from_numpy(edge).to(u.device)
        lap = (2 * u - torch.roll(u, 1, -1) - torch.roll(u, -1, -1)) * sx
        return torch.where(cache[key], u, udot + lap)

    return ifunc
