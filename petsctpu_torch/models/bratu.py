"""Bratu problem (solid-fuel ignition) — SNES ex5.

Counterpart of petsctpu/models/bratu.py (reference:
src/snes/examples/tutorials/ex5.c): 2-D Bratu −Δu − λ·eᵘ = 0 on the unit
square, u = 0 on the boundary, 5-point stencil on an m×n vertex grid,
residual scaled as ex5.c's FormFunctionLocal (ex5.c:270-286: interior
(2u−uW−uE)·hy/hx + (2u−uN−uS)·hx/hy − λ·hx·hy·eᵘ with the boundary
neighbours taken as 0; boundary rows 2(hy/hx + hx/hy)·u).

A residual takes u of shape [n] or a batch [B, n] (the FD-coloring
assembly evaluates every color at once), writes nothing in place and
reads no value to the host, so torch.func.jvp and vjp run through it.
The sharded residual takes the rank's parallel.comm.Comm and fetches
its neighbours' boundary rows with Comm.ppermute.
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as TF

from petsctpu_torch.device import np_dtype, resolve_device


def _boundary(m: int, n: int, device) -> torch.Tensor:
    i = torch.arange(m, device=device)[:, None]
    j = torch.arange(n, device=device)[None, :]
    return (i == 0) | (i == m - 1) | (j == 0) | (j == n - 1)


def bratu_residual(da, lam: float = 6.0):
    """F(u) -> residual, u [n] or [B, n] flat in the DA's natural order."""
    m, n = da.grid
    hx = 1.0 / (m - 1)
    hy = 1.0 / (n - 1)

    def F(u):
        U = u.reshape(*u.shape[:-1], m, n)
        boundary = _boundary(m, n, u.device)
        Ub = torch.where(boundary, torch.zeros((), dtype=u.dtype,
                                               device=u.device), U)
        P = TF.pad(Ub, (1, 1, 1, 1))
        uW, uE = P[..., :-2, 1:-1], P[..., 2:, 1:-1]
        uS, uN = P[..., 1:-1, :-2], P[..., 1:-1, 2:]
        interior = ((2 * U - uW - uE) * (hy / hx)
                    + (2 * U - uS - uN) * (hx / hy)
                    - lam * hx * hy * torch.exp(U))
        bscale = 2.0 * (hy / hx + hx / hy)
        return torch.where(boundary, bscale * U, interior).reshape(u.shape)

    return F


def bratu_residual_sharded(da, nshards: int, mloc: int = None,
                           lam: float = 6.0):
    """The rank's Bratu residual F(u_local, comm) for a World whose ranks
    split the leading grid axis (the reference's DMDA x-partition): each
    evaluation exchanges one boundary row with each neighbour rank (two
    Comm.ppermute, the DMGlobalToLocal ghost scatter before
    FormFunctionLocal, dm.c:1620). Rows past the true grid (padding to
    nshards·mloc) have the identity residual F = u. Returns (F, padded
    grid)."""
    m, n = da.grid
    if mloc is None:
        mloc = -(-m // nshards)
    assert mloc * nshards >= m
    hx = 1.0 / (m - 1)
    hy = 1.0 / (n - 1)
    fwd = [(i, i + 1) for i in range(nshards - 1)]
    bwd = [(i + 1, i) for i in range(nshards - 1)]

    def F(u, comm):
        U = u.reshape(*u.shape[:-1], mloc, n)
        gi = comm.rank * mloc + torch.arange(mloc, device=u.device)[:, None]
        j = torch.arange(n, device=u.device)[None, :]
        boundary = (gi == 0) | (gi == m - 1) | (j == 0) | (j == n - 1)
        pad_row = gi >= m
        zero = torch.zeros((), dtype=u.dtype, device=u.device)
        Ub = torch.where(boundary | pad_row, zero, U)  # ex5.c: bnd nbrs ≡ 0
        above, below = comm.ppermutes([(Ub[..., -1:, :].contiguous(), fwd),
                                       (Ub[..., :1, :].contiguous(), bwd)])
        Ue = torch.cat([above, Ub, below], dim=-2)        # [mloc+2, n]
        uW, uE = Ue[..., :-2, :], Ue[..., 2:, :]
        Pj = TF.pad(Ub, (1, 1))
        uS, uN = Pj[..., :-2], Pj[..., 2:]
        interior = ((2 * U - uW - uE) * (hy / hx)
                    + (2 * U - uS - uN) * (hx / hy)
                    - lam * hx * hy * torch.exp(U))
        bscale = 2.0 * (hy / hx + hx / hy)
        out = torch.where(boundary, bscale * U, interior)
        return torch.where(pad_row, U, out).reshape(u.shape)

    return F, (mloc * nshards, n)


def bratu_jacobian_template(da, dtype=np.float64, device=None):
    """StencilMat pattern donor for the FD-coloring assembly: the
    diagonal everywhere, the four neighbours on interior rows."""
    from petsctpu_torch.mat.stencil import StencilMat

    offs = ((0, 0), (-1, 0), (1, 0), (0, -1), (0, 1))
    m, n = da.grid
    C = np.zeros((5, m, n), np_dtype(dtype))
    C[0] = 1.0
    C[1:, 1:-1, 1:-1] = 1.0
    return StencilMat(torch.from_numpy(C).to(resolve_device(device)), offs,
                      (m, n))


def bratu_initial_guess(da, lam: float = 6.0, device=None):
    """ex5.c FormInitialGuess: temp·√(min distance to the boundary)."""
    m, n = da.grid
    hx = 1.0 / (m - 1)
    hy = 1.0 / (n - 1)
    temp1 = lam / (lam + 1.0)
    i = np.arange(m)[:, None]
    j = np.arange(n)[None, :]
    tx = np.minimum(i, m - 1 - i) * hx
    ty = np.minimum(j, n - 1 - j) * hy
    U = temp1 * np.sqrt(np.minimum(tx, ty))
    U[0, :] = U[-1, :] = 0.0
    U[:, 0] = U[:, -1] = 0.0
    return torch.from_numpy(U.reshape(-1)).to(resolve_device(device))


def bratu_nonlinear_gs(da, lam: float = 6.0, sweeps: int = 1,
                       max_its: int = 50, rtol: float = 1e-5,
                       atol: float = 1e-15, stol: float = 1e-12):
    """ex5.c's user NonlinearGS (ex5.c:485-584, SNESSetGS): a sequential
    lexicographic sweep (y outer, x inner), per interior point up to
    `max_its` scalar Newton steps on
        F = (2u−uE−uW)·hy/hx + (2u−uN−uS)·hx/hy − λ·hx·hy·eᵘ − b,
        J = 2(hy/hx + hx/hy) − λ·hx·hy·eᵘ,
    stopping after an update when atol > |F|, rtol·|F0| > |F| or
    stol·|u| > |y|; boundary points are set to 0. Later points read the
    updated neighbours. Defaults are SNESCreate_GS's (snesgs.c:376-380).

    The sweep is a plain Python loop over the points on the host (the
    reference's lax.scan with a nested while_loop), for the goldens'
    grid sizes; a kernel for it is later work (ROADMAP queue 2). Returns
    smooth(x, b=None) on x's device."""
    m, n = da.grid
    hx, hy = 1.0 / (m - 1), 1.0 / (n - 1)
    sc = hx * hy * lam
    hxdhy, hydhx = hx / hy, hy / hx
    diag = 2.0 * (hydhx + hxdhy)

    def smooth(xflat, bflat=None):
        X = xflat.detach().cpu().double().numpy().reshape(m, n).tolist()
        B = (None if bflat is None
             else bflat.detach().cpu().double().numpy().reshape(m, n).tolist())
        for _ in range(sweeps):
            for j in range(n):
                for i in range(m):
                    if i == 0 or i == m - 1 or j == 0 or j == n - 1:
                        X[i][j] = 0.0
                        continue
                    uW, uE = X[i - 1][j], X[i + 1][j]
                    uS, uN = X[i][j - 1], X[i][j + 1]
                    bij = 0.0 if B is None else B[i][j]
                    u = X[i][j]
                    F0 = 0.0
                    for k in range(max_its):
                        eu = math.exp(u)
                        Fv = ((2.0 * u - uW - uE) * hydhx
                              + (2.0 * u - uS - uN) * hxdhy - sc * eu - bij)
                        if k == 0:
                            F0 = Fv
                        y = Fv / (diag - sc * eu)
                        u = u - y
                        if (atol > abs(Fv) or rtol * abs(F0) > abs(Fv)
                                or stol * abs(u) > abs(y)):
                            break
                    X[i][j] = u
        return torch.tensor(X, dtype=xflat.dtype,
                            device=xflat.device).reshape(-1)

    return smooth


# ---- snes ex14: the 3-D Bratu problem ----------------------------------------
# src/snes/examples/tutorials/ex14.c on an m³ DMDA (hx = hy = hz = h):
# interior rows (−Δ_h u)·h − λ·h³·eᵘ, each axis's second difference
# scaled by hyhz/hx = h, boundary rows u; the form of
# tests/test_sweep.py::run_snes_ex14.

STAR3 = ((0, 0, 0), (0, 0, -1), (0, 0, 1), (0, -1, 0), (0, 1, 0),
         (-1, 0, 0), (1, 0, 0))


def _boundary3(m: int, device) -> torch.Tensor:
    i = torch.arange(m, device=device)
    e = (i == 0) | (i == m - 1)
    return e[:, None, None] | e[None, :, None] | e[None, None, :]


def bratu3d_residual(m: int, lam: float = 6.0):
    """F(u) -> residual of ex14 on an m³ grid, u [n] or [B, n]."""
    h = 1.0 / (m - 1)
    sc = h * h * h * lam

    def F(u):
        U = u.reshape(*u.shape[:-1], m, m, m)
        up = TF.pad(U, (1, 1, 1, 1, 1, 1))
        u_xx = (-up[..., 1:-1, 1:-1, 2:] + 2 * U - up[..., 1:-1, 1:-1, :-2]) * h
        u_yy = (-up[..., 1:-1, 2:, 1:-1] + 2 * U - up[..., 1:-1, :-2, 1:-1]) * h
        u_zz = (-up[..., 2:, 1:-1, 1:-1] + 2 * U - up[..., :-2, 1:-1, 1:-1]) * h
        del up
        interior = u_xx + u_yy + u_zz - sc * torch.exp(U)
        return torch.where(_boundary3(m, u.device), U,
                           interior).reshape(u.shape)

    return F


def bratu3d_initial_guess(m: int, lam: float = 6.0, device=None):
    """ex14.c FormInitialGuess: temp1·√(min over the axes of the distance
    to the boundary), 0 on the boundary."""
    h = 1.0 / (m - 1)
    idx = np.arange(m)
    dk = np.minimum(idx, m - 1 - idx) * h
    t3 = np.minimum(np.minimum(dk[:, None, None], dk[None, :, None]),
                    dk[None, None, :])
    x0 = lam / (lam + 1.0) * np.sqrt(t3)
    e = (idx == 0) | (idx == m - 1)
    x0[e[:, None, None] | e[None, :, None] | e[None, None, :]] = 0.0
    return torch.from_numpy(x0.reshape(-1)).to(resolve_device(device))


def bratu3d_pattern(m: int):
    """The 7-point star pattern of the DMDA-preallocated matrix (boundary
    rows keep their neighbour slots, which assemble to zero), values 1."""
    import scipy.sparse as sp

    e = np.ones(m)
    T = sp.diags([e[:-1], e, e[:-1]], [-1, 0, 1])
    I = sp.eye(m)
    pat = (sp.kron(sp.kron(T, I), I) + sp.kron(sp.kron(I, T), I)
           + sp.kron(sp.kron(I, I), T)).tocsr()
    pat.data[:] = 1.0
    return pat


def bratu3d_fd_jacobian(m: int, htype: str = "ds", device=None):
    """ex14's -fdcoloring plan: the 7-point AIJ template colored by the
    DMDA stencil colors (i%3)+3(j%3)+9(k%3) (fdda.c, 27 colors), with the
    'ds' differencing parameters (fdmatrix.c:583-593)."""
    from petsctpu_torch.mat.coloring import stencil_coloring
    from petsctpu_torch.mat.ell import aij_from_scipy
    from petsctpu_torch.snes.fdjac import ColoredJacobian

    colors = stencil_coloring((m, m, m), STAR3)
    return ColoredJacobian(aij_from_scipy(bratu3d_pattern(m), device=device),
                           colors, int(colors.max()) + 1, htype=htype)
