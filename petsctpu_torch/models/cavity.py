"""Driven-cavity flow (velocity-vorticity with temperature) — SNES ex19.

Counterpart of petsctpu/models/cavity.py, serial (reference:
src/snes/examples/tutorials/ex19.c FormFunctionLocal): 4 fields a node
(u, v, omega, temp) on a 2-D DMDA, 5-point star with first-order
upwinding of the convective terms; boundary rows take one-sided formulas
in the reference's order (bottom, top, left, right: later edges own the
corners). Defaults are ex19's: lidvelocity = 1/(mx·my), prandtl = 1,
grashof = 1. The state is x.reshape(my, mx, 4), j (y) the slow axis as
the reference's x[j][i]. A residual takes x of shape [n] or [B, n] and
writes nothing in place. cavity_residual_sharded is the rank's residual
of a World whose ranks split the j axis.
"""

from __future__ import annotations

import math

import numpy as np
import scipy.sparse as sp
import torch
import torch.nn.functional as TF

from petsctpu_torch.device import resolve_device


def cavity_residual(mx: int, my: int, lidvelocity: float = None,
                    prandtl: float = 1.0, grashof: float = 1.0):
    if lidvelocity is None:
        lidvelocity = 1.0 / (mx * my)
    dhx, dhy = float(mx - 1), float(my - 1)
    hx, hy = 1.0 / dhx, 1.0 / dhy
    hxdhy, hydhx = hx * dhy, hy * dhx

    def F(xflat):
        X = xflat.reshape(*xflat.shape[:-1], my, mx, 4)
        P = TF.pad(X, (0, 0, 1, 1, 1, 1))
        W, E = P[..., 1:-1, :-2, :], P[..., 1:-1, 2:, :]
        S, N = P[..., :-2, 1:-1, :], P[..., 2:, 1:-1, :]
        u, v, om, te = X[..., 0], X[..., 1], X[..., 2], X[..., 3]

        avx, avy = torch.abs(u), torch.abs(v)
        vxp, vxm = 0.5 * (u + avx), 0.5 * (u - avx)
        vyp, vym = 0.5 * (v + avy), 0.5 * (v - avy)

        def lap(c, w, e, s, n):
            return (2.0 * c - w - e) * hydhx + (2.0 * c - s - n) * hxdhy

        fu = lap(u, W[..., 0], E[..., 0], S[..., 0], N[..., 0]) \
            - 0.5 * (N[..., 2] - S[..., 2]) * hx
        fv = lap(v, W[..., 1], E[..., 1], S[..., 1], N[..., 1]) \
            + 0.5 * (E[..., 2] - W[..., 2]) * hy
        fo = lap(om, W[..., 2], E[..., 2], S[..., 2], N[..., 2]) \
            + (vxp * (om - W[..., 2]) + vxm * (E[..., 2] - om)) * hy \
            + (vyp * (om - S[..., 2]) + vym * (N[..., 2] - om)) * hx \
            - 0.5 * grashof * (E[..., 3] - W[..., 3]) * hy
        ft = lap(te, W[..., 3], E[..., 3], S[..., 3], N[..., 3]) \
            + prandtl * ((vxp * (te - W[..., 3])
                          + vxm * (E[..., 3] - te)) * hy
                         + (vyp * (te - S[..., 3])
                            + vym * (N[..., 3] - te)) * hx)
        Fg = torch.stack([fu, fv, fo, ft], dim=-1)

        # boundary overrides, the reference's order: bottom, top, left,
        # right (a later edge owns the corner)
        j = torch.arange(my, device=X.device)[:, None, None]
        i = torch.arange(mx, device=X.device)[None, :, None]
        edges = (
            (j == 0, (u, v, om + (N[..., 0] - u) * dhy, te - N[..., 3])),
            (j == my - 1, (u - lidvelocity, v, om + (u - S[..., 0]) * dhy,
                           te - S[..., 3])),
            (i == 0, (u, v, om - (E[..., 1] - v) * dhx, te)),
            (i == mx - 1, (u, v, om - (v - W[..., 1]) * dhx,
                           te - float(grashof > 0))),
        )
        for where, vals in edges:
            Fg = torch.where(where, torch.stack(vals, dim=-1), Fg)
        return Fg.reshape(xflat.shape)

    return F


def cavity_residual_sharded(mx: int, my: int, nshards: int,
                            mloc: int = None, lidvelocity: float = None,
                            prandtl: float = 1.0, grashof: float = 1.0):
    """The rank's ex19 residual F(x_local, comm) for a World whose ranks
    split the j (my) axis (petsctpu's cavity_residual_sharded, the DMDA
    ghost scatter of the reference's distributed ex19): each evaluation
    sends one full (mx, 4) boundary row to each neighbour rank (two
    Comm.ppermute), then takes the serial residual's formulas, the
    boundary rows by global row in the reference's bottom, top, left,
    right order; rows past the true grid have the identity residual.
    Returns (F, padded grid (my_pad, mx, 4))."""
    if lidvelocity is None:
        lidvelocity = 1.0 / (mx * my)
    if mloc is None:
        mloc = -(-my // nshards)
    assert mloc * nshards >= my
    dhx, dhy = float(mx - 1), float(my - 1)
    hx, hy = 1.0 / dhx, 1.0 / dhy
    hxdhy, hydhx = hx * dhy, hy * dhx
    fwd = [(i, i + 1) for i in range(nshards - 1)]
    bwd = [(i + 1, i) for i in range(nshards - 1)]

    def F(xflat, comm):
        X = xflat.reshape(*xflat.shape[:-1], mloc, mx, 4)
        gj = comm.rank * mloc + torch.arange(mloc, device=X.device)[:, None,
                                                                    None]
        i = torch.arange(mx, device=X.device)[None, :, None]
        pad_row = gj >= my
        Xt = torch.where(pad_row, torch.zeros((), dtype=X.dtype,
                                              device=X.device), X)
        above, below = comm.ppermutes([
            (Xt[..., -1:, :, :].contiguous(), fwd),      # my j-1 halo
            (Xt[..., :1, :, :].contiguous(), bwd)])      # my j+1 halo
        Xe = torch.cat([above, Xt, below], dim=-3)
        S, N = Xe[..., :-2, :, :], Xe[..., 2:, :, :]
        Pi = TF.pad(Xt, (0, 0, 1, 1))
        W, E = Pi[..., :-2, :], Pi[..., 2:, :]
        u, v, om, te = X[..., 0], X[..., 1], X[..., 2], X[..., 3]

        avx, avy = torch.abs(u), torch.abs(v)
        vxp, vxm = 0.5 * (u + avx), 0.5 * (u - avx)
        vyp, vym = 0.5 * (v + avy), 0.5 * (v - avy)

        def lap(c, w, e, s, n):
            return (2.0 * c - w - e) * hydhx + (2.0 * c - s - n) * hxdhy

        fu = lap(u, W[..., 0], E[..., 0], S[..., 0], N[..., 0]) \
            - 0.5 * (N[..., 2] - S[..., 2]) * hx
        fv = lap(v, W[..., 1], E[..., 1], S[..., 1], N[..., 1]) \
            + 0.5 * (E[..., 2] - W[..., 2]) * hy
        fo = lap(om, W[..., 2], E[..., 2], S[..., 2], N[..., 2]) \
            + (vxp * (om - W[..., 2]) + vxm * (E[..., 2] - om)) * hy \
            + (vyp * (om - S[..., 2]) + vym * (N[..., 2] - om)) * hx \
            - 0.5 * grashof * (E[..., 3] - W[..., 3]) * hy
        ft = lap(te, W[..., 3], E[..., 3], S[..., 3], N[..., 3]) \
            + prandtl * ((vxp * (te - W[..., 3])
                          + vxm * (E[..., 3] - te)) * hy
                         + (vyp * (te - S[..., 3])
                            + vym * (N[..., 3] - te)) * hx)
        Fg = torch.stack([fu, fv, fo, ft], dim=-1)

        edges = (
            (gj == 0, (u, v, om + (N[..., 0] - u) * dhy, te - N[..., 3])),
            (gj == my - 1, (u - lidvelocity, v, om + (u - S[..., 0]) * dhy,
                            te - S[..., 3])),
            (i == 0, (u, v, om - (E[..., 1] - v) * dhx, te)),
            (i == mx - 1, (u, v, om - (v - W[..., 1]) * dhx,
                           te - float(grashof > 0))),
        )
        for where, vals in edges:
            Fg = torch.where(where, torch.stack(vals, dim=-1), Fg)
        return torch.where(pad_row, X, Fg).reshape(xflat.shape)

    return F, (mloc * nshards, mx, 4)


def cavity_initial_guess(mx: int, my: int, grashof: float = 1.0,
                         dtype=np.float64, device=None):
    """ex19.c FormInitialGuess: zero flow, a linear temperature ramp."""
    dx = 1.0 / (mx - 1)
    X = np.zeros((my, mx, 4), dtype)
    X[:, :, 3] = (grashof > 0) * np.arange(mx)[None, :] * dx
    return torch.from_numpy(X.reshape(-1)).to(resolve_device(device))


def cavity_jacobian_pattern(mx: int, my: int):
    """Host sparsity superset for FD coloring: full 4×4 blocks on the
    5-point star (what DMDA preallocation produces, fdda.c)."""
    n = mx * my
    Ii = np.arange(n)
    j = Ii // mx
    i = Ii % mx
    rows, cols = [Ii], [Ii]
    for cond, off in ((i > 0, -1), (i < mx - 1, 1),
                      (j > 0, -mx), (j < my - 1, mx)):
        r = Ii[cond]
        rows.append(r)
        cols.append(r + off)
    adj = sp.coo_matrix((np.ones(sum(len(r) for r in rows)),
                         (np.concatenate(rows), np.concatenate(cols))),
                        shape=(n, n)).tocsr()
    return sp.kron(adj, np.ones((4, 4)), format="csr")


def cavity_nonlinear_gs(mx: int, my: int, lidvelocity: float = None,
                        prandtl: float = 1.0, grashof: float = 1.0,
                        sweeps: int = 1, max_its: int = 50,
                        rtol: float = 1e-5, atol: float = 1e-15,
                        stol: float = 1e-12):
    """ex19.c's user NonlinearGS: a sequential lexicographic sweep; a
    point takes pointwise Newton steps on its 4×4 lower-triangular local
    system (u, v decoupled; ω, T back-substituted). The u/v boundary
    values are assigned before the sweep (bottom, top, left, right); the
    ω/T boundary branches run in order (i == 0, i == mx−1, j == 0,
    j == my−1; a corner runs two). The per-point test is the reference's,
    including its overwrite of pfnorm by √pynorm.

    The sweep is a plain Python loop over the points on the host (the
    reference's lax.scan with a nested while_loop), for the goldens' grid
    sizes; a kernel for it is later work (ROADMAP queue 2). Returns
    smooth(x, b=None) on x's device (b is the FAS right-hand side)."""
    if lidvelocity is None:
        lidvelocity = 1.0 / (mx * my)
    lid = lidvelocity
    dhx, dhy = float(mx - 1), float(my - 1)
    hx, hy = 1.0 / dhx, 1.0 / dhy
    hxdhy, hydhx = hx * dhy, hy * dhx
    gflag = float(grashof > 0)

    def point_newton(x, W, E, S, N, b4, interior, is_w, is_e, is_s, is_n):
        u, v, o, t = x
        pf0 = 0.0
        for l in range(max_its):
            yu = yv = yo = yt = 0.0
            if interior:
                uxx = (2.0 * u - W[0] - E[0]) * hydhx
                uyy = (2.0 * u - S[0] - N[0]) * hxdhy
                fu = uxx + uyy - .5 * (N[2] - S[2]) * hx - b4[0]
                dfudu = 2.0 * (hydhx + hxdhy)
                vxx = (2.0 * v - W[1] - E[1]) * hydhx
                vyy = (2.0 * v - S[1] - N[1]) * hxdhy
                fv = vxx + vyy + .5 * (E[2] - W[2]) * hy - b4[1]
                dfvdv = 2.0 * (hydhx + hxdhy)
                avx, avy = abs(u), abs(v)
                vxp, vxm = .5 * (u + avx), .5 * (u - avx)
                vyp, vym = .5 * (v + avy), .5 * (v - avy)
                oxx = (2.0 * o - W[2] - E[2]) * hydhx
                oyy = (2.0 * o - S[2] - N[2]) * hxdhy
                fo = (oxx + oyy
                      + (vxp * (o - W[2]) + vxm * (E[2] - o)) * hy
                      + (vyp * (o - S[2]) + vym * (N[2] - o)) * hx
                      - .5 * grashof * (E[3] - W[3]) * hy - b4[2])
                dfodo = 2.0 * (hydhx + hxdhy) + ((vxp - vxm) * hy
                                                 + (vyp - vym) * hx)
                dfodu = (o - W[2]) * hy if u > 0.0 else (E[2] - o) * hy
                dfodv = (o - S[2]) * hx if v > 0.0 else (N[2] - o) * hx
                txx = (2.0 * t - W[3] - E[3]) * hydhx
                tyy = (2.0 * t - S[3] - N[3]) * hxdhy
                ft = (txx + tyy + prandtl * (
                    (vxp * (t - W[3]) + vxm * (E[3] - t)) * hy
                    + (vyp * (t - S[3]) + vym * (N[3] - t)) * hx) - b4[3])
                dftdt = 2.0 * (hydhx + hxdhy) + prandtl * (
                    (vxp - vxm) * hy + (vyp - vym) * hx)
                dftdu = (prandtl * (t - W[3]) * hy if u > 0.0
                         else prandtl * (E[3] - t) * hy)
                dftdv = (prandtl * (t - S[3]) * hx if v > 0.0
                         else prandtl * (N[3] - t) * hx)
                yu = fu / dfudu
                yv = fv / dfvdv
                yo = (fo - (dfodu * yu + dfodv * yv)) / dfodo
                yt = (ft - (dftdu * yu + dftdv * yv)) / dftdt
                u, v, o, t = u - yu, v - yv, o - yo, t - yt
            # the boundary constraint branches, in order (ex19.c:232-263)
            if is_w:
                yo = o - (E[1] - v) * dhx - b4[2]
                yt = t - b4[3]
                o, t = o - yo, t - yt
            if is_e:
                yo = o - (v - W[1]) * dhx - b4[2]
                yt = t - gflag - b4[3]
                o, t = o - yo, t - yt
            if is_s:
                yo = o + (N[0] - u) * dhy - b4[2]
                yt = t - N[3] - b4[3]
                o, t = o - yo, t - yt
            if is_n:
                yo = o + (u - S[0]) * dhy - b4[2]
                yt = t - S[3] - b4[3]
                o, t = o - yo, t - yt
            # ex19.c:265-275, with pfnorm = √pynorm
            pynorm = yu * yu + yv * yv + yo * yo + yt * yt
            pfnorm = math.sqrt(pynorm)
            pxnorm = math.sqrt(u * u + v * v + o * o + t * t)
            if l == 0:
                pf0 = pfnorm
            if (rtol * pf0 > pfnorm or atol > pfnorm
                    or pxnorm * stol > pynorm):
                break
        return [u, v, o, t]

    def smooth(xflat, bflat=None):
        X = xflat.detach().cpu().double().numpy().reshape(my, mx, 4).copy()
        B = (np.zeros_like(X) if bflat is None
             else bflat.detach().cpu().double().numpy().reshape(my, mx, 4))
        # u/v Dirichlet values first (bottom, top, left, right)
        X[0, :, :2] = B[0, :, :2]
        X[-1, :, 0] = lid + B[-1, :, 0]
        X[-1, :, 1] = B[-1, :, 1]
        X[:, 0, :2] = B[:, 0, :2]
        X[:, -1, :2] = B[:, -1, :2]
        Xl = X.tolist()
        Bl = B.tolist()
        for _ in range(sweeps):
            for j in range(my):
                jm, jp = max(j - 1, 0), min(j + 1, my - 1)
                for i in range(mx):
                    im, ip = max(i - 1, 0), min(i + 1, mx - 1)
                    Xl[j][i] = point_newton(
                        Xl[j][i], Xl[j][im], Xl[j][ip], Xl[jm][i],
                        Xl[jp][i], Bl[j][i],
                        i != 0 and i != mx - 1 and j != 0 and j != my - 1,
                        i == 0, i == mx - 1, j == 0, j == my - 1)
        return torch.tensor(Xl, dtype=xflat.dtype,
                            device=xflat.device).reshape(-1)

    return smooth


class _FieldQ1:
    """Q1 interpolation ⊗ I_dof on a (my, mx, dof) grid (the MAIJ
    transfer DMDA builds for dof > 1, dainterp.c MatCreateMAIJ)."""

    def __init__(self, fine, coarse, dof=4):
        self.fine, self.coarse, self.dof = fine, coarse, dof

    def mult(self, xc):
        from petsctpu_torch.dm.da import _interp_axis
        X = xc.reshape(self.coarse + (self.dof,))
        for ax in (0, 1):
            X = _interp_axis(X, ax, self.fine[ax])
        return X.reshape(-1)

    def multT(self, xf):
        from petsctpu_torch.dm.da import _restrict_axis
        X = xf.reshape(self.fine + (self.dof,))
        for ax in (0, 1):
            X = _restrict_axis(X, ax, self.coarse[ax])
        return X.reshape(-1)


def cavity_fas_levels(m0: int, nlevels: int, lidvelocity: float,
                      prandtl: float = 1.0, grashof: float = 1.0,
                      gs_kw: dict = None):
    """FAS hierarchy for snes ex19: rediscretized cavity residuals on the
    2m−1 vertex chain, MAIJ Q1 transfers, node injection and the user
    NonlinearGS smoother a level (SNESSetGS). Returns (levels,
    smoothers), fine first."""
    from petsctpu_torch.snes.fas import FASLevel

    sizes = [m0]
    for _ in range(nlevels - 1):
        sizes.append((sizes[-1] + 1) // 2)
    levels, smoothers = [], []
    for l, m in enumerate(sizes):
        F = cavity_residual(m, m, lidvelocity, prandtl, grashof)
        smoothers.append(cavity_nonlinear_gs(
            m, m, lidvelocity, prandtl, grashof, **(gs_kw or {})))
        colors = np.zeros(m * m * 4, np.int32)       # unused with "user"
        if l < nlevels - 1:
            mc = (m + 1) // 2
            idx = np.arange(m * m * 4).reshape(m, m, 4)
            levels.append(FASLevel(F, colors, 1, _FieldQ1((m, m), (mc, mc)),
                                   idx[::2, ::2, :].reshape(-1).copy(), None))
        else:
            levels.append(FASLevel(F, colors, 1))
    return levels, smoothers
