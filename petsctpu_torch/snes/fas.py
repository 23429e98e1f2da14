"""FAS nonlinear multigrid, colored nonlinear Gauss-Seidel, nonlinear CG.

Counterpart of petsctpu/snes/fas.py (reference: SNESFAS,
src/snes/impls/fas/fas.c — full approximation scheme V-cycles with
nonlinear smoothers and a Newton coarse solve; SNESGS, src/snes/impls/gs,
here swept by stencil COLOR so a color's pointwise Newton updates run
together; SNESNCG, src/snes/impls/ncg).

A colored NGS sweep is two residual evaluations a color (probe and
update). The V-cycle is a Python recursion over the levels; the outer
iteration an eager loop with its test on the host (snes/api.py).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Optional, Sequence

import numpy as np
import torch

from petsctpu_torch.device import np_dtype
from petsctpu_torch.ksp.common import KSPConfig, to_host
from petsctpu_torch.mat.coloring import stencil_coloring
from petsctpu_torch.snes.api import (Monitor, SNESConfig, SNESResult,
                                     _linesearch_cp, _linesearch_l2,
                                     configure, snes_solve)
from petsctpu_torch.vec import ops


# ---------------------------------------------------------------------------
# Colored nonlinear Gauss-Seidel
# ---------------------------------------------------------------------------

def ngs_sweep(F: Callable, x: torch.Tensor, b, colors: torch.Tensor,
              ncolors: int, omega: float = 1.0, h: float = None):
    """One nonlinear Gauss-Seidel sweep over stencil colors: for each
    color, one residual and one probe along the color's indicator give
    the Jacobian diagonal on that color (points of one color do not
    interact under a distance-2 coloring), then the color's points take
    a damped pointwise Newton step together."""
    dtype = x.dtype
    hval = h if h is not None else float(np.sqrt(np.finfo(
        np_dtype(dtype)).eps))
    colors = torch.as_tensor(colors, device=x.device)
    for c in range(ncolors):
        Fx = F(x)
        r = Fx - b if b is not None else Fx
        on = colors == c
        d = on.to(dtype)
        diag = (F(x + hval * d) - Fx) / hval
        safe = torch.where(torch.abs(diag) > 1e-30, diag,
                           torch.ones_like(diag))
        x = x - torch.where(on, omega * r / safe, torch.zeros_like(x))
    return x


def snes_ngs(F: Callable, x0: torch.Tensor, colors: np.ndarray,
             ncolors: int = None, omega: float = 1.0,
             cfg: SNESConfig = None, axis: Optional[str] = None,
             **kw) -> SNESResult:
    """Standalone nonlinear Gauss-Seidel solver (SNESGS)."""
    cfg = configure(cfg, kw)
    colors_t = torch.as_tensor(np.asarray(colors), device=x0.device)
    nc = ncolors if ncolors is not None else int(np.max(colors)) + 1
    mon = Monitor(cfg, x0, ops.norm(F(x0), axis), axis)
    x = x0
    while mon.iterating:
        xn = ngs_sweep(F, x, None, colors_t, nc, omega)
        mon.step_from(xn, x, ops.norm(F(xn), axis))
        x = xn
    return mon.result(x, ops.norm(F(x), axis))


# ---------------------------------------------------------------------------
# FAS — full approximation scheme
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class FASLevel:
    """One level of the FAS hierarchy (fine→coarse list order).

    F        residual function on this level
    colors   distance-2 coloring (the NGS smoother's plan)
    ncolors  number of colors
    interp   Q1Interp fine←coarse (None on the coarsest level)
    inject   int index array restricting fine states to the coarse grid
             (None on the coarsest level)
    interior mask (1 on PDE rows, 0 on Dirichlet boundary rows) of the
             coarse grid: Pᵀ would otherwise leak interior residuals into
             coarse boundary rows and corrupt the FAS right-hand side
    """

    F: Callable
    colors: np.ndarray
    ncolors: int
    interp: object = None
    inject: np.ndarray = None
    interior: np.ndarray = None


def fas_levels_from_da(da, make_residual: Callable, nlevels: int,
                       mask_boundary: bool = False) -> Sequence[FASLevel]:
    """A FAS hierarchy from a DA and a residual factory
    `make_residual(da) -> F` (e.g. models.bratu.bratu_residual)."""
    levels = []
    cur = da

    def interior_mask(grid):
        m = np.zeros(grid, bool)
        m[tuple(slice(1, -1) for _ in grid)] = True
        return m.reshape(-1)

    for l in range(nlevels):
        colors = stencil_coloring(cur.grid, cur.stencil_offsets())
        nc = int(colors.max()) + 1
        if l < nlevels - 1:
            coarse = cur.coarsen()
            idx = np.arange(int(np.prod(cur.grid))).reshape(cur.grid)
            inject = idx[tuple(slice(None, None, 2) for _ in cur.grid)
                         ].reshape(-1).copy()
            levels.append(FASLevel(make_residual(cur), colors, nc,
                                   cur.interpolation(coarse), inject,
                                   interior_mask(coarse.grid)
                                   if mask_boundary else None))
            cur = coarse
        else:
            levels.append(FASLevel(make_residual(cur), colors, nc))
    return levels


def snes_fas(levels: Sequence[FASLevel], x0: torch.Tensor,
             cfg: SNESConfig = None, npre: int = 2, npost: int = 2,
             omega: float = 0.9, coarse_cfg: SNESConfig = None,
             coarse_ksp: KSPConfig = None, axis: Optional[str] = None,
             smoother: str = "ngs", user_smoothers=None,
             fas_type: str = "multiplicative", **kw) -> SNESResult:
    """FAS V-cycle iteration (SNESFAS, fas.c).

    An outer iteration is one cycle: presmooth, restrict the state
    (injection) and the residual (Pᵀ), form the coarse FAS right-hand
    side b_c = F_c(R x) + R(b − F(x)), recurse, prolong the coarse
    CORRECTION, postsmooth. The coarsest level is solved by Newton-Krylov
    (the reference's SNESNEWTONLS on level 0).

    smoother: "ngs" (colored nonlinear Gauss-Seidel), "nrichardson" (the
    reference's default level smoother, fasfunc.c:396: one L2 Richardson
    step a sweep), or "user" with user_smoothers = per-level callables
    f(x, b) (the SNESSetGS hook; one call a smoother iteration).
    fas_type "additive" is SNESFASCycle_Additive (fas.c:625)."""
    cfg = configure(cfg, kw)
    coarse_cfg = coarse_cfg or SNESConfig(maxits=12, rtol=1e-10,
                                          linesearch="bt")
    coarse_ksp = coarse_ksp or KSPConfig(ksp_type="gmres", rtol=1e-8,
                                         maxits=200)
    nlev = len(levels)
    dev = x0.device
    colors_t = [torch.as_tensor(L.colors, device=dev) for L in levels]
    inject_t = [torch.as_tensor(L.inject, device=dev)
                if L.inject is not None else None for L in levels]
    interior_t = [torch.as_tensor(L.interior, device=dev)
                  if L.interior is not None else None for L in levels]

    def smooth(l, x, b, sweeps):
        if smoother == "user":
            for _ in range(sweeps):
                x = user_smoothers[l](x, b)
            return x
        if smoother == "nrichardson":
            def Rf(v):
                return levels[l].F(v) - b
            for _ in range(sweeps):
                Rx = Rf(x)
                (rn,) = to_host(ops.norm(Rx, axis))
                x, _, _, _, _ = _linesearch_l2(Rf, x, Rx, rn, axis)
            return x
        for _ in range(sweeps):
            x = ngs_sweep(levels[l].F, x, b, colors_t[l], levels[l].ncolors,
                          omega)
        return x

    def coarse_solve(L, x, b):
        return snes_solve(lambda y: L.F(y) - b, x, jac="jvp",
                          ksp_cfg=coarse_ksp, cfg=coarse_cfg, axis=axis).x

    def restrict(l, r):
        Rr = levels[l].interp.multT(r)
        if interior_t[l] is not None:
            Rr = torch.where(interior_t[l], Rr, torch.zeros_like(Rr))
        return Rr

    def vcycle(l, x, b):
        L = levels[l]
        if l == nlev - 1:
            return coarse_solve(L, x, b)
        x = smooth(l, x, b, npre)
        xc0 = x[inject_t[l]]
        bc = levels[l + 1].F(xc0) + restrict(l, b - L.F(x))
        xc = vcycle(l + 1, xc0, bc)
        x = x + L.interp.mult(xc - xc0)
        return smooth(l, x, b, npost)

    def acycle(l, x, b):
        """SNESFASCycle_Additive (fas.c:625): recurse first from the
        unsmoothed iterate, smooth this level from the same iterate,
        then add the interpolated coarse direction through the L2 line
        search (fas.c:343)."""
        L = levels[l]
        if l == nlev - 1:
            return coarse_solve(L, x, b)

        def G(y):
            return L.F(y) - b

        xc0 = x[inject_t[l]]
        bc = levels[l + 1].F(xc0) - restrict(l, G(x))
        xc = acycle(l + 1, xc0, bc)
        xs = smooth(l, x, b, npre)
        d = L.interp.mult(xc0 - xc)      # minus convention: xn = x − λd
        (fs,) = to_host(ops.norm(G(xs), axis))
        xn, _, _, _, _ = _linesearch_l2(G, xs, d, fs, axis)
        return xn

    cycle = acycle if fas_type == "additive" else vcycle
    F0 = levels[0].F
    mon = Monitor(cfg, x0, ops.norm(F0(x0), axis), axis)
    zero_b = torch.zeros_like(x0)
    x = x0
    while mon.iterating:
        x = cycle(0, x, zero_b)
        (fn,) = to_host(ops.norm(F0(x), axis))
        # fas.c:824 passes xnorm = snorm = 0 to the convergence test: the
        # step tolerance never fires for FAS cycles
        mon.step(fn, mon.dt(0), mon.dt(0))
    return mon.result(x, ops.norm(F0(x), axis))


# ---------------------------------------------------------------------------
# Nonlinear CG
# ---------------------------------------------------------------------------

def snes_ncg(F: Callable, x0: torch.Tensor, beta_type: str = "prp",
             ls_its: int = 1, cfg: SNESConfig = None,
             axis: Optional[str] = None, **kw) -> SNESResult:
    """Nonlinear conjugate gradients (SNESNCG, src/snes/impls/ncg):
    directions p = F + β p with Fletcher-Reeves ("fr") or
    Polak-Ribière-Polyak ("prp", the reference default, β clipped at 0),
    the step from the default CP line search (one secant step on
    g(λ) = ⟨F(x−λp), p⟩)."""
    cfg = configure(cfg, kw)
    Fx = F(x0)
    fnorm_t = ops.norm(Fx, axis)
    mon = Monitor(cfg, x0, fnorm_t, axis)
    x, p = x0, Fx
    while mon.iterating:
        xn, Fn, fn_t, _, _ = _linesearch_cp(F, x, p, Fx, axis, ls_its)
        denom = torch.clamp(fnorm_t ** 2, min=1e-300)
        if beta_type == "fr":
            beta = (fn_t * fn_t) / denom
        else:                                   # PRP+ (reference default)
            beta = torch.clamp(ops.dot(Fn, Fn - Fx, axis) / denom, min=0.0)
        p = Fn + beta * p
        mon.step_from(xn, x, fn_t)
        x, Fx, fnorm_t = xn, Fn, fn_t
    return mon.result(x, fnorm_t)
