"""Jacobian construction strategies for SNES.

Counterpart of petsctpu/snes/fdjac.py (reference: SNESComputeJacobian,
src/snes/interface/snes.c:2101, dispatching between a user callback,
FD coloring — MatFDColoringApply, src/mat/matfd/fdmatrix.c — and the
matrix-free MFFD of src/mat/impls/mffd):

  * `jvp_operator` — exact J(x)·v by forward-mode AD (torch.func.jvp;
    the transpose product by torch.func.vjp), one product at a time in
    the process: PyTorch's forward-AD level is the process's, not a
    thread's, so the rank threads of a World take turns (F must not
    communicate inside it; snes_nasm's subdomain solves replay their
    halos);
  * `mffd_operator` — (F(x + h v) − F(x))/h with wp.c's h;
  * `ColoredJacobian` — the FD-coloring assembly as ONE batched residual
    evaluation F(x + dx·D) over the color indicator rows D [C, n] (the
    reference's vmap), the entries gathered straight into the ELL or
    stencil value arrays: vals[i,k] = (Fb[color[cols[i,k]], i] − F0[i])
    · vscale[cols[i,k]].
"""

from __future__ import annotations

import threading
from typing import Callable

import numpy as np
import torch

from petsctpu_torch.device import np_dtype
from petsctpu_torch.mat.base import Shell
from petsctpu_torch.mat.coloring import stencil_coloring
from petsctpu_torch.mat.ell import AIJ
from petsctpu_torch.mat.stencil import StencilMat


_AD_LOCK = threading.Lock()        # one AD product at a time (see above)


def jvp_operator(F: Callable, x: torch.Tensor, Fx: torch.Tensor) -> Shell:
    """Exact J(x)·v (and Jᵀ(x)·v) by automatic differentiation."""
    n = x.shape[0]

    def mv(ctx, v):
        xx, = ctx
        with _AD_LOCK:
            return torch.func.jvp(F, (xx,), (v,))[1]

    def mtv(ctx, v):
        xx, = ctx
        with _AD_LOCK:
            return torch.func.vjp(F, xx)[1](v)[0]

    return Shell(ctx=(x,), mult_fn=mv, multT_fn=mtv, shape=(n, n))


def mffd_operator(F: Callable, x: torch.Tensor, Fx: torch.Tensor,
                  umin: float = 1e-6) -> Shell:
    """MFFD: J·v ≈ (F(x + h v) − F(x))/h, h from the reference's 'wp'
    differencing parameter (src/mat/impls/mffd/wp.c:73-81 verbatim:
    h = error_rel·√(1+‖u‖)/‖a‖)."""
    n = x.shape[0]
    eps = float(np.sqrt(np.finfo(np_dtype(x.dtype)).eps))

    def mv(ctx, v):
        xx, Fxx = ctx
        nv = torch.linalg.vector_norm(v)
        nx = torch.linalg.vector_norm(xx)
        h = eps * torch.where(nv > 0,
                              torch.sqrt(1.0 + nx) / torch.clamp(nv, min=1e-30),
                              torch.ones_like(nv))
        return (F(xx + h * v) - Fxx) / h

    return Shell(ctx=(x, Fx), mult_fn=mv, shape=(n, n))


class ColoredJacobian:
    """Plan for the FD-coloring assembly into a frozen layout.

    template : AIJ or StencilMat (the structure donor; an AIJ's padding
               and explicit zeros have vals 0 and stay 0)
    color    : int [n] column colors (host)
    ncolors  : number of colors
    htype    : "const" (one h = √eps for every column) or "ds" (the
               reference's MatFDColoringApply default, fdmatrix.c:583-593:
               dx_j = eps·x_j clamped to ±eps·umin, entries scaled by 1/dx_j)
    umin     : 0 means 100·√eps

    `assemble(F, x, Fx)` runs on x's device and returns an AIJ or a
    StencilMat. The gather indices are built once, at the first assembly
    on a device, and kept."""

    def __init__(self, template, color, ncolors: int, htype: str = "const",
                 umin: float = 0.0):
        if htype not in ("const", "ds"):
            raise ValueError(f"htype must be 'const' or 'ds', got {htype!r}")
        self.template = template
        self.color = np.asarray(color)
        self.ncolors = int(ncolors)
        self.htype = htype
        self.umin = umin
        self._plan = {}

    @classmethod
    def from_sparsity(cls, A_host, template,
                      htype: str = "const") -> "ColoredJacobian":
        from petsctpu_torch.mat.host_graph import greedy_color
        color = greedy_color(A_host)
        return cls(template, color, int(color.max()) + 1, htype)

    @classmethod
    def from_stencil(cls, template: StencilMat,
                     htype: str = "const") -> "ColoredJacobian":
        color = stencil_coloring(template.grid, template.offsets)
        return cls(template, color, int(color.max()) + 1, htype)

    def plan(self, device):
        """The gather indices on `device`: the colors and, for a
        StencilMat template, each offset's neighbour column and in-grid
        mask [D, n]; for an AIJ, the pattern mask of the template."""
        key = str(device)
        p = self._plan.get(key)
        if p is not None:
            return p
        colors = torch.from_numpy(self.color.astype(np.int64)).to(device)
        t = self.template
        if isinstance(t, StencilMat):
            grid = np.array(t.grid)
            n = int(np.prod(grid))
            multi = np.stack(np.unravel_index(np.arange(n), t.grid), axis=1)
            strides = np.array([int(np.prod(grid[k + 1:]))
                                for k in range(len(grid))])
            col, ok = [], []
            for off in t.offsets:
                tgt = multi + np.array(off)
                inside = np.all((tgt >= 0) & (tgt < grid), axis=1)
                col.append(np.where(inside, tgt @ strides, 0))
                ok.append(inside)
            p = dict(colors=colors,
                     col=torch.from_numpy(np.stack(col)).to(device),
                     ok=torch.from_numpy(np.stack(ok)).to(device))
        else:
            p = dict(colors=colors, pattern=(t.vals != 0).to(device))
        self._plan[key] = p
        return p

    def assemble(self, F: Callable, x: torch.Tensor, Fx: torch.Tensor,
                 h: float = None):
        dtype = x.dtype
        n = x.shape[0]
        p = self.plan(x.device)
        eps_m = float(np.finfo(np_dtype(dtype)).eps)
        # the perturbation directions: D[c] = 1 where color == c
        D = (p["colors"][None, :] == torch.arange(
            self.ncolors, device=x.device)[:, None]).to(dtype)
        if self.htype == "ds":
            umin = self.umin or 100.0 * np.sqrt(eps_m)
            one = torch.ones((), dtype=dtype, device=x.device)
            dx = torch.where(x == 0, one, x)
            dx = torch.where((torch.abs(dx) < umin) & (dx.real >= 0),
                             umin * one, dx)
            dx = torch.where((dx.real < 0) & (torch.abs(dx) < umin),
                             -umin * one, dx)
            dx = dx * np.sqrt(eps_m)             # per-column parameter
            vscale = 1.0 / dx
            Fb = F(x[None, :] + dx[None, :] * D)             # [C, n]
        else:
            hval = torch.tensor(h if h is not None else np.sqrt(eps_m),
                                dtype=dtype, device=x.device)
            vscale = torch.full((n,), 1.0, dtype=dtype,
                                device=x.device) / hval
            Fb = F(x[None, :] + hval * D)                    # [C, n]
        del D
        return self._fill(Fb, Fx, p, vscale, n)

    def _fill(self, Fb, Fx, p, vscale, n):
        t = self.template
        colors = p["colors"]
        flat = Fb.reshape(-1)
        rows = torch.arange(n, device=Fb.device)
        zero = torch.zeros((), dtype=Fb.dtype, device=Fb.device)
        if isinstance(t, StencilMat):
            col, ok = p["col"], p["ok"]
            v = (flat[colors[col] * n + rows[None, :]] - Fx[None, :]) \
                * vscale[col]
            v = torch.where(ok, v, zero)
            return StencilMat(v.reshape((len(t.offsets),) + tuple(t.grid)),
                              t.offsets, t.grid, t.boundary)
        # AIJ/ELL: vals[i,k] = (Fb[color[cols[i,k]], i] − Fx[i]) / h
        m = t.shape[0]
        rws = torch.arange(m, device=Fb.device)[:, None]
        vj = (flat[colors[t.cols] * n + rws] - Fx[:, None]) * vscale[t.cols]
        # only true pattern entries (padding has vals == 0 in the template)
        return AIJ(t.cols, torch.where(p["pattern"], vj, zero), t.shape,
                   t.nnz)
