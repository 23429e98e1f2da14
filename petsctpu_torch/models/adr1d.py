"""1-D advection-reaction IMEX model — TS ex22.

Counterpart of petsctpu/models/adr1d.py (reference:
src/ts/examples/tutorials/ex22.c): two species on 0 < x < 1,

    u_t + a1*u_x = -k1*u + k2*v + s1
    v_t + a2*v_x =  k1*u - k2*v + s2

with a biased 4th-order upwind advection stencil (FormRHSFunction,
ex22.c:166-222: special rows at i = 0, 1, mx-2, mx-1, time-dependent
inflow u(0,t) = 1 - sin(12t)^4), the explicit part, and the stiff
linear reaction (FormIFunction, ex22.c:133-162), the implicit part.
The state is flat [mx*2], interleaved a grid point (DMDA dof = 2).
"""

from __future__ import annotations

import numpy as np
import torch

from petsctpu_torch.device import resolve_device


def adr_initial(mx: int, a=(1.0, 0.0), k=(1e6, 2e6), s=(0.0, 1.0),
                dtype=torch.float64, device=None):
    """FormInitialSolution ex22.c:268-294: r = (i+1)*hx, u = 1 + s[1]*r,
    v = k[0]/k[1]*u + s[1]/k[1]."""
    hx = 1.0 / mx
    r = (np.arange(mx) + 1.0) * hx
    ik = 1.0 / k[1] if k[1] != 0.0 else 1.0
    u = 1.0 + s[1] * r
    v = k[0] * ik * u + s[1] * ik
    return torch.as_tensor(np.stack([u, v], axis=1).ravel(), dtype=dtype,
                           device=resolve_device(device))


def adr_rhs_advection(mx: int, a=(1.0, 0.0), s=(0.0, 1.0)):
    """Explicit part (FormRHSFunction): biased 4th-order upwind
    advection with the inflow u0(t) = [1 - sin(12t)^4, 0]."""
    hx = 1.0 / mx

    def rhs(t, xflat):
        x = xflat.reshape(mx, 2)
        t = torch.as_tensor(t, dtype=x.dtype, device=x.device)
        u0t = torch.stack([1.0 - torch.sin(12.0 * t) ** 4,
                           torch.zeros_like(t)])
        f = ((-1.0 / 12.0) * torch.roll(x, 2, dims=0)
             + (2.0 / 3.0) * torch.roll(x, 1, dims=0)
             + (-2.0 / 3.0) * torch.roll(x, -1, dims=0)
             + (1.0 / 12.0) * torch.roll(x, -2, dims=0))
        # the boundary-biased rows (ex22.c:203-213)
        f = torch.cat([
            ((1.0 / 3.0) * u0t + 0.5 * x[0] - x[1]
             + (1.0 / 6.0) * x[2])[None],
            ((-1.0 / 12.0) * u0t + (2.0 / 3.0) * x[0]
             - (2.0 / 3.0) * x[2] + (1.0 / 12.0) * x[3])[None],
            f[2:mx - 2],
            ((-1.0 / 6.0) * x[mx - 4] + x[mx - 3] - 0.5 * x[mx - 2]
             - (1.0 / 3.0) * x[mx - 1])[None],
            (-x[mx - 1] + x[mx - 2])[None]])
        av = torch.as_tensor(a, dtype=x.dtype, device=x.device)
        return ((av / hx) * f).reshape(-1)

    return rhs


def adr_rhs_reaction(mx: int, k=(1e6, 2e6), s=(0.0, 1.0)):
    """Implicit part in RHS form (FormIFunction ex22.c:152-155 solved for
    xdot): udot = -k0*u + k1*v + s0; vdot = k0*u - k1*v + s1."""

    def rhs(t, xflat):
        x = xflat.reshape(mx, 2)
        r = k[0] * x[:, 0] - k[1] * x[:, 1]
        return torch.stack([-r + s[0], r + s[1]], dim=1).reshape(-1)

    return rhs


def ts_reason_string(steps: int, t: float, max_steps: int,
                     max_time: float) -> str:
    """TSStep's reason priority (ts.c:2319-2324): ITS before TIME."""
    if steps >= max_steps:
        return "CONVERGED_ITS"
    if t >= max_time:
        return "CONVERGED_TIME"
    return "CONVERGED_ITERATING"
