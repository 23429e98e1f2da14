"""Method of characteristics — semi-Lagrangian advection on DA grids.

Counterpart of petsctpu/ts/characteristic.py (reference:
src/ts/characteristic — CharacteristicSolve: for u_t + v·∇u = g, trace
characteristics back and interpolate the field at the departure points
by bilinear interpolation).

The departure-point interpolation over the whole grid is written out
here as petsctpu's `jax.scipy.ndimage.map_coordinates(order=1)` computes
it, so the two agree to the last bit on the same inputs: per axis the
lower node floor(c) with weight 1 − (c − floor(c)) and the upper node
floor(c) + 1 with weight c − floor(c); the node indices fixed by the
mode (`nearest`: clipped to [0, size − 1]; `wrap`: taken modulo size,
JAX's rule, which scipy calls 'grid-wrap'); the four products w₀·w₁·u
summed (lower, lower), (lower, upper), (upper, lower), (upper, upper),
left to right.
"""

from __future__ import annotations

from typing import Callable, Optional

import torch

from petsctpu_torch.ts.steppers import (TSConfig, TSResult, _monitor,
                                        configure, result, running,
                                        step_size, time_dtype)


def _nodes(coord: torch.Tensor, size: int, mode: str):
    """[(index, weight)] of the linear interpolation along one axis."""
    lower = torch.floor(coord)
    upper_weight = coord - lower
    lower_weight = 1 - upper_weight
    index = lower.to(torch.int64)
    out = []
    for idx, wgt in ((index, lower_weight), (index + 1, upper_weight)):
        if mode == "wrap":
            idx = torch.remainder(idx, size)
        else:                                  # nearest
            idx = torch.clamp(idx, 0, size - 1)
        out.append((idx, wgt))
    return out


def map_coordinates_linear(u: torch.Tensor, di: torch.Tensor,
                           dj: torch.Tensor, mode: str) -> torch.Tensor:
    """u [m, n] bilinearly interpolated at (di, dj) in index coordinates,
    mode "nearest" or "wrap" (JAX's map_coordinates order=1)."""
    m, n = u.shape
    flat = u.reshape(-1)
    result_ = None
    for i, wi in _nodes(di, m, mode):
        for j, wj in _nodes(dj, n, mode):
            term = (wi * wj) * flat[i * n + j]
            result_ = term if result_ is None else result_ + term
    return result_


def characteristic_step(u: torch.Tensor, vx: torch.Tensor, vy: torch.Tensor,
                        dt, hx: float, hy: float,
                        bc: str = "clamp") -> torch.Tensor:
    """One semi-Lagrangian step for u_t + v·∇u = 0 on a uniform grid.

    u, vx, vy: [m, n] grid fields; departure points x − dt·v are
    evaluated by bilinear interpolation."""
    m, n = u.shape
    ii = torch.arange(m, dtype=u.dtype, device=u.device)[:, None]
    jj = torch.arange(n, dtype=u.dtype, device=u.device)[None, :]
    di = ii - dt * vx / hx                       # departure index coords
    dj = jj - dt * vy / hy
    if bc == "periodic":
        mode = "wrap"
    else:
        mode = "nearest"
        di = torch.clamp(di, 0.0, m - 1.0)
        dj = torch.clamp(dj, 0.0, n - 1.0)
    return map_coordinates_linear(u, di, dj, mode)


def ts_characteristic(velocity: Callable, u0: torch.Tensor, grid: tuple,
                      cfg: TSConfig = None, source: Callable = None,
                      bc: str = "clamp", axis: Optional[str] = None,
                      **kw) -> TSResult:
    """Integrate u_t + v·∇u = g by characteristics (TSSolve shape).

    velocity: (t, u_grid) -> (vx, vy) grid fields
    source:   optional (t, u_grid) -> g grid field (explicit update)
    u0 flat or grid-shaped; grid = (m, n); spacing assumes the unit
    square with vertex grids (the DA convention)."""
    cfg = configure(cfg, kw)
    m, n = grid
    hx = 1.0 / max(m - 1, 1)
    hy = 1.0 / max(n - 1, 1)
    shape_in = u0.shape
    tt = time_dtype(u0)
    t, u, dt, step = tt(cfg.t0), u0, tt(cfg.dt), 0
    while running(cfg, t, step):
        dt_eff = step_size(cfg, t, dt)
        ug = u.reshape(grid)
        vx, vy = velocity(t, ug)
        un = characteristic_step(ug, vx, vy, dt_eff, hx, hy, bc)
        if source is not None:
            un = un + dt_eff * source(t + dt_eff, un)
        t = t + dt_eff
        step += 1
        _monitor(cfg, step, t, un)
        u = un.reshape(shape_in)
    return result(u, t, step, dt)
