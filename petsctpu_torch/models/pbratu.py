"""p-Bratu: p-Laplacian nonlinear diffusion plus Bratu ignition — SNES ex15.

Counterpart of petsctpu/models/pbratu.py (reference:
src/snes/examples/tutorials/ex15.c FormFunctionLocal): flux-form finite
differences with the strain-regularized p-Laplacian diffusivity
η(γ) = (ε² + γ)^((p−2)/2), γ = ½|∇u|² on the E/W/N/S edge midpoints
(ex15.c:351-352), the Bratu source −λ·hx·hy·eᵘ and a constant source.
Boundary rows are the identity. A residual takes u [n] or [B, n].
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as TF

from petsctpu_torch.device import resolve_device


def pbratu_residual(mx: int, my: int, p: float = 2.0, lam: float = 0.0,
                    epsilon: float = 1e-5, source: float = 0.1):
    hx, hy = 1.0 / (mx - 1), 1.0 / (my - 1)
    dhx, dhy = 1.0 / hx, 1.0 / hy
    sc = hx * hy * lam
    src = hx * hy * source

    def eta(ux, uy):
        return (epsilon * epsilon
                + 0.5 * (ux * ux + uy * uy)) ** (0.5 * (p - 2.0))

    def F(uflat):
        X = uflat.reshape(*uflat.shape[:-1], my, mx)
        P = TF.pad(X, (1, 1, 1, 1))
        C = X
        E, W = P[..., 1:-1, 2:], P[..., 1:-1, :-2]
        N, S = P[..., 2:, 1:-1], P[..., :-2, 1:-1]
        NE, NW = P[..., 2:, 2:], P[..., 2:, :-2]
        SE, SW = P[..., :-2, 2:], P[..., :-2, :-2]
        ux_E = dhx * (E - C)
        uy_E = 0.25 * dhy * (N + NE - S - SE)
        ux_W = dhx * (C - W)
        uy_W = 0.25 * dhy * (NW + N - SW - S)
        ux_N = 0.25 * dhx * (E + NE - W - NW)
        uy_N = dhy * (N - C)
        ux_S = 0.25 * dhx * (SE + E - SW - W)
        uy_S = dhy * (C - S)
        uxx = -hy * (eta(ux_E, uy_E) * ux_E - eta(ux_W, uy_W) * ux_W)
        uyy = -hx * (eta(ux_N, uy_N) * uy_N - eta(ux_S, uy_S) * uy_S)
        interior = uxx + uyy - sc * torch.exp(C) - src
        j = torch.arange(my, device=X.device)[:, None]
        i = torch.arange(mx, device=X.device)[None, :]
        bnd = (i == 0) | (j == 0) | (i == mx - 1) | (j == my - 1)
        return torch.where(bnd, X, interior).reshape(uflat.shape)

    return F


def pbratu_initial_guess(mx: int, my: int, lam: float = 0.0, device=None):
    """ex15.c FormInitialGuess: λ ≠ 0 → the Bratu distance-to-boundary
    profile; λ = 0 → the (1−x²)(1−y²) bump."""
    hx, hy = 1.0 / (mx - 1), 1.0 / (my - 1)
    temp1 = lam / (lam + 1.0)
    jj = np.minimum(np.arange(my), my - 1 - np.arange(my)) * hy
    ii = np.minimum(np.arange(mx), mx - 1 - np.arange(mx)) * hx
    J, I = np.meshgrid(jj, ii, indexing="ij")
    if lam != 0:
        X0 = temp1 * np.sqrt(np.minimum(I, J))
    else:
        x = 2.0 * np.arange(mx) / (mx - 1) - 1
        y = 2.0 * np.arange(my) / (my - 1) - 1
        YY, XX = np.meshgrid(y, x, indexing="ij")
        X0 = (1 - XX * XX) * (1 - YY * YY)
    X0[0, :] = X0[-1, :] = 0.0
    X0[:, 0] = X0[:, -1] = 0.0
    return torch.from_numpy(X0.reshape(-1)).to(resolve_device(device))
