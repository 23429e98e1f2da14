"""Nonlinear radiative transport — SNES ex18.

Counterpart of petsctpu/models/radiative.py (reference:
src/snes/examples/tutorials/ex18.c FormFunction): −div(α·T^β ∇T) = 0,
β = 2.5, by edge-harmonic flux differences (d_edge = ((T₀+T₁)/2)^β),
Dirichlet T = tleft on the left edge and T = tright on the right edge
through ghost values, zero flux on the top and bottom. Every node
carries a PDE row. A residual takes u [n] or [B, n].
"""

from __future__ import annotations

import torch

from petsctpu_torch.device import resolve_device


def radiative_residual(mx: int, my: int, beta: float = 2.5,
                       tleft: float = 1.0, tright: float = 0.1):
    def F(uflat):
        X = uflat.reshape(*uflat.shape[:-1], my, mx)
        L = torch.cat([torch.full_like(X[..., :1], tleft), X[..., :-1]],
                      dim=-1)
        R = torch.cat([X[..., 1:], torch.full_like(X[..., :1], tright)],
                      dim=-1)
        S = torch.cat([X[..., :1, :] * 0, X[..., :-1, :]], dim=-2)
        N = torch.cat([X[..., 1:, :], X[..., -1:, :] * 0], dim=-2)

        def flux(a, b):
            return (0.5 * (a + b)) ** beta * (b - a)

        fw, fe = flux(L, X), flux(X, R)
        fs, fn = flux(S, X), flux(X, N)
        j = torch.arange(my, device=X.device)[:, None]
        zero = torch.zeros((), dtype=X.dtype, device=X.device)
        fs = torch.where(j == 0, zero, fs)
        fn = torch.where(j == my - 1, zero, fn)
        return (-(fe - fw) - (fn - fs)).reshape(uflat.shape)

    return F


def radiative_initial_guess(mx: int, my: int, tleft: float = 1.0,
                            device=None):
    """ex18.c FormInitialGuess: the constant tleft."""
    return torch.full((mx * my,), tleft, dtype=torch.float64,
                      device=resolve_device(device))
