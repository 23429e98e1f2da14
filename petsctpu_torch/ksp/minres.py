"""MINRES (symmetric indefinite) and LSQR (least squares).

Reference: src/ksp/ksp/impls/minres/minres.c and
src/ksp/ksp/impls/lsqr/lsqr.c. The recurrences' scalars are 0-d
tensors on the operands' device; the monitored norm and the
indefinite-PC flag come to the host once per iteration.
"""

from __future__ import annotations

import torch

from petsctpu_torch.core.errors import ConvergedReason
from petsctpu_torch.ksp.common import (
    KSPConfig, SolveResult, advance, apply_pc, initial_guess, make_result,
    positive_or_one, start, to_host,
)
from petsctpu_torch.vec import ops

ITERATING = ConvergedReason.ITERATING
INDEFINITE_PC = ConvergedReason.DIVERGED_INDEFINITE_PC


def solve_minres(A, b, x0, pc, cfg: KSPConfig, axis=None) -> SolveResult:
    """Preconditioned MINRES (Paige & Saunders Lanczos recurrence).

    Requires an SPD preconditioner. Monitors the PRECONDITIONED
    residual 2-norm like the reference: np0 = ||z||_2 (minres.c:98
    VecNorm(Z)) carried through the rotation recurrence
    np_k = np_{k-1}*|s_k| (minres.c:175)."""
    x = initial_guess(b, x0, cfg)
    r = b - A.mult(x) if cfg.guess_nonzero else b
    z = apply_pc(pc, r)
    beta1_sq = torch.real(ops.dot(r, z, axis))
    beta1 = torch.sqrt(torch.abs(beta1_sq))
    dp0 = ops.norm(z, axis)
    history, rnorm0, reason = start(cfg, dp0, beta1_sq < 0, INDEFINITE_PC)
    # Hermitian operator: the Lanczos alpha is real — the rotation
    # algebra stays in the real dtype (minres.c works in PetscRealPart)
    one = torch.ones((), dtype=beta1.dtype, device=b.device)
    zs = torch.zeros((), dtype=beta1.dtype, device=b.device)
    zero = torch.zeros_like(b)
    r_old = z_old = w = w_old = zero
    beta, beta_old, c, c_old, s, s_old = beta1, one, one, one, zs, zs
    eta, np_ = beta1, dp0
    its = 0
    while reason == ITERATING:
        v = z / beta
        Av = A.mult(v)
        alpha = torch.real(ops.dot(v, Av, axis))
        z_new = apply_pc(pc, Av) - (alpha / beta) * z \
            - (beta / beta_old) * z_old
        r_lanczos = Av - (alpha / beta) * r - (beta / beta_old) * r_old
        beta_new_sq = torch.real(ops.dot(r_lanczos, z_new, axis))
        beta_new = torch.sqrt(torch.abs(beta_new_sq))
        # QR via Givens on the tridiagonal
        delta = c * alpha - c_old * s * beta
        gamma = torch.sqrt(delta * delta + beta_new * beta_new)
        eps = s_old * beta
        lam = s * alpha + c_old * c * beta
        c_new = delta / gamma
        s_new = beta_new / gamma
        w_new = (v - lam * w - eps * w_old) / gamma
        x = x + c_new * eta * w_new
        eta = -s_new * eta
        np_ = np_ * torch.abs(s_new)
        dp, indef = to_host(np_, beta_new_sq < 0)
        its += 1
        reason = advance(cfg, history, its, dp, rnorm0, bool(indef),
                         INDEFINITE_PC)
        r_old, r = r, r_lanczos
        z_old, z = z, z_new
        w_old, w = w, w_new
        beta_old, beta = beta, beta_new
        c_old, c = c, c_new
        s_old, s = s, s_new
    return make_result(x, its, reason, history)


def solve_lsqr(A, b, x0, pc, cfg: KSPConfig, axis=None) -> SolveResult:
    """LSQR on min ‖Ax−b‖ (Golub-Kahan bidiagonalization; lsqr.c).

    With a PC the reference preconditions the normal equations
    (lsqr.c:133-144,160-184): Z = M⁻¹V, α = sqrt(V·Z), the matmul
    runs on Z and the update basis W tracks Z — reproduced here. The
    monitored norm is the recursive estimate φ̄ (lsqr.c:209). Needs
    A.multT: an AIJ operator on the card."""
    n = A.shape[1]
    x = x0 if cfg.guess_nonzero else torch.zeros(n, dtype=b.dtype,
                                                 device=b.device)
    u = b - A.mult(x) if cfg.guess_nonzero else b
    beta = ops.norm(u, axis)
    u = u / positive_or_one(beta)

    def bidiag(v):
        """(v, z, alpha) normalized: z = M⁻¹v, alpha = sqrt(vᴴz)."""
        if pc is None:
            alpha = ops.norm(v, axis)
            z = v
        else:
            z = apply_pc(pc, v)
            alpha = torch.sqrt(torch.clamp(ops.dot(v, z, axis).real, min=0.0))
            z = z / positive_or_one(alpha)
        return v / positive_or_one(alpha), z, alpha

    v, z, alpha = bidiag(A.multT(u))
    w = v if pc is None else z
    history, rnorm0, reason = start(cfg, beta)
    rhobar, phibar = alpha, beta
    its = 0
    while reason == ITERATING:
        u = A.mult(v if pc is None else z) - alpha * u
        beta = ops.norm(u, axis)
        u = u / positive_or_one(beta)
        v, z, alpha = bidiag(A.multT(u) - beta * v)
        rho = torch.sqrt(rhobar ** 2 + beta ** 2)
        cs = rhobar / rho
        sn = beta / rho
        theta = sn * alpha
        rhobar = -cs * alpha
        phi = cs * phibar
        phibar = sn * phibar
        x = x + (phi / rho) * w
        w = (v if pc is None else z) - (theta / rho) * w
        (dp,) = to_host(phibar)           # ‖r‖ estimate
        its += 1
        reason = advance(cfg, history, its, dp, rnorm0)
    return make_result(x, its, reason, history)
