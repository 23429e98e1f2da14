"""LCD (left conjugate directions) and TCQMR (Tony Chan's
transpose-free QMR).

Reference: src/ksp/ksp/impls/lcd/lcd.c (Yuan/Golub left conjugate
direction method with restarts; GCR-shaped storage of P and Q = BAP
with oblique P-orthogonalization) and src/ksp/ksp/impls/tcqmr/tcqmr.c
(squared-Lanczos TFQMR variant; iteration structure transcribed from
tcqmr.c:30-135). Both left-preconditioned; both copy their norm and
breakdown flags to the host once per iteration.
"""

from __future__ import annotations

import numpy as np
import torch

from petsctpu_torch.core.errors import ConvergedReason
from petsctpu_torch.ksp.common import (
    KSPConfig, SolveResult, advance, apply_pc, initial_guess, make_result,
    nonzero_or_one, positive_or_one, preconditioned_residual, start,
    to_host,
)
from petsctpu_torch.device import np_dtype
from petsctpu_torch.vec import ops

ITERATING = ConvergedReason.ITERATING


def solve_lcd(A, b, x0, pc, cfg: KSPConfig, axis=None) -> SolveResult:
    """KSPLCD (lcd.c): per step α = (Pᵢ·r)/(Pᵢ·Qᵢ), x += αPᵢ, r −= αQᵢ;
    the next direction is r obliquely orthogonalized against stored
    directions: βⱼ = −(Pⱼ·Q_new)/(Pⱼ·Qⱼ), applied to both P and Q, one
    j after another like the reference's j-loop (lcd.c:106-112).
    Restart copies the last direction to slot 0 (lcd.c:116)."""

    def BA(v):
        return apply_pc(pc, A.mult(v))

    x = initial_guess(b, x0, cfg)
    r = preconditioned_residual(A, b, x, pc, cfg)
    history, rnorm0, reason = start(cfg, ops.norm(r, axis))
    one = torch.ones((), dtype=b.dtype, device=b.device)
    P, Q, dens = [r], [None], []
    its = last = 0
    while reason == ITERATING:
        it = its % cfg.restart
        if it == 0 and its > 0:
            # restart: the last direction moves to slot 0
            P, Q, dens = [P[last]], [None], []
        if it == 0:
            Q[0] = BA(P[0])
        q_it = Q[it]
        num, den = ops.reduce_all((torch.vdot(P[it], r),
                                   torch.vdot(P[it], q_it)), axis)
        dens.append(den)
        alfa = num / nonzero_or_one(den)
        x = x + alfa * P[it]
        r = r - alfa * q_it
        dp = ops.norm(r, axis)
        # build next direction: p = r, q = BA r, obliquely
        # orthogonalized sequentially (modified Gram-Schmidt)
        pn, qn = r, BA(r)
        for j in range(it + 1):
            beta = -ops.dot(P[j], qn, axis) / torch.where(
                dens[j] != 0, dens[j], one)
            pn = pn + beta * P[j]
            qn = qn + beta * Q[j]
        P.append(pn)
        Q.append(qn)
        last = it + 1
        dp_h, bad = to_host(dp, den == 0)
        its += 1
        reason = advance(cfg, history, its, dp_h, rnorm0, bool(bad))
    return make_result(x, its, reason, history)


def solve_tcqmr(A, b, x0, pc, cfg: KSPConfig, axis=None) -> SolveResult:
    """KSPTCQMR (tcqmr.c): squared-Lanczos vectors + Givens rotations;
    monitors the QMR upper bound rnorm0·√(its+2)·Π|s| (tcqmr.c:130)."""

    def BA(v):
        return apply_pc(pc, A.mult(v))

    x = initial_guess(b, x0, cfg)
    r = preconditioned_residual(A, b, x, pc, cfg)
    rnorm0_t = ops.norm(r, axis)
    history, rnorm0, reason = start(cfg, rnorm0_t)
    rt = rnorm0_t.dtype                      # norms/products: real
    rdt = np_dtype(rt).type
    zero = torch.zeros_like(b)
    u = r / positive_or_one(rnorm0_t)
    um1, v, vm1, v0, p = zero, u, zero, u, zero
    pvec1 = pvec2 = zero
    z0 = torch.zeros((), dtype=b.dtype, device=b.device)
    theta = ep = cl1 = sl1 = cl = sl = z0
    one_r = torch.ones((), dtype=rt, device=b.device)
    sprod, f, Gamma = one_r, one_r, one_r
    tau_n1 = rnorm0_t.to(b.dtype)
    rhom1 = torch.ones((), dtype=b.dtype, device=b.device)
    its = 0
    while reason == ITERATING:
        its += 1
        y = BA(u)
        dp11, dp2 = ops.reduce_all((torch.vdot(y, v0), torch.vdot(u, v0)),
                                   axis)
        alpha = dp11 / nonzero_or_one(dp2)
        deltmp = alpha
        z = y - alpha * u
        rho = dp2                              # VecDot(u, v0) again
        beta = rho / (f * rhom1)
        rhom1 = rho
        utmp = z - 2.0 * beta * p
        up1 = BA(utmp) - alpha * utmp + (f * beta * beta) * um1
        dp1 = ops.norm(up1, axis)
        f = 1.0 / positive_or_one(dp1)
        up1 = up1 * f
        p = f * (z - beta * p)
        um1, u = u, up1
        beta_g = beta / nonzero_or_one(Gamma)
        eptmp = beta_g
        vp1 = BA(v) - alpha * v - beta_g * vm1
        Gamma = ops.norm(vp1, axis)
        sG = positive_or_one(Gamma)
        vp1 = vp1 / sG
        vm1, v = v, vp1
        # apply last two Givens rotations (tcqmr.c:99-106)
        if its > 2:
            theta = sl1 * beta_g
            eptmp = -cl1 * beta_g
        if its > 1:
            ep = -cl * eptmp + sl * alpha
            deltmp = -sl * eptmp - cl * alpha
        big = torch.abs(Gamma) > torch.abs(deltmp)
        ta1 = -deltmp / sG
        s1 = 1.0 / torch.sqrt(1.0 + ta1 * ta1)
        ta2 = -Gamma / nonzero_or_one(deltmp)
        c2 = 1.0 / torch.sqrt(1.0 + ta2 * ta2)
        s_ = torch.where(big, s1, c2 * ta2)
        c_ = torch.where(big, s1 * ta1, c2)
        delta = -c_ * deltmp + s_ * Gamma
        tau_n = -c_ * tau_n1
        tau_n1 = -s_ * tau_n1
        pvec = (vm1 - theta * pvec2 - ep * pvec1) / nonzero_or_one(delta)
        x = x + tau_n * pvec
        sprod = sprod * torch.abs(s_)
        rnorm = rnorm0_t * float(np.sqrt(rdt(its) + rdt(2.0))) * sprod
        pvec2, pvec1 = pvec1, pvec
        cl1, sl1, cl, sl = cl, sl, c_, s_
        dp_h, bad = to_host(rnorm, (dp2 == 0) | (dp1 == 0))
        reason = advance(cfg, history, its, dp_h, rnorm0, bool(bad))
    return make_result(x, its, reason, history)
