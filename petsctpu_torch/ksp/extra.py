"""Additional Krylov methods: CR, TFQMR, CGNE, FBCGS, FBCGSR.

Reference: src/ksp/ksp/impls/{cr,tfqmr,cgne,bcgs/fbcgs,bcgs/fbcgsr}.
Each loop keeps petsctpu/ksp/extra.py's order of operations and copies
its norms and breakdown flags to the host once per iteration.
"""

from __future__ import annotations

import numpy as np
import torch

from petsctpu_torch.core.errors import ConvergedReason
from petsctpu_torch.ksp.common import (
    KSPConfig, SolveResult, advance, apply_pc, check_convergence,
    initial_guess, make_result, monitor, nonzero_or_one, positive_or_one,
    preconditioned_residual, record, start, to_host,
)
from petsctpu_torch.vec import ops

ITERATING = ConvergedReason.ITERATING


def solve_cr(A, b, x0, pc, cfg: KSPConfig, axis=None) -> SolveResult:
    """Preconditioned conjugate residuals, reference-exact recurrence
    (KSPSolve_CR cr.c): RT is the preconditioned residual, the step is
    ai = (RT, A·RT)/(AP, M⁻¹AP), P/AP update with bi = btop/bbot, and
    the default norm is ‖RT‖. The reference's indefinite-matrix test
    (|btop| < 0, cr.c) is dead code, so it is not checked."""
    x = initial_guess(b, x0, cfg)
    r0 = b - A.mult(x) if cfg.guess_nonzero else b
    rt = apply_pc(pc, r0)
    p = rt
    ap = A.mult(p)
    # VecDot(RT,ART) = sum RT conj(ART)
    btop, nrm2 = ops.reduce_all((torch.vdot(ap, rt), torch.vdot(rt, rt).real),
                                axis)
    history, rnorm0, reason = start(cfg, torch.sqrt(nrm2))
    its = 0
    while reason == ITERATING:
        q = apply_pc(pc, ap)
        apq = ops.dot(q, ap, axis)            # VecDot(AP,Q)
        bad_pc = apq.real <= 0
        ai = btop / torch.where(bad_pc, torch.ones_like(apq), apq)
        x = x + ai * p
        rt = rt - ai * q
        art = A.mult(rt)
        btop_new, nrm2 = ops.reduce_all(
            (torch.vdot(art, rt), torch.vdot(rt, rt).real), axis)
        bi = btop_new / nonzero_or_one(btop)
        p = rt + bi * p
        ap = art + bi * ap
        btop = btop_new
        dp, bad = to_host(torch.sqrt(nrm2), bad_pc)
        its += 1
        reason = advance(cfg, history, its, dp, rnorm0, bool(bad),
                         ConvergedReason.DIVERGED_INDEFINITE_PC)
    return make_result(x, its, reason, history)


def solve_tfqmr(A, b, x0, pc, cfg: KSPConfig, axis=None) -> SolveResult:
    """Transpose-free QMR, reference-exact (KSPSolve_TFQMR tfqmr.c):
    each outer iteration performs TWO QMR half-step updates with
    w = sqrt(dp·dpold) then w = dp, monitors dpest = sqrt(m+1)·tau at
    BOTH half-steps (labelled i+1 — the stream carries two entries per
    iteration), and tests convergence on each. `its` counts outer
    iterations; `history` holds the monitor stream (2 per iteration).

    Both half-steps run on the device before the one copy of the
    iteration: the second's iterate is taken only if the first did not
    converge, as the reference's `live` mask does."""
    x = initial_guess(b, x0, cfg)
    r0 = preconditioned_residual(A, b, x, pc, cfg)

    def B(v):
        return apply_pc(pc, A.mult(v))

    dp0 = ops.norm(r0, axis)
    (rnorm0,) = to_host(dp0)
    history = np.full((2 * cfg.maxits + 3,), np.nan, dtype=rnorm0.dtype)
    record(history, 0, rnorm0)
    monitor(cfg, 0, rnorm0)
    reason = check_convergence(rnorm0, rnorm0, 0, cfg)
    rp = r0
    rhoold = ops.dot(rp, r0, axis)            # VecDot(R,RP)
    v = B(r0)
    r, u, p = r0, r0, r0
    q = d = torch.zeros_like(b)
    tau, dpold = dp0, dp0
    etaold = torch.zeros((), dtype=b.dtype, device=b.device)
    psiold = torch.zeros((), dtype=dp0.dtype, device=b.device)
    its = hidx = 0
    while reason == ITERATING:
        its += 1
        s = ops.dot(rp, v, axis)              # VecDot(V,RP)
        a = rhoold / nonzero_or_one(s)
        q = u - a * v
        t = u + q
        auq = B(t)
        r = r - a * auq
        dp = ops.norm(r, axis)
        xs, dpests = [], []
        for m in (0, 1):
            w = torch.sqrt(dp * dpold) if m == 0 else dp
            psi = w / tau
            cm = 1.0 / torch.sqrt(1.0 + psi * psi)
            tau = tau * psi * cm
            eta = (cm * cm) * a
            cfac = psiold * psiold * etaold / nonzero_or_one(a)
            d = (u if m == 0 else q) + cfac * d
            x = x + eta * d
            xs.append(x)
            dpests.append(((m + 1.0) ** 0.5) * tau)
            etaold, psiold = eta, psi
        rho = ops.dot(rp, r, axis)            # VecDot(R,RP)
        bb = rho / nonzero_or_one(rhoold)
        u = r + bb * q
        q2 = q + bb * p
        p = u + bb * q2
        v = B(p)
        est0, est1, bad = to_host(*dpests, (rho == 0) | (s == 0))
        hidx += 1
        record(history, hidx, est0)
        monitor(cfg, its, est0)
        reason = check_convergence(est0, rnorm0, its, cfg)
        if reason == ITERATING:
            hidx += 1
            record(history, hidx, est1)
            reason = check_convergence(est1, rnorm0, its, cfg)
        else:
            x = xs[0]
        monitor(cfg, its, est1)
        if reason == ITERATING and bad:
            reason = ConvergedReason.DIVERGED_BREAKDOWN
        rhoold, dpold = rho, dp
    return make_result(x, its, reason, history, rnorm=history[hidx])


class _SquaredPC:
    """CGNE's preconditioner: Z = M⁻ᵀ(M⁻¹ r) (cgne.c:96-100 — the PC
    for AᵀA is applied twice, transposed second when available)."""

    def __init__(self, pc):
        self.pc = pc

    def apply(self, r):
        t = self.pc.apply(r)
        if hasattr(self.pc, "apply_transpose"):
            return self.pc.apply_transpose(t)
        return self.pc.apply(t)


def solve_cgne(A, b, x0, pc, cfg: KSPConfig, axis=None) -> SolveResult:
    """CG on the normal equations AᵀA x = Aᵀ b (cgne.c): the residual
    is r = Aᵀ(b − Ax), the PC is applied twice (M⁻ᵀM⁻¹), and the
    default monitored norm is ‖M⁻ᵀM⁻¹r‖. Needs A.multT."""
    from petsctpu_torch.ksp.cg import solve_cg
    from petsctpu_torch.mat.base import Normal

    bt = A.multT(b)
    return solve_cg(Normal(A), bt, x0,
                    None if pc is None else _SquaredPC(pc), cfg, axis)


def solve_fbcgs(A, b, x0, pc, cfg: KSPConfig, axis=None) -> SolveResult:
    """Flexible BiCGStab (fbcgs.c): right preconditioning, so the PC may
    vary; monitors the TRUE residual."""
    x = initial_guess(b, x0, cfg)
    r = b - A.mult(x) if cfg.guess_nonzero else b
    rt = r
    history, rnorm0, reason = start(cfg, ops.norm(r, axis))
    its = 0
    while reason == ITERATING:
        rho = ops.dot(rt, r, axis)
        if its == 0:
            p = r
        else:
            beta = (rho / rho_old) * (alpha / omega)
            p = r + beta * (p - omega * v)
        ph = apply_pc(pc, p)
        v = A.mult(ph)
        rtv = ops.dot(rt, v, axis)
        alpha = rho / rtv
        s = r - alpha * v
        sh = apply_pc(pc, s)
        t = A.mult(sh)
        tt, ts = ops.reduce_all((torch.vdot(t, t).real, torch.vdot(t, s)),
                                axis)
        omega = ts / positive_or_one(tt)
        x = x + alpha * ph + omega * sh
        r = s - omega * t
        dp, bad = to_host(ops.norm(r, axis),
                          (rho == 0) | (rtv == 0) | (omega == 0))
        its += 1
        reason = advance(cfg, history, its, dp, rnorm0, bool(bad))
        rho_old = rho
    return make_result(x, its, reason, history)


def solve_fbcgsr(A, b, x0, pc, cfg: KSPConfig, axis=None) -> SolveResult:
    """FBiCGStab-R (src/ksp/ksp/impls/bcgs/fbcgsr/fbcgsr.c): the
    single-rendezvous flexible BiCGStab — mathematically equivalent to
    fbcgs but with the six inner products packed into TWO fused
    reductions per iteration ((tau,sigma) then (xi1..xi4)), and the
    residual norm recovered algebraically from xi1 - omega*xi2 instead
    of a third reduction (fbcgsr.c:105-167). Right preconditioning
    only, like the reference. The merged sums use the reference's
    unconjugated products (its VEC_ReduceArithmetic loops). On a
    breakdown the previous iterate, residual and norm are kept: the
    reference aborts before applying the update."""
    x = initial_guess(b, x0, cfg)
    r = b - A.mult(x) if cfg.guess_nonzero else b
    rp = r
    dp0 = ops.norm(r, axis)
    history, rnorm0, reason = start(cfg, dp0)
    p = r
    its = 0
    while reason == ITERATING:
        p2 = apply_pc(pc, p)
        v = A.mult(p2)
        # fused reduction 1: tau = (r,rp), sigma = (v,rp)
        tau, sigma = ops.reduce_all((torch.sum(r * rp), torch.sum(v * rp)),
                                    axis)
        if its == 0:
            tau = (dp0 * dp0).to(b.dtype)
        # guard the division: the reference errors out on sigma==0
        # before using alpha — keep the iterate finite and let the
        # breakdown reason terminate below
        alpha = tau / nonzero_or_one(sigma)
        s = r - alpha * v
        s2 = apply_pc(pc, s)
        t = A.mult(s2)
        # fused reduction 2: (s,s), (t,s), (t,t), (t,rp)
        xi1, xi2, xi3, xi4 = ops.reduce_all(
            (torch.sum(s * s), torch.sum(t * s), torch.sum(t * t),
             torch.sum(t * rp)), axis)
        omega = xi2 / nonzero_or_one(xi3)
        beta = -xi4 / nonzero_or_one(sigma)
        dp = torch.sqrt(torch.abs(xi1 - omega * xi2)).real.to(dp0.dtype)
        dp, bad = to_host(dp, (xi3 == 0) | (sigma == 0))
        its += 1
        if bad:
            dp = history[its - 1].astype(dp.dtype)
        else:
            x = x + alpha * p2 + omega * s2
            r_new = s - omega * t
            p = r_new + beta * (p - omega * v)
            r = r_new
        reason = advance(cfg, history, its, dp, rnorm0, bool(bad))
    return make_result(x, its, reason, history)
