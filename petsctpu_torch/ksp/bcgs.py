"""BiCGStab and friends (nonsymmetric Krylov).

Reference: KSPSolve_BCGS (src/ksp/ksp/impls/bcgs/bcgs.c) — left-
preconditioned BiCGStab on M⁻¹A with rho/omega breakdown detection;
plus CGS and BiCG siblings (src/ksp/ksp/impls/{cgs,bicg}).

Each loop keeps petsctpu/ksp/bcgs.py's order of operations with its
scalars as 0-d tensors on the operands' device, and copies the norm and
the breakdown flags to the host once per iteration.
"""

from __future__ import annotations

import torch

from petsctpu_torch.core.errors import ConvergedReason
from petsctpu_torch.ksp.common import (
    KSPConfig, SolveResult, advance, apply_pc, initial_guess, make_result,
    positive_or_one, preconditioned_residual, start, to_host,
)
from petsctpu_torch.vec import ops

ITERATING = ConvergedReason.ITERATING


def _op(A, pc, v):
    """Preconditioned operator M⁻¹A v (left)."""
    return apply_pc(pc, A.mult(v))


def solve_bcgs(A, b, x0, pc, cfg: KSPConfig, axis=None) -> SolveResult:
    x = initial_guess(b, x0, cfg)
    r = preconditioned_residual(A, b, x, pc, cfg)
    rt = r                                    # shadow residual r̃₀
    history, rnorm0, reason = start(cfg, ops.norm(r, axis))
    its = 0
    while reason == ITERATING:
        rho = ops.dot(rt, r, axis)
        if its == 0:
            p = r
        else:
            beta = (rho / rho_old) * (alpha / omega)
            p = r + beta * (p - omega * v)
        v = _op(A, pc, p)
        rtv = ops.dot(rt, v, axis)
        alpha = rho / rtv
        s = r - alpha * v
        t = _op(A, pc, s)
        # the two omega reductions, fused as in the reference
        tt, ts = ops.reduce_all((torch.vdot(t, t).real, torch.vdot(t, s)),
                                axis)
        omega = ts / positive_or_one(tt)
        x = x + alpha * p + omega * s
        r = s - omega * t
        dp, bad = to_host(ops.norm(r, axis),
                          (rho == 0) | (rtv == 0) | (omega == 0))
        its += 1
        reason = advance(cfg, history, its, dp, rnorm0, bool(bad))
        rho_old = rho
    return make_result(x, its, reason, history)


def solve_cgsq(A, b, x0, pc, cfg: KSPConfig, axis=None) -> SolveResult:
    """Conjugate Gradient Squared (src/ksp/ksp/impls/cgs)."""
    x = initial_guess(b, x0, cfg)
    r = preconditioned_residual(A, b, x, pc, cfg)
    rt = r
    history, rnorm0, reason = start(cfg, ops.norm(r, axis))
    its = 0
    while reason == ITERATING:
        rho = ops.dot(rt, r, axis)
        if its == 0:
            u = p = r
        else:
            beta = rho / rho_old
            u = r + beta * q
            p = u + beta * (q + beta * p)
        v = _op(A, pc, p)
        sigma = ops.dot(rt, v, axis)
        alpha = rho / sigma
        q = u - alpha * v
        uq = u + q
        x = x + alpha * uq
        r = r - alpha * _op(A, pc, uq)
        dp, bad = to_host(ops.norm(r, axis), (rho == 0) | (sigma == 0))
        its += 1
        reason = advance(cfg, history, its, dp, rnorm0, bool(bad))
        rho_old = rho
    return make_result(x, its, reason, history)


def solve_bicg(A, b, x0, pc, cfg: KSPConfig, axis=None) -> SolveResult:
    """BiCG (src/ksp/ksp/impls/bicg/bicg.c, complex-correct): left
    vectors run through the HERMITIAN adjoint (the reference's
    VecConjugate sandwich around MatMultTranspose/PCApplyTranspose,
    bicg.c:90-93). PCs exposing `apply_transpose` (ILUPCT via
    -pc_factor_transpose_solves, the PCApplyTranspose analog) get the
    TRUE adjoint; symmetric PCs fall back to the conjugate sandwich
    M⁻ᴴ v = conj(M⁻¹ conj(v)). Needs A.multT: an AIJ operator (SELL's
    transpose is chunk-mode only, as in petsctpu)."""
    x = initial_guess(b, x0, cfg)
    rr = b - A.mult(x) if cfg.guess_nonzero else b
    rl = rr
    # a PC "has a true transpose" only when the whole wrapper chain
    # does (PermutedPC always defines apply_transpose but its inner
    # may not — has_transpose reports the chain's capability)
    true_transpose = getattr(pc, "has_transpose",
                             hasattr(pc, "apply_transpose"))

    def pc_herm(v):
        if true_transpose:
            return torch.conj(pc.apply_transpose(torch.conj(v)))
        return torch.conj(apply_pc(pc, torch.conj(v)))

    def mult_herm(v):
        return torch.conj(A.multT(torch.conj(v)))

    zr = apply_pc(pc, rr)
    zl = pc_herm(rl)
    history, rnorm0, reason = start(cfg, ops.norm(zr, axis))
    its = 0
    while reason == ITERATING:
        # VecDot(Zr, Rl) = conj(Rl)·Zr
        beta = ops.dot(rl, zr, axis)
        if its == 0:
            pr, pl = zr, zl
        else:
            bfac = beta / beta_old
            pr = zr + bfac * pr
            pl = zl + torch.conj(bfac) * pl
        vzr = A.mult(pr)
        vzl = mult_herm(pl)
        dpi = ops.dot(pl, vzr, axis)          # VecDot(Zr, Pl)
        a = beta / dpi
        x = x + a * pr
        rr = rr - a * vzr
        rl = rl - torch.conj(a) * vzl
        zr = apply_pc(pc, rr)
        zl = pc_herm(rl)
        dp, bad = to_host(ops.norm(zr, axis), (beta == 0) | (dpi == 0))
        its += 1
        reason = advance(cfg, history, its, dp, rnorm0, bool(bad))
        beta_old = beta
    return make_result(x, its, reason, history)
