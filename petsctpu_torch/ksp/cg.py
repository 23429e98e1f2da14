"""Conjugate gradients: standard PCG, single-reduction CG and PIPECG.

Reference: KSPSolve_CG (src/ksp/ksp/impls/cg/cg.c:92) with its NaN/Inf
guard (cg.c:152) and indefinite-PC/matrix detection (cg.c:188);
KSPCGUseSingleReduction (cg.c:116-266); pipelined KSPSolve_PIPECG
(src/ksp/ksp/impls/cg/pipecg/pipecg.c:45). GROPPCG shares PIPECG's
iteration, as in petsctpu.

Each loop keeps its vectors and device scalars on the operands'
device in the order of operations of petsctpu/ksp/cg.py, and copies
the scalars it branches on to the host once per iteration.
"""

from __future__ import annotations

import torch

from petsctpu_torch.core.errors import ConvergedReason
from petsctpu_torch.ksp.common import (
    KSPConfig, SolveResult, NORM_NATURAL, NORM_PRECONDITIONED,
    NORM_UNPRECONDITIONED, apply_pc, check_convergence, init_history,
    make_result, monitor, monitor_true, rnorm0_reference, to_host,
)
from petsctpu_torch.vec import ops

ITERATING = ConvergedReason.ITERATING


def _norm(nt, r, z, rz, axis=None):
    """The convergence norm of the norm type, from the residual r, the
    preconditioned residual z and rz = zᴴr."""
    if nt == NORM_PRECONDITIONED:
        return ops.norm(z, axis)
    if nt == NORM_UNPRECONDITIONED:
        return ops.norm(r, axis)
    if nt == NORM_NATURAL:
        return torch.sqrt(torch.abs(rz))
    return torch.zeros((), dtype=r.real.dtype, device=r.device)


def _fused(nt, r, z, pairs, axis):
    """(*(aᴴb for each pair), zᴴr, the norm type's norm), the partials
    with zᴴz and rᴴr in ONE reduction, as petsctpu's reduce_all of an
    iteration's inner products (serially the local values themselves)."""
    dot = ops.local_dot
    *vals, rz, zz, rr = ops.reduce_all(
        (*(dot(a, b) for a, b in pairs), dot(z, r), dot(z, z).real,
         dot(r, r).real), axis)
    if nt == NORM_PRECONDITIONED:
        return (*vals, rz, torch.sqrt(zz))
    if nt == NORM_UNPRECONDITIONED:
        return (*vals, rz, torch.sqrt(rr))
    return (*vals, rz, _norm(nt, r, z, rz))


def _flag_indefinite(reason, indefinite_mat, indefinite_pc):
    if reason == ITERATING and indefinite_mat:
        return ConvergedReason.DIVERGED_INDEFINITE_MAT
    if reason == ITERATING and indefinite_pc:
        return ConvergedReason.DIVERGED_INDEFINITE_PC
    return reason


def solve_cg(A, b, x0, pc, cfg: KSPConfig, axis=None) -> SolveResult:
    if cfg.cg_single_reduction:
        return solve_cg_single(A, b, x0, pc, cfg, axis)
    nt = cfg.norm_type or NORM_PRECONDITIONED
    x = x0
    r = b - A.mult(x) if cfg.guess_nonzero else b
    z = apply_pc(pc, r)
    rz = ops.dot(z, r, axis)
    dp_t = _norm(nt, r, z, rz, axis)
    (dp,) = to_host(dp_t)
    history = init_history(cfg, b.dtype)
    history[0] = dp
    monitor(cfg, 0, dp)
    if cfg.monitor_true:
        bnorm = to_host(ops.norm(b, axis))[0]
        monitor_true(cfg, 0, dp, to_host(ops.norm(r, axis))[0], bnorm)
    rnorm0 = rnorm0_reference(cfg, b, pc, nt, axis, dp)
    reason = check_convergence(dp, rnorm0, 0, cfg)
    p, its = z, 0
    while reason == ITERATING:
        w = A.mult(p)
        pw = ops.dot(p, w, axis)
        alpha = rz / pw
        x = x + alpha * p
        r = r - alpha * w
        z = apply_pc(pc, r)
        rz_new, dp_t = _fused(nt, r, z, (), axis)
        beta = rz_new / rz
        dp, pw_h, beta_h = to_host(dp_t, pw, beta)
        dp = dp.real                # one copy: a complex solve's is complex
        its += 1
        history[its] = dp
        monitor(cfg, its, dp)
        if cfg.monitor_true:
            monitor_true(cfg, its, dp, to_host(ops.norm(r, axis))[0], bnorm)
        reason = check_convergence(dp, rnorm0, its, cfg)
        reason = _flag_indefinite(reason, pw_h <= 0, beta_h < 0)
        p = z + beta * p
        rz = rz_new
    return make_result(x, its, reason, history)


def solve_cg_single(A, b, x0, pc, cfg: KSPConfig, axis=None) -> SolveResult:
    """CG with KSPCGUseSingleReduction (cg.c:116-266, option
    -ksp_cg_single_reduction): keeps s = Az each iteration, rebuilds
    w = Ap from w <- s + (beta/betaold)·w and p'Ap from the recurrence
    dpi = delta - beta²·dpiold/betaold² (delta = z'Az), so the
    iteration's inner products merge into one reduction, at the cost of
    the extra matmult s = Az. Keeps petsctpu's quirks (ROADMAP queue 3):
    no beta==0 → CONVERGED_ATOL break, and the update is applied before
    an indefinite break."""
    nt = cfg.norm_type or NORM_PRECONDITIONED
    x = x0
    r = b - A.mult(x) if cfg.guess_nonzero else b
    z = apply_pc(pc, r)
    s = A.mult(z)
    delta = ops.dot(z, s, axis)
    rz = ops.dot(z, r, axis)
    (dp,) = to_host(_norm(nt, r, z, rz, axis))
    history = init_history(cfg, b.dtype)
    history[0] = dp
    monitor(cfg, 0, dp)
    if cfg.monitor_true:
        bnorm = to_host(ops.norm(b, axis))[0]
        monitor_true(cfg, 0, dp, to_host(ops.norm(r, axis))[0], bnorm)
    rnorm0 = rnorm0_reference(cfg, b, pc, nt, axis, dp)
    reason = check_convergence(dp, rnorm0, 0, cfg)
    one = torch.ones((), dtype=rz.dtype, device=rz.device)
    zero = torch.zeros((), dtype=rz.dtype, device=rz.device)
    p, w, rzold, dpiold, its = z, s, one, zero, 0
    while reason == ITERATING:
        first = its == 0
        bcoef = zero if first else \
            rz / torch.where(rzold == 0, one, rzold)
        p = z + bcoef * p
        w = s + bcoef * w                   # w = Ap by recurrence
        dpi = delta if first else \
            delta - rz * rz * dpiold / torch.where(rzold == 0, one,
                                                    rzold * rzold)
        alpha = rz / torch.where(dpi == 0, one, dpi)
        x = x + alpha * p
        r = r - alpha * w
        z = apply_pc(pc, r)
        s = A.mult(z)
        delta_n, rz_n, dp_t = _fused(nt, r, z, ((z, s),), axis)
        dp, dpi_h, dpiold_h, rzz_h = to_host(
            dp_t, dpi.real, dpiold.real, (rz_n * rz).real)
        indefinite_mat = dpi_h == 0 or (not first and dpi_h * dpiold_h <= 0)
        its += 1
        history[its] = dp
        monitor(cfg, its, dp)
        if cfg.monitor_true:
            monitor_true(cfg, its, dp, to_host(ops.norm(r, axis))[0], bnorm)
        reason = check_convergence(dp, rnorm0, its, cfg)
        reason = _flag_indefinite(reason, indefinite_mat, rzz_h < 0)
        rzold, rz, delta, dpiold = rz, rz_n, delta_n, dpi
    return make_result(x, its, reason, history)


def solve_pipecg(A, b, x0, pc, cfg: KSPConfig, axis=None) -> SolveResult:
    """Pipelined CG (pipecg.c:45): one fused reduction per iteration,
    started BEFORE the preconditioner+SpMV it overlaps with.

    State follows Ghysels & Vanroose: r, u=M⁻¹r, w=Au, and the shifted
    vectors z=Aq, q=M⁻¹p, p. Each iteration does one SpMV, one PC apply
    and ONE reduction of (r·u, w·u, ||r||², ||u||²)."""
    nt = cfg.norm_type or NORM_PRECONDITIONED
    x = x0
    r = b - A.mult(x) if cfg.guess_nonzero else b
    u = apply_pc(pc, r)
    w = A.mult(u)

    def reduce(r, u, w):
        delta, gamma, dp = _fused(nt, r, u, ((w, u),), axis)
        return gamma, delta, dp

    gamma, delta, dp_t = reduce(r, u, w)
    (dp,) = to_host(dp_t)
    history = init_history(cfg, b.dtype)
    history[0] = dp
    monitor(cfg, 0, dp)
    rnorm0 = rnorm0_reference(cfg, b, pc, nt, axis, dp)
    reason = check_convergence(dp, rnorm0, 0, cfg)

    zero = torch.zeros_like(b)
    z, q, p, s = zero, zero, zero, zero
    gamma_old = alpha_old = None
    its = 0
    while reason == ITERATING:
        m = apply_pc(pc, w)                # m = M⁻¹ w
        n = A.mult(m)                      # n = A m   (the overlapped SpMV)
        if its == 0:
            beta = torch.zeros((), dtype=gamma.dtype, device=gamma.device)
            alpha = gamma / delta
        else:
            beta = gamma / gamma_old
            alpha = gamma / (delta - (beta / alpha_old) * gamma)
        z = n + beta * z
        q = m + beta * q
        p = u + beta * p
        s = w + beta * s
        x = x + alpha * p
        u = u - alpha * q
        w = w - alpha * z
        r = r - alpha * s
        gamma_old, alpha_old = gamma, alpha
        gamma, delta, dp_t = reduce(r, u, w)
        (dp,) = to_host(dp_t)
        its += 1
        history[its] = dp
        monitor(cfg, its, dp)
        reason = check_convergence(dp, rnorm0, its, cfg)
    return make_result(x, its, reason, history)
