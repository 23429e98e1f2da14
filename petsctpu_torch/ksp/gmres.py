"""GMRES(m) and flexible FGMRES.

Reference: KSPGMRESCycle (src/ksp/ksp/impls/gmres/gmres.c:118) —
restarted Arnoldi with Givens-rotation Hessenberg updates; pluggable
orthogonalization (classical Gram-Schmidt with optional iterative
refinement, borthog2.c; modified GS, borthog.c); FGMRES
(src/ksp/ksp/impls/gmres/fgmres) stores the preconditioned directions
so the preconditioner may change per iteration.

The Krylov basis V [m+1, n] lives on the operands' device; classical
GS is one V@w product (VecMDot, dvec2.c:36) plus one correction. The
(m+1)×m Hessenberg matrix, the rotations and the least-squares solve
are a few hundred scalars: they live on the host in numpy, in the
solve's dtype, and each Arnoldi step brings its new column across in
one transfer.
"""

from __future__ import annotations

import numpy as np
import scipy.linalg
import torch

from petsctpu_torch.core.errors import ConvergedReason
from petsctpu_torch.ksp.common import (
    KSPConfig, SolveResult, NORM_PRECONDITIONED, NORM_UNPRECONDITIONED,
    apply_pc, check_convergence, init_history, make_result, monitor,
    monitor_true, rnorm0_reference, to_host,
)
from petsctpu_torch.device import np_dtype
from petsctpu_torch.vec import ops

ITERATING = ConvergedReason.ITERATING


def _orthogonalize(V, w, j, cfg, axis=None):
    """Orthogonalize w against V[0..j]. Returns (w, h [j+1])."""
    if cfg.orth == "mgs":
        # modified Gram-Schmidt: sequential dots (borthog.c)
        h = []
        for i in range(j + 1):
            hi = ops.dot(V[i], w, axis)
            w = w - hi * V[i]
            h.append(hi)
        return w, torch.stack(h)
    # classical GS: one mdot + correction (borthog2.c)
    Vj = V[:j + 1]
    h = ops.mdot(w, Vj, axis)
    w = w - h @ Vj
    if cfg.cgs_refine in ("always", "ifneeded"):
        # 'ifneeded' is treated as 'always', as in petsctpu: a second
        # CGS pass is one extra matvec and is unconditionally stable
        h2 = ops.mdot(w, Vj, axis)
        w = w - h2 @ Vj
        h = h + h2
    return w, h


def _apply_givens(h, hj1, cs, sn, g, j):
    """Apply stored rotations 0..j-1 to the column h (host, in place),
    then form rotation j. Returns the residual estimate |g[j+1]|."""
    # KSPGMRESUpdateHessenberg (gmres.c): complex-correct plane
    # rotations — h_i ← conj(c)h_i + s·h_{i+1}; h_{i+1} ← c·h_{i+1}
    # − s·h_i (conj is a no-op for real dtypes)
    for i in range(j):
        hi = np.conj(cs[i]) * h[i] + sn[i] * h[i + 1]
        h[i + 1] = cs[i] * h[i + 1] - sn[i] * h[i]
        h[i] = hi
    dt = h.dtype.type
    hj = h[j]
    # tt = sqrt(conj(h)h + conj(h1)h1); c = h/tt; s = h1/tt (hj1 is the
    # real orthogonalization norm, so tt is real-positive)
    denom = dt(np.sqrt((np.conj(hj) * hj + hj1 * hj1).real))
    if abs(denom) > 0:
        c, s = hj / denom, hj1 / denom
    else:
        c, s = dt(1), dt(0)
    cs[j], sn[j] = c, s
    h[j] = np.conj(c) * hj + s * hj1
    gj = g[j]
    g[j] = np.conj(c) * gj
    g[j + 1] = -s * gj
    return np.abs(g[j + 1])


def _solve_update(H, g, basis, j_end, m):
    """x-correction = basisᵀ y with R y = g solved on the leading j_end.

    basis is [m, n]. Unused columns of H (j >= j_end) are still zero,
    so adding 1 to their diagonal with a zero rhs makes y vanish there."""
    k = np.arange(m)
    R = H[:m, :m] + np.diag((k >= j_end).astype(H.dtype))
    gs = np.where(k < j_end, g[:m], 0).astype(g.dtype)
    y = scipy.linalg.solve_triangular(R, gs, lower=False).astype(g.dtype)
    return torch.from_numpy(y).to(basis.device) @ basis


def _gmres_generic(A, b, x0, pc, cfg: KSPConfig, axis, flexible: bool):
    m = cfg.restart
    n = b.shape[0]
    dt = np_dtype(b.dtype)
    nt = cfg.norm_type or (NORM_UNPRECONDITIONED if flexible
                           else NORM_PRECONDITIONED)

    def precond_res(x):
        r = b - A.mult(x)
        if flexible or nt == NORM_UNPRECONDITIONED:
            return r          # right-preconditioned: residual is true residual
        return apply_pc(pc, r)

    def true_norm(x):
        return to_host(ops.norm(b - A.mult(x), axis))[0]

    history = init_history(cfg, b.dtype)
    if cfg.monitor_true:
        bnorm = to_host(ops.norm(b, axis))[0]
    x = x0 if cfg.guess_nonzero else torch.zeros_like(b)
    its, reason, rnorm0 = 0, ITERATING, None
    while reason == ITERATING:
        r = precond_res(x)
        beta_t = ops.norm(r, axis)
        (beta,) = to_host(beta_t)
        if its == 0:
            rnorm0 = rnorm0_reference(cfg, b, pc, nt, axis, beta)
            history[0] = beta
            monitor(cfg, 0, beta)
            if cfg.monitor_true:
                monitor_true(cfg, 0, beta, true_norm(x), bnorm)
            reason = check_convergence(beta, rnorm0, 0, cfg)

        V = torch.zeros((m + 1, n), dtype=b.dtype, device=b.device)
        V[0] = r / beta_t if beta > 0 else r
        Z = torch.zeros((m, n), dtype=b.dtype, device=b.device) \
            if flexible else None
        H = np.zeros((m + 1, m), dt)
        cs = np.zeros(m, dt)
        sn = np.zeros(m, dt)
        g = np.zeros(m + 1, dt)
        g[0] = beta
        j = 0
        while j < m and reason == ITERATING:
            if flexible:
                z = apply_pc(pc, V[j])
                Z[j] = z
                w = A.mult(z)
            else:
                w = apply_pc(pc, A.mult(V[j]))
            w, h_t = _orthogonalize(V, w, j, cfg, axis)
            hj1_t = ops.norm(w, axis)
            hh = torch.cat([h_t, hj1_t.to(h_t.dtype)[None]]).cpu().numpy()
            hj1 = hh[-1].real
            V[j + 1] = w / hj1_t if hj1 > 0 else w
            h = np.zeros(m + 1, dt)
            h[:j + 1] = hh[:-1]
            rnorm = _apply_givens(h, hj1, cs, sn, g, j)
            H[:, j] = h
            its += 1
            history[its] = rnorm
            monitor(cfg, its, rnorm)
            if cfg.monitor_true:
                # KSPBuildResidual: form the current iterate and its
                # actual residual
                basis = Z if flexible else V[:m]
                xcur = x + _solve_update(H, g, basis, j + 1, m)
                monitor_true(cfg, its, rnorm, true_norm(xcur), bnorm)
            reason = check_convergence(rnorm, rnorm0, its, cfg)
            # lucky/happy breakdown: residual exactly 0
            if reason == ITERATING and hj1 == 0:
                reason = ConvergedReason.CONVERGED_HAPPY_BREAKDOWN
            j += 1

        basis = Z if flexible else V[:m]
        x = x + _solve_update(H, g, basis, j, m)
    return make_result(x, its, reason, history)


def solve_gmres(A, b, x0, pc, cfg: KSPConfig, axis=None) -> SolveResult:
    """Left-preconditioned restarted GMRES (gmres.c default)."""
    return _gmres_generic(A, b, x0, pc, cfg, axis, flexible=False)


def solve_fgmres(A, b, x0, pc, cfg: KSPConfig, axis=None) -> SolveResult:
    """Flexible (right-preconditioned) GMRES storing Z directions."""
    return _gmres_generic(A, b, x0, pc, cfg, axis, flexible=True)
