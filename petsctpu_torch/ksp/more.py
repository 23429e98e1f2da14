"""More Krylov methods: SYMMLQ, GCR, BiCGStab(l), trust-region CG, LGMRES.

Reference impls: src/ksp/ksp/impls/{symmlq,gcr,bcgsl,cg/stcg,cg/nash,
cg/gltr,gmres/lgmres}. Each loop keeps petsctpu/ksp/more.py's order of
operations, multi-term reductions fused through `ops.reduce_all`, and
copies its norm and flags to the host once per iteration; BiCGStab(l)
also brings its (l+1)² Gram matrix over for LAPACK's pseudo-inverse,
and LGMRES its Hessenberg column, as GMRES does.
"""

from __future__ import annotations

import numpy as np
import torch

from petsctpu_torch.core.errors import ConvergedReason
from petsctpu_torch.device import np_dtype
from petsctpu_torch.ksp.common import (
    KSPConfig, SolveResult, advance, apply_pc, check_convergence,
    init_history, initial_guess, make_result, monitor, positive_or_one,
    preconditioned_residual, record, start, to_host,
)
from petsctpu_torch.ksp.gmres import (_apply_givens, _orthogonalize,
                                      _solve_update)
from petsctpu_torch.vec import ops

ITERATING = ConvergedReason.ITERATING
INDEFINITE_PC = ConvergedReason.DIVERGED_INDEFINITE_PC


# ---------------------------------------------------------------------------
# SYMMLQ — symmetric (possibly indefinite) systems, SPD preconditioner
# ---------------------------------------------------------------------------

def solve_symmlq(A, b, x0, pc, cfg: KSPConfig, axis=None) -> SolveResult:
    """SYMMLQ, transcribed to the reference's exact state machine
    (src/ksp/ksp/impls/symmlq/symmlq.c): Lanczos on the B-inner
    product with the deferred w/w_bar rotation (the its>1 update
    block), ceta three-term recurrence, residual MONITOR
    np0 = ||z||_2 then np = beta1·Π|s|/|c| (the CGNORM estimate,
    symmlq.c:91,163-167), and the exit move to the CG point
    x += (ceta/c)·w_bar. Requires symmetric A and SPD M."""
    x_base = initial_guess(b, x0, cfg)
    r = b - A.mult(x_base) if cfg.guess_nonzero else b
    z = apply_pc(pc, r)
    dp0 = torch.real(ops.dot(r, z, axis))
    beta1 = torch.sqrt(torch.clamp(dp0, min=0.0))
    sb1 = positive_or_one(beta1)
    v = r / sb1
    u = z / sb1
    wbar = u
    np0 = ops.norm(z, axis)
    history, np0_h, reason = start(cfg, np0, dp0 < 0, INDEFINITE_PC)
    zero = torch.zeros_like(b)
    one = torch.ones((), dtype=beta1.dtype, device=b.device)
    zs = torch.zeros((), dtype=beta1.dtype, device=b.device)
    x = zero
    uold = vold = zero
    beta, c, cold, s, sold = beta1, one, one, zs, zs
    ceta = ceta_old = ceta_oold = zs
    s_prod = torch.abs(beta1)
    its = 0
    while reason == ITERATING:
        its += 1
        if its > 1:
            sbeta = positive_or_one(beta)
            vold, uold = v, u
            v = r / sbeta
            u = z / sbeta
            w = c * wbar + s * u
            wbar = -s * wbar + c * u
            x = x + ceta * w
            ceta_oold, ceta_old = ceta_old, ceta
        # Lanczos
        r = A.mult(u)
        alpha = torch.real(ops.dot(u, r, axis))
        z = apply_pc(pc, r)
        r = r - alpha * v - beta * vold
        z = z - alpha * u - beta * uold
        betaold = beta
        dp = torch.real(ops.dot(r, z, axis))
        beta = torch.sqrt(torch.clamp(dp, min=0.0))
        # QR factorization of the tridiagonal
        coold, cold = cold, c
        soold, sold = sold, s
        rho0 = cold * alpha - coold * sold * betaold
        rho1 = torch.sqrt(rho0 * rho0 + beta * beta)
        rho2 = sold * alpha + coold * cold * betaold
        rho3 = soold * betaold
        srho1 = positive_or_one(rho1)
        c = rho0 / srho1
        s = beta / srho1
        if its == 1:
            ceta = beta1 / srho1
        else:
            ceta = -(rho2 * ceta_old + rho3 * ceta_oold) / srho1
        s_prod = s_prod * torch.abs(s)
        np_ = torch.where(c == 0, s_prod * 1e16,
                          s_prod / torch.where(c == 0, one, torch.abs(c)))
        np_h, indef = to_host(np_, dp < 0)
        reason = advance(cfg, history, its, np_h, np0_h, bool(indef),
                         INDEFINITE_PC)
    # move to the CG point: x <- x + (ceta/c) w_bar (symmlq.c:180-186)
    ceta_bar = torch.where(c == 0, ceta * 1e15,
                           ceta / torch.where(c == 0, one, c))
    return make_result(x_base + x + ceta_bar * wbar, its, reason, history)


# ---------------------------------------------------------------------------
# GCR(m) — flexible, right-preconditioned generalized conjugate residuals
# ---------------------------------------------------------------------------

def solve_gcr(A, b, x0, pc, cfg: KSPConfig, axis=None) -> SolveResult:
    """GCR(m) (reference gcr.c). Right-preconditioned and flexible; the
    orthogonalization of the new direction against the stored A-images
    is one [k,n]@[n] product (the VecMDots of gcr.c:40); the window of
    m directions restarts when it wraps."""
    m = cfg.restart
    n = b.shape[0]
    x = initial_guess(b, x0, cfg)
    r = b - A.mult(x) if cfg.guess_nonzero else b
    history, rnorm0, reason = start(cfg, ops.norm(r, axis))
    VV = torch.zeros((m, n), dtype=b.dtype, device=b.device)
    SS = torch.zeros((m, n), dtype=b.dtype, device=b.device)
    its = 0
    while reason == ITERATING:
        k = its % m
        s = apply_pc(pc, r)
        v = A.mult(s)
        if k > 0:
            betas = ops.mdot(v, VV[:k], axis)
            v = v - betas @ VV[:k]
            s = s - betas @ SS[:k]
        # projection coefficient <v, r> = conj(v)·r
        nv_sq, rv = ops.reduce_all((torch.vdot(v, v).real, torch.vdot(v, r)),
                                   axis)
        nv = torch.sqrt(nv_sq)
        snv = positive_or_one(nv)
        v = v / snv
        s = s / snv
        gamma = rv / snv
        x = x + gamma * s
        r = r - gamma * v
        VV[k] = v
        SS[k] = s
        dp, bad = to_host(ops.norm(r, axis), nv == 0)
        its += 1
        reason = advance(cfg, history, its, dp, rnorm0, bool(bad))
    return make_result(x, its, reason, history)


# ---------------------------------------------------------------------------
# BiCGStab(l) — Sleijpen–Fokkema polynomial BiCGStab
# ---------------------------------------------------------------------------

def solve_bcgsl(A, b, x0, pc, cfg: KSPConfig, axis=None) -> SolveResult:
    """BiCGStab(l) (reference bcgsl.c), left-preconditioned. The BiCG
    half-sweep runs over the polynomial degree l; the MR polynomial is
    found from the Gram matrix of the residual stack — one
    [l+1,n]@[n,l+1] product, then an SVD-based pseudo-inverse on the
    host (the residual stack goes numerically dependent near
    convergence; bcgsl.c uses LAPACK gelss with a drop tolerance)."""
    ell = max(1, int(cfg.bcgsl_ell))
    x = initial_guess(b, x0, cfg)
    r0 = preconditioned_residual(A, b, x, pc, cfg)

    def B(v):
        return apply_pc(pc, A.mult(v))

    history, rnorm0, reason = start(cfg, ops.norm(r0, axis))
    zero = torch.zeros_like(b)
    R = [r0] + [zero] * ell
    U = [zero] * (ell + 1)
    rt = r0
    rho0 = torch.ones((), dtype=b.dtype, device=b.device)
    alpha = torch.zeros((), dtype=b.dtype, device=b.device)
    omega = torch.ones((), dtype=b.dtype, device=b.device)
    dt = np_dtype(b.dtype)
    rcond = 64 * np.finfo(dt).eps
    its = 0
    while reason == ITERATING:
        rho0 = -omega * rho0
        breakdown = torch.zeros((), dtype=torch.bool, device=b.device)
        # ---- BiCG part ----
        for j in range(ell):
            rho1 = ops.dot(R[j], rt, axis)
            safe = rho0 != 0
            beta = alpha * rho1 / torch.where(safe, rho0,
                                              torch.ones_like(rho0))
            breakdown = breakdown | ~safe
            rho0 = rho1
            for i in range(j + 1):
                U[i] = R[i] - beta * U[i]
            U[j + 1] = B(U[j])
            gamma_d = ops.dot(U[j + 1], rt, axis)
            safe_g = gamma_d != 0
            alpha = rho0 / torch.where(safe_g, gamma_d,
                                       torch.ones_like(gamma_d))
            breakdown = breakdown | ~safe_g
            for i in range(j + 1):
                R[i] = R[i] - alpha * U[i + 1]
            R[j + 1] = B(R[j])
            x = x + alpha * U[0]
        # ---- MR part: minimize ||R[0] - sum_j g_j R[j]|| ----
        Rs = torch.stack(R)
        G = Rs @ Rs.T                         # (ell+1)² dots
        hh = torch.cat([G.reshape(-1), breakdown.reshape(1).to(G.dtype)]) \
            .cpu().numpy()
        Gh = hh[:-1].reshape(ell + 1, ell + 1)
        g_h = np.linalg.pinv(Gh[1:, 1:], rcond=rcond) @ Gh[1:, 0]
        g = torch.from_numpy(g_h.astype(dt)).to(b.device)
        x = x + g @ Rs[:ell]
        R[0] = R[0] - g @ Rs[1:]
        U[0] = U[0] - g @ torch.stack(U[1:])
        omega = g[ell - 1]
        (dp,) = to_host(ops.norm(R[0], axis))
        its += 1
        reason = advance(cfg, history, its, dp, rnorm0,
                         bool(hh[-1]) or g_h[ell - 1] == 0)
    return make_result(x, its, reason, history)


# ---------------------------------------------------------------------------
# Trust-region CG (STCG / NASH / GLTR) — for SNES Newton trust region
# ---------------------------------------------------------------------------

def solve_stcg(A, b, x0, pc, cfg: KSPConfig, axis=None) -> SolveResult:
    """Steihaug–Toint trust-region CG (reference stcg.c; nash.c and
    gltr.c share the interface — they refine the boundary handling,
    which this implementation resolves by stepping exactly to the
    sphere). cfg.radius <= 0 means unconstrained (plain PCG).

    On negative curvature or when the iterate would leave the ball
    ||x|| <= radius, x moves to the boundary along p and the solve
    stops with CONVERGED_CG_NEG_CURVE / CONVERGED_CG_CONSTRAINED —
    exactly the semantics SNES NEWTONTR consumes."""
    bounded = cfg.radius > 0
    radius = cfg.radius
    x = torch.zeros_like(b)         # TR solves always start at the origin
    r = b
    z = apply_pc(pc, r)
    rz = ops.dot(r, z, axis)
    history, rnorm0, reason = start(cfg, ops.norm(r, axis))
    p = z
    its = 0
    false = torch.zeros((), dtype=torch.bool, device=b.device)
    while reason == ITERATING:
        Ap = A.mult(p)
        kappa, xx, xp, pp = ops.reduce_all(
            (torch.vdot(p, Ap).real, torch.vdot(x, x).real,
             torch.vdot(x, p).real, torch.vdot(p, p).real), axis)
        neg_curve = kappa <= 0
        alpha = rz / torch.where(kappa != 0, kappa, torch.ones_like(kappa))
        crosses = false
        if bounded:
            # boundary intersection: ||x + tau p|| = radius, tau >= 0
            disc = torch.clamp(xp * xp + pp * (radius ** 2 - xx), min=0.0)
            tau = (-xp + torch.sqrt(disc)) / positive_or_one(pp)
            crosses = neg_curve | (torch.sqrt(torch.clamp(
                xx + 2 * alpha * xp + alpha ** 2 * pp, min=0.0)) >= radius)
            alpha = torch.where(crosses, tau.to(alpha.dtype), alpha)
        x = x + alpha * p
        r = r - alpha * Ap
        z = apply_pc(pc, r)
        rz_new, rr = ops.reduce_all((torch.vdot(r, z), torch.vdot(r, r).real),
                                    axis)
        beta = rz_new / torch.where(rz != 0, rz, torch.ones_like(rz))
        p = z + beta * p
        rz = rz_new
        dp, cross_h, neg_h = to_host(torch.sqrt(rr), crosses, neg_curve)
        its += 1
        reason = advance(cfg, history, its, dp, rnorm0)
        if cross_h:
            reason = (ConvergedReason.CONVERGED_CG_NEG_CURVE if neg_h
                      else ConvergedReason.CONVERGED_CG_CONSTRAINED)
    return make_result(x, its, reason, history)


# ---------------------------------------------------------------------------
# LGMRES(m, k) — GMRES augmented with previous-cycle error approximations
# ---------------------------------------------------------------------------

def solve_lgmres(A, b, x0, pc, cfg: KSPConfig, axis=None) -> SolveResult:
    """LGMRES (Baker–Jessup–Manteuffel; reference lgmres.c). Each
    restart cycle spends cfg.restart total directions, of which the
    trailing min(cycle, aug_dim) are the error approximations dx from
    previous cycles. lgmres.c:448 (approx_constant default false):
    every cycle runs restart − aug_dim Arnoldi steps, so the FIRST
    cycle uses only (restart − aug_dim) directions even though no error
    approximations exist yet. The Hessenberg, rotations and
    least-squares solve are on the host, as in `ksp/gmres.py`."""
    m = cfg.restart
    k_aug = min(cfg.aug_dim, m - 1)
    n = b.shape[0]
    dt = np_dtype(b.dtype)
    s_split = m - k_aug                          # Krylov directions
    history = init_history(cfg, b.dtype)
    x = initial_guess(b, x0, cfg)
    AUG = torch.zeros((max(k_aug, 1), n), dtype=b.dtype, device=b.device)
    its, reason, rnorm0, n_aug = 0, ITERATING, None, 0
    while reason == ITERATING:
        r = apply_pc(pc, b - A.mult(x))
        beta_t = ops.norm(r, axis)
        (beta,) = to_host(beta_t)
        if its == 0:
            rnorm0 = beta
            record(history, 0, beta)
            monitor(cfg, 0, beta)
            reason = check_convergence(beta, rnorm0, 0, cfg)
        j_tot = s_split + min(n_aug, k_aug)     # directions this cycle
        V = torch.zeros((m + 1, n), dtype=b.dtype, device=b.device)
        V[0] = r / beta_t if beta > 0 else r
        Z = torch.zeros((m, n), dtype=b.dtype, device=b.device)
        H = np.zeros((m + 1, m), dt)
        cs = np.zeros(m, dt)
        sn = np.zeros(m, dt)
        g = np.zeros(m + 1, dt)
        g[0] = beta
        j = 0
        while j < j_tot and reason == ITERATING:
            src = V[j] if j < s_split else AUG[j - s_split]
            Z[j] = src
            w = apply_pc(pc, A.mult(src))
            w, h_t = _orthogonalize(V, w, j, cfg)
            hj1_t = ops.norm(w, axis)
            hh = torch.cat([h_t, hj1_t.to(h_t.dtype)[None]]).cpu().numpy()
            hj1 = hh[-1].real
            V[j + 1] = w / hj1_t if hj1 > 0 else w
            h = np.zeros(m + 1, dt)
            h[:j + 1] = hh[:-1]
            rnorm = _apply_givens(h, hj1, cs, sn, g, j)
            H[:, j] = h
            its += 1
            reason = advance(cfg, history, its, rnorm, rnorm0, hj1 == 0,
                             ConvergedReason.CONVERGED_HAPPY_BREAKDOWN)
            j += 1
        dx = _solve_update(H, g, Z, j, m)
        x = x + dx
        if k_aug > 0:
            # store the normalized error approximation for the next cycle
            AUG = torch.roll(AUG, 1, dims=0)
            AUG[0] = dx / positive_or_one(ops.norm(dx, axis))
        n_aug += 1
    return make_result(x, its, reason, history)
