"""Chebyshev iteration, Richardson and preonly, and the Krylov spectrum
estimators.

Reference: KSPSolve_Chebychev (src/ksp/ksp/impls/cheby/cheby.c:345):
no inner products in the hot loop, which is why it is the default MG
smoother. Eigenvalue bounds are auto-estimated like the reference's
estimate-eigenvalues option: a few power iterations on M⁻¹A, then
(emin, emax) = (0.1, 1.1)·λmax — the reference's default transform
factors. KSPSolve_Richardson (src/ksp/ksp/impls/rich), KSPSolve_PREONLY
(src/ksp/ksp/impls/preonly); the Arnoldi estimators are gmreig.c's
KSPComputeEigenvalues_GMRES / KSPComputeExtremeSingularValues_GMRES.

The Arnoldi basis lives on the operands' device in fp64 (petsctpu
copies every basis vector to host numpy); only the small Hessenberg
comes to the host, one column a step, for LAPACK's eigvals and svd.
"""

from __future__ import annotations

import numpy as np
import torch

from petsctpu_torch.core.errors import ConvergedReason
from petsctpu_torch.ksp.common import (
    KSPConfig, SolveResult, NORM_NONE, NORM_PRECONDITIONED, advance,
    apply_pc, check_convergence, init_history, initial_guess, make_result,
    monitor, record, start, to_host,
)
from petsctpu_torch.vec import ops

ITERATING = ConvergedReason.ITERATING


def estimate_lambda_max(A, pc, n, dtype, axis=None, iters: int = 12,
                        seed: int = 7, device=None):
    """Power-iteration estimate of λmax(M⁻¹A) (deterministic start);
    a 0-d tensor of the solve's real dtype on `device`."""
    rdtype = torch.empty((), dtype=dtype).real.dtype
    i = torch.arange(n, dtype=rdtype, device=device)
    v = (torch.sin(i * 12.9898 + 78.233) + 0.01).to(dtype)
    v = v / ops.norm(v, axis)
    lam = torch.ones((), dtype=v.real.dtype, device=device)
    for _ in range(iters):
        w = apply_pc(pc, A.mult(v))
        lam = ops.norm(w, axis)
        v = w / torch.where(lam > 0, lam, torch.ones_like(lam))
    return lam


def _arnoldi(A, pc, b, iters: int, refine: bool) -> np.ndarray:
    """`iters` left-preconditioned Arnoldi steps on the right-hand side
    b with classical Gram-Schmidt (one refinement pass if `refine`), in
    fp64. Returns the (k+1)×k Hessenberg on the host; its basis stays on
    b's device."""
    v = apply_pc(pc, b).to(torch.float64)
    (beta,) = to_host(ops.norm(v))
    n = v.shape[0]
    m = min(iters, n)
    H = np.zeros((m + 1, m))
    if beta == 0.0:
        return H[:1, :0]
    V = torch.zeros((m + 1, n), dtype=torch.float64, device=v.device)
    V[0] = v / float(beta)
    k = m
    for j in range(m):
        w = apply_pc(pc, A.mult(V[j])).to(torch.float64)
        Vj = V[:j + 1]
        h = Vj @ w
        w = w - h @ Vj
        if refine:
            h2 = Vj @ w
            w = w - h2 @ Vj
            h = h + h2
        hh = to_host(*h, ops.norm(w))
        H[:j + 1, j] = hh[:-1]
        hj1 = float(hh[-1])
        H[j + 1, j] = hj1
        if hj1 == 0.0:
            k = j + 1
            break
        V[j + 1] = w / hj1
    return H[:k + 1, :k]


def _arnoldi_hessenberg(A, pc, b, iters: int = 10) -> np.ndarray:
    """A fixed number (default 10, KSPSetTolerances cheby.c:77) of
    left-preconditioned GMRES/Arnoldi steps on the solve's actual
    right-hand side with classical Gram-Schmidt (the est-GMRES
    default, borthog2.c, REFINE_NEVER). Returns the (k+1)×k
    Hessenberg, host numpy fp64."""
    return _arnoldi(A, pc, b, iters, refine=False)


def estimate_eigen_arnoldi(A, pc, b, iters: int = 10):
    """(min, max) of the real parts of the Hessenberg Ritz values —
    the KSPComputeEigenvalues_GMRES convention (gmreig.c geev path)."""
    H = _arnoldi_hessenberg(A, pc, b, iters)
    k = H.shape[1]
    if k == 0:
        return 0.0, 0.0
    ritz = np.linalg.eigvals(H[:k, :k])
    return float(ritz.real.min()), float(ritz.real.max())


def _extreme_singular(H):
    if H.shape[1] == 0:
        return 0.0, 0.0
    s = np.linalg.svd(H, compute_uv=False)
    return float(s.min()), float(s.max())


def estimate_extreme_singular_arnoldi(A, pc, b, iters: int = 10):
    """Extreme SINGULAR values of the full (k+1)×k Hessenberg — the
    KSPComputeExtremeSingularValues_GMRES convention (gmreig.c gesvd
    of hh_origin), the estimator the reference's chebyest golden
    outputs were made with: (σmin, σmax) = (0.0357405, 1.1495838) on
    the 80×80 ex2 system with ILU(0). Apply the a,b,c,d transform at
    the call site: emin = a·min + b·max, emax = c·min + d·max."""
    return _extreme_singular(_arnoldi_hessenberg(A, pc, b, iters))


def solve_chebyshev(A, b, x0, pc, cfg: KSPConfig, axis=None) -> SolveResult:
    x = initial_guess(b, x0, cfg)
    if cfg.cheby_emax > 0:
        emin = torch.tensor(cfg.cheby_emin, dtype=b.dtype, device=b.device)
        emax = torch.tensor(cfg.cheby_emax, dtype=b.dtype, device=b.device)
    else:
        lam = estimate_lambda_max(A, pc, b.shape[0], b.dtype, axis,
                                  device=b.device)
        emin = 0.1 * lam     # reference default transform (0, 0.1, 0, 1.1)
        emax = 1.1 * lam
    theta = 0.5 * (emax + emin)
    delta = 0.5 * (emax - emin)
    sigma = theta / delta
    norm_type = cfg.norm_type or NORM_PRECONDITIONED
    want_norm = norm_type != NORM_NONE

    r = b - A.mult(x)
    z = apply_pc(pc, r)
    # NO initial monitor: the reference applies the first correction
    # p[k] = x + scale·B⁻¹r BEFORE the counted loop, and the first
    # monitor (labelled 0, at ksp->its == 1) shows the residual AFTER
    # it; KSPDefaultConverged's rnorm0 snapshot is therefore that
    # after-one-correction norm (cheby.c:429-488).
    history = init_history(cfg, b.dtype)
    reason, its, rnorm0 = ITERATING, 0, None
    d = z / theta
    rho_old = 1.0 / sigma
    while reason == ITERATING:
        x = x + d
        r = r - A.mult(d)
        z = apply_pc(pc, r)
        rho = 1.0 / (2.0 * sigma - rho_old)
        d = rho * rho_old * d + (2.0 * rho / delta) * z
        its += 1
        if want_norm:
            (dp,) = to_host(ops.norm(z if norm_type == NORM_PRECONDITIONED
                                     else r, axis))
            if its == 1:
                rnorm0 = dp
            # history index = reference monitor label = its - 1
            record(history, its - 1, dp)
            monitor(cfg, its - 1, dp)
            reason = check_convergence(dp, rnorm0, its, cfg)
        elif its >= cfg.maxits:
            reason = ConvergedReason.CONVERGED_ITS
        rho_old = rho
    # KSPSolve_Chebyshev applies the initial scale·B⁻¹r step BEFORE its
    # counted loop, so a max_it-bounded solve ends with max_it+1 total
    # corrections — the last applied after the final convergence check
    if reason in (ConvergedReason.CONVERGED_ITS,
                  ConvergedReason.DIVERGED_ITS):
        x = x + d
    return make_result(x, its, reason, history,
                       rnorm=history[max(its - 1, 0)])


def solve_richardson(A, b, x0, pc, cfg: KSPConfig, axis=None) -> SolveResult:
    """Richardson x ← x + s·M⁻¹r (src/ksp/ksp/impls/rich); with
    -ksp_richardson_self_scale (rich.c:84-92) the per-step scale
    (Br)ᴴ(BABr)/(BABr)ᴴ(BABr), x, r AND z updated by it (one PC apply
    per iteration)."""
    x = initial_guess(b, x0, cfg)
    s = cfg.richardson_scale
    norm_type = cfg.norm_type or NORM_PRECONDITIONED
    want_norm = norm_type != NORM_NONE

    def conv_norm(r, z):
        return ops.norm(z if norm_type == NORM_PRECONDITIONED else r, axis)

    r = b - A.mult(x)
    z = apply_pc(pc, r)
    if want_norm:
        history, rnorm0, reason = start(cfg, conv_norm(r, z))
    else:
        history = init_history(cfg, b.dtype)
        record(history, 0, 0.0)
        monitor(cfg, 0, history[0])
        reason = ITERATING
    its = 0
    while reason == ITERATING:
        if cfg.richardson_self_scale:
            w = A.mult(z)
            y = apply_pc(pc, w)
            ss = ops.dot(z, y, axis) / ops.dot(y, y, axis)
            x = x + ss * z
            r = r - ss * w
            z = z - ss * y
        else:
            x = x + s * z
            r = r - s * A.mult(z)
            z = apply_pc(pc, r)
        its += 1
        if want_norm:
            (dp,) = to_host(conv_norm(r, z))
            reason = advance(cfg, history, its, dp, rnorm0)
        elif its >= cfg.maxits:
            reason = ConvergedReason.CONVERGED_ITS
    return make_result(x, its, reason, history)


def solve_preonly(A, b, x0, pc, cfg: KSPConfig, axis=None) -> SolveResult:
    """x = M⁻¹ b (src/ksp/ksp/impls/preonly) — one PC application."""
    x = apply_pc(pc, b)
    history = init_history(cfg, b.dtype)
    return make_result(x, 1, ConvergedReason.CONVERGED_ITS, history,
                       rnorm=np.zeros((), history.dtype))


def ksp_compute_eigenvalues(A, pc, b, iters: int = 30):
    """KSPComputeEigenvalues analog (-ksp_compute_eigenvalues,
    gmreig.c KSPComputeEigenvalues_GMRES): Ritz values of the
    preconditioned operator M⁻¹A from an `iters`-step Arnoldi run (one
    refinement pass: full-dimension Arnoldi needs it) on the solve's
    right-hand side. Returns a complex numpy array (host)."""
    H = _arnoldi(A, pc, b, iters, refine=True)
    k = H.shape[1]
    if k == 0:
        return np.zeros(0, np.complex128)
    return np.linalg.eigvals(H[:k, :k])


def ksp_compute_extreme_singular_values(A, pc, b, iters: int = 30):
    """KSPComputeExtremeSingularValues analog (gmreig.c:21): extreme
    singular values of the preconditioned operator from the Arnoldi
    upper-Hessenberg (SVD of H̄ₘ). Returns (smin, smax)."""
    return _extreme_singular(_arnoldi(A, pc, b, iters, refine=True))
