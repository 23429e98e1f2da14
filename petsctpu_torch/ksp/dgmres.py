"""DGMRES — deflated GMRES (adaptive spectral deflation at restarts).

Reference: src/ksp/ksp/impls/gmres/dgmres (Erhel, Burrage & Pohl;
KSPDGMRES: after each unconverged restart cycle, extract the smallest
Ritz vectors of the Arnoldi Hessenberg, accumulate them into a
deflation space U, and precondition subsequent cycles with
M_D⁻¹ = I + U(σ·T⁻¹ − I)Uᵀ, T = Uᵀ(A M⁻¹)U — removing the small
eigenvalues that make restarted GMRES stall).

Host-driven, as in the reference: LAPACK runs between cycles. The
Krylov basis V [m+1, n] and the deflation basis U stay on the
operands' device; the host gets one Hessenberg column an Arnoldi step
and works only on m×m matrices (eig of the Hessenberg, inv of T). The
Ritz vectors are lifted to n-vectors on the device, and U is
re-orthonormalized there (QR of the n×k stack).
"""

from __future__ import annotations

import numpy as np
import torch

from petsctpu_torch.core.errors import ConvergedReason
from petsctpu_torch.device import np_dtype
from petsctpu_torch.ksp.common import (
    KSPConfig, SolveResult, apply_pc, check_convergence, make_result, to_host,
)
from petsctpu_torch.ksp.gmres import (_apply_givens, _orthogonalize,
                                      _solve_update)
from petsctpu_torch.vec import ops


def _cycle(A, b, x, r, pc, cfg: KSPConfig, U, C):
    """One right-preconditioned Arnoldi(m) cycle on the operator
    w = A·pc(Md(v)), Md(v) = v + Uᵀ C (U v). It stops at m steps or
    when the Givens estimate reaches the cycle's own tolerance
    max(rtol·‖r‖, atol). Returns (x, r, V, Hraw, j): Hraw is the
    unrotated Hessenberg (host) for the Ritz extraction."""
    m = cfg.restart
    n = b.shape[0]
    dt = np_dtype(b.dtype)

    def Md(v):
        return v if U is None else v + U.T @ (C @ (U @ v))

    beta_t = ops.norm(r)
    (beta,) = to_host(beta_t)
    V = torch.zeros((m + 1, n), dtype=b.dtype, device=b.device)
    V[0] = r / beta_t if beta > 0 else r
    H = np.zeros((m + 1, m), dt)
    Hraw = np.zeros((m + 1, m), dt)
    cs = np.zeros(m, dt)
    sn = np.zeros(m, dt)
    g = np.zeros(m + 1, dt)
    g[0] = beta
    tol = max(dt.type(cfg.rtol) * beta, dt.type(cfg.atol))
    j, rnorm = 0, beta
    while j < m and rnorm > tol:
        w = A.mult(apply_pc(pc, Md(V[j])))
        w, h_t = _orthogonalize(V, w, j, cfg)
        hj1_t = ops.norm(w)
        hh = torch.cat([h_t, hj1_t.to(h_t.dtype)[None]]).cpu().numpy()
        hj1 = hh[-1].real
        V[j + 1] = w / hj1_t if hj1 > 0 else w
        h = np.zeros(m + 1, dt)
        h[:j + 1] = hh[:-1]
        h[j + 1] = hj1
        Hraw[:, j] = h
        rnorm = _apply_givens(h, hj1, cs, sn, g, j)
        H[:, j] = h
        j += 1
    # x update: dx = pc(Md(Vᵀ y))
    x = x + apply_pc(pc, Md(_solve_update(H, g, V[:m], j, m)))
    return x, b - A.mult(x), V, Hraw, j


def _ritz_vectors(Hm, extract_k):
    """The real basis of the extract_k smallest-magnitude Ritz vectors
    of the j×j Hessenberg (conjugate pairs kept together), host numpy;
    and the largest Ritz magnitude. None if LAPACK fails."""
    try:
        lam, W = np.linalg.eig(Hm)
    except np.linalg.LinAlgError:
        return None, None
    take = []
    for idx in np.argsort(np.abs(lam)):
        if len(take) >= extract_k:
            break
        take.append(idx)
        # keep conjugate pairs together for a real basis
        if abs(lam[idx].imag) > 0 and len(take) < extract_k + 1:
            conj = np.argmin(np.abs(lam - np.conj(lam[idx])))
            if conj not in take:
                take.append(conj)
    Wr = np.real(W[:, take])
    Wi = np.imag(W[:, take])
    W = np.unique(np.concatenate([Wr, Wi], axis=1).round(14), axis=1)
    return W, float(np.abs(lam).max())


def solve_dgmres(A, b, x0, pc, cfg: KSPConfig, axis=None,
                 max_neig: int = 8, extract_k: int = 2) -> SolveResult:
    if axis is not None:
        raise ValueError("dgmres is host-driven (between-cycle LAPACK, as "
                         "in the reference); use lgmres on the SPMD path")
    x = x0 if cfg.guess_nonzero else torch.zeros_like(b)
    r = b - A.mult(x) if cfg.guess_nonzero else b
    rnorm0 = float(to_host(ops.norm(r, axis))[0])
    history = np.full(cfg.maxits + 1, np.nan)
    history[0] = rnorm0
    reason = check_convergence(np.float64(rnorm0), np.float64(rnorm0), 0,
                               cfg)
    its = 0
    U = C = None                       # no deflation yet: Md = I
    # the deflation basis in double precision (complex for complex solves)
    U64 = torch.zeros((0, b.shape[0]), device=b.device,
                      dtype=torch.promote_types(b.dtype, torch.float64))
    sigma = 1.0
    while reason == ConvergedReason.ITERATING:
        x, r, V, Hraw, j = _cycle(A, b, x, r, pc, cfg, U, C)
        rn = float(to_host(ops.norm(r, axis))[0])     # true residual
        its += j
        history[min(its, cfg.maxits)] = rn       # filled at cycle ends only
        reason = check_convergence(np.float64(rn), np.float64(rnorm0), its,
                                   cfg)
        if reason != ConvergedReason.ITERATING or j < 1:
            break
        # ---- host: Ritz extraction from the j×j Hessenberg ----
        W, lam_max = _ritz_vectors(Hraw[:j, :j], extract_k)
        if W is None:
            continue
        sigma = max(sigma, lam_max)
        # new deflation vectors, lifted on the device in the basis's
        # dtype (petsctpu's numpy product keeps it)
        cand = torch.from_numpy(np.ascontiguousarray(W.T)).to(
            V.device, V.dtype) @ V[:j]
        U64 = torch.cat([U64, cand.to(U64.dtype)])
        # re-orthonormalize and cap the basis size
        Q, _ = torch.linalg.qr(U64.T)
        U64 = Q.T[:max_neig]
        # T = Uᵀ (A M⁻¹) U (r matvecs)
        Ud = U64.to(b.dtype)
        AU = torch.stack([A.mult(apply_pc(pc, u)) for u in Ud])
        T = (Ud @ AU.T).cpu().numpy()
        try:
            Cn = sigma * np.linalg.inv(T) - np.eye(T.shape[0])
        except np.linalg.LinAlgError:
            Cn = np.zeros_like(T)
        U, C = Ud, torch.from_numpy(np.asarray(Cn)).to(b.device, b.dtype)
    (rfinal,) = to_host(ops.norm(r, axis))
    hist = history.astype(np_dtype(rfinal.dtype))
    return make_result(x, min(its, cfg.maxits), reason, hist,
                       rnorm=rfinal)
