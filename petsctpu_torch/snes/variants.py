"""More nonlinear solvers: NEWTONTR, NGMRES (Anderson), QN.

Counterpart of petsctpu/snes/variants.py (reference: src/snes/impls/tr,
src/snes/impls/ngmres, src/snes/impls/qn). Each solver's outer loop, and
each inner loop that ends on a test, is an eager Python loop that reads
its branch scalars to the host once an iteration (snes/api.py's
Monitor); the vectors and the small dense histories stay on the device
of x.
"""

from __future__ import annotations

from typing import Callable, Optional

import numpy as np
import torch

from petsctpu_torch.core.errors import SNESConvergedReason
from petsctpu_torch.ksp.common import to_host
from petsctpu_torch.snes.api import (Monitor, SNESConfig, SNESResult,
                                     _linesearch_cp, _linesearch_l2,
                                     configure, jacobian_builder)
from petsctpu_torch.vec import ops

R = SNESConvergedReason


def snes_newtontr(F: Callable, x0: torch.Tensor, cfg: SNESConfig = None,
                  axis: Optional[str] = None, delta0: float = 0.2,
                  delta_max: float = 1e10, eta: float = 1e-4,
                  cg_maxits: int = 50, cg_rtol: float = 1e-8,
                  **kw) -> SNESResult:
    """Gauss-Newton trust region with Steihaug-CG subproblem solves on
    φ(x)=½‖F‖² with model Hessian JᵀJ (products by torch.func jvp/vjp);
    CG stops at the trust boundary or on negative curvature."""
    cfg = configure(cfg, kw)

    def phi(x):
        r = F(x)
        return 0.5 * ops.dot(r, r, axis).real, r

    def Hv(x, v):
        Jv = torch.func.jvp(F, (x,), (v,))[1]
        return torch.func.vjp(F, x)[1](Jv)[0]

    def steihaug(x, g, delta):
        """min gᵀp + ½pᵀHp  s.t. ‖p‖ ≤ Δ."""
        p = torch.zeros_like(x)
        r = -g
        d = r
        rr = ops.dot(r, r, axis).real
        rr0 = rr
        (done,) = to_host(rr0 == 0)
        k = 0
        while not done and k < cg_maxits:
            Hd = Hv(x, d)
            dHd = ops.dot(d, Hd, axis).real
            alpha = rr / dHd
            p_new = p + alpha * d
            over = ops.norm(p_new, axis) >= delta
            # τ solving ‖p + τd‖ = Δ
            pd = ops.dot(p, d, axis).real
            dd = ops.dot(d, d, axis).real
            pp = ops.dot(p, p, axis).real
            disc = torch.clamp(pd * pd - dd * (pp - delta * delta), min=0.0)
            tau = (-pd + torch.sqrt(disc)) / torch.where(
                dd > 0, dd, torch.ones_like(dd))
            neg_curv = dHd <= 0
            p = torch.where(neg_curv | over, p + tau * d, p_new)
            r = r - alpha * Hd
            rr_new = ops.dot(r, r, axis).real
            stop = neg_curv | over | (torch.sqrt(rr_new)
                                      <= cg_rtol * torch.sqrt(rr0))
            d = r + (rr_new / rr) * d
            rr = rr_new
            (done,) = to_host(stop)
            k += 1
        return p

    f0, _ = phi(x0)
    mon = Monitor(cfg, x0, torch.sqrt(2.0 * f0), axis)
    x = x0
    delta = torch.tensor(delta0, dtype=x0.dtype, device=x0.device)
    while mon.iterating:
        fval, r = phi(x)
        g = torch.func.vjp(F, x)[1](r)[0]          # ∇φ = JᵀF
        p = steihaug(x, g, delta)
        fnew, _ = phi(x + p)
        # model decrease: −gᵀp − ½pᵀHp
        pred = -(ops.dot(g, p, axis).real
                 + 0.5 * ops.dot(p, Hv(x, p), axis).real)
        rho = (fval - fnew) / torch.where(pred > 0, pred,
                                          torch.full_like(pred, 1e-30))
        accept = rho > eta
        x_new = torch.where(accept, x + p, x)
        pn = ops.norm(p, axis)
        delta = torch.where(
            rho < 0.25, 0.25 * delta,
            torch.where((rho > 0.75) & (pn >= 0.99 * delta),
                        torch.clamp(2.0 * delta, max=delta_max), delta))
        fn = torch.sqrt(2.0 * torch.where(accept, fnew, fval))
        fnh, pnh, xnh, dh = to_host(fn, pn, ops.norm(x_new, axis), delta)
        mon.step(fnh, pnh, xnh,
                 R.DIVERGED_LINE_SEARCH if dh < 1e-14 else None)
        x = x_new
    return mon.result(x, ops.norm(F(x), axis))


def snes_tr(F: Callable, x0: torch.Tensor, jac=None, pc_builder=None,
            ksp_cfg=None, cfg: SNESConfig = None,
            axis: Optional[str] = None, delta0: float = 0.2,
            delta1: float = 0.3, delta2: float = 0.75, delta3: float = 2.0,
            mu: float = 0.25, eta: float = 0.75, sigma: float = 1e-4,
            deltatol: float = 1e-12, max_shrinks: int = 30,
            **kw) -> SNESResult:
    """The reference's Newton trust region (src/snes/impls/tr/tr.c): ONE
    Krylov solve of J·Y = F an outer iteration (tr.c:166), then the
    shrink loop (tr.c:173-219): clip the step to the radius (‖Y‖ ≥ Δ
    scales it by Δ/‖Y‖, predicted norm (1−Δ/‖Y‖)·‖F‖), evaluate the
    trial, ρ = (‖F‖²−‖G‖²)/(‖F‖²−gpnorm²), Δ ← Δ·{delta1|delta2|delta3}
    on ρ < mu / < eta / else, accept when ρ > sigma. Δ0 = delta0·‖F(x0)‖
    (tr.c:134); CONVERGED_TR_DELTA when Δ < ‖x‖·deltatol."""
    from petsctpu_torch.ksp.api import KSP_REGISTRY
    from petsctpu_torch.ksp.common import KSPConfig

    cfg = configure(cfg, kw)
    ksp_cfg = ksp_cfg or KSPConfig(ksp_type="gmres", rtol=1e-5, maxits=200)
    build_J = jacobian_builder(F, jac or cfg.jac)
    ksolver = KSP_REGISTRY[ksp_cfg.ksp_type]

    x = x0
    Fx = F(x)
    fnorm_t = ops.norm(Fx, axis)
    mon = Monitor(cfg, x, fnorm_t, axis)
    dt = mon.dt
    fnorm = mon.fnorm0
    delta = dt(delta0) * fnorm                            # tr.c:134
    with np.errstate(all="ignore"):
        while mon.iterating:
            J = build_J(x, Fx)
            pc = pc_builder(J) if pc_builder is not None else None
            kres = ksolver(J, Fx, torch.zeros_like(x), pc, ksp_cfg, axis)
            Ytmp = kres.x
            nrm0, xnorm = to_host(ops.norm(Ytmp, axis), ops.norm(x, axis))
            accepted, tries = False, 0
            Xt, G, gnorm_t, gnorm, ynorm = x, Fx, fnorm_t, fnorm, dt(0)
            while not accepted and tries < max_shrinks:
                over = nrm0 >= delta
                s = delta / max(nrm0, dt(1e-300)) if over else dt(1.0)
                gpnorm = (dt(1.0) - s) * fnorm if over else dt(0.0)
                ynorm = delta if over else nrm0
                Xt = x - float(s) * Ytmp                   # tr.c:191
                G = F(Xt)
                gnorm_t = ops.norm(G, axis)
                (gnorm,) = to_host(gnorm_t)
                denom = fnorm * fnorm - gpnorm * gpnorm
                rho = (dt(0.0) if fnorm == gpnorm else
                       (fnorm * fnorm - gnorm * gnorm)
                       / (denom if denom != 0 else dt(1.0)))
                delta = delta * dt(delta1 if rho < mu else
                                   delta2 if rho < eta else delta3)
                accepted = bool(rho > sigma)
                tries += 1
                if delta < xnorm * dt(deltatol):
                    break
            if accepted:
                x_new, Fx, fnorm_t, fnorm = Xt, G, gnorm_t, gnorm
            else:
                x_new = x
            (xn_norm,) = to_host(ops.norm(x_new, axis))
            fail = (R.CONVERGED_TR_DELTA if not accepted else
                    R.DIVERGED_LINEAR_SOLVE if int(kres.reason) < 0
                    else None)
            mon.step(fnorm, ynorm, xn_norm, fail)
            x = x_new
    return mon.result(x, fnorm_t)


def snes_anderson(F: Callable, x0: torch.Tensor, window: int = 5,
                  beta: float = 1.0, cfg: SNESConfig = None,
                  axis: Optional[str] = None,
                  npc: Optional[Callable] = None, **kw) -> SNESResult:
    """Anderson mixing / nonlinear GMRES (src/snes/impls/ngmres): a window
    of (x, F) pairs; each step solves min‖F_k + Σαᵢ(Fᵢ−F_k)‖ and
    combines. npc: an optional nonlinear preconditioner x → x' applied
    to the accelerated point each iteration. On a Comm the small Gram
    system's two contractions are summed over the ranks (two psums an
    iteration), so every rank solves the same one."""
    cfg = configure(cfg, kw)
    dtype, dev = x0.dtype, x0.device
    n, w = x0.shape[0], window
    Fx = F(x0)
    mon = Monitor(cfg, x0, ops.norm(Fx, axis), axis)
    x = x0
    Xh = torch.zeros((w, n), dtype=dtype, device=dev)
    Fh = torch.zeros((w, n), dtype=dtype, device=dev)
    ar = torch.arange(w, device=dev)
    while mon.iterating:
        its = mon.its
        k = min(its, w)
        slot = its % w
        Xh[slot] = x
        Fh[slot] = Fx
        valid = ((ar < k) & (ar != slot)) | ((ar == slot) & (k == w))
        D = Fx[None, :] - Fh
        Dm = torch.where(valid[:, None], D, torch.zeros_like(D))
        G = ops.psum(Dm @ Dm.T, axis) \
            + 1e-12 * torch.eye(w, dtype=dtype, device=dev)
        alpha = torch.linalg.solve(G, ops.psum(Dm @ Fx, axis))
        alpha = torch.where(valid, alpha, torch.zeros_like(alpha))
        x_mix = x + (Xh - x[None, :]).T @ alpha
        F_mix = Fx - Dm.T @ alpha
        x_new = x_mix - beta * F_mix
        if npc is not None:
            x_new = npc(x_new)
        Fn = F(x_new)
        mon.step_from(x_new, x, ops.norm(Fn, axis))
        x, Fx = x_new, Fn
    return mon.result(x, ops.norm(F(x), axis))


def snes_qn(F: Callable, x0: torch.Tensor, history_len: int = 10,
            cfg: SNESConfig = None, axis: Optional[str] = None,
            scale_type: str = "shanno", restart_type: str = "powell",
            powell_gamma: float = 0.9999, **kw) -> SNESResult:
    """L-BFGS quasi-Newton on F, the reference's SNESQN (qn.c
    SNESQNApply_LBFGS + SNESSolve_QN): secant pairs (dX, dF) of
    successive iterates, the two-loop recursion with Shanno's initial
    scaling γ = dX·dF/dF·dF of the latest pair, Powell restarts
    (|Dold·D| > 0.9999·|Dold·Dold|) and the CP line search, the defaults
    of qn.c:762-773."""
    cfg = configure(cfg, kw)
    dtype, dev = x0.dtype, x0.device
    n, m = x0.shape[0], history_len
    Fx = F(x0)
    mon = Monitor(cfg, x0, ops.norm(Fx, axis), axis)
    dX = torch.zeros((m, n), dtype=dtype, device=dev)
    dF = torch.zeros((m, n), dtype=dtype, device=dev)
    dXtdF = [None] * m
    scaling = torch.ones((), dtype=dtype, device=dev)
    x, D = x0, Fx
    Dold = Xold = torch.zeros_like(x0)
    i_r = 0
    while mon.iterating:
        # the two-loop recursion over the l stored pairs (qn.c)
        l = min(i_r, m)
        if i_r > 0:
            k_new = (i_r - 1) % m
            dFk, dXk = D - Dold, x - Xold
            dX[k_new], dF[k_new] = dXk, dFk
            dXtdF[k_new] = ops.dot(dXk, dFk, axis)
            if scale_type == "shanno":
                scaling = dXtdF[k_new] / ops.dot(dFk, dFk, axis)
        Y = D
        alpha = [None] * m
        for i2 in range(l):
            k = (i_r - i2 - 1) % m
            alpha[k] = ops.dot(dX[k], Y, axis) / dXtdF[k]
            Y = Y - alpha[k] * dF[k]
        Y = Y * scaling
        for i2 in range(l):
            k = (i_r - l + i2) % m
            b = ops.dot(dF[k], Y, axis) / dXtdF[k]
            Y = Y + (alpha[k] - b) * dX[k]
        Dold, Xold = D, x
        xn, Fn, fn_t, _, _ = _linesearch_cp(F, x, Y, Fx, axis)
        mon.step_from(xn, x, fn_t)
        D = Fn
        # Powell restart: history dropped when the new direction is too
        # close to the old one (qn.c:462-473)
        powell = torch.abs(ops.dot(Dold, D, axis)) > \
            powell_gamma * torch.abs(ops.dot(Dold, Dold, axis))
        (powell,) = to_host(powell)
        i_r = 0 if (restart_type == "powell" and powell) else i_r + 1
        x, Fx = xn, Fn
    return mon.result(x, mon.history[mon.its])


def snes_ngmres(F: Callable, x0: torch.Tensor, msize: int = 30,
                cfg: SNESConfig = None, axis: Optional[str] = None,
                gammaA: float = 2.0, gammaC: float = 2.0,
                epsilonB: float = 0.1, deltaB: float = 0.9,
                restart_it: int = 2, npc: Optional[Callable] = None,
                **kw) -> SNESResult:
    """SNESNGMRES (src/snes/impls/ngmres/snesngmres.c): each iteration
    takes an L2-line-search Richardson step (or, with npc, one inner
    solve) to (XM, FM), minimizes ‖FM − Σβ(FM − F_i)‖ over the stored
    subspace through the Gram matrix (H β = ν − ξ), forms the
    accelerated XA, then applies the DIFFERENCE selection (gammaA,
    epsilonB, deltaB) and DIFFERENCE restart (gammaC, restart_it = 2)
    with the reference's default constants (snesngmres.c:726-742). On a
    Comm the subspace's inner products (ξ, the new Q column) and the
    distances to it are summed over the ranks, so every rank takes the
    same selection and restart: the serial method's iterates. (petsctpu
    under shard_map reduces them per shard, and its shards then
    disagree; ROADMAP queue 3.)"""
    cfg = configure(cfg, kw)
    dtype, dev = x0.dtype, x0.device
    n, m = x0.shape[0], msize
    Fc = F(x0)
    fnorm_t = ops.norm(Fc, axis)
    mon = Monitor(cfg, x0, fnorm_t, axis)
    fnorm = mon.fnorm0
    Xdot = torch.zeros((m, n), dtype=dtype, device=dev)
    Fdot = torch.zeros((m, n), dtype=dtype, device=dev)
    Q = torch.zeros((m, m), dtype=dtype, device=dev)
    Xdot[0], Fdot[0], Q[0, 0] = x0, Fc, fnorm_t * fnorm_t
    X, l, k_restart, restart_count = x0, 1, 1, 0
    fminnorm = fnorm_t
    ar = torch.arange(m, device=dev)
    eps = float(np.finfo(mon.dt).eps)
    while mon.iterating:
        ivec = k_restart % m
        if npc is not None:
            # right nonlinear preconditioning (snesngmres.c:254-266)
            XM = npc(X)
            FM = F(XM)
            fMnorm = ops.norm(FM, axis)
        else:
            XM, FM, fMnorm, _, _ = _linesearch_l2(F, X, Fc, fnorm, axis)
        nu = fMnorm * fMnorm
        fminnorm = torch.minimum(fminnorm, fMnorm)
        mask = (ar < l).to(dtype)
        xi = ops.psum(Fdot @ FM, axis) * mask
        rhs = (nu - xi) * mask
        H = (Q - xi[:, None] - xi[None, :] + nu) * (mask[:, None]
                                                    * mask[None, :])
        # inactive slots → p·I with p = max|H_active|, so the padded
        # matrix has the active block's σmax; then an SVD solve with
        # LAPACK gelss's rcond rule (σ ≤ eps·σmax dropped,
        # snesngmres.c:315)
        pad = torch.clamp(torch.max(torch.abs(H)), min=1e-300)
        H = H + pad * torch.diag(1.0 - mask)
        U, S, Vt = torch.linalg.svd(H, full_matrices=False)
        keep = S > eps * S[0]
        Sinv = torch.where(keep, 1.0 / torch.where(keep, S,
                                                   torch.ones_like(S)),
                           torch.zeros_like(S))
        beta = (Vt.T @ (Sinv * (U.T @ rhs))) * mask
        XA = (1.0 - torch.sum(beta)) * XM + beta @ Xdot
        FA = F(XA)
        fAnorm = ops.norm(FA, axis)
        dnorm = ops.norm(XA - XM, axis)
        dall = torch.sqrt(ops.psum(torch.sum((Xdot - XA[None, :]) ** 2,
                                             dim=1), axis))
        dminnorm = torch.min(torch.where(mask > 0, dall,
                                         torch.full_like(dall, np.inf)))
        # DIFFERENCE selection (snesngmres.c:440-470)
        selectA = (fAnorm < gammaA * fminnorm) & (
            (epsilonB * dnorm < dminnorm)
            | (torch.sqrt(fnorm_t) < deltaB * torch.sqrt(fminnorm)))
        # DIFFERENCE restart (snesngmres.c:480-500)
        bad = ((epsilonB * dnorm > dminnorm)
               & (torch.sqrt(fAnorm) > deltaB * torch.sqrt(fminnorm))) \
            | (torch.sqrt(fAnorm) > gammaC * torch.sqrt(fminnorm))
        sel, bad = to_host(selectA, bad)
        Xn, Fn, fn_t = (XA, FA, fAnorm) if sel else (XM, FM, fMnorm)
        restart_count = restart_count + 1 if bad else 0
        do_restart = restart_count >= restart_it
        fminnorm = torch.minimum(fminnorm, fn_t)
        if do_restart:
            l, k_restart, restart_count = 1, 1, 0
            Xdot = torch.zeros_like(Xdot)
            Fdot = torch.zeros_like(Fdot)
            Q = torch.zeros_like(Q)
            Xdot[0], Fdot[0], Q[0, 0] = Xn, Fn, fn_t * fn_t
        else:
            l_app = min(l + 1, m)
            Xdot[ivec], Fdot[ivec] = Xn, Fn
            xi2 = ops.psum(Fdot @ Fn, axis) * (ar < l_app).to(dtype)
            Q[:, ivec] = xi2
            Q[ivec, :] = xi2
            l, k_restart = l_app, k_restart + 1
        mon.step_from(Xn, X, fn_t)
        X, Fc, fnorm_t, fnorm = Xn, Fn, fn_t, mon.history[mon.its]
    return mon.result(X, fnorm_t)
