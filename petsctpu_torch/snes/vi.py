"""SNES VI — box-constrained variational inequalities.

Counterpart of petsctpu/snes/vi.py (reference: src/snes/impls/vi).
Solves F(x) ⟂ (lb ≤ x ≤ ub): x in the box, F_i(x) = 0 where
lb < x_i < ub, F_i ≥ 0 where x_i = lb, F_i ≤ 0 where x_i = ub.

RSLS (SNESVINEWTONRSLS): each iteration classifies the active set from
(x, F), solves the Newton system on the inactive variables (the
operator maps active rows and columns to the identity, so the shapes
never change), steps active variables to their bound, projects, and
measures the natural residual ‖x − Π(x − F)‖.

SSLS (SNESVINEWTONSSLS): Newton on the Fischer-Burmeister
reformulation Φ(x) = 0, φ(a, b) = a + b − √(a² + b²), with an Armijo
line search on ½‖Φ‖². The Newton operators are matrix-free Shells over
torch.func.jvp.
"""

from __future__ import annotations

from typing import Callable, Optional

import torch

from petsctpu_torch.core.errors import SNESConvergedReason
from petsctpu_torch.ksp.api import KSP_REGISTRY
from petsctpu_torch.ksp.common import KSPConfig, to_host
from petsctpu_torch.mat.base import Shell
from petsctpu_torch.snes.api import (Monitor, SNESConfig, SNESResult,
                                     configure)
from petsctpu_torch.vec import ops

R = SNESConvergedReason


def _bounds(lb, ub, x0):
    def full(b):
        return torch.broadcast_to(torch.as_tensor(b, dtype=x0.dtype,
                                                  device=x0.device), x0.shape)
    return full(lb), full(ub)


def _projected_search(x, dx, rn, tries, merit, accept):
    """The damped search shared by both variants: λ = 1, ½, ¼, … for
    `tries` trials; the first trial that `accept(λ, rnn)` takes is kept.
    merit(λ) -> (x_λ, ‖residual(x_λ)‖ on the device). Returns (x, norm,
    found)."""
    lam = 1.0
    for _ in range(tries):
        xn, rnn_t = merit(lam)
        (rnn,) = to_host(rnn_t)
        if accept(lam, rnn):
            return xn, rnn, True
        lam *= 0.5
    return x, rn, False


def snes_vinewtonrsls(F: Callable, x0: torch.Tensor, lb, ub,
                      cfg: SNESConfig = None, ksp_cfg: KSPConfig = None,
                      axis: Optional[str] = None, active_tol: float = 1e-10,
                      **kw) -> SNESResult:
    """Reduced-space VI Newton (SNESVINEWTONRSLS) with a damped
    projected search on the natural residual (12 halvings)."""
    cfg = configure(cfg, kw)
    ksp_cfg = ksp_cfg or KSPConfig(ksp_type="gmres", rtol=1e-6, maxits=300)
    solver = KSP_REGISTRY[ksp_cfg.ksp_type]
    lb, ub = _bounds(lb, ub, x0)
    zero = torch.zeros((), dtype=x0.dtype, device=x0.device)

    def proj(x):
        return torch.minimum(torch.maximum(x, lb), ub)

    def natural_residual(x, Fx):
        return x - proj(x - Fx)

    x = proj(x0)
    mon = Monitor(cfg, x, ops.norm(natural_residual(x, F(x)), axis), axis)
    rn = mon.fnorm0
    while mon.iterating:
        Fx = F(x)
        at_lb = (x <= lb + active_tol) & (Fx > 0)
        at_ub = (x >= ub - active_tol) & (Fx < 0)
        active = at_lb | at_ub

        def red_mult(ctx, v):
            xx, act = ctx
            Jv = torch.func.jvp(F, (xx,), (torch.where(act, zero, v),))[1]
            return torch.where(act, v, Jv)

        J = Shell(ctx=(x, active), mult_fn=red_mult,
                  shape=(x.shape[0], x.shape[0]))
        rhs = torch.where(at_lb, x - lb, torch.where(at_ub, x - ub, Fx))
        dx = solver(J, rhs, torch.zeros_like(x), None, ksp_cfg, axis).x

        def merit(lam):
            xn = proj(x - lam * dx)
            return xn, ops.norm(natural_residual(xn, F(xn)), axis)

        xn, rn, ok = _projected_search(x, dx, rn, 12, merit,
                                       lambda lam, r: r < rn)
        (snorm, xnorm) = to_host(ops.norm(xn - x, axis), ops.norm(xn, axis))
        mon.step(rn, snorm, xnorm, None if ok else R.DIVERGED_LINE_SEARCH)
        x = xn
    return mon.result(x, rn)


# ---------------------------------------------------------------------------
# Semismooth (Fischer-Burmeister) Newton — SNESVINEWTONSSLS
# ---------------------------------------------------------------------------

def _phi_fb(a, b):
    """viss.c Phi: a + b − √(a² + b²) (zero ⟺ a, b ≥ 0, ab = 0)."""
    return a + b - torch.sqrt(a * a + b * b)


def _dphi_fb(a, b):
    """viss.c DPhi: ∂Phi/∂a = 1 − a/√(a²+b²); 0.5 near the kink."""
    r = torch.sqrt(a * a + b * b)
    safe = (torch.abs(a) >= 1e-6) | (torch.abs(b) >= 1e-6)
    return torch.where(safe, 1.0 - a / torch.clamp(r, min=1e-300),
                       torch.full_like(a, 0.5))


def snes_vinewtonssls(F: Callable, x0: torch.Tensor, lb, ub,
                      cfg: SNESConfig = None, ksp_cfg: KSPConfig = None,
                      axis: Optional[str] = None, **kw) -> SNESResult:
    """Semismooth VI Newton (src/snes/impls/vi/ss): Newton on the
    Fischer-Burmeister reformulation with Armijo (σ = 1e-4, 16 halvings)
    on ½‖Φ‖²."""
    cfg = configure(cfg, kw)
    ksp_cfg = ksp_cfg or KSPConfig(ksp_type="gmres", rtol=1e-6, maxits=300)
    solver = KSP_REGISTRY[ksp_cfg.ksp_type]
    lb, ub = _bounds(lb, ub, x0)
    # the reference's SNES_VI_INF convention: |bound| ≥ 1e20 is unbounded
    has_lb = lb > -1.0e20
    has_ub = ub < 1.0e20
    fixed = has_lb & has_ub & (lb == ub)
    both = has_lb & has_ub

    def Phi(x):
        """SNESVIComputeFunction (viss.c:61), all four bound cases."""
        Fx = F(x)
        out = torch.where(
            both, _phi_fb(x - lb, -_phi_fb(ub - x, -Fx)),
            torch.where(has_lb, _phi_fb(x - lb, Fx),
                        torch.where(has_ub, -_phi_fb(ub - x, -Fx), Fx)))
        return torch.where(fixed, lb - x, out)

    def make_jss(x):
        """The B-subdifferential element Da + Db·J at x as a matrix-free
        Shell (SNESVIComputeBsubdifferentialVectors, viss.c)."""
        Fx = F(x)
        zero, one = torch.zeros_like(x), torch.ones_like(x)
        da1 = _dphi_fb(x - lb, -_phi_fb(ub - x, -Fx))
        db1 = _dphi_fb(-_phi_fb(ub - x, -Fx), x - lb)
        da2 = _dphi_fb(ub - x, -Fx)
        db2 = _dphi_fb(-Fx, ub - x)
        Da = torch.where(both, da1 + db1 * da2,
                         torch.where(has_lb, _dphi_fb(x - lb, Fx),
                                     torch.where(has_ub, da2, zero)))
        Db = torch.where(both, db1 * db2,
                         torch.where(has_lb, _dphi_fb(Fx, x - lb),
                                     torch.where(has_ub, db2, one)))
        Da = torch.where(fixed, one, Da)
        Db = torch.where(fixed, zero, Db)

        def mult(ctx, v):
            xx, Da, Db = ctx
            return Da * v + Db * torch.func.jvp(F, (xx,), (v,))[1]

        return Shell(ctx=(x, Da, Db), mult_fn=mult,
                     shape=(x.shape[0], x.shape[0]))

    x = torch.minimum(torch.maximum(x0, lb), ub)
    mon = Monitor(cfg, x, ops.norm(Phi(x), axis), axis)
    rn = mon.fnorm0
    dt = mon.dt
    while mon.iterating:
        dx = solver(make_jss(x), Phi(x), torch.zeros_like(x), None, ksp_cfg,
                    axis).x
        merit0 = dt(0.5) * rn ** 2

        def merit(lam):
            xn = x - lam * dx
            return xn, ops.norm(Phi(xn), axis)

        xn, rn, ok = _projected_search(
            x, dx, rn, 16, merit,
            lambda lam, r: dt(0.5) * r ** 2 <= merit0 * (1.0 - 1e-4 * lam))
        (snorm, xnorm) = to_host(ops.norm(xn - x, axis), ops.norm(xn, axis))
        mon.step(rn, snorm, xnorm, None if ok else R.DIVERGED_LINE_SEARCH)
        x = xn
    return mon.result(x, rn)
