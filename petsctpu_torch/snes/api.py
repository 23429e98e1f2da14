"""SNES — Newton-Krylov nonlinear solver.

Counterpart of petsctpu/snes/api.py (reference: SNESSolve,
src/snes/interface/snes.c:3585; SNESSolve_NEWTONLS,
src/snes/impls/ls/ls.c:191-271; the line searches of
src/snes/linesearch/impls/{basic,bt,l2,cp}; SNESDefaultConverged).

The Newton loop and each line search are eager Python loops: the
residuals, Jacobians, Krylov solves and updates run on the device of
x, and after each Newton step and each line-search trial the loop
copies the few scalars it branches on to the host in one transfer. The
convergence test, the step-length arithmetic and the monitor run there,
on numpy scalars of the solve's dtype, so every threshold is rounded
and compared as in petsctpu's device-side code.
"""

from __future__ import annotations

from dataclasses import dataclass, replace
from typing import Callable, NamedTuple, Optional, Union

import numpy as np
import torch

from petsctpu_torch.core.errors import SNESConvergedReason
from petsctpu_torch.ksp.api import KSP_REGISTRY
from petsctpu_torch.ksp.common import KSPConfig, real_dtype, to_host
from petsctpu_torch.snes.fdjac import (ColoredJacobian, jvp_operator,
                                       mffd_operator)
from petsctpu_torch.vec import ops

R = SNESConvergedReason


@dataclass(frozen=True)
class SNESConfig:
    rtol: float = 1e-8
    atol: float = 1e-50
    stol: float = 1e-8
    maxits: int = 50
    linesearch: str = "bt"            # bt | basic | l2 | cp
    ls_alpha: float = 1e-4
    ls_maxits: int = 40
    ls_it: int = 1                    # l2/cp refinement iterations
                                      # (SNESLineSearch max_its default,
                                      # linesearch.c:63)
    ls_lambda_min: float = 1e-12
    ls_order: str = "cubic"           # bt model: cubic | quadratic
                                      # (-snes_linesearch_order)
    monitor: bool = False
    jac: str = "jvp"                  # jvp | fd (when no explicit jac given)


class SNESResult(NamedTuple):
    x: torch.Tensor          # on x0's device
    its: torch.Tensor        # int32 (host)
    reason: torch.Tensor     # int32 SNESConvergedReason (host)
    fnorm: torch.Tensor      # final function norm (host)
    history: torch.Tensor    # [maxits+1] function norms, NaN-padded (host)

    @property
    def converged(self):
        return int(self.reason) > 0


def configure(cfg: Optional[SNESConfig], kw, base: SNESConfig = None):
    """cfg (or `base`, or the defaults) with the fields of kw replaced."""
    cfg = cfg or base or SNESConfig()
    return replace(cfg, **kw) if kw else cfg


def _monitor(cfg: SNESConfig, its: int, fnorm) -> None:
    if cfg.monitor:
        print(f"{int(its):3d} SNES Function norm {float(fnorm):g} ")


def _check(fnorm, fnorm0, snorm, xnorm, its: int, cfg: SNESConfig) -> int:
    """SNESDefaultConverged on host scalars of the solve's real dtype."""
    dt = np.asarray(fnorm).dtype.type
    if np.isnan(fnorm):
        return R.DIVERGED_FNORM_NAN
    if fnorm < dt(cfg.atol):
        return R.CONVERGED_FNORM_ABS
    if fnorm <= dt(cfg.rtol) * fnorm0:
        return R.CONVERGED_FNORM_RELATIVE
    # snesut.c:30: strict snorm < stol·xnorm (no floor on xnorm: with
    # xnorm = snorm = 0, as FAS passes per fas.c:824, this must not fire)
    if its > 0 and snorm < dt(cfg.stol) * xnorm:
        return R.CONVERGED_SNORM_RELATIVE
    if its >= cfg.maxits:
        return R.DIVERGED_MAX_IT
    return R.ITERATING


class Monitor:
    """A solve's history, monitor and convergence test on the host. On a
    Comm (`axis`) the step and solution norms of the test are global, so
    every rank takes the same decision."""

    def __init__(self, cfg: SNESConfig, x0, fnorm0: torch.Tensor,
                 axis=None):
        f0, xn = to_host(fnorm0, ops.norm(x0, axis))
        self.axis = axis
        self.cfg = cfg
        self.dt = f0.dtype.type
        self.fnorm0 = f0
        self.history = np.full((cfg.maxits + 1,), np.nan,
                               real_dtype(x0.dtype))
        self.history[0] = f0
        self.its = 0
        _monitor(cfg, 0, f0)
        self.reason = _check(f0, f0, self.dt(0), xn, 0, cfg)

    @property
    def iterating(self) -> bool:
        return self.reason == R.ITERATING

    def step(self, fn, snorm, xnorm, fail=None) -> int:
        """Record the next iterate's norm and test it; a still-iterating
        solve with `fail` set (a reason) takes that reason."""
        self.its += 1
        self.history[self.its] = fn
        _monitor(self.cfg, self.its, fn)
        self.reason = _check(fn, self.fnorm0, snorm, xnorm, self.its,
                             self.cfg)
        if self.reason == R.ITERATING and fail is not None:
            self.reason = fail
        return self.reason

    def step_from(self, xn, x, fn_t, fail_if=None) -> int:
        """step() with ‖F‖, ‖xn − x‖ and ‖xn‖ copied in one transfer."""
        fn, snorm, xnorm = to_host(fn_t, ops.norm(xn - x, self.axis),
                                   ops.norm(xn, self.axis))
        return self.step(fn, snorm, xnorm, fail_if)

    def result(self, x, fnorm) -> SNESResult:
        return SNESResult(x, torch.tensor(self.its, dtype=torch.int32),
                          torch.tensor(int(self.reason), dtype=torch.int32),
                          torch.as_tensor(fnorm).detach().cpu(),
                          torch.from_numpy(self.history))


def _linesearch_bt(F, x, dx, Fx, fnorm, cfg: SNESConfig, axis):
    """Backtracking line search (linesearchbt.c) on φ(λ)=½‖F(x−λdx)‖²
    with slope −‖F‖²: the first backtrack fits the quadratic model, later
    ones (ls_order "cubic", the reference default) the Dennis-Schnabel
    cubic through the last two trials; steps clamped to [0.1λ, 0.5λ].
    `fnorm` is the host norm of Fx. Returns (xn, Fn, ‖Fn‖ on the device,
    ‖Fn‖ on the host, λ, success)."""
    dt = np.asarray(fnorm).dtype.type
    phi0 = dt(0.5) * fnorm * fnorm
    slope = -fnorm * fnorm
    cubic = cfg.ls_order == "cubic"
    lam = lam_prev = dt(1.0)
    phi_prev = phi0
    k, done = 0, False
    last = None
    with np.errstate(all="ignore"):
        while not done and k < cfg.ls_maxits:
            xn = x - float(lam) * dx
            Fn = F(xn)
            fn_t = ops.norm(Fn, axis)
            (fn,) = to_host(fn_t)
            last = (lam, xn, Fn, fn_t, fn)
            phin = dt(0.5) * fn * fn
            ok = phin <= phi0 + dt(cfg.ls_alpha) * lam * slope
            denom = dt(2.0) * (phin - phi0 - lam * slope)
            lam_q = -slope * lam * lam / denom if denom > 0 \
                else dt(0.5) * lam
            lam_t = lam_q
            if cubic:
                d1 = phin - phi0 - lam * slope
                d2 = phi_prev - phi0 - lam_prev * slope
                dl = lam - lam_prev
                safe = abs(dl) > 1e-30
                dl = dl if safe else dt(1.0)
                a = (d1 / (lam * lam) - d2 / (lam_prev * lam_prev)) / dl
                bq = (-lam_prev * d1 / (lam * lam)
                      + lam * d2 / (lam_prev * lam_prev)) / dl
                disc = np.maximum(bq * bq - dt(3.0) * a * slope, dt(0.0))
                if abs(a) > 1e-30:
                    lam_c = (-bq + np.sqrt(disc)) / (dt(3.0) * a)
                elif abs(bq) > 1e-30:
                    lam_c = -slope / (dt(2.0) * bq)
                else:
                    lam_c = dt(0.5) * lam
                if safe and k > 0:
                    lam_t = lam_c
            lam_new = np.minimum(np.maximum(lam_t, dt(0.1) * lam),
                                 dt(0.5) * lam)
            if not ok:
                lam_prev, lam = lam, lam_new
                phi_prev = phin
            k += 1
            done = bool(ok or lam_new < cfg.ls_lambda_min)
    if last is not None and last[0] == lam:
        _, xn, Fn, fn_t, fn = last
    else:
        xn = x - float(lam) * dx
        Fn = F(xn)
        fn_t = ops.norm(Fn, axis)
        (fn,) = to_host(fn_t)
    # accept any decrease (ls.c:248 failure policy)
    return xn, Fn, fn_t, fn, lam, bool(fn < fnorm)


def _linesearch_l2(F, x, dx, fnorm, axis, max_its: int = 1,
                   damping: float = 1.0, steptol: float = 1e-12):
    """The reference's L2 line search (linesearchl2.c): secant-Newton on
    the quadratic fit of ‖F(x−λ·dx)‖² through (λ_old, λ_mid, λ), ONE
    iteration by default (linesearch.c:63). `fnorm` is a host scalar.
    Returns (xn, Fn, ‖Fn‖ on the device, λ, True)."""
    dt = np.asarray(fnorm).dtype.type
    lam = dt(damping)
    lam_old = dt(0.0)
    fnrm_old = fnorm * fnorm
    with np.errstate(all="ignore"):
        for _ in range(max_its):
            lam_mid = dt(0.5) * (lam + lam_old)
            fm, fl = to_host(ops.norm(F(x - float(lam_mid) * dx), axis),
                             ops.norm(F(x - float(lam) * dx), axis))
            fnrm_mid, fnrm = fm ** 2, fl ** 2
            dl = lam - lam_old
            dF = (dt(3.0) * fnrm - dt(4.0) * fnrm_mid + fnrm_old) / dl
            dF_old = (dt(-3.0) * fnrm_old + dt(4.0) * fnrm_mid - fnrm) / dl
            d2F = (dF - dF_old) / dl
            lam_upd = lam - dF / d2F if d2F > 0 else lam + dF / d2F
            if lam_upd < steptol:
                lam_upd = dt(0.5) * (lam + lam_old)
            lam_old, lam, fnrm_old = lam, lam_upd, fnrm
    xn = x - float(lam) * dx
    Fn = F(xn)
    return xn, Fn, ops.norm(Fn, axis), lam, True


def _linesearch_cp(F, x, dx, Fx, axis, max_its: int = 1,
                   damping: float = 1.0, steptol: float = 1e-12):
    """The reference's CP line search, linear order, ONE iteration by
    default (linesearchcp.c:61,177): secant on g(λ) = ⟨F(x−λ·dx), dx⟩
    with its sign and steptol rules. Returns (xn, Fn, ‖Fn‖ on the
    device, λ, True)."""
    (fty_old,) = to_host(ops.dot(Fx, dx, axis))
    dt = np.asarray(fty_old).dtype.type
    lam = dt(damping)
    lam_old = dt(0.0)
    with np.errstate(all="ignore"):
        for _ in range(max_its):
            (fty,) = to_host(ops.dot(F(x - float(lam) * dx), dx, axis))
            s = (fty - fty_old) / (lam - lam_old)
            if s > 0:
                s = -s
            upd = lam - fty / s
            if upd < steptol:
                upd = lam + fty / s
            lam_old, lam, fty_old = lam, upd, fty
    xn = x - float(lam) * dx
    Fn = F(xn)
    return xn, Fn, ops.norm(Fn, axis), lam, True


def jacobian_builder(F, jac):
    """(x, Fx) -> the Newton operator: "jvp" (AD matrix-free), "fd"
    (MFFD), an FD-coloring plan (anything with `assemble`), or a
    callable (x, Fx) -> operator."""
    def build(x, Fx):
        if jac == "jvp":
            return jvp_operator(F, x, Fx)
        if jac == "fd":
            return mffd_operator(F, x, Fx)
        if isinstance(jac, ColoredJacobian) or hasattr(jac, "assemble"):
            return jac.assemble(F, x, Fx)
        return jac(x, Fx)
    return build


def snes_solve(F: Callable, x0: torch.Tensor,
               jac: Union[str, ColoredJacobian, Callable] = None,
               pc_builder: Optional[Callable] = None,
               ksp_cfg: KSPConfig = None, cfg: SNESConfig = None,
               axis: Optional[str] = None,
               npc: Optional[Callable] = None,
               pre_check: Optional[Callable] = None,
               post_check: Optional[Callable] = None, **kw) -> SNESResult:
    """Newton-LS solve of F(x) = 0.

    jac: "jvp" (AD matrix-free), "fd" (MFFD), a ColoredJacobian plan
         (assembled FD), or a callable (x, Fx) -> operator.
    pc_builder: callable J -> PC, rebuilt every Newton step.
    npc: optional nonlinear right-preconditioner x → x' applied before
         each Newton step (ls.c:199-211's snes->pc composition).
    pre_check: optional (its, x, dx) -> dx before the line search
         (SNESLineSearchSetPreCheck).
    post_check: optional (its, x, dx, xn) -> xn on the line search's
         candidate (SNESLineSearchSetPostCheck)."""
    cfg = configure(cfg, kw)
    ksp_cfg = ksp_cfg or KSPConfig(ksp_type="gmres", rtol=1e-5, maxits=200)
    build_J = jacobian_builder(F, jac or cfg.jac)
    ksolver = KSP_REGISTRY[ksp_cfg.ksp_type]

    x = x0
    Fx = F(x)
    fnorm_t = ops.norm(Fx, axis)
    mon = Monitor(cfg, x, fnorm_t, axis)
    fnorm = mon.fnorm0
    while mon.iterating:
        its = mon.its
        if npc is not None:               # nonlinear right-preconditioning
            x = npc(x)
            Fx = F(x)
            fnorm_t = ops.norm(Fx, axis)
            (fnorm,) = to_host(fnorm_t)
        J = build_J(x, Fx)
        pc = pc_builder(J) if pc_builder is not None else None
        kres = ksolver(J, Fx, torch.zeros_like(x), pc, ksp_cfg, axis)
        del J, pc
        dx = kres.x                       # J dx = F → the step is −dx
        lin_fail = int(kres.reason) < 0
        if pre_check is not None:
            dx = pre_check(its, x, dx)
        if cfg.linesearch == "basic":
            xn = x - dx
            Fn = F(xn)
            fn_t = ops.norm(Fn, axis)
            ls_ok = True
        elif cfg.linesearch == "l2":
            xn, Fn, fn_t, _, ls_ok = _linesearch_l2(F, x, dx, fnorm, axis,
                                                    max_its=cfg.ls_it)
        elif cfg.linesearch == "cp":
            xn, Fn, fn_t, _, ls_ok = _linesearch_cp(F, x, dx, Fx, axis,
                                                    max_its=cfg.ls_it)
        else:
            xn, Fn, fn_t, _, _, ls_ok = _linesearch_bt(F, x, dx, Fx, fnorm,
                                                       cfg, axis)
        if post_check is not None:
            xn = post_check(its, x, dx, xn)
            Fn = F(xn)
            fn_t = ops.norm(Fn, axis)
        fail = (R.DIVERGED_LINE_SEARCH if not ls_ok
                else R.DIVERGED_LINEAR_SOLVE if lin_fail else None)
        mon.step_from(xn, x, fn_t, fail)
        x, Fx, fnorm_t, fnorm = xn, Fn, fn_t, mon.history[mon.its]
    return mon.result(x, fnorm_t)


def snes_ksponly(F, x0, jac=None, pc_builder=None, ksp_cfg=None,
                 cfg=None, axis=None, **kw) -> SNESResult:
    """One full-step Newton iteration (src/snes/impls/ksponly): reports
    CONVERGED_ITS after its single iteration (ksponly.c)."""
    cfg = replace(configure(cfg, kw), maxits=1, linesearch="basic")
    r = snes_solve(F, x0, jac=jac, pc_builder=pc_builder, ksp_cfg=ksp_cfg,
                   cfg=cfg, axis=axis)
    if int(r.reason) == R.DIVERGED_MAX_IT:
        r = r._replace(reason=torch.tensor(int(R.CONVERGED_ITS),
                                           dtype=torch.int32))
    return r


def snes_nrichardson(F, x0, cfg: SNESConfig = None, axis=None,
                     damping: float = 1.0, **kw) -> SNESResult:
    """Nonlinear Richardson x ← x − λ·F(x) with the reference's default L2
    line search (src/snes/impls/richardson). SNESCreate_NRichardson sets
    the stol default to 1e-20 (snesrichardson.c:262)."""
    cfg = configure(cfg, kw, SNESConfig(stol=1e-20))
    x = x0
    Fx = F(x)
    fn_t = ops.norm(Fx, axis)
    mon = Monitor(cfg, x, fn_t, axis)
    fnorm = mon.fnorm0
    while mon.iterating:
        xn, Fn, fn_t, _, _ = _linesearch_l2(F, x, damping * Fx, fnorm, axis)
        mon.step_from(xn, x, fn_t)
        x, Fx, fnorm = xn, Fn, mon.history[mon.its]
    return mon.result(x, fn_t)


class SNES:
    """Stateful wrapper mirroring the reference SNES lifecycle."""

    def __init__(self, options=None, prefix: str = ""):
        from petsctpu_torch.core.options import Options
        self.opts = (options or Options()).prefixed(prefix)
        self.F = None
        self.jac = None
        self.pc_builder = None
        self.axis = None

    def set_function(self, F):
        self.F = F
        return self

    def set_jacobian(self, jac):
        self.jac = jac
        return self

    def set_pc_builder(self, pb):
        self.pc_builder = pb
        return self

    def config(self) -> SNESConfig:
        o = self.opts
        return SNESConfig(
            rtol=o.get_real("snes_rtol", 1e-8),
            atol=o.get_real("snes_atol", 1e-50),
            stol=o.get_real("snes_stol", 1e-8),
            maxits=o.get_int("snes_max_it", 50),
            linesearch=o.get_str("snes_linesearch_type", "bt"),
            monitor=o.get_bool("snes_monitor", False),
            jac="fd" if o.get_bool("snes_mf", False) else "jvp")

    def solve(self, x0) -> SNESResult:
        from petsctpu_torch.ksp.api import config_from_options

        cfg = self.config()
        ksp_cfg = config_from_options(self.opts, KSPConfig(
            ksp_type="gmres", rtol=1e-5, maxits=200))
        snes_type = self.opts.get_str("snes_type", "newtonls")
        if snes_type == "newtontr":          # -snes_type newtontr (tr.c)
            from petsctpu_torch.snes.variants import snes_tr
            return snes_tr(self.F, x0, jac=self.jac,
                           pc_builder=self.pc_builder, ksp_cfg=ksp_cfg,
                           cfg=cfg, axis=self.axis)
        if snes_type == "ksponly":
            return snes_ksponly(self.F, x0, jac=self.jac,
                                pc_builder=self.pc_builder,
                                ksp_cfg=ksp_cfg, cfg=cfg, axis=self.axis)
        if snes_type in ("qn", "ngmres", "anderson", "ncg", "nrichardson"):
            from petsctpu_torch.snes.fas import snes_ncg
            from petsctpu_torch.snes.variants import (snes_anderson,
                                                      snes_ngmres, snes_qn)
            impl = {"qn": snes_qn, "ngmres": snes_ngmres,
                    "anderson": snes_anderson, "ncg": snes_ncg,
                    "nrichardson": snes_nrichardson}[snes_type]
            return impl(self.F, x0, cfg=cfg, axis=self.axis)
        if snes_type != "newtonls":
            raise ValueError(f"unknown -snes_type {snes_type!r}")
        return snes_solve(self.F, x0, jac=self.jac,
                          pc_builder=self.pc_builder, ksp_cfg=ksp_cfg,
                          cfg=cfg, axis=self.axis)


def snes_grid_sequence(da, make_residual: Callable, nrefine: int,
                       x0: torch.Tensor, initial_guess: Callable = None,
                       solver: Callable = None, **kw):
    """Grid sequencing (-snes_grid_sequence; SNESSolve loop
    snes.c:3609-3674): solve on the DM, then repeatedly refine,
    Q1-interpolate the converged solution as the finer grid's initial
    guess (MatInterpolate, snes.c:3665) and solve again.

    make_residual(da) -> F; initial_guess(da) -> x (the coarsest grid's
    guess when x0 is None); solver defaults to snes_solve and receives
    **kw. Returns the per-grid SNESResults, finest last."""
    solver = solver or snes_solve
    cur = da
    x = x0 if x0 is not None else initial_guess(cur)
    results = []
    for g in range(nrefine + 1):
        res = solver(make_residual(cur), x, **kw)
        results.append(res)
        if g < nrefine:
            fine = cur.refine()
            x = fine.interpolation(cur).mult(res.x)
            cur = fine
    return results
