"""TS — time integration.

Counterpart of petsctpu/ts/steppers.py (reference: src/ts (TSSolve
ts.c:2388 → TSStep ts.c:2297; impls euler, rk (adaptive), ssp, theta —
TSStep_Theta theta.c:151 solves the implicit stage with SNES;
pseudo-timestepping src/ts/impls/pseudo; step adaptivity
src/ts/adapt/impls/basic).

The step loop is an eager Python loop. The state stays on the device of
u0; the time, the step size and the step count live on the host as
numpy scalars of the state's real dtype, so the loop test
`t < max_time − 1e-14`, `min(dt, max_time − t)` and every step-size
update round as petsctpu's device-side carry does. A step that accepts
or rejects (the rk basic adaptor) copies its two norms to the host in
one transfer; implicit steps nest the port's Newton solve (snes_solve),
which nests its Krylov solve. A callable `rhs(t, u)` receives t as that
host scalar.

Methods:
  euler       u ← u + dt·F(t,u)
  ssp         3-stage SSP-RK3 (Shu-Osher), rks2, rks3, rk104
  rk          Bogacki–Shampine 3(2) or Dormand–Prince 5(4), basic adaptor
  theta       u ← u + dt[θF(t+dt,u⁺)+(1−θ)F(t,u)]  (BE: θ=1, CN: θ=½)
  beuler/cn   aliases of theta
  pseudo      pseudo-transient continuation with SER dt growth
"""

from __future__ import annotations

from dataclasses import dataclass, field, replace
from typing import Callable, NamedTuple, Optional

import numpy as np
import torch

from petsctpu_torch.ksp.common import KSPConfig, real_dtype, to_host
from petsctpu_torch.snes.api import SNESConfig, snes_solve
from petsctpu_torch.vec import ops


@dataclass(frozen=True)
class TSConfig:
    ts_type: str = "euler"
    t0: float = 0.0
    dt: float = 0.01
    max_steps: int = 1000
    max_time: float = 1.0
    theta: float = 1.0              # for theta method
    endpoint: bool = False          # theta endpoint variant (CN = θ½+endpoint)
    adapt: bool = False             # basic controller (rk only)
    adapt_rtol: float = 1e-4
    adapt_atol: float = 1e-4
    adapt_clip: tuple = (0.1, 10.0)
    cfl_safety: float = 0.9         # TSAdapt 'cfl' safety factor
    # SSP family (TSSSPSetType/SetNumStages; reference default rks2/5):
    # "rk3so" = 3-stage Shu-Osher (this framework's default),
    # "rks2"/"rks3"/"rk104" = the reference's low-storage schemes
    ssp_type: str = "rk3so"
    ssp_nstages: int = 5
    # TS rk tableau: "bs23" (Bogacki-Shampine 3(2)) or "dp45"
    # (Dormand-Prince 5(4) — the reference's tableau, rk.c:87-139)
    rk_type: str = "bs23"
    alpha_radius: float = 0.5       # generalized-α spectral radius ρ∞
    monitor: bool = False
    # Reference TSSolve duration semantics (ts.c:2429-2437): steps are
    # NOT clamped to max_time (TS_EXACTFINALTIME_STEPOVER, the 3.3-dev
    # default) — the last step may overshoot, and the loop stops when
    # ptime >= max_time AFTER a full step. clamp_final=True keeps this
    # framework's historical exact-final-time behavior (read by the
    # IMEX steppers; ts_solve always clamps).
    clamp_final: bool = True
    # pseudo-timestepping
    pseudo_max_dt: float = 1e12
    # TSPSEUDO duration: stop when t >= this (STEPOVER semantics, like
    # ts ex24's -ts_final_time 1e5); inf = run to fnorm convergence
    pseudo_max_time: float = float("inf")
    pseudo_fnorm_rtol: float = 1e-8
    pseudo_increment: float = 1.1   # TSPseudoSetTimeStepIncrement default
    # inner nonlinear/linear solve settings for implicit methods
    snes: SNESConfig = field(default_factory=lambda: SNESConfig(rtol=1e-8))
    ksp: KSPConfig = field(default_factory=lambda: KSPConfig(
        ksp_type="gmres", rtol=1e-6, maxits=200))


class TSResult(NamedTuple):
    u: torch.Tensor                     # on u0's device
    t: torch.Tensor                     # final time (host)
    steps: torch.Tensor                 # int32 step count (host)
    dt_final: torch.Tensor              # step size after the last step (host)
    fnorm_history: torch.Tensor = None  # pseudo: ‖F‖ per step, 0-padded (host)
    dt_history: torch.Tensor = None     # pseudo: dt chosen after each step


def configure(cfg: Optional[TSConfig], kw) -> TSConfig:
    """cfg (or the defaults) with the fields of kw replaced."""
    cfg = cfg or TSConfig()
    return replace(cfg, **kw) if kw else cfg


def time_dtype(u: torch.Tensor):
    """The numpy scalar type of a state's time, step and norms."""
    return real_dtype(u.dtype).type


def _monitor(cfg, step, t, u):
    if cfg.monitor:
        print(f"TS step {int(step)} time {float(t):g} ")


def result(u, t, step, dt, fh=None, dh=None) -> TSResult:
    """A TSResult of host scalars in their dtype (histories as given)."""
    return TSResult(u, torch.from_numpy(np.asarray(t)),
                    torch.tensor(int(step), dtype=torch.int32),
                    torch.from_numpy(np.asarray(dt)), fh, dh)


def running(cfg: TSConfig, t, step, clamp: bool = True) -> bool:
    """The step loop's test: step < max_steps and t < max_time − 1e-14
    (t < max_time under STEPOVER), the bound rounded to t's dtype."""
    tmax = cfg.max_time - 1e-14 if clamp else cfg.max_time
    return step < cfg.max_steps and t < type(t)(tmax)


def step_size(cfg: TSConfig, t, dt, clamp: bool = True):
    """min(dt, max_time − t) in t's dtype (dt itself under STEPOVER)."""
    return np.minimum(dt, type(t)(cfg.max_time) - t) if clamp else dt


def _basic_controller(cfg: TSConfig, order: float, un, err_vec, u_prev,
                      dt, axis=None):
    """TSAdapt 'basic' on the embedded error estimate: h_new =
    h·clip(0.9·(err/scale)^(−1/order)), accept when err ≤ scale. The two
    norms are copied to the host in one transfer; the controller runs
    there in dt's dtype. Returns (u, dt used, dt next)."""
    err, nu = to_host(ops.norm(err_vec, axis), ops.norm(un, axis))
    tt = type(dt)
    scale = nu * tt(cfg.adapt_rtol) + tt(cfg.adapt_atol)
    ratio = err / np.maximum(scale, tt(1e-30))
    with np.errstate(divide="ignore", over="ignore"):
        fac = np.clip(tt(0.9) * ratio ** tt(-1.0 / order),
                      tt(cfg.adapt_clip[0]), tt(cfg.adapt_clip[1]))
    if ratio <= 1.0:
        return un, dt, dt * fac
    return u_prev, tt(0.0), dt * fac


def ts_solve(rhs: Callable, u0: torch.Tensor, cfg: TSConfig = None,
             axis: Optional[str] = None, cfl_fn: Optional[Callable] = None,
             jac=None, pc_builder=None, ifunc: Callable = None,
             post_step: Optional[Callable] = None, **kw) -> TSResult:
    """Integrate u' = rhs(t, u) from t0 until max_time/max_steps.

    ifunc: optional IMPLICIT form F(t, u, u̇) = 0 (the TSSetIFunction
    analog, ts.c:902) for the theta/beuler steppers — supports DAEs
    whose algebraic rows have no u̇ (e.g. ts ex17's Dirichlet rows
    F = u). The theta stage solve becomes
    F(t+θdt, X, (X−u)/(θdt)) = 0 with u⁺ = u + (X−u)/θ (TSStep_Theta
    shift σ = 1/(θdt)). Pass rhs=None when only ifunc is given. With a
    ColoredJacobian `jac`, ifunc is called on a batch X [C, n] too.

    cfl_fn: optional (t, u) -> max stable dt; when given, the step size
    is capped at cfl_safety·cfl_fn each step (TSAdapt 'cfl',
    src/ts/adapt/impls/cfl).

    jac / pc_builder: forwarded to the implicit steppers' inner Newton
    solves (theta/beuler/cn, alpha, pseudo) — e.g. a ColoredJacobian
    plan over the stage-residual sparsity plus a Jacobi/ILU/MG
    pc_builder, the analog of the reference's TSSetRHSJacobian +
    default-ILU inner KSP.

    post_step: optional (step, t, u) -> None called after each step
    (TSSetPostStep, ts.c), e.g. to read the state of every step of one
    integration."""
    cfg = configure(cfg, kw)
    t_type = cfg.ts_type
    if t_type == "beuler":
        cfg = replace(cfg, theta=1.0)
        t_type = "theta"
    elif t_type == "cn":
        cfg = replace(cfg, theta=0.5, endpoint=True)
        t_type = "theta"
    tt = time_dtype(u0)

    def euler_step(t, u, dt):
        return u + dt * rhs(t, u), dt, dt

    def ssp_step(t, u, dt):
        v = cfg.ssp_type
        s = cfg.ssp_nstages
        if v == "rks2":
            # TSSSPRKS2 (ssp.c:65, Ketcheson 2008 pseudocode 2):
            # s−1 forward-Euler substeps then the combining stage
            w = u
            for i in range(s - 1):
                w = w + (dt / (s - 1.0)) * rhs(t + dt * i / (s - 1.0), w)
            F = rhs(t + dt, w)
            un = ((s - 1.0) / s) * w + (dt / s) * F + (1.0 / s) * u
            return un, dt, dt
        if v == "rks3":
            # TSSSPRKS3 (ssp.c:90): s = n² stages, optimal 3rd order
            n = int(np.sqrt(s) + 0.001)
            assert n * n == s, "rks3 needs a square stage count >= 4"
            r = s - n

            def ci(i):
                return (i / (s - n)) if i < n * (n + 1) // 2 \
                    else ((i - n) / (s - n))
            w = u
            i = 0
            while i < (n - 1) * (n - 2) // 2:
                w = w + (dt / r) * rhs(t + ci(i) * dt, w)
                i += 1
            w1 = w
            while i < n * (n + 1) // 2 - 1:
                w = w + (dt / r) * rhs(t + ci(i) * dt, w)
                i += 1
            F = rhs(t + ci(i) * dt, w)
            w = (n / (2.0 * n - 1.0)) * w1 \
                + ((n - 1.0) * dt / (r * (2.0 * n - 1.0))) * F \
                + ((n - 1.0) / (2.0 * n - 1.0)) * w
            i += 1
            while i < s:
                w = w + (dt / r) * rhs(t + ci(i) * dt, w)
                i += 1
            return w, dt, dt
        if v == "rk104":
            # TSSSPRK104 (ssp.c, Ketcheson's 10-stage 4th order)
            cs = [0, 1/6, 2/6, 3/6, 4/6, 2/6, 3/6, 4/6, 5/6, 1.0]
            w = u
            for i in range(5):
                w = w + (dt / 6.0) * rhs(t + cs[i] * dt, w)
            w1 = (1.0 / 25.0) * u + (9.0 / 25.0) * w
            w = 15.0 * w1 - 5.0 * w
            for i in range(5, 9):
                w = w + (dt / 6.0) * rhs(t + cs[i] * dt, w)
            F = rhs(t + dt, w)
            return w1 + 0.6 * w + (dt / 10.0) * F, dt, dt
        # default: SSPRK3 (Shu–Osher)
        u1 = u + dt * rhs(t, u)
        u2 = 0.75 * u + 0.25 * (u1 + dt * rhs(t + dt, u1))
        un = u / 3.0 + (2.0 / 3.0) * (u2 + dt * rhs(t + 0.5 * dt, u2))
        return un, dt, dt

    def rk_step(t, u, dt):
        if cfg.rk_type == "dp45":
            # Dormand–Prince 5(4) — the reference's tableau (rk.c:87-139)
            a = ((), (1 / 5,), (3 / 40, 9 / 40),
                 (44 / 45, -56 / 15, 32 / 9),
                 (19372 / 6561, -25360 / 2187, 64448 / 6561, -212 / 729),
                 (9017 / 3168, -355 / 33, 46732 / 5247, 49 / 176,
                  -5103 / 18656),
                 (35 / 384, 0.0, 500 / 1113, 125 / 192, -2187 / 6784,
                  11 / 84))
            c = (0.0, 1 / 5, 3 / 10, 4 / 5, 8 / 9, 1.0, 1.0)
            b1 = (35 / 384, 0.0, 500 / 1113, 125 / 192, -2187 / 6784,
                  11 / 84, 0.0)
            b2 = (5179 / 57600, 0.0, 7571 / 16695, 393 / 640,
                  -92097 / 339200, 187 / 2100, 1 / 40)
            porder = 5.0
            ks = []
            for i in range(7):
                yi = u
                for j, aij in enumerate(a[i]):
                    if aij:
                        yi = yi + dt * aij * ks[j]
                ks.append(rhs(t + c[i] * dt, yi))
            un = u
            u2 = u
            for j in range(7):
                if b1[j]:
                    un = un + dt * b1[j] * ks[j]
                if b2[j]:
                    u2 = u2 + dt * b2[j] * ks[j]
        else:
            # Bogacki–Shampine 3(2)
            k1 = rhs(t, u)
            k2 = rhs(t + 0.5 * dt, u + 0.5 * dt * k1)
            k3 = rhs(t + 0.75 * dt, u + 0.75 * dt * k2)
            un = u + dt * (2.0 * k1 + 3.0 * k2 + 4.0 * k3) / 9.0
            k4 = rhs(t + dt, un)
            u2 = u + dt * (7.0 * k1 + 6.0 * k2 + 8.0 * k3 + 3.0 * k4) / 24.0
            porder = 3.0
        if not cfg.adapt:
            return un, dt, dt
        # basic controller: h_new = h·min(facmax, max(facmin,
        # fac·(tol/err)^(1/(p+1)))) (rk.c:366 rule / adapt basic)
        return _basic_controller(cfg, porder, un, un - u2, u, dt, axis)

    def theta_step(t, u, dt):
        th = cfg.theta
        if ifunc is not None:
            assert not cfg.endpoint, "ifunc supports the stage form"
            ts = t + th * dt
            sh = th * dt

            def G(v):
                return ifunc(ts, v, (v - u) / sh)

            res = snes_solve(G, u, jac=jac or "jvp",
                             pc_builder=pc_builder, cfg=cfg.snes,
                             ksp_cfg=cfg.ksp, axis=axis)
            v = res.x
            un = u + (v - u) / th if th > 0 else v
            return un, dt, dt
        if cfg.endpoint:
            # u⁺ = u + dt[(1−θ)F(t,u) + θF(t+dt,u⁺)]
            known = u + dt * (1.0 - th) * rhs(t, u)

            def G(v):
                return v - known - dt * th * rhs(t + dt, v)
        else:
            # stage formulation (theta.c): solve at t+θdt then extrapolate
            def G(v):
                return v - u - dt * th * rhs(t + th * dt, v)
        res = snes_solve(G, u, jac=jac or "jvp", pc_builder=pc_builder,
                         cfg=cfg.snes, ksp_cfg=cfg.ksp, axis=axis)
        v = res.x
        if cfg.endpoint:
            un = v
        else:
            un = u + (v - u) / th if th > 0 else v
        return un, dt, dt

    stepper = {"euler": euler_step, "ssp": ssp_step, "rk": rk_step,
               "theta": theta_step}[t_type]

    t, u, dt, step = tt(cfg.t0), u0, tt(cfg.dt), 0
    while running(cfg, t, step):
        dt_eff = step_size(cfg, t, dt)
        if cfl_fn is not None:
            (cfl,) = to_host(cfl_fn(t, u))
            dt_eff = np.minimum(dt_eff, tt(cfg.cfl_safety * tt(cfl)))
        u, dt_used, dt_next = stepper(t, u, dt_eff)
        t = t + dt_used
        step += 1
        _monitor(cfg, step, t, u)
        if post_step is not None:
            post_step(step, t, u)
        dt = tt(dt_next)
    return result(u, t, step, dt)


def ts_alpha(rhs: Callable, u0: torch.Tensor, cfg: TSConfig = None,
             axis: Optional[str] = None, jac=None, pc_builder=None,
             **kw) -> TSResult:
    """Generalized-α for first-order systems (TSALPHA,
    src/ts/impls/alpha/alpha.c — Jansen, Whiting & Hulbert).

    Parameters from the spectral radius ρ∞ (alpha_radius):
    α_m = ½(3−ρ)/(1+ρ), α_f = 1/(1+ρ), γ = ½ + α_m − α_f — second-order
    accurate, user-controlled high-frequency damping. Each step solves
    G(v₁) = v_n + α_m(v₁−v_n) − rhs(t+α_f·dt, u_n + α_f·dt((1−γ)v_n +
    γv₁)) = 0 for the new rate v₁, then u₁ = u_n + dt((1−γ)v_n + γv₁).
    """
    cfg = configure(cfg, kw)
    rho = cfg.alpha_radius
    am = 0.5 * (3.0 - rho) / (1.0 + rho)
    af = 1.0 / (1.0 + rho)
    gamma = 0.5 + am - af
    tt = time_dtype(u0)
    t, u, dt, step = tt(cfg.t0), u0, tt(cfg.dt), 0
    v = rhs(t, u0)                         # consistent initial rate
    while running(cfg, t, step):
        dt_eff = step_size(cfg, t, dt)

        def G(v1, t=t, u=u, v=v, dt_eff=dt_eff):
            ua = u + af * dt_eff * ((1.0 - gamma) * v + gamma * v1)
            va = v + am * (v1 - v)
            return va - rhs(t + af * dt_eff, ua)

        res = snes_solve(G, v, jac=jac or "jvp", pc_builder=pc_builder,
                         cfg=cfg.snes, ksp_cfg=cfg.ksp, axis=axis)
        v1 = res.x
        u = u + dt_eff * ((1.0 - gamma) * v + gamma * v1)
        v = v1
        t = t + dt_eff
        step += 1
        _monitor(cfg, step, t, u)
    return result(u, t, step, dt)


def ts_pseudo(rhs: Callable, u0: torch.Tensor, cfg: TSConfig = None,
              axis: Optional[str] = None, jac=None, pc_builder=None,
              **kw) -> TSResult:
    """Pseudo-transient continuation to steady state (src/ts/impls/
    pseudo): backward-Euler steps with SER dt growth
    dt ← increment·dt·‖F(u_prev)‖/‖F(u)‖ (TSPseudoDefaultTimeStep,
    increment default 1.1) until ‖F‖ drops by pseudo_fnorm_rtol.
    fnorm/dt histories are recorded per step (the -ts_monitor_pseudo
    stream) in fixed [max_steps + 1] arrays, 0-padded.

    The reference computes the step's dt BEFORE stepping from the ratio
    of the two PREVIOUS residual norms (TSStep_Pseudo: step 1 already
    uses increment·dt0), so dt lags the fnorm sequence by one."""
    cfg = configure(cfg, kw)
    tt = time_dtype(u0)
    (f0,) = to_host(ops.norm(rhs(tt(0.0), u0), axis))
    M = cfg.max_steps + 1
    fh = np.zeros(M, f0.dtype)
    dh = np.zeros(M, tt)
    fh[0], dh[0] = f0, tt(cfg.dt)
    t, u, dt, step, f_p, f_pp = tt(cfg.t0), u0, tt(cfg.dt), 0, f0, f0
    while (step < cfg.max_steps and f_p > f0.dtype.type(
            cfg.pseudo_fnorm_rtol) * f0 and t < cfg.pseudo_max_time):
        dt_used = tt(np.clip(tt(cfg.pseudo_increment) * dt * f_pp
                             / np.maximum(f_p, f0.dtype.type(1e-30)),
                             0.0, cfg.pseudo_max_dt))

        def G(v, t=t, u=u, dt_used=dt_used):
            return (v - u) / dt_used - rhs(t + dt_used, v)

        res = snes_solve(G, u, jac=jac or "jvp", pc_builder=pc_builder,
                         cfg=cfg.snes, ksp_cfg=cfg.ksp, axis=axis)
        u = res.x
        (fn,) = to_host(ops.norm(rhs(t + dt_used, u), axis))
        fh[step + 1] = fn
        dh[step + 1] = dt_used
        t, dt, step, f_pp, f_p = t + dt_used, dt_used, step + 1, f_p, fn
    return result(u, t, step, dt, torch.from_numpy(fh), torch.from_numpy(dh))


class TS:
    """Stateful wrapper mirroring the reference TS lifecycle."""

    def __init__(self, options=None, prefix: str = ""):
        from petsctpu_torch.core.options import Options
        self.opts = (options or Options()).prefixed(prefix)
        self.rhs = None
        self.axis = None

    def set_rhs_function(self, rhs):
        self.rhs = rhs
        return self

    def solve(self, u0) -> TSResult:
        o = self.opts
        cfg = TSConfig(
            ts_type=o.get_str("ts_type", "euler"),
            dt=o.get_real("ts_dt", 0.01),
            max_steps=o.get_int("ts_max_steps", 1000),
            max_time=o.get_real("ts_max_time", 1.0),
            theta=o.get_real("ts_theta_theta", 1.0),
            endpoint=o.get_bool("ts_theta_endpoint", False),
            adapt=o.get_str("ts_adapt_type", "none") != "none",
            monitor=o.get_bool("ts_monitor", False),
        )
        solver = ts_pseudo if cfg.ts_type == "pseudo" else ts_solve
        return solver(self.rhs, u0, cfg=cfg, axis=self.axis)
