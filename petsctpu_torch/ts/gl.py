"""TSGL — implicit general linear methods (IRKS family).

Counterpart of petsctpu/ts/gl.py (reference:
src/ts/impls/implicit/gl/gl.c, general linear methods with inherent
Runge-Kutta stability, Butcher & Podhaisky; the FULL scheme family of
TSGLCreate_IRKS gl.c:515-633 — orders p=1..5 with r=s=p+1). A GL method
carries a Nordsieck-like vector X = (x₁..x_r), x₁ = u,
x_{j>1} = hʲ⁻¹u⁽ʲ⁻¹⁾ (no factorial):

  stage i:  Y_i   = h Σⱼ a_ij Ẏ_j + Σⱼ u_ij x_j   (implicit in Ẏ_i,
                                                    diagonal a_ii)
  update:   x_i⁺  = h Σⱼ b_ij Ẏ_j + Σⱼ v_ij x_j

Each implicit stage solve is a Newton solve (snes_solve, matrix-free
Newton-Krylov) in an eager Python step loop. ts_gl keeps a fixed step
size and scheme order; ts_gl_adaptive is the reference's adaptive
order/step controller (TSSolve_GL + TSGLAdaptChoose_Both), host control
logic around the same stage solves. ts_gl's starting vector is exact:
x_j = hʲ⁻¹u⁽ʲ⁻¹⁾ with the ODE derivatives u⁽ᵏ⁾ generated by nested
torch.func.jvp through u' = f (the reference bootstraps with a
lower-order starting method instead).

The scheme tables and gl_error_coeffs are numpy host code, a copy of
petsctpu's.
"""

from __future__ import annotations

import math
from typing import Callable, Optional

import numpy as np
import torch

from petsctpu_torch.snes.api import snes_solve
from petsctpu_torch.ts.steppers import (TSConfig, TSResult, _monitor,
                                        configure, result, running,
                                        step_size, time_dtype)


# (p, c, A, B, U, V) transcribed from gl.c TSGLRegisterAll
GL_SCHEMES = {
    1: dict(
        c=np.array([0.3, 1.0]),
        A=np.array([[0.3, 0.0], [0.7, 0.3]]),
        B=np.array([[0.7, 0.3], [0.0, 1.0]]),
        U=np.array([[1.0, 0.0], [1.0, 0.0]]),
        V=np.array([[1.0, 0.0], [0.0, 0.0]]),
    ),
    2: dict(
        c=np.array([1 / 3, 2 / 3, 1.0]),
        A=np.array([[4 / 9, 0.0, 0.0],
                    [1.03750643704090e+00, 4 / 9, 0.0],
                    [7.67024779410304e-01, -3.81140216918943e-01, 4 / 9]]),
        B=np.array([[0.767024779410304, -0.381140216918943, 4 / 9],
                    [0.0, 0.0, 1.0],
                    [-2.075048385225385, 0.621728385225383,
                     1.277197204924873]]),
        U=np.array([[1.0, -0.1111111111111109, -0.0925925925925922],
                    [1.0, -0.8152842148186744, -0.4199095530877056],
                    [1.0, 0.1696709930641948, 0.0539741070314165]]),
        V=np.array([[1.0, 0.1696709930641948, 0.0539741070314165],
                    [0.0, 0.0, 0.0],
                    [0.0, 0.176122795075129, 0.0]]),
    ),
    3: dict(   # p=q=3, r=s=4: irks(9/40,...) gl.c:548-567
        c=np.array([0.25, 0.5, 0.75, 1.0]),
        A=np.array([
            [9. / 40., 0, 0, 0],
            [2.11286958887701e-01, 9. / 40., 0, 0],
            [9.46338294287584e-01, -3.42942861246094e-01, 9. / 40., 0],
            [0.521490453970721, -0.662474225622980, 0.490476425459734,
             9. / 40.]]),
        B=np.array([
            [0.521490453970721, -0.662474225622980, 0.490476425459734,
             9. / 40.],
            [0.0, 0.0, 0.0, 1.0],
            [-0.084677029310348, 1.390757514776085, -1.568157386206001,
             2.023192696767826],
            [0.465383797936408, 1.478273530625148, -1.930836081010182,
             1.644872111193354]]),
        U=np.array([
            [1.0, 0.02500000000001035, -0.02499999999999053,
             -0.00442708333332865],
            [1.0, 0.06371304111232945, -0.04032173972189845,
             -0.01389438413189452],
            [1.0, -0.07839543304147778, 0.04738685705116663,
             0.02032603595928376],
            [1.0, 0.42550734619251651, 0.10800718022400080,
             -0.01726712647760034]]),
        V=np.array([
            [1.0, 0.42550734619251651, 0.10800718022400080,
             -0.01726712647760034],
            [0.0, 0.0, 0.0, 0.0],
            [0.0, -1.761115796027561, -0.521284157173780,
             0.258249384305463],
            [0.0, -1.657693358744728, -1.052227765232394,
             0.521284157173780]]),
    ),
    4: dict(   # p=q=4, r=s=5: irks(3/11,...) gl.c:569-597
        c=np.array([0.2, 0.4, 0.6, 0.8, 1.0]),
        A=np.array([
            [2.72727272727352e-01, 0, 0, 0, 0],
            [-1.03980153733431e-01, 2.72727272727405e-01, 0, 0, 0],
            [-1.58615400341492e+00, 7.44168951881122e-01,
             2.72727272727309e-01, 0, 0],
            [-8.73658042865628e-01, 5.37884671894595e-01,
             -1.63298538799523e-01, 2.72727272726996e-01, 0],
            [2.95489397443992e-01, -1.18481693910097e+00,
             -6.68029812659953e-01, 1.00716687860943e+00,
             2.72727272727288e-01]]),
        B=np.array([
            [2.95489397443992e-01, -1.18481693910097e+00,
             -6.68029812659953e-01, 1.00716687860943e+00,
             2.72727272727288e-01],
            [0.0, 1.11022302462516e-16, -2.22044604925031e-16, 0.0, 1.0],
            [-4.05882503986005e+00, -4.00924006567769e+00,
             -1.38930610972481e+00, 4.45223930308488e+00,
             6.32331093108427e-01],
            [8.35690179937017e+00, -2.26640927349732e+00,
             6.86647884973826e+00, -5.22595158025740e+00,
             4.50893068837431e+00],
            [1.27656267027479e+01, 2.80882153840821e+00,
             8.91173096522890e+00, -1.07936444078906e+01,
             4.82534148988854e+00]]),
        U=np.array([
            [1.0, -7.27272727273551e-02, -3.45454545454419e-02,
             -4.12121212119565e-03, -2.96969696964014e-04],
            [1.0, 2.31252881006154e-01, -8.29487834416481e-03,
             -9.07191207681020e-03, -1.70378403743473e-03],
            [1.0, 1.16925777880663e+00, 3.59268562942635e-02,
             -4.09013451730615e-02, -1.02411119670164e-02],
            [1.0, 1.02634463704356e+00, 1.59375044913405e-01,
             1.89673015035370e-03, -4.89987231897569e-03],
            [1.0, 1.27746320298021e+00, 2.37186008132728e-01,
             -8.28694373940065e-02, -5.34396510196430e-02]]),
        V=np.array([
            [1.0, 1.27746320298021e+00, 2.37186008132728e-01,
             -8.28694373940065e-02, -5.34396510196430e-02],
            [0.0, -1.77635683940025e-15, -1.99840144432528e-15,
             -9.99200722162641e-16, -3.33066907387547e-16],
            [0.0, 4.37280081906924e+00, 5.49221645016377e-02,
             -8.88913177394943e-02, 1.12879077989154e-01],
            [0.0, -1.22399504837280e+01, -5.21287338448645e+00,
             -8.03952325565291e-01, 4.60298678047147e-01],
            [0.0, -1.85178762883829e+01, -5.21411849862624e+00,
             -1.04283436528809e+00, 7.49030161063651e-01]]),
    ),
    5: dict(   # p=q=5, r=s=6: irks(1/3,...) gl.c:599-633
        c=np.array([1. / 6, 2. / 6, 3. / 6, 4. / 6, 5. / 6, 1.]),
        A=np.array([
            [3.33333333333940e-01, 0, 0, 0, 0, 0],
            [-8.64423857333350e-02, 3.33333333332888e-01, 0, 0, 0, 0],
            [-2.16850174258252e+00, -2.23619072028839e+00,
             3.33333333335204e-01, 0, 0, 0],
            [-4.73160970138997e+00, -3.89265344629268e+00,
             -2.76318716520933e-01, 3.33333333335759e-01, 0, 0],
            [-6.75187540297338e+00, -7.90756533769377e+00,
             7.90245051802259e-01, -4.48352364517632e-01,
             3.33333333328483e-01, 0],
            [-4.26488287921548e+00, -1.19320395589302e+01,
             3.38924509887755e+00, -2.23969848002481e+00,
             6.62807710124007e-01, 3.33333333335440e-01]]),
        B=np.array([
            [-4.26488287921548e+00, -1.19320395589302e+01,
             3.38924509887755e+00, -2.23969848002481e+00,
             6.62807710124007e-01, 3.33333333335440e-01],
            [-8.88178419700125e-16, 4.44089209850063e-16,
             -1.54737334057131e-15, -8.88178419700125e-16, 0.0,
             1.00000000000001e+00],
            [-2.87780425770651e+01, -1.13520448264971e+01,
             2.62002318943161e+01, 2.56943874812797e+01,
             -3.06702268304488e+01, 6.68067773510103e+00],
            [5.47971245256474e+01, 6.80366875868284e+01,
             -6.50952588861999e+01, -8.28643975339097e+01,
             8.17416943896414e+01, -1.17819043489036e+01],
            [-2.33332114788869e+02, 6.12942539462634e+01,
             -4.91850135865944e+01, 1.82716844135480e+02,
             -1.29788173979395e+02, 3.09968095651099e+01],
            [-1.72049132343751e+02, 8.60194713593999e+00,
             7.98154219170200e-01, 1.50371386053218e+02,
             -1.18515423962066e+02, 2.50898277784663e+01]]),
        U=np.array([
            [1.0, -1.66666666666870e-01, -4.16666666664335e-02,
             -3.85802469124815e-03, -2.25051440302250e-04,
             -9.64506172339142e-06],
            [1.0, 8.64423857327162e-02, -4.11484912671353e-02,
             -1.11450903217645e-02, -1.47651050487126e-03,
             -1.34395070766826e-04],
            [1.0, 4.57135912953434e+00, 1.06514719719137e+00,
             1.33517564218007e-01, 1.11365952968659e-02,
             6.12382756769504e-04],
            [1.0, 9.23391519753404e+00, 2.22431212392095e+00,
             2.91823807741891e-01, 2.52058456411084e-02,
             1.22800542949647e-03],
            [1.0, 1.48175480533865e+01, 3.73439117461835e+00,
             5.14648336541804e-01, 4.76430038853402e-02,
             2.56798515502156e-03],
            [1.0, 1.50512347758335e+01, 4.10099701165164e+00,
             5.66039141003603e-01, 3.91213893800891e-02,
             -2.99136269067853e-03]]),
        V=np.array([
            [1.0, 1.50512347758335e+01, 4.10099701165164e+00,
             5.66039141003603e-01, 3.91213893800891e-02,
             -2.99136269067853e-03],
            [0.0, -4.88498130835069e-15, -6.43929354282591e-15,
             -3.55271367880050e-15, -1.22124532708767e-15,
             -3.12250225675825e-16],
            [0.0, 1.22250171233141e+01, -1.77150760606169e+00,
             3.54516769879390e-01, 6.22298845883398e-01,
             2.31647447450276e-01],
            [0.0, -4.48339457331040e+01, -3.57363126641880e-01,
             5.18750173123425e-01, 6.55727990241799e-02,
             1.63175368287079e-01],
            [0.0, 1.37297394708005e+02, -1.60145272991317e+00,
             -5.05319555199441e+00, 1.55328940390990e-01,
             9.16629423682464e-01],
            [0.0, 1.05703241119022e+02, -1.16610260983038e+00,
             -2.99767252773859e+00, -1.13472315553890e-01,
             1.09742849254729e+00]]),
    ),
}




def ode_derivs(rhs: Callable, t: torch.Tensor, u: torch.Tensor, k: int):
    """[u', u'', ..., u^(k)] of u' = rhs(t, u) at (t, u), t a 0-d tensor,
    by nested torch.func.jvp: d_t g(t,u) = g_t + g_u·f."""
    gs = [rhs]
    for _ in range(k - 1):
        gprev = gs[-1]

        def gnext(tt, uu, gprev=gprev):
            return torch.func.jvp(gprev, (tt, uu),
                                  (torch.ones_like(tt), rhs(tt, uu)))[1]

        gs.append(gnext)
    return [g(t, u) for g in gs]


def ts_gl(rhs: Callable, u0: torch.Tensor, order: int = 2,
          cfg: TSConfig = None, axis: Optional[str] = None,
          **kw) -> TSResult:
    """Fixed-step, fixed-order general linear integration of u' = rhs."""
    cfg = configure(cfg, kw)
    sch = GL_SCHEMES[order]
    c, A, B, U, V = (sch["c"], sch["A"], sch["B"], sch["U"], sch["V"])
    s = A.shape[0]
    r = V.shape[0]
    tt = time_dtype(u0)

    def step(t, X, h):
        Ydots = []
        for i in range(s):                     # stages
            known = sum(U[i, j] * X[j] for j in range(r))
            known = known + h * sum(A[i, j] * Ydots[j] for j in range(i))
            aii = A[i, i]
            ti = t + c[i] * h

            def G(yd, known=known, aii=aii, ti=ti):
                return yd - rhs(ti, known + h * aii * yd)

            guess = Ydots[i - 1] if i else rhs(t, X[0])
            res = snes_solve(G, guess, jac="jvp", cfg=cfg.snes,
                             ksp_cfg=cfg.ksp, axis=axis)
            Ydots.append(res.x)
        Xn = []
        for i in range(r):
            xi = sum(V[i, j] * X[j] for j in range(r)) \
                + h * sum(B[i, j] * Ydots[j] for j in range(s))
            Xn.append(xi)
        return Xn

    # starting vector x_j = h^{j-1} u^{(j-1)} — ODE derivatives by
    # nested jvp through u' = f (exact Nordsieck start; the reference
    # bootstraps with a lower-order starting scheme instead)
    h0 = tt(cfg.dt)
    t0 = torch.tensor(cfg.t0, dtype=u0.dtype, device=u0.device)
    derivs = ode_derivs(rhs, t0, u0, r - 1)
    X0 = [u0] + [(h0 ** j) * derivs[j - 1] for j in range(1, r)]
    # Unresolved stiff modes make h^j u^(j) explode (|hλ| ≫ 1). Those
    # components are L-stably damped by the scheme anyway, so clip each
    # tail component to the solution scale — smooth starts are
    # untouched and keep the full design order.
    uscale = torch.linalg.vector_norm(u0) + 1e-30
    X = [X0[0]] + [
        x * torch.clamp(uscale / (torch.linalg.vector_norm(x) + 1e-30),
                        max=1.0)
        for x in X0[1:]]

    t, nsteps = tt(cfg.t0), 0
    while running(cfg, t, nsteps):
        h = step_size(cfg, t, tt(cfg.dt))
        X = step(t, X, h)
        t = t + h
        nsteps += 1
        _monitor(cfg, nsteps, t, X[0])
    return result(X[0], t, nsteps, tt(cfg.dt))
# ---------------------------------------------------------------------------
# TSGLAdapt — adaptive order/step control
# ---------------------------------------------------------------------------
def gl_error_coeffs(p: int):
    """Scheme error-estimation coefficients, reproducing
    TSGLSchemeCreate (gl.c:143-306): alpha/beta/gamma (leading error
    constants and their Nordsieck corrections), the stage error xi,
    and the phi/psi higher-moment estimators (GELSS least squares).
    Returns a dict of numpy arrays."""
    sch = GL_SCHEMES[p]
    c, A, B, U, V = (sch["c"], sch["A"], sch["B"], sch["U"], sch["V"])
    r = s = p + 1
    f = math.factorial

    def cpow(cc, k):
        return cc ** k / f(k)

    ImV = np.eye(r - 1) - V[1:, 1:]
    alpha = np.zeros(r)
    rhs = np.array([1.0 / f(p + 1 - i) - B[i] @ cpow(c, p)
                    for i in range(1, r)])
    alpha[1:] = np.linalg.solve(ImV, rhs)
    beta = np.zeros(r)
    rhs = np.array([1.0 / f(p + 2 - i) - alpha[i] - B[i] @ cpow(c, p + 1)
                    for i in range(1, r)])
    beta[1:] = np.linalg.solve(ImV, rhs)
    xi = cpow(c, p + 1) - A @ cpow(c, p) + U[:, 1:] @ alpha[1:]
    alpha[0] = 1.0 / f(p + 1) - B[0] @ cpow(c, p) + V[0, 1:] @ alpha[1:]
    gamma = np.zeros(r)
    rhs = np.array([(-alpha[0] if i == 1 else 0.0) + B[i] @ xi
                    for i in range(1, r)])
    gamma[1:] = np.linalg.solve(ImV, rhs)
    beta[0] = (1.0 / f(p + 2) - B[0] @ cpow(c, p + 1)
               + V[0, 1:] @ beta[1:])
    gamma[0] = B[0] @ xi + V[0, 1:] @ gamma[1:]

    H = np.zeros((3, s))
    ks = np.arange(1, r)
    for j in range(s):
        ck = np.array([cpow(c[j], k - 1) for k in ks])
        H[0, j] = cpow(c[j], p) + ck @ alpha[1:]
        H[1, j] = cpow(c[j], p + 1) + ck @ beta[1:]
        H[2, j] = xi[j] - ck @ gamma[1:]
    bmat = np.array([[1.0, 0.0, 0.0], [1.0, 1.0, 0.0], [0.0, 0.0, -1.0]])
    phi = np.linalg.lstsq(H, bmat, rcond=1e-12)[0].T       # [3, s]
    psi = np.zeros((3, r))
    for k in range(1, r):
        ck = np.array([cpow(c[m], k - 1) for m in range(s)])
        psi[:, k] = -(phi @ ck)
    return dict(alpha=alpha, beta=beta, gamma=gamma, xi=xi,
                phi=phi, psi=psi, p=p, q=p, r=r, s=s)




def ts_gl_adaptive(rhs: Callable, u0: torch.Tensor, cfg: TSConfig = None,
                   min_order: int = 1, max_order: int = 3,
                   start_order: int = 1, wrms_atol: float = 1e-8,
                   wrms_rtol: float = 1e-5, record: bool = True,
                   linear_A=None, axis: Optional[str] = None, **kw):
    """Adaptive general linear integration — the reference's FULL
    TSSolve_GL control flow (gl.c:910-1090) with the 'both'
    order+stepsize controller (TSGLAdaptChoose_Both gladapt.c) and the
    rescale-and-modify step completion (gl.c:459): per step, the
    higher moments h^{p+1}x^{(p+1)}.. are estimated from (phi, psi),
    WRMS-normed against (atol + rtol|x|) weights, candidate schemes of
    order p-1/p/p+1 are priced via their leading error constants, and
    the Nordsieck vector is rescaled to the chosen (scheme, h).
    Default accept test is 'always', like the reference.

    linear_A: optional scipy matrix for TS_LINEAR problems (udot =
    A u). The reference then uses SNESKSPONLY (ts.c:259) — ONE
    GMRES(30)+ILU(0) rtol-1e-5 solve per stage in the Y variable with
    the previous stage as initial guess (gl.c:1005 "reuse the last
    stage") — and the error estimator sees that solver's inexactness.
    Reproducing it makes the adaptive trajectory match the oracle's.

    Host-driven control loop: the Nordsieck vector is kept on the host
    (numpy), each stage solve runs on u0's device. Returns (TSResult,
    record list of (t, h, order) per accepted step)."""
    cfg = configure(cfg, kw)
    dev, dtype = u0.device, u0.dtype
    schemes = {}
    for p in range(max(min_order, 1), min(max_order, 5) + 1):
        schemes[p] = (GL_SCHEMES[p], gl_error_coeffs(p))
    max_r = max(e["r"] for _, e in schemes.values())

    def on_dev(v):
        return torch.as_tensor(np.asarray(v), dtype=dtype, device=dev)

    X = [u0.cpu().numpy()] + [np.zeros(u0.shape, u0.cpu().numpy().dtype)
                              for _ in range(max_r - 1)]
    w = 1.0 / (wrms_atol + wrms_rtol * np.abs(X[0]))
    N = X[0].size

    def wrms(v):
        return float(np.sqrt(np.sum((v * w) ** 2) / N))

    t = float(cfg.t0)
    h = float(cfg.dt)
    cur_p = start_order
    desired_h = 0.0
    count_at_order = 0
    final_step = False
    finish = False
    steps = 0
    rec = []
    dec, inc, safe = 0.2, 5.0, 0.9

    for k in range(cfg.max_steps):
        if finish or t > cfg.max_time:
            break
        sch, ec = schemes[cur_p]
        c, A, B, U, V = (sch["c"], sch["A"], sch["B"], sch["U"],
                         sch["V"])
        r, s = ec["r"], ec["s"]

        # ---- stage solves (gl.c:976-1014) -------------------------------
        Ydots = []
        if linear_A is not None:
            import scipy.sparse as ssp

            from petsctpu_torch.ksp import ksp_solve
            from petsctpu_torch.mat import aij_from_scipy
            from petsctpu_torch.pc.factor import make_ilu
            Ah = ssp.csr_matrix(linear_A)
            Y = X[0].copy()                  # stage guess carries over
            for i in range(s):
                shift = 1.0 / (A[i, i] * h)
                Z = -shift * (sum(U[i, j] * X[j] for j in range(r))
                              + h * sum(A[i, j] * Ydots[j]
                                        for j in range(i)))
                J = (shift * ssp.eye(Ah.shape[0]) - Ah).tocsr()
                J.sort_indices()
                F0 = Z + shift * Y - Ah @ Y
                rk = ksp_solve(aij_from_scipy(J, device=dev), on_dev(-F0),
                               pc=make_ilu(J, device=dev), ksp_type="gmres",
                               rtol=1e-5, maxits=10000)
                # SNESKSPONLY quirk (ksponly.c): F is NOT re-evaluated
                # after the update, so the Ydot the integrator keeps
                # (computed inside the function evaluation,
                # gl.c:1005-1012) is the one at the PRE-SOLVE guess;
                # the solved Y only becomes the next stage's guess.
                Ydots.append(Z + shift * Y)
                Y = Y + rk.x.cpu().numpy()
        else:
            for i in range(s):
                known = sum(U[i, j] * X[j] for j in range(r))
                known = known + h * sum(A[i, j] * Ydots[j]
                                        for j in range(i))
                aii = A[i, i]
                ti = t + c[i] * h
                knj = on_dev(known)

                def G(yd, knj=knj, aii=aii, ti=ti):
                    return yd - rhs(ti, knj + h * aii * yd)

                guess = on_dev(Ydots[i - 1] if i
                               else rhs(t, on_dev(X[0])).cpu().numpy())
                res = snes_solve(G, guess, jac="jvp", cfg=cfg.snes,
                                 ksp_cfg=cfg.ksp, axis=axis)
                Ydots.append(res.x.cpu().numpy())

        # ---- higher moments + WRMS norms (gl.c:415-432, :1017-1030) ----
        phi, psi = ec["phi"], ec["psi"]
        hm = [h * sum(phi[i, j] * Ydots[j] for j in range(s))
              + sum(psi[i, j] * X[j] for j in range(r))
              for i in range(3)]
        hmnorm = [0.0] * 4
        for i in range(3):
            hmnorm[i + 1] = wrms(hm[i])
        # accept test: 'always' (the reference default, gl.c:1198)
        hmnorm[0] = wrms(X[r - 1])

        # ---- choose next scheme (gl.c:862-895 + gladapt.c Both) --------
        tleft = cfg.max_time - (t + h)
        if not final_step:
            cands = []
            for pp, (_, e2) in sorted(schemes.items()):
                if pp == cur_p - 1:
                    err = abs(e2["alpha"][0]) * hmnorm[0]
                elif pp == cur_p:
                    err = abs(e2["alpha"][0]) * hmnorm[1]
                elif pp == cur_p + 1:
                    err = abs(e2["alpha"][0]) * (hmnorm[2] + hmnorm[3])
                else:
                    continue
                cands.append(dict(p=pp, order=min(pp, e2["q"]),
                                  err=err, cost=e2["s"]))
            cur_i = next(i for i, cd in enumerate(cands)
                         if cd["p"] == cur_p)
            best = cur_tr = None
            for i, cd in enumerate(cands):
                optimal = cd["err"] ** (-1.0 / (safe * cd["order"]))
                trial = dict(i=i, h=h * optimal,
                             eff=h * optimal / cd["cost"])
                if best is None or trial["eff"] > best["eff"]:
                    best = trial
                if i == cur_i:
                    cur_tr = trial
            if (best["eff"] < 1.2 * cur_tr["eff"]
                    or count_at_order < cands[cur_i]["order"] + 2):
                next_i = cur_i
                last_desired = desired_h
                desired_h = max(h * dec, min(h * inc, cur_tr["h"]))
                next_h = (np.sqrt(last_desired * desired_h)
                          if count_at_order > 0 else desired_h)
                count_at_order += 1
            else:
                rat = (cands[best["i"]]["cost"]
                       / cands[cur_i]["cost"])
                next_i = best["i"]
                next_h = max(h * rat * dec,
                             min(h * rat * inc, best["h"]))
                count_at_order = 0
                desired_h = best["h"]
            if next_h > tleft:
                final_step = True
                next_h = tleft
            next_p = cands[next_i]["p"]
        else:
            next_p = cur_p
            next_h = h
            finish = True

        # ---- complete step: rescale-and-modify (gl.c:459-505) ----------
        next_r = schemes[next_p][1]["r"]
        ratio = next_h / h if h else 1.0
        alpha, beta, gamma = ec["alpha"], ec["beta"], ec["gamma"]
        Xold = X
        Xn = []
        for i in range(r):
            acc = np.zeros_like(Xold[0])
            for j in range(s):
                br = h * (ratio ** i * B[i, j]
                          + (ratio ** i - ratio ** (ec["p"] + 1))
                          * (alpha[i] * phi[0, j])
                          + (ratio ** i - ratio ** (ec["p"] + 2))
                          * (beta[i] * phi[1, j]
                             + gamma[i] * phi[2, j]))
                acc = acc + br * Ydots[j]
            for j in range(r):
                vr = (ratio ** i * V[i, j]
                      + (ratio ** i - ratio ** (ec["p"] + 1))
                      * (alpha[i] * psi[0, j])
                      + (ratio ** i - ratio ** (ec["p"] + 2))
                      * (beta[i] * psi[1, j] + gamma[i] * psi[2, j]))
                acc = acc + vr * Xold[j]
            Xn.append(acc)
        if r < next_r:
            acc = np.zeros_like(Xold[0])
            for j in range(s):
                acc = acc + h * ratio ** (ec["p"] + 1) * phi[0, j] * Ydots[j]
            for j in range(r):
                acc = acc + ratio ** (ec["p"] + 1) * psi[0, j] * Xold[j]
            Xn.append(acc)
        while len(Xn) < max_r:
            Xn.append(np.zeros_like(Xold[0]))
        X = Xn
        w = 1.0 / (wrms_atol + wrms_rtol * np.abs(X[0]))
        t += h
        steps += 1
        if record:
            rec.append((t, h, cur_p))
        _monitor(cfg, steps, t, None)
        cur_p = next_p
        h = next_h

    tt = time_dtype(u0)
    return result(on_dev(X[0]), tt(t), steps, tt(h)), rec
