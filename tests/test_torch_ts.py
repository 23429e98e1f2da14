"""TS through the port (petsctpu_torch.ts), on the CPU in fp64.

Held to the oracle numbers directly, at the reference tests' own
tolerances (petsctpu's own tests hold petsctpu to the same numbers):
the two TS goldens of tests/test_golden.py (ts ex1's pseudo-Bratu fnorm
and dt streams, ts ex3's SSP errors) and the ts ex2, ex4_1, ex7_1,
ex15_1, ex15_3, ex17_1, ex17_2 and ex24 goldens of tests/test_ts.py;
the explicit, implicit, pseudo, alpha and CFL checks of test_ts.py and
test_ts_alpha.py; the characteristic cases of test_characteristic.py.

Held against petsctpu on the same numpy inputs, each JAX reference
integrated once:
  * one short integration per stepper family (euler, the four SSP
    schemes, rk bs23 and dp45 with the basic adaptor, beuler, cn, the
    θ stage form, the ifunc form, alpha, pseudo): equal step counts and
    final times, states within 1e-13 relative (explicit) and 1e-11
    relative (implicit: the inner GMRES sums in another order);
  * ex15 at M = 20 with the stencil-colored Jacobian and a Jacobi PC,
    three BE steps, states within 1e-11 relative;
  * characteristic_step in both modes within 1e-15 relative, the
    periodic one on a field where scipy's 'wrap' and JAX's differ.
"""

import numpy as np
import pytest
import scipy.sparse as sp
import torch

from petsctpu_torch.core.options import Options
from petsctpu_torch.ksp import ksp_solve
from petsctpu_torch.ksp.common import KSPConfig
from petsctpu_torch.mat import aij_from_scipy
from petsctpu_torch.mat.ell import aij_to_scipy
from petsctpu_torch.models.heat import (heat1d_ifunc, heat1d_initial,
                                        heat2d_ifunc, heat2d_initial,
                                        heat2d_jacobian_template)
from petsctpu_torch.pc.factor import make_ilu
from petsctpu_torch.pc.simple import JacobiPC
from petsctpu_torch.snes import ColoredJacobian, snes_solve
from petsctpu_torch.snes.api import SNESConfig
from petsctpu_torch.ts import (TS, TSConfig, characteristic_step, ts_alpha,
                               ts_characteristic, ts_pseudo, ts_solve)

# one intra-op thread: the suite runs in parallel workers (pytest -n), and
# PyTorch's default of a thread a core oversubscribes the host's cores
torch.set_num_threads(1)


def t(a):
    return torch.from_numpy(np.asarray(a, np.float64))


def rel(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return np.abs(a - b).max() / max(np.abs(b).max(), 1e-300)


def decay_rhs(t_, u):
    return -u


def logistic(t_, u):
    return u * (1.0 - u)


LOGISTIC_EXACT = 0.1 * np.exp(2.0) / (1 - 0.1 + 0.1 * np.exp(2.0))


# ---------------------------------------------------------------------------
# the TS goldens of tests/test_golden.py
# ---------------------------------------------------------------------------

def test_ts_ex1_pseudo_bratu_golden():
    """ts ex1_1.out: Bratu 4x4 (λ=6) by pseudo-timestepping, dt0 =
    0.125, SER increment 1.1: fnorm and dt streams within 2e-3."""
    mx = my = 4
    lam = 6.0
    hx = hy = 1.0 / (mx - 1)
    sc = hx * hy
    hxdhy, hydhx = hx / hy, hy / hx
    mask = np.zeros((my, mx), bool)
    mask[1:-1, 1:-1] = True
    maskt = torch.from_numpy(mask)

    def F(t_, xv):
        X = xv.reshape(my, mx)
        u = X[1:-1, 1:-1]
        uxx = (-X[1:-1, 2:] + 2 * u - X[1:-1, :-2]) * hydhx
        uyy = (-X[2:, 1:-1] + 2 * u - X[:-2, 1:-1]) * hxdhy
        f_int = -uxx - uyy + sc * lam * torch.exp(u)
        out = torch.where(maskt, torch.zeros((), dtype=xv.dtype), X)
        out = torch.cat([out[:1], torch.cat([out[1:-1, :1], f_int,
                                             out[1:-1, -1:]], 1),
                         out[-1:]], 0)
        return out.reshape(-1)

    temp1 = lam / (lam + 1.0)
    u0 = np.zeros((my, mx))
    for j in range(1, my - 1):
        tj = min(j, my - 1 - j) * hy
        for i in range(1, mx - 1):
            u0[j, i] = temp1 * np.sqrt(min(min(i, mx - 1 - i) * hx, tj))
    res = ts_pseudo(F, t(u0.reshape(-1)),
                    TSConfig(ts_type="pseudo", dt=0.125, max_steps=12,
                             pseudo_fnorm_rtol=1e-10))
    f_golden = [0.207564, 0.184718, 0.160569, 0.135283, 0.109165,
                0.0827478, 0.0569517, 0.03335, 0.0144859, 0.00341003,
                0.000212272]
    dt_golden = [0.125, 0.1375, 0.169957, 0.215069, 0.280795,
                 0.382774, 0.555471, 0.887776, 1.66766, 4.22328]
    np.testing.assert_allclose(res.fnorm_history[:11].numpy(), f_golden,
                               rtol=2e-3)
    np.testing.assert_allclose(res.dt_history[:10].numpy(), dt_golden,
                               rtol=2e-3)


def heat_matrix(m):
    """ex3/ex4's 1-D heat RHS matrix (unit boundary rows)."""
    h = 1.0 / (m - 1)
    A = sp.diags([np.ones(m - 1), -2.0 * np.ones(m), np.ones(m - 1)],
                 [-1, 0, 1]).tolil() / h ** 2
    A[0, :] = 0.0
    A[0, 0] = 1.0
    A[m - 1, :] = 0.0
    A[m - 1, m - 1] = 1.0
    return sp.csr_matrix(A)


def test_ts_ex3_ssp_heat_golden():
    """ts ex3_1.out: 1-D heat m=60, -ts_type ssp (rks2, 5 stages)
    -ts_dt 0.0005: the h-scaled 2-norm errors of steps 1..10 within
    2e-4."""
    m = 60
    h = 1.0 / (m - 1)
    Ad = t(heat_matrix(m).toarray())

    def rhs(t_, u):
        return Ad @ u

    xs = h * np.arange(m)

    def exact(tt):
        return (np.sin(6 * np.pi * xs) * np.exp(-36 * np.pi ** 2 * tt)
                + 3 * np.sin(2 * np.pi * xs) * np.exp(-4 * np.pi ** 2 * tt))

    golden = [0.00103714, 0.00173865, 0.00218619, 0.00244382,
              0.00256155, 0.0025782, 0.00252361, 0.00242114,
              0.00228786, 0.00213706]
    u = t(exact(0.0))
    errs = []
    for k in range(10):
        u = ts_solve(rhs, u, TSConfig(ts_type="ssp", ssp_type="rks2",
                                      ssp_nstages=5, dt=0.0005,
                                      max_steps=1, max_time=1.0)).u
        errs.append(np.sqrt(h) * np.linalg.norm(u.numpy()
                                                - exact(0.0005 * (k + 1))))
    np.testing.assert_allclose(errs, golden, rtol=2e-4)


# ---------------------------------------------------------------------------
# the TS goldens of tests/test_ts.py
# ---------------------------------------------------------------------------

def test_ex2_beuler_exact_to_solver_noise():
    """ts ex2: u_t = u·u_xx/(2(1+t)²), exact (1+x²)(1+t) reproduced by
    the scheme; BE dt=10 with the colored Jacobian and Jacobi: each
    step's error below 1e-6."""
    M = 60
    h = 1.0 / (M - 1)
    xs = np.linspace(0.0, 1.0, M)

    def rhs(t_, u):                 # u [n] or a batch [C, n]
        sc = 1.0 / (h * h * 2.0 * (1.0 + t_) * (1.0 + t_))
        interior = u[..., 1:-1] * sc * (u[..., 2:] + u[..., :-2]
                                        - 2.0 * u[..., 1:-1])
        one = torch.ones_like(u[..., :1])
        return torch.cat([one, interior, 2.0 * one], -1)

    def exact(tt):
        return (1.0 + xs * xs) * (1.0 + tt)

    patt = sp.diags([np.ones(M - 1), np.ones(M), np.ones(M - 1)],
                    [-1, 0, 1]).tocsr()
    plan = ColoredJacobian.from_sparsity(patt, aij_from_scipy(
        patt, device="cpu"))
    u, tt = t(exact(0.0)), 0.0
    for _ in range(10):
        r = ts_solve(rhs, u, ts_type="beuler", t0=tt, dt=10.0,
                     max_steps=1, max_time=tt + 10.0, jac=plan,
                     pc_builder=lambda J: JacobiPC(1.0 / J.diagonal()))
        u, tt = r.u, float(r.t)
        maxerr = np.abs(u.numpy() - exact(tt)).max()
        assert maxerr < 1e-6, (tt, maxerr)
    assert tt == 100.0


def test_ex4_1_euler_error_stream():
    """ts ex4_1.out: TS_LINEAR 1-D heat m=60, forward Euler dt = h²/2:
    the per-step 2-norm and max errors within 2e-5, and the ex6_1
    averages."""
    m = 60
    h = 1.0 / (m - 1)
    dt = h * h / 2.0
    x = np.arange(m) * h
    stwo = -2.0 / (h * h)
    sone = -0.5 * stwo
    A = sp.diags([np.full(m - 1, sone), np.full(m, stwo),
                  np.full(m - 1, sone)], [-1, 0, 1]).tolil()
    A[0, :] = 0.0
    A[0, 0] = 1.0
    A[m - 1, :] = 0.0
    A[m - 1, m - 1] = 1.0
    Ad = aij_from_scipy(sp.csr_matrix(A), device="cpu")

    def rhs(t_, u):
        return Ad.mult(u)

    def exact(tt):
        return (np.exp(-36 * np.pi ** 2 * tt) * np.sin(6 * np.pi * x)
                + 3 * np.exp(-4 * np.pi ** 2 * tt) * np.sin(2 * np.pi * x))

    golden2 = [0.000599907, 0.00113969, 0.00162387, 0.00205669,
               0.00244208, 0.00278372, 0.00308505, 0.00334925,
               0.0035793, 0.00377799]
    goldenmax = [0.000863771, 0.00164231, 0.00234201, 0.00296886,
                 0.00352842, 0.00402589, 0.00446612, 0.00485363,
                 0.00519261, 0.00548699]
    u, tt = t(exact(0.0)), 0.0
    for step in range(10):
        r = ts_solve(rhs, u, ts_type="euler", t0=tt, dt=dt, max_steps=1,
                     max_time=tt + dt)
        u, tt = r.u, float(r.t)
        err = u.numpy() - exact(tt)
        np.testing.assert_allclose(np.linalg.norm(err) * np.sqrt(h),
                                   golden2[step], rtol=2e-5)
        np.testing.assert_allclose(np.abs(err).max(), goldenmax[step],
                                   rtol=2e-5)
    np.testing.assert_allclose(np.mean(golden2[:4]), 0.00135504, rtol=2e-5)
    np.testing.assert_allclose(np.mean(goldenmax[:4]), 0.00195424,
                               rtol=2e-5)


def ex7_rhs(M):
    h = 1.0 / (M - 1)
    s = 1.0 / (h * h)
    bnd = np.zeros((M, M), bool)
    bnd[0, :] = bnd[-1, :] = bnd[:, 0] = bnd[:, -1] = True
    bndt = torch.from_numpy(bnd)

    def rhs(t_, uflat):
        X = uflat.reshape(M, M)
        P = torch.nn.functional.pad(X, (1, 1, 1, 1))
        C = X
        W, E = P[1:-1, :-2], P[1:-1, 2:]
        S, N = P[:-2, 1:-1], P[2:, 1:-1]
        uxx = (2 * C - W - E) * s
        uyy = (2 * C - S - N) * s
        interior = -C * (uxx + uyy) - 3.0 * (
            ((E - W) ** 2) * 0.25 * s + ((N - S) ** 2) * 0.25 * s)
        return torch.where(bndt, X, interior).reshape(-1)

    return rhs


def test_ex7_1_beuler_solution_norms():
    """ts ex7_1.out: u_t = −u·Δu − 3|∇u|² on 8×8, BE dt=1e-4 with the
    nested Newton: the six solution norms within 2e-5."""
    M = 8
    h = 1.0 / (M - 1)
    x = np.arange(M) * h
    XX, YY = np.meshgrid(x, x, indexing="xy")
    r = np.sqrt((XX - 0.5) ** 2 + (YY - 0.5) ** 2)
    U0 = np.where(r < 0.125, np.exp(-30.0 * r ** 3), 0.0)
    golden = [1.9391, 1.90776, 1.87731, 1.84771, 1.81893, 1.79094]
    rhs = ex7_rhs(M)
    u, tt = t(U0.reshape(-1)), 0.0
    np.testing.assert_allclose(np.linalg.norm(u.numpy()), golden[0],
                               rtol=2e-5)
    for step in range(1, 6):
        res = ts_solve(rhs, u, ts_type="beuler", t0=tt, dt=1e-4,
                       max_steps=1, max_time=tt + 1e-4)
        u, tt = res.u, float(res.t)
        np.testing.assert_allclose(np.linalg.norm(u.numpy()),
                                   golden[step], rtol=2e-5)


def test_ex17_1_beuler_ifunction_dae():
    """ts ex17_1.out (Mx=40, 2 steps): per-step SNES fnorm₀ (2869.48,
    142.606), the ILU(0)-preconditioned GMRES r₀ (1.42606, 0.517415) in
    one iteration, the maxima 0.999937 → 0.714133 → 0.536609 (2e-5);
    ts_solve(ifunc=...) reproduces the trajectory."""
    Mx = 40
    ifunc = heat1d_ifunc(Mx)
    u0 = heat1d_initial(Mx, device="cpu")
    dt = 0.01
    patt = sp.diags([np.ones(Mx - 1), np.ones(Mx), np.ones(Mx - 1)],
                    [-1, 0, 1]).tocsr()
    plan = ColoredJacobian.from_sparsity(patt, aij_from_scipy(
        patt, device="cpu"))
    ksp_r0_golden = [1.42606, 0.517415]
    fnorm_golden = [2869.48, 142.606]
    max_golden = [0.714133, 0.536609]
    u = u0
    np.testing.assert_allclose(float(u.max()), 0.999937, rtol=2e-5)
    tt = 0.0
    for step in range(2):
        def G(v, u=u, tt=tt):
            return ifunc(tt + dt, v, (v - u) / dt)

        Fx = G(u)
        np.testing.assert_allclose(float(torch.linalg.norm(Fx)),
                                   fnorm_golden[step], rtol=2e-5)
        J = plan.assemble(G, u, Fx)
        ilu = make_ilu(aij_to_scipy(J), device="cpu")
        rk = ksp_solve(J, Fx, pc=ilu, ksp_type="gmres", rtol=1e-5,
                       atol=1e-50, maxits=100)
        np.testing.assert_allclose(float(rk.history[0]),
                                   ksp_r0_golden[step], rtol=2e-5)
        assert int(rk.its) == 1 and float(rk.history[1]) < 1e-11
        un = u - rk.x
        assert float(torch.linalg.norm(G(un))) < 1e-10
        u = un
        tt += dt
        np.testing.assert_allclose(float(u.max()), max_golden[step],
                                   rtol=2e-5)
    res = ts_solve(None, u0, ifunc=ifunc, ts_type="beuler", dt=dt,
                   max_steps=2, max_time=1.0)
    np.testing.assert_allclose(float(res.u.max()), 0.536609, rtol=2e-5)
    np.testing.assert_allclose(res.u.numpy(), u.numpy(), atol=1e-9)


EX15_GOLDEN = {
    0: ([0.455605, 0.238234, 0.148476, 0.104384, 0.0788279, 0.0620459,
         0.0500304, 0.0409203, 0.0337537, 0.0279837], [0.0] * 10),
    1: ([0.455785, 0.239093, 0.150767, 0.108931, 0.086344, 0.0730277,
         0.0647339, 0.0593882, 0.0558655, 0.0535095],
        [0.0019786, 0.00668432, 0.0132097, 0.0201985, 0.0266541,
         0.0320965, 0.0364221, 0.0397284, 0.0421896, 0.0439885]),
}


@pytest.mark.parametrize("boundary,route", [(0, "jvp"), (0, "colored"),
                                            (1, "colored")],
                         ids=["ex15_1_dirichlet", "ex15_1_colored",
                              "ex15_3_neumann_colored"])
def test_ex15_heat2d_golden(boundary, route):
    """ts ex15_1/ex15_3.out: 2-D heat DAE M=20, BE dt=0.01, ten steps
    through ts_solve(ifunc=...) and unpreconditioned GMRES: the max column
    within 2e-5, the min column within 3e-4 (the reference's inner GMRES
    noise). The Newton operator is the AD product (the reference test's
    route) or the stencil-colored FD Jacobian on heat2d_jacobian_template
    (ex15's pattern: the Neumann rows' partners on a 9-point box), the
    route chip_smoke.py drives."""
    u = heat2d_initial(20, device="cpu")
    np.testing.assert_allclose(float(u.max()), 0.998455, rtol=2e-5)
    ifunc = heat2d_ifunc(20, boundary)
    jac = None if route == "jvp" else ColoredJacobian.from_stencil(
        heat2d_jacobian_template(20, boundary, device="cpu"))
    mx, mn = EX15_GOLDEN[boundary]
    seen = []
    ts_solve(None, u, ifunc=ifunc, ts_type="beuler", dt=0.01, max_steps=10,
             max_time=1.0, jac=jac, post_step=lambda k, tt, v: seen.append(
                 (float(v.max()), float(v.min()))))
    assert len(seen) == 10
    for k, (a, b) in enumerate(seen):
        np.testing.assert_allclose(a, mx[k], rtol=2e-5, err_msg=f"step {k}")
        np.testing.assert_allclose(b, mn[k], rtol=3e-4, atol=1e-12,
                                   err_msg=f"step {k}")


def test_ex15_weighted_rows_keep_the_trajectory_and_mg_its():
    """heat2d_ifunc(bscale=4/h²), the route chip_smoke.py drives at 2049²:
    at M = 65 the same BE states as ex15.c's unit rows (3 steps, within
    1e-7 relative: both solves stop at Newton rtol 1e-8), and GMRES + the
    device MG on the colored Jacobian in at most 5 its a Newton step,
    where the unit rows take 12-20 at 65² and fail to converge in 200
    from 257² on."""
    import petsctpu_torch.ksp.api as kapi
    from petsctpu_torch.dm import DA
    from petsctpu_torch.pc.mg import make_geometric_mg_device

    M = 65
    da = DA((M, M))
    u0 = heat2d_initial(M, device="cpu")
    its = []
    real = kapi.KSP_REGISTRY["gmres"]

    def spy(*a):
        res = real(*a)
        its.append((int(res.its), int(res.reason)))
        return res

    kapi.KSP_REGISTRY["gmres"] = spy
    try:
        r = ts_solve(None, u0, ifunc=heat2d_ifunc(M, 0, bscale=4.0 * 64 ** 2),
                     ts_type="beuler", dt=0.01, max_steps=3, max_time=1.0,
                     jac=ColoredJacobian.from_stencil(heat2d_jacobian_template(
                         M, 0, device="cpu")),
                     pc_builder=lambda J: make_geometric_mg_device(J, da))
    finally:
        kapi.KSP_REGISTRY["gmres"] = real
    assert its and all(0 < reason and n <= 5 for n, reason in its), its
    ref = ts_solve(None, u0, ifunc=heat2d_ifunc(M, 0), ts_type="beuler",
                   dt=0.01, max_steps=3, max_time=1.0,
                   ksp=KSPConfig(ksp_type="gmres", rtol=1e-10, maxits=500))
    assert rel(r.u.numpy(), ref.u.numpy()) < 1e-7


def test_ex17_2_crank_nicolson():
    """runex17_2: Mx=100, θ=0.5 (CN) on the 1-D heat DAE: the first five
    steps' max within 2e-5 and min within 2e-4."""
    Mx = 100
    ifunc = heat1d_ifunc(Mx)
    u = heat1d_initial(Mx, device="cpu")
    np.testing.assert_allclose(float(u.max()), 0.999996, rtol=2e-5)
    dt, theta = 0.01, 0.5
    golden = [(0.882245, 0.0), (0.777702, -0.0272512),
              (0.71264, -0.0448901), (0.663065, -0.0773792),
              (0.623411, -0.0845737)]
    for step in range(5):
        def G(v, u=u):
            return ifunc(0.0, v, (v - u) / (theta * dt))

        res = snes_solve(G, u, jac="jvp",
                         cfg=SNESConfig(maxits=20, rtol=1e-8,
                                        linesearch="bt"),
                         ksp_cfg=KSPConfig(ksp_type="gmres", rtol=1e-8,
                                           maxits=300))
        u = u + (res.x - u) / theta
        np.testing.assert_allclose(float(u.max()), golden[step][0],
                                   rtol=2e-5)
        np.testing.assert_allclose(float(u.min()), golden[step][1],
                                   rtol=2e-4, atol=1e-12)


def rosenbrock_grad(x):
    """∇ of Σ (1 − x_i)² + 100 (x_{i+1} − x_i²)²; x [n] or a batch [C, n]."""
    a = x[..., 1:] - x[..., :-1] ** 2
    z = torch.zeros_like(x[..., :1])
    return (torch.cat([-2.0 * (1.0 - x[..., :-1])
                       + 200.0 * a * (-2.0 * x[..., :-1]), z], -1)
            + torch.cat([z, 200.0 * a], -1))


def test_ex24_pseudo_rosenbrock():
    """ts ex24 (TSPSEUDO gradient flow of the 50-variable Rosenbrock
    objective, dt0 1e-5, final time 1e5, one Newton iteration a step
    with GMRES to 1e-12): the oracle's dt and gradient-norm columns of
    steps 1..15 within 6 % (its 2-digit precision), and STEPOVER past
    the final time. The Newton operator is the FD-colored Jacobian on
    the Hessian's tridiagonal pattern (3 colors); the reference test
    runs AD products, which GMRES applies about 11,000 times here. Both
    are the exact Jacobian to √eps."""
    n = 50
    patt = sp.diags([np.ones(n - 1), np.ones(n), np.ones(n - 1)],
                    [-1, 0, 1]).tocsr()
    plan = ColoredJacobian.from_sparsity(patt, aij_from_scipy(
        patt, device="cpu"))
    x0 = t(np.concatenate([[5.0, -5.0], 5.0 * np.ones(n - 2)]))
    cfg = TSConfig(ts_type="pseudo", dt=1e-5, max_steps=300,
                   pseudo_fnorm_rtol=0.0, pseudo_max_time=1e5,
                   snes=SNESConfig(maxits=1, rtol=1e-8, linesearch="bt"),
                   ksp=KSPConfig(ksp_type="gmres", rtol=1e-12, maxits=300))
    res = ts_pseudo(lambda t_, x: -rosenbrock_grad(x), x0, cfg,
                    jac=plan)
    dh = res.dt_history.numpy()
    fh = res.fnorm_history.numpy()
    np.testing.assert_allclose(fh[0], 2.6e5, rtol=0.05)
    oracle = [(1.1e-05, 2.1e+05), (1.5e-05, 1.6e+05), (2.1e-05, 1.2e+05),
              (3.2e-05, 8.5e+04), (4.9e-05, 5.8e+04), (7.9e-05, 3.7e+04),
              (1.4e-04, 2.2e+04), (2.6e-04, 1.2e+04), (5.2e-04, 5.7e+03),
              (1.2e-03, 2.5e+03), (2.9e-03, 9.7e+02), (8.4e-03, 3.2e+02),
              (2.8e-02, 8.2e+01), (1.2e-01, 1.5e+01), (7.4e-01, 9.0e+00)]
    for k, (dt_o, df_o) in enumerate(oracle, start=1):
        np.testing.assert_allclose(dh[k], dt_o, rtol=0.06)
        np.testing.assert_allclose(fh[k], df_o, rtol=0.06)
    assert float(res.t) >= 1e5


# ---------------------------------------------------------------------------
# the port's own checks of tests/test_ts.py and test_ts_alpha.py
# ---------------------------------------------------------------------------

def err_at_one(**kw):
    r = ts_solve(decay_rhs, t([1.0]), max_time=1.0, **kw)
    return abs(float(r.u[0]) - np.exp(-1.0))


@pytest.mark.parametrize("kw,dts,lo,hi", [
    (dict(ts_type="euler", max_steps=100000), (0.01, 0.005), 1.8, np.inf),
    (dict(ts_type="ssp"), (0.1, 0.05), 6.0, np.inf),
    (dict(ts_type="ssp", ssp_type="rks2", ssp_nstages=5, max_steps=10000),
     (0.1, 0.05), 3.0, 5.0),
    (dict(ts_type="ssp", ssp_type="rks3", ssp_nstages=4, max_steps=10000),
     (0.1, 0.05), 6.0, 11.0),
    (dict(ts_type="ssp", ssp_type="rk104", ssp_nstages=10, max_steps=10000),
     (0.2, 0.1), 12.0, 22.0),
    (dict(ts_type="cn"), (0.1, 0.05), 3.5, np.inf),
], ids=["euler", "ssp", "rks2", "rks3", "rk104", "cn"])
def test_error_ratio_shows_the_order(kw, dts, lo, hi):
    e1, e2 = (err_at_one(dt=dt, **kw) for dt in dts)
    assert lo < e1 / e2 < hi, (e1, e2)


def test_rk_adaptive_oscillator():
    def rhs(t_, u):
        return torch.stack([u[1], -25.0 * u[0]])

    r = ts_solve(rhs, t([1.0, 0.0]), ts_type="rk", dt=0.05, max_time=1.0,
                 adapt=True, adapt_rtol=1e-6, adapt_atol=1e-8,
                 max_steps=10000)
    np.testing.assert_allclose(float(r.u[0]), np.cos(5.0 * float(r.t)),
                               atol=1e-4)


def test_exact_final_time():
    r = ts_solve(decay_rhs, t([1.0]), ts_type="euler", dt=0.3,
                 max_time=1.0, max_steps=100)
    np.testing.assert_allclose(float(r.t), 1.0, atol=1e-12)
    assert int(r.steps) == 4


def test_backward_euler_stable_stiff():
    r = ts_solve(lambda t_, u: -1000.0 * u, t([1.0]), ts_type="beuler",
                 dt=0.01, max_time=0.1)
    assert abs(float(r.u[0])) < 1.0 and np.isfinite(float(r.u[0]))


def test_theta_nonlinear():
    r = ts_solve(logistic, t([0.1]), ts_type="cn", dt=0.05, max_time=2.0)
    np.testing.assert_allclose(float(r.u[0]), LOGISTIC_EXACT, atol=1e-4)


def test_pseudo_steady_state():
    target = torch.sin(torch.linspace(0, np.pi, 20, dtype=torch.float64))
    r = ts_pseudo(lambda t_, u: -(u - target), torch.zeros(
        20, dtype=torch.float64), dt=0.1, max_steps=100,
        pseudo_fnorm_rtol=1e-10)
    np.testing.assert_allclose(r.u.numpy(), target.numpy(), atol=1e-8)


def test_ts_object_options_driven():
    ts = TS(options=Options({"ts_type": "ssp", "ts_dt": "0.05",
                             "ts_max_time": "1.0"}))
    ts.set_rhs_function(decay_rhs)
    r = ts.solve(t([2.0]))
    np.testing.assert_allclose(float(r.u[0]), 2 * np.exp(-1.0), atol=1e-4)


def test_dp45_order5():
    errs = []
    for dt in (0.4, 0.2):
        r = ts_solve(logistic, t([0.1]), ts_type="rk", rk_type="dp45",
                     dt=dt, max_time=2.0)
        errs.append(abs(float(r.u[0]) - LOGISTIC_EXACT))
    assert np.log2(errs[0] / max(errs[1], 1e-17)) > 4.4, errs


def test_dp45_adaptive():
    def rhs(t_, u):
        return -u + float(np.sin(5.0 * t_))

    r = ts_solve(rhs, t([1.0]), ts_type="rk", rk_type="dp45", dt=0.5,
                 max_time=2.0, adapt=True, adapt_rtol=1e-8,
                 adapt_atol=1e-10, max_steps=5000)
    exact = (np.exp(-2.0) * (1 + 5.0 / 26.0)
             + (np.sin(10.0) - 5 * np.cos(10.0)) / 26.0)
    assert float(r.t) > 2.0 - 1e-10
    assert abs(float(r.u[0]) - exact) < 1e-6


def test_alpha_second_order():
    errs = []
    for dt in (0.1, 0.05):
        r = ts_alpha(decay_rhs, t([1.0]), dt=dt, max_time=1.0)
        errs.append(abs(float(r.u[0]) - np.exp(-1.0)))
    assert errs[0] / errs[1] > 3.5


def test_alpha_damping_radius():
    def rhs(t_, u):
        return torch.stack([u[1], -400.0 * u[0]])

    amp = {}
    for rho in (0.0, 1.0):
        r = ts_alpha(rhs, t([1.0, 0.0]), dt=0.05, max_time=2.0,
                     alpha_radius=rho, max_steps=100)
        amp[rho] = abs(float(r.u[0])) + abs(float(r.u[1])) / 20.0
    assert amp[0.0] < 0.1 * amp[1.0]


def test_alpha_nonlinear():
    r = ts_alpha(logistic, t([0.1]), dt=0.02, max_time=2.0)
    np.testing.assert_allclose(float(r.u[0]), LOGISTIC_EXACT, atol=1e-3)


def test_dt_capped_by_cfl():
    r = ts_solve(decay_rhs, t([1.0]), ts_type="euler", dt=0.5, max_time=1.0,
                 cfl_fn=lambda t_, u: torch.tensor(0.02, dtype=torch.float64),
                 cfl_safety=0.5, max_steps=1000)
    assert 95 <= int(r.steps) <= 105
    np.testing.assert_allclose(float(r.u[0]), np.exp(-1.0), atol=5e-3)


def test_post_step_sees_every_step_of_one_integration():
    """post_step reads each step's state; chaining one-step integrations
    from the same times gives the same bits."""
    seen = []
    r = ts_solve(logistic, t([0.1]), ts_type="rk", dt=0.1, max_time=0.5,
                 post_step=lambda k, tt, u: seen.append((k, tt, u.clone())))
    assert [k for k, _, _ in seen] == [1, 2, 3, 4, 5]
    u, tt = t([0.1]), 0.0
    for k, tk, uk in seen:
        s = ts_solve(logistic, u, ts_type="rk", t0=tt, dt=0.1, max_time=0.5,
                     max_steps=1)
        u, tt = s.u, float(s.t)
        assert tt == tk and torch.equal(u, uk)
    assert torch.equal(r.u, seen[-1][2])


# ---------------------------------------------------------------------------
# characteristics (tests/test_characteristic.py)
# ---------------------------------------------------------------------------

def test_characteristic_uniform_translation():
    m = n = 65
    xs = np.linspace(0, 1, m)
    X, Y = np.meshgrid(xs, xs, indexing="ij")
    u0 = np.exp(-200 * ((X - 0.3) ** 2 + (Y - 0.5) ** 2))
    vx = torch.full((m, n), 0.5, dtype=torch.float64)
    vy = torch.zeros((m, n), dtype=torch.float64)
    r = ts_characteristic(lambda t_, u: (vx, vy), t(u0), (m, n), dt=0.05,
                          max_time=0.5)
    uT = r.u.numpy()
    exact = np.exp(-200 * ((X - 0.55) ** 2 + (Y - 0.5) ** 2))
    i, j = np.unravel_index(np.argmax(uT), (m, n))
    assert abs(xs[i] - 0.55) < 0.03 and abs(xs[j] - 0.5) < 0.03
    assert np.abs(uT - exact).max() < 0.4
    assert uT.max() > 0.5


def test_characteristic_rotation_returns():
    m = n = 65
    xs = np.linspace(0, 1, m)
    X, Y = np.meshgrid(xs, xs, indexing="ij")
    u0 = np.exp(-100 * ((X - 0.7) ** 2 + (Y - 0.5) ** 2))
    om = 2 * np.pi
    VX, VY = t(-om * (Y - 0.5)), t(om * (X - 0.5))
    r = ts_characteristic(lambda t_, u: (VX, VY), t(u0), (m, n), dt=0.005,
                          max_time=1.0)
    i, j = np.unravel_index(np.argmax(r.u.numpy()), (m, n))
    assert abs(xs[i] - 0.7) < 0.05 and abs(xs[j] - 0.5) < 0.05


def test_characteristic_unconditionally_stable_large_dt():
    m = n = 33
    u0 = np.zeros((m, n))
    u0[16, 16] = 1.0
    vx = torch.full((m, n), 10.0, dtype=torch.float64)
    vy = torch.zeros((m, n), dtype=torch.float64)
    r = ts_characteristic(lambda t_, u: (vx, vy), t(u0), (m, n), dt=0.1,
                          max_time=0.5)
    assert torch.isfinite(r.u).all() and float(r.u.max()) <= 1.0 + 1e-12


# ---------------------------------------------------------------------------
# against petsctpu on the same inputs
# ---------------------------------------------------------------------------

def _family_cases():
    """(label, stepper, rhs kind, kwargs, implicit)."""
    return [
        ("euler", "solve", dict(ts_type="euler", dt=0.1, max_time=1.0), 0),
        ("ssp rk3so", "solve", dict(ts_type="ssp", dt=0.1, max_time=1.0), 0),
        ("ssp rks2", "solve", dict(ts_type="ssp", ssp_type="rks2",
                                   dt=0.1, max_time=1.0), 0),
        ("ssp rks3", "solve", dict(ts_type="ssp", ssp_type="rks3",
                                   ssp_nstages=9, dt=0.1, max_time=1.0), 0),
        ("ssp rk104", "solve", dict(ts_type="ssp", ssp_type="rk104",
                                    dt=0.1, max_time=1.0), 0),
        ("rk bs23 adapt", "solve", dict(ts_type="rk", dt=0.3, max_time=2.0,
                                        adapt=True, adapt_rtol=1e-6,
                                        adapt_atol=1e-8), 0),
        ("rk dp45 adapt", "solve", dict(ts_type="rk", rk_type="dp45",
                                        dt=0.5, max_time=2.0, adapt=True,
                                        adapt_rtol=1e-9,
                                        adapt_atol=1e-11), 0),
        ("beuler", "solve", dict(ts_type="beuler", dt=0.1, max_time=0.5), 1),
        ("cn", "solve", dict(ts_type="cn", dt=0.1, max_time=0.5), 1),
        ("theta 0.6 stage", "solve", dict(ts_type="theta", theta=0.6,
                                          dt=0.1, max_time=0.5), 1),
        ("alpha", "alpha", dict(dt=0.1, max_time=0.5), 1),
        ("pseudo", "pseudo", dict(dt=0.1, max_steps=8), 1),
    ]


FAMILY_U0 = np.array([0.1, 0.3, 0.7, 1.2])


def jax_family(kind, kw):
    """petsctpu's result of one _family_cases entry."""
    import jax
    import jax.numpy as jnp

    from petsctpu.ts import ts_alpha as j_alpha
    from petsctpu.ts import ts_pseudo as j_pseudo
    from petsctpu.ts import ts_solve as j_solve

    jax.config.update("jax_enable_x64", True)

    def jrhs(t_, u):
        return u * (1.0 - u) + 0.1 * jnp.sin(t_)

    fn = {"solve": j_solve, "alpha": j_alpha, "pseudo": j_pseudo}[kind]
    r = fn(jrhs, jnp.asarray(FAMILY_U0), **kw)
    return (np.asarray(r.u), float(r.t), int(r.steps),
            None if r.fnorm_history is None
            else np.asarray(r.fnorm_history))


@pytest.mark.parametrize("case", _family_cases(), ids=lambda c: c[0])
def test_stepper_family_matches_petsctpu(case):
    label, kind, kw, implicit = case

    def rhs(t_, u):
        return u * (1.0 - u) + 0.1 * float(np.sin(t_))

    fn = {"solve": ts_solve, "alpha": ts_alpha, "pseudo": ts_pseudo}[kind]
    r = fn(rhs, t(FAMILY_U0), **kw)
    ju, jt, js, jfh = jax_family(kind, kw)
    assert int(r.steps) == js and float(r.t) == jt, (int(r.steps), js)
    assert rel(r.u.numpy(), ju) <= (1e-11 if implicit else 1e-13), \
        rel(r.u.numpy(), ju)
    if jfh is not None:
        np.testing.assert_allclose(r.fnorm_history.numpy(), jfh,
                                   rtol=1e-10, atol=1e-14)


def test_ifunc_form_matches_petsctpu():
    """ex17's DAE at Mx = 40, three BE steps through the ifunc form with
    the AD Jacobian: states within 1e-11 relative."""
    import jax
    import jax.numpy as jnp

    from petsctpu.ts import ts_solve as j_solve

    jax.config.update("jax_enable_x64", True)
    Mx = 40
    sx = 1.0 / (1.0 / (Mx - 1)) ** 2

    def jifunc(t_, u, udot):
        lap = (2 * u - jnp.roll(u, 1) - jnp.roll(u, -1)) * sx
        return (udot + lap).at[0].set(u[0]).at[Mx - 1].set(u[Mx - 1])

    u0 = heat1d_initial(Mx, device="cpu")
    jr = j_solve(None, jnp.asarray(u0.numpy()), ifunc=jifunc,
                 ts_type="beuler", dt=0.01, max_steps=3, max_time=1.0)
    r = ts_solve(None, u0, ifunc=heat1d_ifunc(Mx), ts_type="beuler",
                 dt=0.01, max_steps=3, max_time=1.0)
    assert int(r.steps) == int(jr.steps) == 3
    assert rel(r.u.numpy(), np.asarray(jr.u)) < 1e-11


def test_ex15_colored_jacobian_matches_petsctpu():
    """ex15 (Dirichlet) at M = 20: three BE steps with the stencil-colored
    Jacobian on the 5-point template (petsctpu's bratu_jacobian_template,
    the port's heat2d_jacobian_template: the same pattern) and a Jacobi
    PC, in the port and in petsctpu: the ifuncs agree bit for bit, the
    states within 1e-11 relative."""
    import sys

    import jax
    import jax.numpy as jnp

    from petsctpu.dm import DA as JDA
    from petsctpu.models.bratu import bratu_jacobian_template as j_template
    from petsctpu.pc.simple import JacobiPC as JJacobi
    from petsctpu.snes import ColoredJacobian as JColored
    from petsctpu.ts import ts_solve as j_solve

    jax.config.update("jax_enable_x64", True)
    sys.path.insert(0, __file__.rsplit("/", 1)[0])
    from test_ts import TestEx15Heat2D

    M = 20
    ref = TestEx15Heat2D()
    jifunc = ref._ifunc(0)
    u0 = ref._u0()
    assert np.array_equal(u0, heat2d_initial(M, device="cpu").numpy())
    rng = np.random.default_rng(0)
    a, b = rng.standard_normal((2, M * M))
    assert np.array_equal(np.asarray(jifunc(0.0, jnp.asarray(a),
                                            jnp.asarray(b))),
                          heat2d_ifunc(M, 0)(0.0, t(a), t(b)).numpy())
    jr = j_solve(None, jnp.asarray(u0), ifunc=jifunc, ts_type="beuler",
                 dt=0.01, max_steps=3, max_time=1.0,
                 jac=JColored.from_stencil(j_template(JDA((M, M)))),
                 pc_builder=lambda J: JJacobi(1.0 / J.diagonal()))
    r = ts_solve(None, t(u0), ifunc=heat2d_ifunc(M, 0), ts_type="beuler",
                 dt=0.01, max_steps=3, max_time=1.0,
                 jac=ColoredJacobian.from_stencil(heat2d_jacobian_template(
                     M, 0, device="cpu")),
                 pc_builder=lambda J: JacobiPC(1.0 / J.diagonal()))
    assert int(r.steps) == int(jr.steps) == 3
    assert rel(r.u.numpy(), np.asarray(jr.u)) < 1e-11


def test_characteristic_step_matches_petsctpu():
    """Both modes within 1e-15 relative of petsctpu's map_coordinates;
    the periodic field is one where scipy's 'wrap' differs from JAX's
    (and the port's) rule by more than 1e-3."""
    import jax
    import jax.numpy as jnp
    from scipy import ndimage

    from petsctpu.ts import characteristic_step as j_step

    jax.config.update("jax_enable_x64", True)
    rng = np.random.default_rng(5)
    m, n = 17, 23
    u = rng.standard_normal((m, n))
    vx = 3.0 * rng.standard_normal((m, n))
    vy = 3.0 * rng.standard_normal((m, n))
    hx, hy = 1.0 / (m - 1), 1.0 / (n - 1)
    for bc in ("clamp", "periodic"):
        jr = np.asarray(j_step(jnp.asarray(u), jnp.asarray(vx),
                               jnp.asarray(vy), 0.05, hx, hy, bc))
        tr = characteristic_step(t(u), t(vx), t(vy), 0.05, hx, hy, bc)
        assert rel(tr.numpy(), jr) <= 1e-15, (bc, rel(tr.numpy(), jr))
    ii = np.arange(m)[:, None] - 0.05 * vx / hx
    jj = np.arange(n)[None, :] - 0.05 * vy / hy
    scipy_wrap = ndimage.map_coordinates(u, [ii, jj], order=1, mode="wrap")
    assert np.abs(scipy_wrap - tr.numpy()).max() > 1e-3
