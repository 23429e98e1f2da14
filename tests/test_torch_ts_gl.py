"""TSGL through the port (petsctpu_torch.ts.gl), on the CPU in fp64.

Held against petsctpu:
  * GL_SCHEMES (p = 1..5) and gl_error_coeffs byte for byte;
  * the exact starting vector's ODE derivatives to order 5 by nested
    torch.func.jvp, against the same recursion by nested jax.jvp, within
    1e-12 relative;
  * ts_gl at p = 3 on the same inputs: equal step counts and final
    times, states within 1e-11 relative.
Held to the oracle: the adaptive run of ts ex4 under -ts_type gl
(tests/data/oracle_sweep/tsgl_ex4_adapt.txt) at tests/test_ts_gladapt.py's
own tolerances, and the -ts_view leading error constants. And the
port's own order and stability checks of tests/test_ts_gl.py.
"""

import os
import re

import numpy as np
import pytest
import scipy.sparse as sp
import torch

from petsctpu_torch.ksp.common import KSPConfig
from petsctpu_torch.snes.api import SNESConfig
from petsctpu_torch.ts import ts_gl
from petsctpu_torch.ts.gl import (GL_SCHEMES, gl_error_coeffs, ode_derivs,
                                  ts_gl_adaptive)
from petsctpu_torch.ts.steppers import TSConfig

# one intra-op thread: the suite runs in parallel workers (pytest -n), and
# PyTorch's default of a thread a core oversubscribes the host's cores
torch.set_num_threads(1)

HERE = os.path.join(os.path.dirname(__file__), "data", "oracle_sweep")
LOGISTIC_EXACT = 0.1 * np.exp(2.0) / (1 - 0.1 + 0.1 * np.exp(2.0))


def t(a):
    return torch.from_numpy(np.asarray(a, np.float64))


def rel(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return np.abs(a - b).max() / max(np.abs(b).max(), 1e-300)


def logistic(t_, u):
    return u * (1.0 - u)


@pytest.mark.parametrize("p", [1, 2, 3, 4, 5])
def test_schemes_and_error_coeffs_byte_equal(p):
    from petsctpu.ts import gl as jgl

    ref, got = jgl.GL_SCHEMES[p], GL_SCHEMES[p]
    assert ref.keys() == got.keys()
    for k in ref:
        assert ref[k].tobytes() == got[k].tobytes(), (p, k)
    ref, got = jgl.gl_error_coeffs(p), gl_error_coeffs(p)
    assert ref.keys() == got.keys()
    for k in ref:
        a, b = np.asarray(ref[k]), np.asarray(got[k])
        assert a.dtype == b.dtype and a.tobytes() == b.tobytes(), (p, k)


def test_error_constants_match_reference():
    """-ts_view "Leading error constants" (TSGLSchemeView gl.c:393)."""
    ref = {1: (-1.000e-02, -1.483e-02, -3.450e-02),
           2: (4.801e-03, -2.206e-02, 5.641e-02),
           3: (5.421e-04, -2.296e-02, 2.469e-02),
           4: (2.078e-04, -1.279e-01, 1.278e-01),
           5: (-1.715e-05, 3.771e+00, -3.771e+00)}
    for p, (a, b, g) in ref.items():
        e = gl_error_coeffs(p)
        np.testing.assert_allclose(
            [e["alpha"][0], e["beta"][0], e["gamma"][0]], [a, b, g],
            rtol=1e-3)


def test_ode_derivs_to_order_5_match_jax():
    """u', ..., u⁽⁵⁾ of a nonautonomous nonlinear system by nested
    torch.func.jvp against petsctpu's recursion (gl.py's _ode_derivs:
    d_t g = g_t + g_u·f by nested jax.jvp) on the same (t, u)."""
    import jax
    import jax.numpy as jnp

    jax.config.update("jax_enable_x64", True)

    def jrhs(tt, u):
        return u * (1.0 - u) + jnp.sin(tt) * u[::-1]

    def trhs(tt, u):
        return u * (1.0 - u) + torch.sin(tt) * u.flip(0)

    u0 = np.array([0.1, 0.4, -0.3])
    gs = [jrhs]
    for _ in range(4):
        gprev = gs[-1]

        def gnext(tt, uu, gprev=gprev):
            return jax.jvp(gprev, (tt, uu),
                           (jnp.ones_like(tt), jrhs(tt, uu)))[1]

        gs.append(gnext)
    tj = jnp.asarray(0.3)
    ref = [np.asarray(g(tj, jnp.asarray(u0))) for g in gs]
    got = ode_derivs(trhs, torch.tensor(0.3, dtype=torch.float64), t(u0), 5)
    assert len(got) == 5
    for k, (a, b) in enumerate(zip(got, ref)):
        assert rel(a.numpy(), b) < 1e-12, (k + 1, rel(a.numpy(), b))


def test_ts_gl_p3_matches_petsctpu():
    import jax
    import jax.numpy as jnp

    from petsctpu.ts import ts_gl as j_gl

    jax.config.update("jax_enable_x64", True)
    u0 = np.array([0.1, 0.3])
    jr = j_gl(lambda t_, u: u * (1.0 - u), jnp.asarray(u0), order=3,
              dt=0.1, max_time=0.45)
    r = ts_gl(logistic, t(u0), order=3, dt=0.1, max_time=0.45)
    assert int(r.steps) == int(jr.steps) == 5
    assert float(r.t) == float(jr.t)
    assert rel(r.u.numpy(), np.asarray(jr.u)) < 1e-11


@pytest.mark.parametrize("order,dts,check", [
    (1, (0.1, 0.05), "converges"), (2, (0.1, 0.05), "ratio3")],
    ids=["order1", "order2"])
def test_low_order_convergence(order, dts, check):
    errs = []
    for dt in dts:
        r = ts_gl(lambda t_, u: -u, t([1.0]), order=order, dt=dt,
                  max_time=1.0)
        errs.append(abs(float(r.u[0]) - np.exp(-1.0)))
    if check == "converges":
        assert errs[1] < errs[0] and errs[1] < 2e-4
    else:
        assert errs[0] / errs[1] > 3.0 or max(errs) < 1e-5


def test_L_stable_stiff():
    r = ts_gl(lambda t_, u: -1000.0 * u, t([1.0]), order=2, dt=0.1,
              max_time=1.0)
    assert abs(float(r.u[0])) < 1e-10


def test_nonlinear_system():
    r = ts_gl(logistic, t([0.1]), order=2, dt=0.05, max_time=2.0)
    np.testing.assert_allclose(float(r.u[0]), LOGISTIC_EXACT, atol=2e-4)


@pytest.mark.parametrize("order", [3, 4, 5])
def test_high_order_schemes(order):
    """Orders 3-5: observed convergence order on the logistic equation
    above the design order − 0.5 (exact AD Nordsieck start)."""
    snes = SNESConfig(rtol=1e-13, atol=1e-15, maxits=40)
    ksp = KSPConfig(ksp_type="gmres", rtol=1e-14, maxits=80)
    errs = []
    for dt in (0.2, 0.1):
        r = ts_gl(logistic, t([0.1]), order=order, dt=dt, max_time=2.0,
                  snes=snes, ksp=ksp)
        errs.append(abs(float(r.u[0]) - LOGISTIC_EXACT))
    observed = np.log2(errs[0] / max(errs[1], 1e-17))
    assert observed > order - 0.5, (order, observed, errs)


@pytest.mark.parametrize("order,tol", [(3, 1e-8), (4, 1e-7), (5, 1e-4)])
def test_high_order_stiff_stability(order, tol):
    r = ts_gl(lambda t_, u: -1000.0 * u, t([1.0]), order=order, dt=0.1,
              max_time=1.0)
    assert abs(float(r.u[0])) < tol, order


def test_adaptive_order_and_step_sequence():
    """ts ex4 (1-D heat, m=20) under -ts_type gl: the order sequence of
    the oracle's "Adapt chose scheme" lines, the executed step sizes
    within 1e-4 for seven steps and 1e-2 after, the final time within
    1e-3 (tests/test_ts_gladapt.py's bounds)."""
    txt = open(os.path.join(HERE, "tsgl_ex4_adapt.txt")).read()
    chose = [(int(m.group(1)), float(m.group(2))) for m in re.finditer(
        r"Adapt chose scheme \d+ \((\d+),\d+,\d+,\d+\) with step "
        r"size (\S+),", txt)]
    mon = [(float(m.group(2)), float(m.group(3))) for m in re.finditer(
        r"(\d+) TS dt (\S+) time (\S+)", txt)]
    m = 20
    h = 1.0 / (m - 1)
    x = np.arange(m) * h
    u0 = np.sin(6 * np.pi * x) + 3.0 * np.sin(2 * np.pi * x)
    s1 = 1.0 / h ** 2
    A = sp.diags([s1 * np.ones(m - 1), -2 * s1 * np.ones(m),
                  s1 * np.ones(m - 1)], [-1, 0, 1]).tolil()
    A[0, :] = 0.0
    A[0, 0] = 1.0
    A[m - 1, :] = 0.0
    A[m - 1, m - 1] = 1.0
    Ad = t(sp.csr_matrix(A).toarray())
    res, rec = ts_gl_adaptive(
        lambda t_, u: Ad @ u, t(u0), linear_A=sp.csr_matrix(A),
        cfg=TSConfig(dt=h * h / 2.0, max_steps=12, max_time=1.0))
    orders = [p for (_, _, p) in rec]
    assert orders == [1] + [p for (p, _) in chose][:len(orders) - 1]
    ref_h = [dt for (dt, _) in mon][1:]
    ours_h = [hh for (_, hh, _) in rec]
    np.testing.assert_allclose(ours_h[:7], ref_h[:7], rtol=1e-4)
    np.testing.assert_allclose(ours_h, ref_h[:len(ours_h)], rtol=1e-2)
    np.testing.assert_allclose(float(res.t), mon[len(ours_h)][1], rtol=1e-3)


def test_adaptive_nonlinear_path_matches_petsctpu():
    """ts_gl_adaptive's Newton route (no linear_A) on the logistic system:
    the same (t, h, order) record and the final state within 1e-10."""
    import jax
    import jax.numpy as jnp

    from petsctpu.ts.gl import ts_gl_adaptive as j_adapt

    jax.config.update("jax_enable_x64", True)
    u0 = np.array([0.1, 0.3])
    cfg = TSConfig(dt=0.05, max_steps=6, max_time=1.0)
    jres, jrec = j_adapt(lambda t_, u: u * (1.0 - u), jnp.asarray(u0),
                         cfg=cfg)
    res, rec = ts_gl_adaptive(logistic, t(u0), cfg=cfg)
    assert [p for *_, p in rec] == [p for *_, p in jrec]
    np.testing.assert_allclose(np.array(rec)[:, :2], np.array(jrec)[:, :2],
                               rtol=1e-10)
    assert int(res.steps) == int(jres.steps)
    assert rel(res.u.numpy(), np.asarray(jres.u)) < 1e-10
