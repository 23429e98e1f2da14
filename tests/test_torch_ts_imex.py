"""ARKIMEX and Rosenbrock-W through the port (petsctpu_torch.ts.imex), on
the CPU in fp64.

Held against petsctpu:
  * every registered tableau array (13 ARKIMEX, 16 RosW and the ros2
    alias, and register_ros4 on a new γ) byte for byte;
  * one ARKIMEX (tableau 3, with the basic adaptor) and one RosW
    (ra34pw2, the reaction-only Jacobian of ts ex22) integration on the
    same inputs: equal step counts and final times, states within 1e-11
    relative (the inner Newton/GMRES solves sum in another order).
Held to the oracle: ts ex22_3 (RosW ra34pw2, dt 5e-3: "CONVERGED_TIME
at time 1 after 200 steps" and the final 2-norm within 1e-9, the
reference test's bound). And the port's own order, stability and
adaptivity checks of tests/test_ts_imex.py.
"""

import numpy as np
import pytest
import torch

from petsctpu_torch.ksp.common import KSPConfig
from petsctpu_torch.models.adr1d import (adr_initial, adr_rhs_advection,
                                         adr_rhs_reaction, ts_reason_string)
from petsctpu_torch.snes.api import SNESConfig
from petsctpu_torch.ts import imex
from petsctpu_torch.ts.imex import (arkimex_tableaus, register_ros4,
                                    rosw_tableaus, ts_arkimex, ts_rosw)
from petsctpu_torch.ts.steppers import TSConfig

# one intra-op thread: the suite runs in parallel workers (pytest -n), and
# PyTorch's default of a thread a core oversubscribes the host's cores
torch.set_num_threads(1)

TIGHT_SNES = SNESConfig(rtol=1e-12, atol=1e-14, maxits=30)
TIGHT_KSP = KSPConfig(ksp_type="gmres", rtol=1e-13, maxits=60)
LOGISTIC_EXACT = 0.1 * np.exp(2.0) / (1 - 0.1 + 0.1 * np.exp(2.0))


def t(a):
    return torch.from_numpy(np.asarray(a, np.float64))


def rel(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return np.abs(a - b).max() / max(np.abs(b).max(), 1e-300)


def logistic(t_, u):
    return u * (1.0 - u)


def same_entry(a, b):
    if a is None or b is None:
        return a is None and b is None
    if isinstance(a, np.ndarray):
        return (a.dtype == b.dtype and a.shape == b.shape
                and a.tobytes() == b.tobytes())
    return type(a) is type(b) and a == b


ARK = sorted(["1bee", "ars122", "a2", "l2", "2c", "2d", "2e", "prssp2",
              "3", "ars443", "bpr3", "4", "5"])
ROSW = sorted(["theta1", "theta2", "2m", "2p", "ra3pw", "ra34pw2", "rodas3",
               "sandu3", "assp3p3s1c", "lassp3p4s2c", "llssp3p4s2c", "ark3",
               "grk4t", "shamp4", "veldd4", "4l"])


def test_registries_complete():
    assert arkimex_tableaus() == ARK
    assert rosw_tableaus() == ROSW


@pytest.mark.parametrize("name", ARK)
def test_arkimex_tableau_byte_equal(name):
    from petsctpu.ts import imex as jimex

    ref, got = jimex._ARK_TABLEAUS[name], imex._ARK_TABLEAUS[name]
    assert ref.keys() == got.keys()
    for k in ref:
        assert same_entry(ref[k], got[k]), (name, k)


@pytest.mark.parametrize("name", ROSW + ["ros2"])
def test_rosw_tableau_byte_equal(name):
    from petsctpu.ts import imex as jimex

    ref, got = jimex._ROSW_TABLEAUS[name], imex._ROSW_TABLEAUS[name]
    assert ref.keys() == got.keys()
    for k in ref:
        assert same_entry(ref[k], got[k]), (name, k)


def test_register_ros4_byte_equal_and_order_conditions():
    """register_ros4 on a γ of neither registry: the reference's
    order-condition solve, byte for byte; 4 stages, γ on the diagonal."""
    from petsctpu.ts import imex as jimex

    ref = jimex.register_ros4("tmp_ros4_port", 0.395)
    got = register_ros4("tmp_ros4_port", 0.395)
    try:
        for k in ref:
            assert same_entry(ref[k], got[k]), k
        assert got["s"] == 4 and np.allclose(np.diag(got["Gamma"]), 0.395)
        assert abs(got["b"].sum() - 1.0) < 1e-12
    finally:
        jimex._ROSW_TABLEAUS.pop("tmp_ros4_port")
        imex._ROSW_TABLEAUS.pop("tmp_ros4_port")


def split_parts():
    """u' = sin(t) (explicit) + (−u) (implicit)."""
    def fe(t_, u):
        return torch.full_like(u, float(np.sin(t_)))

    def fi(t_, u):
        return -u

    def exact(tt):
        return 0.5 * (np.exp(-tt) + np.sin(tt) - np.cos(tt)) + np.exp(-tt)

    return fe, fi, exact


def test_arkimex_stiff_stability_and_accuracy():
    for tab in ("ars122", "l2", "2e", "3"):
        r = ts_arkimex(lambda t_, u: -u, lambda t_, u: -500.0 * u, t([1.0]),
                       tableau=tab, dt=0.01, max_time=0.1)
        got = float(r.u[0])
        assert np.isfinite(got) and abs(got - np.exp(-501 * 0.1)) < 5e-3, tab


@pytest.mark.parametrize("tab,order", [
    ("ars122", 2), ("l2", 2), ("2c", 2), ("2d", 2), ("2e", 2),
    ("prssp2", 2), ("3", 3), ("ars443", 3), ("4", 4), ("5", 4),
])
def test_arkimex_design_order(tab, order):
    fe, fi, exact = split_parts()
    errs = []
    for dt in (0.1, 0.05):
        r = ts_arkimex(fe, fi, t([1.0]), tableau=tab, dt=dt, max_time=1.0,
                       snes=TIGHT_SNES, ksp=TIGHT_KSP)
        errs.append(abs(float(r.u[0]) - exact(1.0)))
    observed = np.log2(errs[0] / max(errs[1], 1e-16))
    assert observed > order - 0.35, (tab, observed, errs)


def test_arkimex_bootstrap_tableaus_stable():
    for tab in ("1bee", "bpr3"):
        r = ts_arkimex(lambda t_, u: -u, lambda t_, u: -500.0 * u, t([1.0]),
                       tableau=tab, dt=0.02, max_time=0.2)
        assert np.isfinite(float(r.u[0])) and abs(float(r.u[0])) < 1e-3, tab


def test_arkimex_adaptive_embedded():
    fe, fi, exact = split_parts()
    r = ts_arkimex(fe, fi, t([1.0]), tableau="3", dt=0.2, max_time=1.0,
                   adapt=True, adapt_rtol=1e-6, adapt_atol=1e-8,
                   snes=TIGHT_SNES, ksp=TIGHT_KSP)
    assert abs(float(r.u[0]) - exact(1.0)) < 1e-5


def test_unknown_tableaus_raise():
    with pytest.raises(ValueError, match="unknown arkimex"):
        ts_arkimex(lambda t_, u: u, lambda t_, u: u, t([1.0]), tableau="nope")
    with pytest.raises(ValueError, match="unknown rosw"):
        ts_rosw(lambda t_, u: u, t([1.0]), tableau="nope")


def test_rosw_stiff_decay():
    for tab in ("2p", "rodas3", "ra3pw", "grk4t"):
        r = ts_rosw(lambda t_, u: -1000.0 * u, t([1.0]), dt=0.01,
                    max_time=0.1, tableau=tab,
                    ksp=KSPConfig(ksp_type="gmres", rtol=1e-10, maxits=50))
        assert np.isfinite(float(r.u[0])) and abs(float(r.u[0])) < 1e-2, tab


@pytest.mark.parametrize("tab,order", [
    ("theta1", 1), ("theta2", 2), ("2m", 2), ("2p", 2),
    ("ra3pw", 3), ("ra34pw2", 3), ("sandu3", 3), ("ark3", 3),
    ("assp3p3s1c", 3), ("lassp3p4s2c", 3), ("llssp3p4s2c", 3),
    ("rodas3", 2.5), ("grk4t", 4), ("shamp4", 4), ("veldd4", 4),
    ("4l", 4),
])
def test_rosw_design_order(tab, order):
    errs = []
    for dt in (0.2, 0.1):
        r = ts_rosw(logistic, t([0.1]), dt=dt, max_time=2.0, tableau=tab,
                    ksp=TIGHT_KSP)
        errs.append(abs(float(r.u[0]) - LOGISTIC_EXACT))
    observed = np.log2(errs[0] / max(errs[1], 1e-17))
    assert observed > order - 0.5, (tab, observed, errs)


def test_rosw_adaptive_embedded():
    """ra3pw's embedded row and the basic adaptor reach the horizon from
    dt = 0.5 within 1e-3 of the exact value (tests/test_ts_imex.py's
    check, at adaptor tolerances 1e-4/1e-6 in place of its 1e-5/1e-7:
    686 steps instead of 2,113 of eager stage solves)."""
    def rhs(t_, u):
        return -u + float(np.sin(10.0 * t_))

    r = ts_rosw(rhs, t([1.0]), dt=0.5, max_time=2.0, tableau="ra3pw",
                adapt=True, adapt_rtol=1e-4, adapt_atol=1e-6,
                max_steps=20000, ksp=TIGHT_KSP)
    exact = (np.exp(-2.0) * (1 + 10.0 / 101.0)
             + (np.sin(20.0) - 10 * np.cos(20.0)) / 101.0)
    assert float(r.t) > 2.0 - 1e-10
    assert abs(float(r.u[0]) - exact) < 1e-3


def test_rosw_explicit_first_stage_tableau():
    r = ts_rosw(lambda t_, u: -4.0 * u, t([1.0]), dt=0.05, max_time=1.0,
                tableau="assp3p3s1c", ksp=TIGHT_KSP)
    assert abs(float(r.u[0]) - np.exp(-4.0)) < 2e-4


def ex22_parts(mx=200):
    return (adr_initial(mx, device="cpu"), adr_rhs_advection(mx),
            adr_rhs_reaction(mx))


def test_ex22_3_rosw_ra34pw2_golden():
    """ex22_3.out: -ts_type rosw (ra34pw2) -ts_dt 5e-3 on the 1-D
    advection-reaction system (mx = 200) with the reaction-only
    Jacobian, STEPOVER: the reason line, and the oracle's final 2-norm
    2.146401500573015e+01 within 1e-9."""
    u0, fexp, fimp = ex22_parts()

    def rhs(t_, x):
        return fexp(t_, x) + fimp(t_, x)

    cfg = TSConfig(dt=5e-3, max_steps=10000, max_time=1.0, clamp_final=False)
    r = ts_rosw(rhs, u0, cfg, tableau="ra34pw2", jac_fn=fimp)
    line = "%s at time %g after %d steps" % (
        ts_reason_string(int(r.steps), float(r.t), 10000, 1.0),
        float(r.t), int(r.steps))
    assert line == "CONVERGED_TIME at time 1 after 200 steps"
    assert abs(float(torch.linalg.norm(r.u)) - 2.146401500573015e+01) < 1e-9


@pytest.fixture(scope="module")
def jax_imex():
    """petsctpu's ARKIMEX 3 (adaptive) and RosW ra34pw2 (ex22's reaction
    Jacobian, 20 steps) results, each integrated once."""
    import jax
    import jax.numpy as jnp

    from petsctpu.models.adr1d import (adr_initial as j_init,
                                       adr_rhs_advection as j_adv,
                                       adr_rhs_reaction as j_rea)
    from petsctpu.ts import ts_arkimex as j_ark
    from petsctpu.ts import ts_rosw as j_rosw

    jax.config.update("jax_enable_x64", True)
    ark = j_ark(lambda t_, u: jnp.full_like(u, jnp.sin(t_)),
                lambda t_, u: -u * (1.0 + u * u), jnp.asarray([1.0, 0.5]),
                tableau="3", dt=0.2, max_time=1.0, adapt=True,
                adapt_rtol=1e-6, adapt_atol=1e-8, snes=TIGHT_SNES,
                ksp=TIGHT_KSP)
    fexp, fimp = j_adv(40), j_rea(40)
    ros = j_rosw(lambda t_, x: fexp(t_, x) + fimp(t_, x), j_init(40),
                 TSConfig(dt=5e-3, max_steps=20, max_time=1.0,
                          clamp_final=False), tableau="ra34pw2",
                 jac_fn=fimp)
    return {k: (np.asarray(r.u), float(r.t), int(r.steps))
            for k, r in (("ark", ark), ("rosw", ros))}


def test_arkimex_matches_petsctpu(jax_imex):
    r = ts_arkimex(lambda t_, u: torch.full_like(u, float(np.sin(t_))),
                   lambda t_, u: -u * (1.0 + u * u), t([1.0, 0.5]),
                   tableau="3", dt=0.2, max_time=1.0, adapt=True,
                   adapt_rtol=1e-6, adapt_atol=1e-8, snes=TIGHT_SNES,
                   ksp=TIGHT_KSP)
    ju, jt, js = jax_imex["ark"]
    assert int(r.steps) == js and float(r.t) == jt
    assert rel(r.u.numpy(), ju) < 1e-11


def test_rosw_matches_petsctpu(jax_imex):
    u0, fexp, fimp = ex22_parts(40)
    r = ts_rosw(lambda t_, x: fexp(t_, x) + fimp(t_, x), u0,
                TSConfig(dt=5e-3, max_steps=20, max_time=1.0,
                         clamp_final=False), tableau="ra34pw2", jac_fn=fimp)
    ju, jt, js = jax_imex["rosw"]
    assert int(r.steps) == js == 20 and float(r.t) == jt
    assert rel(r.u.numpy(), ju) < 1e-11
