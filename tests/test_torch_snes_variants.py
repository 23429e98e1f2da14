"""The SNES variants and the nonlinear models through the port, held
against petsctpu on the same numpy inputs (CPU, fp64).

Each solver case runs the reference's function and the port's from one
initial guess and requires the same iteration count and reason, the
function-norm histories within `htol` relative on their entries above
1e-8 of the first (entries at the quadratic limit sit at rounding noise;
the inner solves sum in another order, ~1e-15 a step, and the
histories below carry that a few steps on), and the solutions within
`xtol` relative. Models are held within 1e-13 relative (their exp,
pow and the AIJ product round apart by an ulp at most); the drand48
stream and the pointwise Gauss-Seidel sweeps (both are host loops of
the same scalar arithmetic) within 1e-12.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse as sp
import torch

from petsctpu.dm import DA as JDA
from petsctpu.models import bratu as jb

from petsctpu_torch.dm import DA
from petsctpu_torch.ksp.common import KSPConfig
from petsctpu_torch.mat import aij_from_scipy
from petsctpu_torch.models import bratu as tb

# one intra-op thread: the suite runs in parallel workers (pytest -n), and
# PyTorch's default of a thread a core oversubscribes the host's cores
torch.set_num_threads(1)


def t(a):
    return torch.from_numpy(np.array(a, np.float64))


def rel(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return np.abs(a - b).max() / max(np.abs(b).max(), 1e-300)


def same(r, p, htol=1e-9, xtol=1e-8):
    """Equal its and reason, histories and solutions close."""
    assert int(p.its) == int(r.its), (int(p.its), int(r.its))
    assert int(p.reason) == int(r.reason), (int(p.reason), int(r.reason))
    k = int(r.its)
    hr = np.asarray(r.history[:k + 1])
    hp = p.history[:k + 1].numpy()
    big = hr > 1e-8 * hr[0]
    assert rel(hp[big], hr[big]) < htol
    assert rel(p.x.numpy(), np.asarray(r.x)) < xtol


def bratu(m, lam=6.0):
    jda, tda = JDA((m, m)), DA((m, m))
    x0 = np.asarray(jb.bratu_initial_guess(jda, lam))
    return (jb.bratu_residual(jda, lam), tb.bratu_residual(tda, lam), x0,
            jda, tda)


# ------------------------------------------------------- trust regions

def test_newtontr_steihaug_on_bratu_and_a_hard_start():
    from petsctpu.snes.variants import snes_newtontr as jtr
    from petsctpu_torch.snes.variants import snes_newtontr
    jF, tF, x0, _, _ = bratu(9, 5.0)
    same(jtr(jF, jnp.asarray(x0), rtol=1e-9, maxits=60, delta0=1.0),
         snes_newtontr(tF, t(x0), rtol=1e-9, maxits=60, delta0=1.0))
    same(jtr(jnp.arctan, jnp.asarray([10.0]), rtol=1e-10, maxits=80),
         snes_newtontr(torch.atan, t([10.0]), rtol=1e-10, maxits=80))


def test_tr_on_bratu_with_a_small_radius():
    from petsctpu.ksp.common import KSPConfig as JK
    from petsctpu.snes.variants import snes_tr as jtr
    from petsctpu_torch.snes.variants import snes_tr
    jF, tF, x0, _, _ = bratu(9)
    kw = dict(delta0=0.05, rtol=1e-10, maxits=40)
    same(jtr(jF, jnp.asarray(x0), jac="jvp",
             ksp_cfg=JK(ksp_type="gmres", rtol=1e-10, maxits=200), **kw),
         snes_tr(tF, t(x0), jac="jvp",
                 ksp_cfg=KSPConfig(ksp_type="gmres", rtol=1e-10,
                                   maxits=200), **kw))


# ------------------------------------------- quasi-Newton and friends

def test_anderson_on_a_linear_fixed_point_and_bratu():
    from petsctpu.snes.variants import snes_anderson as jand
    from petsctpu_torch.snes.variants import snes_anderson
    rng = np.random.default_rng(1)
    M = rng.standard_normal((12, 12))
    M = 0.3 * M / np.abs(np.linalg.eigvals(M)).max()
    b = rng.standard_normal(12)
    r = jand(lambda x: x - (jnp.asarray(M) @ x + jnp.asarray(b)),
             jnp.zeros(12), rtol=1e-10, maxits=100)
    p = snes_anderson(lambda x: x - (t(M) @ x + t(b)), torch.zeros(
        12, dtype=torch.float64), rtol=1e-10, maxits=100)
    same(r, p, htol=1e-8)
    jF, tF, x0, _, _ = bratu(9, 2.0)
    same(jand(jF, jnp.asarray(x0), beta=0.05, maxits=15, rtol=1e-12),
         snes_anderson(tF, t(x0), beta=0.05, maxits=15, rtol=1e-12),
         htol=1e-8, xtol=1e-8)


@pytest.mark.parametrize("restart", ["powell", "none"])
def test_qn_lbfgs_on_bratu(restart):
    from petsctpu.snes.variants import snes_qn as jqn
    from petsctpu_torch.snes.variants import snes_qn
    jF, tF, x0, _, _ = bratu(11)
    kw = dict(history_len=4, maxits=12, rtol=1e-12, restart_type=restart)
    same(jqn(jF, jnp.asarray(x0), **kw), snes_qn(tF, t(x0), **kw),
         htol=1e-9, xtol=1e-9)


def test_ngmres_plain_and_preconditioned_by_the_pointwise_gs():
    from petsctpu.snes.variants import snes_ngmres as jng
    from petsctpu_torch.snes.variants import snes_ngmres
    jF, tF, x0, jda, tda = bratu(9)
    same(jng(jF, jnp.asarray(x0), msize=5, maxits=10, rtol=1e-12),
         snes_ngmres(tF, t(x0), msize=5, maxits=10, rtol=1e-12),
         htol=1e-9, xtol=1e-9)
    jgs, tgs = jb.bratu_nonlinear_gs(jda, 6.0), tb.bratu_nonlinear_gs(tda)
    same(jng(jF, jnp.asarray(x0), msize=30, maxits=5, rtol=1e-12, npc=jgs),
         snes_ngmres(tF, t(x0), msize=30, maxits=5, rtol=1e-12, npc=tgs),
         htol=1e-9, xtol=1e-9)


@pytest.mark.parametrize("beta_type", ["prp", "fr"])
def test_ncg_on_bratu(beta_type):
    from petsctpu.snes.fas import snes_ncg as jncg
    from petsctpu_torch.snes.fas import snes_ncg
    jF, tF, x0, _, _ = bratu(11)
    same(jncg(jF, jnp.asarray(x0), beta_type=beta_type, maxits=12,
              rtol=1e-12),
         snes_ncg(tF, t(x0), beta_type=beta_type, maxits=12, rtol=1e-12),
         htol=1e-9, xtol=1e-9)


# --------------------------------------------------------- NGS and FAS

def test_bratu_pointwise_gs_against_reference():
    _, _, x0, jda, tda = bratu(9)
    b = np.random.default_rng(5).uniform(-0.01, 0.01, x0.size)
    for kw in (dict(), dict(sweeps=2, rtol=1e-12, atol=0.0, stol=0.0)):
        for bb in (None, b):
            r = jb.bratu_nonlinear_gs(jda, 6.0, **kw)(
                jnp.asarray(x0), None if bb is None else jnp.asarray(bb))
            p = tb.bratu_nonlinear_gs(tda, 6.0, **kw)(
                t(x0), None if bb is None else t(bb))
            assert rel(p.numpy(), np.asarray(r)) < 1e-12


def test_colored_ngs_solver():
    from petsctpu.mat.coloring import stencil_coloring
    from petsctpu.snes.fas import snes_ngs as jngs
    from petsctpu_torch.snes.fas import snes_ngs
    jF, tF, x0, jda, _ = bratu(9)
    colors = stencil_coloring(jda.grid, jda.stencil_offsets())
    same(jngs(jF, jnp.asarray(x0), colors, rtol=1e-8, maxits=40),
         snes_ngs(tF, t(x0), colors, rtol=1e-8, maxits=40), htol=1e-9)


@pytest.mark.parametrize("smoother,fas_type", [
    ("ngs", "multiplicative"), ("nrichardson", "multiplicative"),
    ("ngs", "additive")])
def test_fas_on_bratu(smoother, fas_type):
    from petsctpu.snes import fas as jfas
    from petsctpu_torch.snes import fas as tfas
    jda, tda = JDA((9, 9)), DA((9, 9))
    x0 = np.asarray(jb.bratu_initial_guess(jda, 6.0))
    kw = dict(smoother=smoother, fas_type=fas_type, maxits=3, rtol=1e-12,
              npre=1 if smoother == "nrichardson" else 2,
              npost=1 if smoother == "nrichardson" else 2)
    jl = jfas.fas_levels_from_da(jda, lambda d: jb.bratu_residual(d, 6.0), 2,
                                 mask_boundary=True)
    tl = tfas.fas_levels_from_da(tda, lambda d: tb.bratu_residual(d, 6.0), 2,
                                 mask_boundary=True)
    same(jfas.snes_fas(jl, jnp.asarray(x0), **kw),
         tfas.snes_fas(tl, t(x0), **kw), htol=1e-8, xtol=1e-8)


def test_fas_with_the_cavity_user_gs():
    from petsctpu.ksp.common import KSPConfig as JK
    from petsctpu.models import cavity as jc
    from petsctpu.snes import fas as jfas
    from petsctpu.snes.api import SNESConfig as JC
    from petsctpu_torch.models import cavity as tc
    from petsctpu_torch.snes import fas as tfas
    from petsctpu_torch.snes.api import SNESConfig
    gs = dict(sweeps=2, max_its=50, rtol=1e-15, atol=0.0, stol=0.0)
    jl, js = jc.cavity_fas_levels(7, 2, lidvelocity=10.0, grashof=100.0,
                                  gs_kw=gs)
    tl, ts = tc.cavity_fas_levels(7, 2, lidvelocity=10.0, grashof=100.0,
                                  gs_kw=gs)
    x0 = np.asarray(jc.cavity_initial_guess(7, 7, grashof=100.0))
    common = dict(smoother="user", npre=1, npost=1, maxits=1, rtol=1e-10)
    same(jfas.snes_fas(jl, jnp.asarray(x0), user_smoothers=js,
                       coarse_cfg=JC(maxits=20, rtol=1e-10, atol=1e-50),
                       coarse_ksp=JK(ksp_type="gmres", rtol=1e-10,
                                     maxits=200), **common),
         tfas.snes_fas(tl, t(x0), user_smoothers=ts,
                       coarse_cfg=SNESConfig(maxits=20, rtol=1e-10,
                                             atol=1e-50),
                       coarse_ksp=KSPConfig(ksp_type="gmres", rtol=1e-10,
                                            maxits=200), **common),
         htol=1e-8, xtol=1e-8)


# ------------------------------------------------------------------ VI

def _obstacle(n=40):
    h = 1.0 / (n + 1)
    A = (sp.diags([-np.ones(n - 1), 2 * np.ones(n), -np.ones(n - 1)],
                  [-1, 0, 1]) / h ** 2).toarray()
    xs = np.linspace(h, 1 - h, n)
    f = -8.0 * np.ones(n)
    psi = -0.2 + 0.4 * (xs - 0.5) ** 2
    return (lambda u: jnp.asarray(A) @ u - jnp.asarray(f),
            lambda u: t(A) @ u - t(f), psi)


# the reference's own SSLS history on the obstacle moves by up to 5.9e-7
# relative under a 1e-15 change of x0 (measured with petsctpu on the
# CPU): its bound is 30 times that
@pytest.mark.parametrize("kind,htol", [("rsls", 1e-8), ("ssls", 2e-5)])
def test_vi_obstacle_and_upper_bound(kind, htol):
    from petsctpu.snes import vi as jvi
    from petsctpu_torch.snes import vi as tvi
    name = f"snes_vinewton{kind}"
    jF, tF, psi = _obstacle()
    n = psi.size
    same(getattr(jvi, name)(jF, jnp.zeros(n), lb=jnp.asarray(psi),
                            ub=jnp.full(n, 1e20), rtol=1e-10, maxits=50),
         getattr(tvi, name)(tF, torch.zeros(n, dtype=torch.float64),
                            lb=t(psi), ub=torch.full((n,), 1e20,
                                                     dtype=torch.float64),
                            rtol=1e-10, maxits=50), htol=htol, xtol=1e-6)
    same(getattr(jvi, name)(lambda x: x - 5.0, jnp.zeros(4), lb=-1e20,
                            ub=2.0, rtol=1e-10),
         getattr(tvi, name)(lambda x: x - 5.0, torch.zeros(
             4, dtype=torch.float64), lb=-1e20, ub=2.0, rtol=1e-10))


def test_vi_fischer_burmeister_helpers():
    from petsctpu.snes import vi as jvi
    from petsctpu_torch.snes import vi as tvi
    rng = np.random.default_rng(6)
    a, b = rng.standard_normal((2, 50))
    a[:5] = b[:5] = 1e-8                          # the kink branch
    for f in ("_phi_fb", "_dphi_fb"):
        assert rel(getattr(tvi, f)(t(a), t(b)).numpy(),
                   np.asarray(getattr(jvi, f)(jnp.asarray(a),
                                              jnp.asarray(b)))) < 1e-14


# ---------------------------------------------------- NASM, multiblock, MS

@pytest.mark.parametrize("nasm_type", ["basic", "restrict"])
def test_nasm_on_bratu(nasm_type):
    from petsctpu.snes.nasm import snes_nasm as jnasm
    from petsctpu_torch.snes.nasm import snes_nasm
    jF, tF, x0, _, _ = bratu(9, 5.0)
    idx = np.arange(81)
    subs, owned = [idx[:45], idx[36:]], [idx[:41], idx[41:]]
    kw = dict(rtol=1e-6, maxits=8, nasm_type=nasm_type,
              owned=owned if nasm_type == "restrict" else None)
    same(jnasm(jF, jnp.asarray(x0), subs, **kw),
         snes_nasm(tF, t(x0), subs, **kw), htol=1e-8, xtol=1e-8)


def test_multiblock_and_ms():
    from petsctpu.mat import aij_from_scipy as j_aij
    from petsctpu.models import ex2_system as jex2
    from petsctpu.snes.nasm import snes_ms as jms
    from petsctpu.snes.nasm import snes_multiblock as jmb
    from petsctpu_torch.snes.nasm import snes_ms, snes_multiblock
    jF, tF, x0, _, _ = bratu(9, 5.0)
    idx = np.arange(81)
    fields = [idx[::2], idx[1::2]]
    same(jmb(jF, jnp.asarray(x0), fields, maxits=4, rtol=1e-10),
         snes_multiblock(tF, t(x0), fields, maxits=4, rtol=1e-10),
         htol=1e-8, xtol=1e-8)
    A, b, _ = jex2(5, 5)
    Aj, At = j_aij(A), aij_from_scipy(A, device="cpu")
    dinv = 1.0 / A.diagonal()
    for scheme in ("euler", "jameson83", "vltp31", "vltp61"):
        same(jms(lambda x: Aj.mult(x) - jnp.asarray(b), jnp.zeros(25),
                 scheme=scheme, scale=jnp.asarray(dinv), damping=0.5,
                 maxits=30, rtol=1e-10),
             snes_ms(lambda x: At.mult(x) - t(b),
                     torch.zeros(25, dtype=torch.float64), scheme=scheme,
                     scale=t(dinv), damping=0.5, maxits=30, rtol=1e-10),
             htol=1e-12, xtol=1e-12)


# ------------------------------------------------------------- models

def test_cavity_residual_guess_pattern_and_newton():
    from petsctpu.ksp.common import KSPConfig as JK
    from petsctpu.models import cavity as jc
    from petsctpu.snes.api import snes_solve as jsolve
    from petsctpu_torch.models import cavity as tc
    from petsctpu_torch.snes import ColoredJacobian, snes_solve
    mx, my = 7, 5
    x0 = np.asarray(jc.cavity_initial_guess(mx, my, grashof=50.0))
    np.testing.assert_array_equal(
        tc.cavity_initial_guess(mx, my, grashof=50.0, device="cpu").numpy(),
        x0)
    X = x0 + 0.1 * np.random.default_rng(7).standard_normal((2, x0.size))
    jF = jc.cavity_residual(mx, my, 3.0, 2.0, 50.0)
    tF = tc.cavity_residual(mx, my, 3.0, 2.0, 50.0)
    for x in X:
        assert rel(tF(t(x)).numpy(), np.asarray(jF(jnp.asarray(x)))) < 1e-13
    np.testing.assert_array_equal(tF(t(X)).numpy(),
                                  np.stack([tF(t(x)).numpy() for x in X]))
    pat = tc.cavity_jacobian_pattern(mx, my)
    assert (pat != jc.cavity_jacobian_pattern(mx, my)).nnz == 0
    # ex19_1: 25² at the default lid velocity, two Newton steps; here 9²
    # through the colored FD Jacobian against the reference's AD Newton
    m = 9
    jF, tF = jc.cavity_residual(m, m), tc.cavity_residual(m, m)
    x0 = np.asarray(jc.cavity_initial_guess(m, m))
    patt = tc.cavity_jacobian_pattern(m, m)
    plan = ColoredJacobian.from_sparsity(patt, aij_from_scipy(
        patt, device="cpu"))
    r = jsolve(jF, jnp.asarray(x0), jac="jvp", rtol=1e-8,
               ksp_cfg=JK(ksp_type="gmres", rtol=1e-10, maxits=2000,
                          restart=100))
    p = snes_solve(tF, t(x0), jac=plan, rtol=1e-8,
                   ksp_cfg=KSPConfig(ksp_type="gmres", rtol=1e-10,
                                     maxits=2000, restart=100))
    assert int(p.its) == int(r.its) == 2 and p.converged
    assert rel(p.x.numpy(), np.asarray(r.x)) < 1e-6     # FD vs AD Jacobian


def test_cavity_pointwise_gs_against_reference():
    from petsctpu.models import cavity as jc
    from petsctpu_torch.models import cavity as tc
    m = 7
    x0 = np.asarray(jc.cavity_initial_guess(m, m, grashof=100.0))
    rng = np.random.default_rng(8)
    x = x0 + 0.01 * rng.standard_normal(x0.size)
    b = 0.01 * rng.standard_normal(x0.size)
    for kw in (dict(), dict(sweeps=2, rtol=1e-15, atol=0.0, stol=0.0)):
        r = jc.cavity_nonlinear_gs(m, m, 10.0, 1.0, 100.0, **kw)(
            jnp.asarray(x), jnp.asarray(b))
        p = tc.cavity_nonlinear_gs(m, m, 10.0, 1.0, 100.0, **kw)(t(x), t(b))
        assert rel(p.numpy(), np.asarray(r)) < 1e-12
        r = jc.cavity_nonlinear_gs(m, m, **kw)(jnp.asarray(x))
        p = tc.cavity_nonlinear_gs(m, m, **kw)(t(x))
        assert rel(p.numpy(), np.asarray(r)) < 1e-12


def test_laplin_ex35_and_rand48():
    from petsctpu.core.random import Rand48 as JR
    from petsctpu.mat import aij_from_scipy as j_aij
    from petsctpu.models import laplin as jl
    from petsctpu.snes.api import snes_nrichardson as jnr
    from petsctpu_torch.core.random import Rand48
    from petsctpu_torch.models import laplin as tl
    from petsctpu_torch.snes.api import snes_nrichardson
    np.testing.assert_array_equal(Rand48(7, -1.0, 2.0).get_values(100),
                                  JR(7, -1.0, 2.0).get_values(100))
    for m in (4, 13):
        np.testing.assert_array_equal(tl.ex35_rhs(m), jl.ex35_rhs(m))
        assert (tl.ex35_matrix(m) != jl.ex35_matrix(m)).nnz == 0
    # runex35: -snes_type nrichardson on the 4×4 system
    A, b = tl.ex35_matrix(4), tl.ex35_rhs(4)
    Aj, At = j_aij(A), aij_from_scipy(A, device="cpu")
    r = jnr(lambda x: Aj.mult(x) - jnp.asarray(b), jnp.zeros(16),
            rtol=1e-12, maxits=40)
    p = snes_nrichardson(lambda x: At.mult(x) - t(b),
                         torch.zeros(16, dtype=torch.float64), rtol=1e-12,
                         maxits=40)
    same(r, p, htol=1e-9, xtol=1e-9)
    from test_laplin import EX35_HISTORY
    np.testing.assert_allclose(p.history[:len(EX35_HISTORY)].numpy(),
                               EX35_HISTORY, rtol=2e-5)


@pytest.mark.parametrize("p_exp,lam", [(2.0, 6.0), (3.0, 1.0), (1.5, 0.0)])
def test_pbratu_against_reference(p_exp, lam):
    from petsctpu.models import pbratu as jp
    from petsctpu_torch.models import pbratu as tp
    mx, my = 9, 7
    x0 = np.asarray(jp.pbratu_initial_guess(mx, my, lam))
    np.testing.assert_array_equal(
        tp.pbratu_initial_guess(mx, my, lam, device="cpu").numpy(), x0)
    x = x0 + 0.05 * np.random.default_rng(9).standard_normal(x0.size)
    r = jp.pbratu_residual(mx, my, p_exp, lam)(jnp.asarray(x))
    p = tp.pbratu_residual(mx, my, p_exp, lam)(t(x))
    assert rel(p.numpy(), np.asarray(r)) < 1e-13


def test_radiative_against_reference():
    from petsctpu.models import radiative as jr
    from petsctpu_torch.models import radiative as tr
    mx, my = 8, 6
    x0 = np.asarray(jr.radiative_initial_guess(mx, my))
    np.testing.assert_array_equal(
        tr.radiative_initial_guess(mx, my, device="cpu").numpy(), x0)
    x = x0 * np.random.default_rng(10).uniform(0.5, 1.5, x0.size)
    r = jr.radiative_residual(mx, my)(jnp.asarray(x))
    p = tr.radiative_residual(mx, my)(t(x))
    assert rel(p.numpy(), np.asarray(r)) < 1e-13


def test_adr1d_against_reference():
    from petsctpu.models import adr1d as ja
    from petsctpu_torch.models import adr1d as ta
    mx = 12
    x0 = np.asarray(ja.adr_initial(mx))
    np.testing.assert_array_equal(ta.adr_initial(mx, device="cpu").numpy(),
                                  x0)
    x = x0 * np.random.default_rng(11).uniform(0.9, 1.1, x0.size)
    for tt in (0.0, 0.13):
        r = ja.adr_rhs_advection(mx)(jnp.asarray(tt), jnp.asarray(x))
        p = ta.adr_rhs_advection(mx)(tt, t(x))
        assert rel(p.numpy(), np.asarray(r)) < 1e-13
        r = ja.adr_rhs_reaction(mx)(tt, jnp.asarray(x))
        p = ta.adr_rhs_reaction(mx)(tt, t(x))
        assert rel(p.numpy(), np.asarray(r)) < 1e-13
    for args in ((5, 0.1, 5, 1.0), (3, 2.0, 5, 1.0), (3, 0.5, 5, 1.0)):
        assert ta.ts_reason_string(*args) == ja.ts_reason_string(*args)
