"""SNES through the port (petsctpu_torch.snes), on the CPU in fp64.

Held against petsctpu on the same numpy inputs:
  * the colorings (stencil, MINPACK sl/lf/id, the inode pipeline) array
    for array, on the reference's oracle_coloring cases;
  * the FD-coloring Jacobians: the same pattern (cols, or the stencil's
    zero planes), values within 1e-12 relative of the reference's
    assembly of the same residual bits (the reference's residual with
    its exp taken on the host, as numpy's and PyTorch's agree bit for
    bit); with XLA's own exp, which rounds one ulp apart from PyTorch's
    in about one value in seven, within 1e-7 (a difference quotient
    divides that ulp by h ~ 1e-8 of the entry's scale);
  * the AD products: jvp and vjp within 1e-13 relative;
  * the Bratu residual within 1e-14 relative, batched rows equal to
    single ones bit for bit;
  * Newton with bt, l2, cp and basic line searches: equal iterations and
    reasons, histories within 1e-10 relative (the inner GMRES sums in
    another order);
and the 10 SNES goldens of tests/test_golden.py replayed through the
port at that file's own tolerances.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse as sp
import torch

from petsctpu_torch.io.viewer import petsc_binary_read_system
from petsctpu.mat import coloring as jcol

from petsctpu_torch.core.options import Options
from petsctpu_torch.dm import DA
from petsctpu_torch.ksp.common import KSPConfig
from petsctpu_torch.mat import aij_from_scipy
from petsctpu_torch.mat import coloring as tcol
from petsctpu_torch.models.bratu import (bratu_initial_guess,
                                         bratu_jacobian_template,
                                         bratu_residual)
from petsctpu_torch.snes import (SNES, ColoredJacobian, jvp_operator,
                                 mffd_operator, snes_solve)
from petsctpu_torch.snes.api import (SNESConfig, snes_grid_sequence,
                                     snes_ksponly, snes_nrichardson)

# one intra-op thread: the suite runs in parallel workers (pytest -n), and
# PyTorch's default of a thread a core oversubscribes the host's cores
torch.set_num_threads(1)

DATA = os.path.join(os.path.dirname(__file__), "data")
T = dict(dtype=torch.float64)


def t(a):
    return torch.from_numpy(np.asarray(a, np.float64))


def rel(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return np.abs(a - b).max() / max(np.abs(b).max(), 1e-300)


# ------------------------------------------------------------- colorings

@pytest.mark.parametrize("grid,offsets", [
    ((7, 7, 7), ((0, 0, 0), (0, 0, -1), (0, 0, 1), (0, -1, 0), (0, 1, 0),
                 (-1, 0, 0), (1, 0, 0))),
    ((9, 5), ((0, 0), (-1, 0), (1, 0), (0, -1), (0, 1))),
    ((6, 8), tuple((a, b) for a in (-1, 0, 1) for b in (-2, -1, 0, 1, 2))),
])
def test_stencil_coloring_equals_reference(grid, offsets):
    np.testing.assert_array_equal(tcol.stencil_coloring(grid, offsets),
                                  jcol.stencil_coloring(grid, offsets))


@pytest.mark.parametrize("f", ["ex10_nonsym", "ex10_poisson", "ex10_baij3"])
@pytest.mark.parametrize("kind", ["sl", "lf", "id"])
def test_minpack_colorings_equal_reference_and_oracle(f, kind):
    A, _ = petsc_binary_read_system(os.path.join(DATA, f + ".bin"))
    A = sp.csr_matrix(A)
    ours = tcol.minpack_coloring_inode(A, kind)
    np.testing.assert_array_equal(ours, jcol.minpack_coloring_inode(A, kind))
    txt = open(os.path.join(DATA, "oracle_coloring",
                            f"{f}_{kind}.txt")).read().split()
    np.testing.assert_array_equal(ours, np.array([int(x) for x in txt[2:]]))
    assert int(ours.max()) + 1 == int(txt[1])
    np.testing.assert_array_equal(tcol.get_coloring(A, kind),
                                  jcol.get_coloring(A, kind))


def test_get_coloring_greedy_and_unknown():
    A = sp.random(60, 60, density=0.1, random_state=1, format="csr") \
        + sp.eye(60)
    np.testing.assert_array_equal(tcol.get_coloring(A, "greedy"),
                                  jcol.greedy_color(A))
    with pytest.raises(ValueError):
        tcol.get_coloring(A, "nope")


# ------------------------------------------------------------- the models

def _ex5(m, lam=6.0):
    from petsctpu.dm import DA as JDA
    from petsctpu.models import bratu as jb
    jda, tda = JDA((m, m)), DA((m, m))
    return (jb.bratu_residual(jda, lam), bratu_residual(tda, lam),
            np.asarray(jb.bratu_initial_guess(jda, lam)), jda, tda)


def test_bratu_residual_and_guess_against_reference():
    jF, tF, x0, jda, tda = _ex5(11)
    np.testing.assert_array_equal(
        bratu_initial_guess(tda, 6.0, device="cpu").numpy(), x0)
    rng = np.random.default_rng(0)
    X = x0 + 0.1 * rng.standard_normal((3, x0.size))
    for x in X:
        assert rel(tF(t(x)).numpy(), np.asarray(jF(jnp.asarray(x)))) < 1e-14
    # a batch gives each row's residual, bit for bit
    np.testing.assert_array_equal(tF(t(X)).numpy(),
                                  np.stack([tF(t(x)).numpy() for x in X]))


def test_jvp_vjp_and_mffd_against_reference():
    from petsctpu.snes import fdjac as jfd
    jF, tF, x0, _, _ = _ex5(9)
    rng = np.random.default_rng(1)
    v = rng.standard_normal(x0.size)
    x = t(x0)
    J = jvp_operator(tF, x, tF(x))
    Jr = jfd.jvp_operator(jF, jnp.asarray(x0), jF(jnp.asarray(x0)))
    assert rel(J.mult(t(v)).numpy(), np.asarray(Jr.mult(jnp.asarray(v)))) \
        < 1e-13
    assert rel(J.multT(t(v)).numpy(),
               np.asarray(Jr.multT(jnp.asarray(v)))) < 1e-13
    M = mffd_operator(tF, x, tF(x))
    Mr = jfd.mffd_operator(jF, jnp.asarray(x0), jF(jnp.asarray(x0)))
    # a difference quotient: ~√eps relative agreement at best
    assert rel(M.mult(t(v)).numpy(), np.asarray(Mr.mult(jnp.asarray(v)))) \
        < 1e-6


def _ex14_pattern(m):
    e = np.ones(m)
    Tm = sp.diags([e[:-1], e, e[:-1]], [-1, 0, 1])
    I = sp.eye(m)
    pat = (sp.kron(sp.kron(Tm, I), I) + sp.kron(sp.kron(I, Tm), I)
           + sp.kron(sp.kron(I, I), Tm)).tocsr()
    pat.data[:] = 1.0
    return pat


def host_exp(u):
    """exp of a jax array taken by numpy on the host (PyTorch's bits)."""
    return jax.pure_callback(lambda a: np.exp(np.asarray(a)),
                             jax.ShapeDtypeStruct(u.shape, u.dtype), u,
                             vmap_method="expand_dims")


class _HostExpJnp:
    """jax.numpy with exp replaced by host_exp (patched into a reference
    module, so that its own residual code runs on PyTorch's exp)."""

    exp = staticmethod(host_exp)

    def __getattr__(self, name):
        return getattr(jnp, name)


def _ex14_residual(m, lam, lib, exp=jnp.exp):
    """tests/test_sweep.py::run_snes_ex14's residual, in jnp or torch."""
    h = 1.0 / (m - 1)
    sc = h * h * h * lam
    idx = np.arange(m)
    b3 = ((idx[:, None, None] == 0) | (idx[:, None, None] == m - 1)
          | (idx[None, :, None] == 0) | (idx[None, :, None] == m - 1)
          | (idx[None, None, :] == 0) | (idx[None, None, :] == m - 1))
    if lib == "jax":
        bm = jnp.asarray(b3)

        def F(u):
            U = u.reshape(m, m, m)
            up = jnp.pad(U, 1)
            lap = ((-up[1:-1, 1:-1, 2:] + 2 * U - up[1:-1, 1:-1, :-2]) * h
                   + (-up[1:-1, 2:, 1:-1] + 2 * U - up[1:-1, :-2, 1:-1]) * h
                   + (-up[2:, 1:-1, 1:-1] + 2 * U - up[:-2, 1:-1, 1:-1]) * h)
            return jnp.where(bm, U, lap - sc * exp(U)).reshape(-1)
        return F
    from petsctpu_torch.models.bratu import bratu3d_residual
    return bratu3d_residual(m, lam)


def test_bratu3d_residual_against_reference():
    m = 7
    jF = _ex14_residual(m, 5.0, "jax")
    tF = _ex14_residual(m, 5.0, "torch")
    x = np.random.default_rng(2).uniform(0, 0.5, m ** 3)
    assert rel(tF(t(x)).numpy(), np.asarray(jF(jnp.asarray(x)))) < 1e-14


@pytest.mark.parametrize("htype", ["ds", "const"])
def test_colored_aij_jacobian_against_reference(htype):
    from petsctpu.mat import aij_from_scipy as j_aij
    from petsctpu.snes.fdjac import ColoredJacobian as JCJ
    m = 6
    pat = _ex14_pattern(m)
    offs = ((0, 0, 0), (0, 0, -1), (0, 0, 1), (0, -1, 0), (0, 1, 0),
            (-1, 0, 0), (1, 0, 0))
    colors = tcol.stencil_coloring((m, m, m), offs)
    x = np.random.default_rng(3).uniform(-0.2, 0.6, m ** 3)
    x[::11] = 0.0                                 # the "ds" zero rule
    tF = _ex14_residual(m, 4.0, "torch")
    cj = ColoredJacobian(aij_from_scipy(pat, device="cpu"), colors,
                         int(colors.max()) + 1, htype=htype)
    J = cj.assemble(tF, t(x), tF(t(x)))
    for exp, tol in ((host_exp, 1e-12), (jnp.exp, 1e-7)):
        jF = _ex14_residual(m, 4.0, "jax", exp)
        Jr = JCJ(j_aij(pat), colors, int(colors.max()) + 1, htype=htype
                 ).assemble(jF, jnp.asarray(x), jF(jnp.asarray(x)))
        np.testing.assert_array_equal(J.cols.numpy(), np.asarray(Jr.cols))
        assert rel(J.vals.numpy(), np.asarray(Jr.vals)) < tol
    # the plan is kept: a second assembly gives the same bits
    np.testing.assert_array_equal(cj.assemble(tF, t(x), tF(t(x))).vals,
                                  J.vals)


@pytest.mark.parametrize("htype", ["const", "ds"])
def test_colored_stencil_jacobian_against_reference(htype, monkeypatch):
    from petsctpu.models import bratu as jb
    from petsctpu.models.bratu import bratu_jacobian_template as jtmpl
    from petsctpu.snes.fdjac import ColoredJacobian as JCJ
    _, tF, x0, jda, tda = _ex5(10)
    cj = ColoredJacobian.from_stencil(
        bratu_jacobian_template(tda, device="cpu"), htype=htype)
    assert cj.ncolors == 9
    J = cj.assemble(tF, t(x0), tF(t(x0)))
    for patch, tol in ((True, 1e-12), (False, 1e-7)):
        if patch:
            monkeypatch.setattr(jb, "jnp", _HostExpJnp())
        else:
            monkeypatch.undo()
        jF = jb.bratu_residual(jda, 6.0)
        Jr = JCJ.from_stencil(jtmpl(jda), htype=htype).assemble(
            jF, jnp.asarray(x0), jF(jnp.asarray(x0)))
        ref = np.asarray(Jr.coeffs)
        np.testing.assert_array_equal(J.coeffs.numpy() == 0, ref == 0)
        assert rel(J.coeffs.numpy(), ref) < tol
    # the assembled operator is the Jacobian: against the AD product
    v = t(np.random.default_rng(4).standard_normal(x0.size))
    Jv = jvp_operator(tF, t(x0), None).mult(v)
    assert rel(J.mult(v).numpy(), Jv.numpy()) < 1e-6


def test_from_sparsity_colors_like_reference():
    from petsctpu.snes.fdjac import ColoredJacobian as JCJ
    from petsctpu.mat import aij_from_scipy as j_aij
    pat = _ex14_pattern(5)
    cj = ColoredJacobian.from_sparsity(pat, aij_from_scipy(pat,
                                                           device="cpu"))
    ref = JCJ.from_sparsity(pat, j_aij(pat))
    np.testing.assert_array_equal(cj.color, ref.color)
    assert cj.ncolors == ref.ncolors


# --------------------------------------------------- Newton vs petsctpu

@pytest.mark.parametrize("ls", ["bt", "l2", "cp", "basic"])
def test_newton_linesearches_against_reference(ls):
    from petsctpu.ksp.common import KSPConfig as JK
    from petsctpu.snes.api import SNESConfig as JC
    from petsctpu.snes.api import snes_solve as jsolve
    jF, tF, x0, _, _ = _ex5(12, 6.5)
    kw = dict(rtol=1e-10, atol=1e-50, linesearch=ls, maxits=30)
    r = jsolve(jF, jnp.asarray(x0), jac="jvp", cfg=JC(**kw),
               ksp_cfg=JK(ksp_type="gmres", rtol=1e-10, maxits=300))
    p = snes_solve(tF, t(x0), jac="jvp", cfg=SNESConfig(**kw),
                   ksp_cfg=KSPConfig(ksp_type="gmres", rtol=1e-10,
                                     maxits=300))
    assert int(p.its) == int(r.its) and int(p.reason) == int(r.reason)
    k = int(r.its)
    hr = np.asarray(r.history[:k + 1])
    hp = p.history[:k + 1].numpy()
    # entries at the quadratic limit sit at rounding noise
    big = hr > 1e-8 * hr[0]
    assert rel(hp[big], hr[big]) < 1e-10
    assert rel(p.x.numpy(), np.asarray(r.x)) < 1e-10


def test_bt_quadratic_order_and_max_it_reason():
    from petsctpu.snes.api import SNESConfig as JC
    from petsctpu.snes.api import snes_solve as jsolve

    def jF(x):
        return jnp.arctan(x) * 3.0 + 0.1 * x

    def tF(x):
        return torch.atan(x) * 3.0 + 0.1 * x

    x0 = np.array([9.0, -7.5, 4.0])
    for order in ("quadratic", "cubic"):
        kw = dict(ls_order=order, maxits=4, rtol=1e-14, atol=1e-50)
        r = jsolve(jF, jnp.asarray(x0), jac="jvp", cfg=JC(**kw))
        p = snes_solve(tF, t(x0), jac="jvp", cfg=SNESConfig(**kw))
        assert int(p.reason) == int(r.reason)
        assert int(p.its) == int(r.its)
        assert rel(p.history[:int(r.its) + 1].numpy(),
                   np.asarray(r.history[:int(r.its) + 1])) < 1e-12


def test_ksponly_nrichardson_and_grid_sequence_against_reference():
    from petsctpu.dm import DA as JDA
    from petsctpu.models import bratu as jb
    from petsctpu.snes import api as japi
    jF, tF, x0, jda, tda = _ex5(9)
    r = japi.snes_ksponly(jF, jnp.asarray(x0), jac="jvp")
    p = snes_ksponly(tF, t(x0), jac="jvp")
    assert int(p.reason) == int(r.reason) == 5
    assert rel(p.x.numpy(), np.asarray(r.x)) < 1e-10
    r = japi.snes_nrichardson(jF, jnp.asarray(x0), maxits=6)
    p = snes_nrichardson(tF, t(x0), maxits=6)
    assert rel(p.history[:7].numpy(), np.asarray(r.history[:7])) < 1e-12
    rs = japi.snes_grid_sequence(JDA((5, 5)), lambda d: jb.bratu_residual(d),
                                 2, None, jb.bratu_initial_guess, jac="jvp")
    ps = snes_grid_sequence(DA((5, 5)), lambda d: bratu_residual(d), 2,
                            None, lambda d: bratu_initial_guess(
                                d, device="cpu"), jac="jvp")
    assert [int(a.its) for a in ps] == [int(a.its) for a in rs]
    assert rel(ps[-1].x.numpy(), np.asarray(rs[-1].x)) < 1e-9


@pytest.mark.parametrize("snes_type", ["newtonls", "newtontr", "ksponly",
                                       "qn", "ngmres", "ncg", "nrichardson",
                                       "anderson"])
def test_snes_object_dispatch_against_reference(snes_type):
    from petsctpu.core.options import Options as JO
    from petsctpu.snes import SNES as JSNES
    jF, tF, x0, _, _ = _ex5(8, 3.0)
    o = {"snes_type": snes_type, "snes_max_it": "5", "snes_rtol": "1e-9",
         "ksp_rtol": "1e-10"}
    r = JSNES(JO(o)).set_function(jF).solve(jnp.asarray(x0))
    p = SNES(Options(o)).set_function(tF).solve(t(x0))
    assert int(p.its) == int(r.its) and int(p.reason) == int(r.reason)
    k = int(r.its)
    assert rel(p.history[:k + 1].numpy(), np.asarray(r.history[:k + 1])) \
        < 1e-8


def test_snes_ilu_pc_builder_through_the_object():
    """The slice's path on the CPU: the SNES object with a ColoredJacobian
    ("ds") and an ILU(0) builder on each Jacobian, as chip_smoke.py
    slice 9 drives it at 128³."""
    from petsctpu_torch.mat.ell import aij_to_scipy
    from petsctpu_torch.models.bratu import (bratu3d_fd_jacobian,
                                             bratu3d_initial_guess,
                                             bratu3d_residual)
    from petsctpu_torch.pc.factor import make_ilu
    m, lam = 8, 5.0
    built = []

    def ilu0(J):
        built.append(J)
        return make_ilu(aij_to_scipy(J), levels=0, device="cpu")

    snes = SNES(Options({"snes_type": "newtonls",
                         "snes_linesearch_type": "bt", "snes_rtol": "1e-8",
                         "ksp_type": "gmres", "ksp_rtol": "1e-5"}))
    snes.set_function(bratu3d_residual(m, lam))
    snes.set_jacobian(bratu3d_fd_jacobian(m, device="cpu"))
    snes.set_pc_builder(ilu0)
    r = snes.solve(bratu3d_initial_guess(m, lam, device="cpu"))
    assert r.converged and int(r.reason) == 3
    assert float(r.fnorm) <= 1e-8 * float(r.history[0])
    assert len(built) == int(r.its)


# ------------------------------------------- the goldens of test_golden.py

def _bvp(N):
    h = 1.0 / (N - 1)
    xs = np.linspace(0.0, 1.0, N)
    FF = t(6.0 * xs + (xs + 1e-12) ** 6)
    d = 1.0 / (h * h)

    def F(u):
        interior = d * (u[:-2] - 2.0 * u[1:-1] + u[2:]) + u[1:-1] ** 2 \
            - FF[1:-1]
        return torch.cat([u[:1], interior, u[-1:] - 1.0])
    return F, xs


def test_golden_snes_ex3_newton_history():
    F, xs = _bvp(5)
    res = snes_solve(F, torch.full((5,), 0.5, **T), jac="jvp", rtol=1e-8,
                     atol=1e-50, ksp_cfg=KSPConfig(ksp_type="gmres",
                                                   rtol=1e-5, maxits=100))
    assert int(res.its) == 3
    np.testing.assert_allclose(res.history[:4].numpy(),
                               [5.41468, 0.295258, 0.000450229, 1.38967e-09],
                               rtol=1e-3)
    assert np.linalg.norm(res.x.numpy() - xs ** 3) < 1e-8


def _ex5_81():
    da = DA((81, 81))
    return bratu_residual(da, 6.0), bratu_initial_guess(da, 6.0,
                                                        device="cpu")


def test_golden_ex5_5_nrichardson():
    F, x0 = _ex5_81()
    r = snes_nrichardson(F, x0, maxits=8, rtol=1e-12)
    np.testing.assert_allclose(
        r.history[:9].numpy(), [1.11127, 0.693019, 0.550529, 0.468878,
                                0.413831, 0.373283, 0.342081, 0.316999,
                                0.296369], rtol=2e-5)


def test_golden_ex5_5_ncg_fr():
    from petsctpu_torch.snes.fas import snes_ncg
    F, x0 = _ex5_81()
    r = snes_ncg(F, x0, beta_type="fr", maxits=8, rtol=1e-12)
    np.testing.assert_allclose(
        r.history[:9].numpy(), [1.11127, 0.886518, 0.718206, 0.591367,
                                0.540892, 0.466458, 0.435514, 0.386243,
                                0.363351], rtol=2e-5)


def test_golden_ex5_5_qn():
    from petsctpu_torch.snes.variants import snes_qn
    F, x0 = _ex5_81()
    r = snes_qn(F, x0, history_len=10, maxits=8, rtol=1e-12)
    np.testing.assert_allclose(
        r.history[:9].numpy(), [1.11127, 0.886518, 0.718213, 0.591377,
                                0.540899, 0.466467, 0.435522, 0.386251,
                                0.363358], rtol=2e-5)


def test_golden_ex5_5_ngmres():
    from petsctpu_torch.snes.variants import snes_ngmres
    F, x0 = _ex5_81()
    r = snes_ngmres(F, x0, msize=10, maxits=7, rtol=1e-12)
    np.testing.assert_allclose(
        r.history[:8].numpy(), [1.11127, 0.693019, 0.498708, 0.381244,
                                0.311619, 0.25912, 0.222688, 0.192923],
        rtol=2e-5)


def test_golden_snes_ex2_2_newtontr_history():
    from petsctpu_torch.snes import snes_tr
    F, xs = _bvp(5)
    res = snes_tr(F, torch.full((5,), 0.5, **T), jac="jvp", rtol=1e-8,
                  atol=1e-50, ksp_cfg=KSPConfig(ksp_type="gmres", rtol=1e-5,
                                                maxits=100))
    assert int(res.its) == 3 and res.converged
    np.testing.assert_allclose(res.history[:4].numpy(),
                               [5.41468, 0.295258, 0.000450229, 1.38967e-09],
                               rtol=1e-3)
    np.testing.assert_allclose(np.linalg.norm(res.x.numpy() - xs ** 3),
                               1.49752e-10, rtol=1e-3)


def test_golden_tr_radius_restricts_then_recovers():
    from petsctpu_torch.snes import snes_tr

    def F(u):
        return torch.stack([u[0] ** 2 - 1.0, u[1] ** 2 - 4.0])

    res = snes_tr(F, t([3.0, 5.0]), jac="jvp", delta0=0.01, rtol=1e-10,
                  maxits=60)
    assert res.converged
    np.testing.assert_allclose(res.x.numpy(), [1.0, 2.0], atol=1e-8)


def test_golden_snes_ex1_1_two_var_system():
    def F(x):
        return torch.stack([x[0] * x[0] + x[0] * x[1] - 3.0,
                            x[0] * x[1] + x[1] * x[1] - 6.0])

    r = snes_solve(F, torch.full((2,), 0.5, **T), jac="jvp", rtol=1e-8,
                   atol=1e-50, ksp_cfg=KSPConfig(ksp_type="gmres", rtol=1e-4,
                                                 maxits=20,
                                                 cgs_refine="always"))
    assert int(r.its) == 6
    np.testing.assert_allclose(r.history[:6].numpy(),
                               [6.04152, 4.78676, 2.98646, 0.230624,
                                0.00193631, 1.43559e-07], rtol=2e-5)
    assert float(r.history[6]) < 1e-11


def test_golden_snes_ex3_4_post_check_iterates():
    F, _ = _bvp(5)
    tol = 1.0

    def post_check(its, x_last, dx, x):
        rdiff = torch.where(torch.abs(x) == 0, torch.full_like(x, 2 * tol),
                            torch.abs((x - x_last) / torch.where(
                                x == 0, torch.ones_like(x), x)))
        alter = (rdiff > tol) & (its > 0)
        return torch.where(alter, 0.5 * (x + x_last), x)

    r = snes_solve(F, torch.full((5,), 0.5, **T), jac="jvp", rtol=1e-8,
                   atol=1e-50, post_check=post_check,
                   ksp_cfg=KSPConfig(ksp_type="gmres", rtol=1e-4, maxits=20,
                                     cgs_refine="always"))
    assert int(r.its) == 4
    np.testing.assert_allclose(r.history[:4].numpy(),
                               [5.41468, 0.295258, 0.303701, 7.24709e-05],
                               rtol=2e-5)
    assert float(r.history[4]) < 1e-10


def test_golden_snes_ex14_3d_bratu():
    M = 4
    h = 1.0 / (M - 1)
    lam = 6.0
    F = _ex14_residual(M, lam, "torch")
    temp1 = lam / (lam + 1.0)
    d1 = np.minimum(np.arange(M), M - 1 - np.arange(M)) * h
    k, j, i = np.meshgrid(d1, d1, d1, indexing="ij")
    X0 = temp1 * np.sqrt(np.minimum(np.minimum(i, j), k))
    bi = np.zeros((M, M, M), bool)
    bi[0] = bi[-1] = True
    bi[:, 0] = bi[:, -1] = True
    bi[:, :, 0] = bi[:, :, -1] = True
    X0[bi] = 0.0
    r = snes_solve(F, t(X0.reshape(-1)), jac="jvp", rtol=1e-8, atol=1e-50,
                   ksp_cfg=KSPConfig(ksp_type="gmres", rtol=1e-5, maxits=300,
                                     cgs_refine="always"))
    assert int(r.its) == 3
    np.testing.assert_allclose(r.history[:4].numpy(),
                               [0.368723, 0.0202824, 4.38259e-05, 2.078e-10],
                               rtol=2e-4)
    np.testing.assert_allclose(float(r.fnorm), 2.07815e-10, rtol=1e-4)
