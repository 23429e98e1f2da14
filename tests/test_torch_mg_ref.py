"""The reference-exact MG stacks and their oracle models through the port,
held against petsctpu and against the reference's goldens (CPU, fp64).

* Every golden of tests/test_mg.py's oracle stacks (ksp ex34_1, ex29_1 and
  its ex29_1/2 oracles, ex45_2 run serially, ex50, ex54's model and GAMG-SA,
  ex28_1's ten wave solves and the periodic hierarchy), snes ex35_7
  (tests/test_laplin.py), the exotic PC's face/wirebasket oracle
  (tests/test_exotic_tfs.py) and snes ex18_1 / ex25_1 (tests/test_mg.py),
  each through petsctpu_torch with the reference test's own assertions and
  tolerances.
* The model builders byte-equal to petsctpu's (indptr, indices, data and the
  right-hand sides).
* make_full_mg_ref's level bounds equal to petsctpu's within 1e-14, in both
  est conventions (the est is the same host numpy/scipy code).
* Each smoother's smooth, PinvCoarsePC.apply and a whole MGPC apply on the
  reference's own state (convert.ref_mg_from_arrays) within 1e-12 of
  petsctpu's on the same seeded inputs.
* ksp ex34's 12³ solve as a whole: equal its and reason, the port's history
  within 1e-10 relative of petsctpu's.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse as sp
import torch

from petsctpu.ksp import ksp_solve as jksp_solve
from petsctpu.mat import aij_from_scipy as jaij
from petsctpu.models import poisson as jpoisson
from petsctpu.models import wave1d as jwave
from petsctpu.pc import mg as jmg

from petsctpu_torch.convert import ref_mg_from_arrays
from petsctpu_torch.core.options import Options
from petsctpu_torch.dm import DA
from petsctpu_torch.dm.da import (interp_dof_scipy, q0_interp_scipy,
                                  q1_interp_scipy)
from petsctpu_torch.ksp import ksp_solve
from petsctpu_torch.ksp.common import KSPConfig
from petsctpu_torch.mat import aij_from_scipy
from petsctpu_torch.models import (ex29_system, ex34_system,
                                   ex45_true_system, ex54_system, poisson,
                                   wave1d)
from petsctpu_torch.models.laplin import ex35_matrix, ex35_rhs
from petsctpu_torch.models.poisson import cell_neumann_laplacian_3d
from petsctpu_torch.pc import make_pc
from petsctpu_torch.pc import mg as tmg

# one intra-op thread: the suite runs in parallel workers (pytest -n), and
# PyTorch's default of a thread a core oversubscribes the host's cores
torch.set_num_threads(1)

CPU = "cpu"


def t(a):
    return torch.from_numpy(np.array(a, np.float64))


def aij(A):
    return aij_from_scipy(A, device=CPU)


def hist(r, k):
    return r.history[:k].numpy()


def _rel(got, ref):
    got, ref = np.asarray(got), np.asarray(ref)
    assert got.shape == ref.shape
    return float(np.abs(got - ref).max() / np.abs(ref).max())


# ---------------------------------------------------------------------------
# the hierarchies of the goldens, built by either package's builders
# ---------------------------------------------------------------------------
def ex34_hierarchy(models, m=12):
    A, b, u = models.ex34_system(m)
    As = [A, models.cell_neumann_laplacian_3d(m // 2),
          models.cell_neumann_laplacian_3d(m // 4)]
    Ps = [q0_interp_scipy((m,) * 3, (m // 2,) * 3),
          q0_interp_scipy((m // 2,) * 3, (m // 4,) * 3)]
    return As, Ps, b, u


EX29_SIZES = [129, 65, 33, 17, 9, 5, 3]


def ex29_hierarchy(neumann):
    As = [ex29_system(m, neumann)[0] for m in EX29_SIZES]
    Ps = [q1_interp_scipy((EX29_SIZES[l],) * 2, (EX29_SIZES[l + 1],) * 2)
          for l in range(len(EX29_SIZES) - 1)]
    return As, Ps, ex29_system(EX29_SIZES[0], neumann)[1]


def ex45_hierarchy():
    sizes = [21, 11, 6]
    As = [ex45_true_system(m)[0] for m in sizes]
    Ps = [q1_interp_scipy((sizes[l],) * 3, (sizes[l + 1],) * 3)
          for l in range(2)]
    return As, Ps, ex45_true_system(21)[1]


def ex28_hierarchy():
    As = [wave1d.ex28_matrix(12), wave1d.ex28_matrix(6),
          wave1d.ex28_matrix(3)]
    Ps = [interp_dof_scipy(q1_interp_scipy((12,), (6,), ("periodic",)), 2),
          interp_dof_scipy(q1_interp_scipy((6,), (3,), ("periodic",)), 2)]
    return As, Ps


def ex35_hierarchy():
    As = [ex35_matrix(13), ex35_matrix(7), ex35_matrix(4)]
    Ps = [q1_interp_scipy((13, 13), (7, 7)), q1_interp_scipy((7, 7), (4, 4))]
    return As, Ps, ex35_rhs(13)


def ex50_A(m):
    idx = np.arange(m * m)
    i, j = idx % m, idx // m
    rows, cols, vals = [], [], []
    diag = np.zeros(m * m)
    for di, dj in ((0, -1), (-1, 0), (1, 0), (0, 1)):
        ii, jj = i + di, j + dj
        ok = (ii >= 0) & (ii < m) & (jj >= 0) & (jj < m)
        rows.append(idx[ok])
        cols.append((ii + m * jj)[ok])
        vals.append(np.full(ok.sum(), -1.0))
        diag[ok] += 1.0
    rows.append(idx)
    cols.append(idx)
    vals.append(diag)
    return sp.csr_matrix((np.concatenate(vals),
                          (np.concatenate(rows), np.concatenate(cols))),
                         shape=(m * m, m * m))


def ex50_hierarchy():
    m = 21
    H = 1.0 / m
    x = (np.arange(m) + 0.5) * H
    b = (-np.cos(np.pi * x)[None, :]
         * np.cos(np.pi * x)[:, None] * H * H).reshape(-1)
    return [ex50_A(21), ex50_A(11)], [q1_interp_scipy((21, 21), (11, 11))], \
        b - b.mean()


# ---------------------------------------------------------------------------
# (a) the goldens through the port
# ---------------------------------------------------------------------------
def test_ex34_1_cell_centered_neumann_full_mg():
    """ksp ex34_1 (tests/test_mg.py:521): the -ksp_view bounds, 4 its, the
    5 monitor values, the final residual and the three error norms."""
    As, Ps, b, u = ex34_hierarchy(poisson)
    pc = tmg.make_full_mg_ref(As, Ps, b, nullspace=True, device=CPU)
    np.testing.assert_allclose([lv.smoother.emax for lv in pc.levels],
                               [1.1066216, 1.1018735], rtol=1e-6)
    r = ksp_solve(aij(As[0]), t(b), pc=pc, ksp_type="fgmres", rtol=1e-5,
                  atol=1e-50, maxits=10000)
    assert int(r.its) == 4
    np.testing.assert_allclose(hist(r, 5), [1.00731, 0.0422914, 0.00290556,
                                            9.48719e-05, 4.05385e-06],
                               rtol=2e-5)
    x = r.x.numpy()
    np.testing.assert_allclose(np.linalg.norm(b - As[0] @ x), 4.05385e-06,
                               rtol=1e-4)
    err = x - u
    np.testing.assert_allclose(
        [np.abs(err).max(), np.abs(err).sum() / 1728,
         np.linalg.norm(err) / 1728],
        [0.0208756, 0.00618519, 0.000197005], rtol=1e-5)


def test_ex29_1_full_mg_rediscretized():
    """ksp ex29_1 (tests/test_mg.py:470): the 5-point 129² Dirichlet
    Poisson, full MG over 7 rediscretized levels with Chebyshev + SSOR
    (make_algebraic_mg_from_hierarchy, sm_pc="sor"): at most 3 its."""
    def build_A(m):
        N = m * m
        rows, cols, vals = [], [], []
        for j in range(m):
            for i in range(m):
                r0 = i + m * j
                rows.append(r0)
                cols.append(r0)
                vals.append(4.0)
                if 0 < i < m - 1 and 0 < j < m - 1:
                    for ci, cj in ((i - 1, j), (i + 1, j), (i, j - 1),
                                   (i, j + 1)):
                        rows.append(r0)
                        cols.append(ci + m * cj)
                        vals.append(-1.0)
        return sp.csr_matrix((vals, (rows, cols)), shape=(N, N))

    As = [build_A(m) for m in EX29_SIZES]
    Ps = [q1_interp_scipy((EX29_SIZES[l],) * 2, (EX29_SIZES[l + 1],) * 2)
          for l in range(len(EX29_SIZES) - 1)]
    pc = tmg.make_algebraic_mg_from_hierarchy(As, Ps, sm_its=2,
                                              mg_type="full", sm_pc="sor",
                                              device=CPU)
    m = EX29_SIZES[0]
    h = 1.0 / (m - 1)
    x = np.arange(m) * h
    X, Y = np.meshgrid(x, x)
    b = (np.exp(-X * X / 0.1) * np.exp(-Y * Y / 0.1) * h * h).reshape(-1)
    r = ksp_solve(aij(As[0]), t(b), pc=pc, ksp_type="fgmres", rtol=1e-5,
                  maxits=50)
    assert int(r.its) <= 3                       # reference: 2
    assert float(r.history[int(r.its)]) <= 1e-5 * float(r.history[0])


@pytest.mark.parametrize("neumann,golden", [
    (False, [0.00157869, 1.59862e-05, 1.69573e-07, 2.35656e-09]),
    (True, [0.00144931, 1.67868e-05, 2.17787e-07, 5.35208e-09])])
def test_ex29_oracle(neumann, golden):
    """ksp ex29_1 / ex29_2 against the reference-source oracle
    (tests/test_mg.py:599, :609): est_convention "eigen", 3 its."""
    As, Ps, b = ex29_hierarchy(neumann)
    pc = tmg.make_full_mg_ref(As, Ps, b, nullspace=neumann,
                              est_convention="eigen", device=CPU)
    r = ksp_solve(aij(As[0]), t(b), pc=pc, ksp_type="fgmres", rtol=1e-5,
                  atol=1e-50, maxits=50)
    assert int(r.its) == 3
    np.testing.assert_allclose(hist(r, 4), golden, rtol=2e-5)


def test_ex45_2_serial_variant_oracle():
    """ksp ex45_2 run serially (tests/test_mg.py:620): Richardson + ILU(0)
    smoothers on 21³ → 11³ → 6³, GMRES outer, 3 its."""
    As, Ps, b = ex45_hierarchy()
    pc = tmg.make_mg_richardson_ilu(As, Ps, device=CPU)
    r = ksp_solve(aij(As[0]), t(b), pc=pc, ksp_type="gmres", rtol=1e-5,
                  atol=1e-50, maxits=50)
    assert int(r.its) == 3
    np.testing.assert_allclose(hist(r, 4), [97.1387, 1.45713, 0.0719792,
                                            0.00069467], rtol=2e-5)
    np.testing.assert_allclose(np.linalg.norm(b - As[0] @ r.x.numpy()),
                               6.67463e-05, rtol=1e-4)


def test_ex50_oracle():
    """ksp ex50 (tests/test_mg.py:715): 21² / 11² full MG, "eigen", 4 its."""
    As, Ps, b = ex50_hierarchy()
    pc = tmg.make_full_mg_ref(As, Ps, b, nullspace=True,
                              est_convention="eigen", device=CPU)
    r = ksp_solve(aij(As[0]), t(b), pc=pc, ksp_type="fgmres", rtol=1e-5,
                  atol=1e-50, maxits=50)
    assert int(r.its) == 4
    np.testing.assert_allclose(hist(r, 5), [0.0238095, 0.000505391,
                                            1.65644e-05, 3.31334e-07,
                                            6.55816e-09], rtol=2e-5)


def test_ex54_model_digit_exact():
    """ksp ex54's operator at ne = 109 through its Jacobi-CG monitor stream
    (tests/test_mg.py:659)."""
    A, b, _ = ex54_system(109, 1e-3)
    Ad = aij(A)
    r = ksp_solve(Ad, t(b), pc=make_pc("jacobi", A=Ad), ksp_type="cg",
                  rtol=1e-30, maxits=3)
    np.testing.assert_allclose(hist(r, 4), [1.48983, 5.13538, 4.84176,
                                            4.5793], rtol=2e-5)


def test_ex54_gamg_sa_iteration_parity():
    """runex54_SA (tests/test_mg.py:673): smoothed aggregation, CG, at most
    the oracle's 7 its."""
    A, b, _ = ex54_system(109, 1e-3)
    Ad = aij(A)
    pc = make_pc("gamg", A=Ad, A_host=A,
                 options=Options({"pc_gamg_coarse_eq_limit": 80,
                                  "pc_gamg_agg_nsmooths": 1}))
    r = ksp_solve(Ad, t(b), pc=pc, ksp_type="cg", rtol=1e-5, atol=1e-50,
                  maxits=100)
    assert int(r.reason) > 0
    assert int(r.its) <= 7, int(r.its)


EX28_GOLDEN = [
    [1.8138, 0.132153, 0.00642643, 9.04729e-05, 1.5538e-06],
    [0.811156, 0.0633908, 0.00570215, 8.89157e-05, 2.12515e-07],
    [0.36276, 0.00394307, 0.000188394, 1.95227e-05, 1.64486e-07],
    [0.162231, 0.0126521, 0.000481439, 1.84513e-05, 1.0402e-07],
    [0.072552, 0.00472681, 0.000381663, 2.26074e-06, 7.85518e-08],
    [0.0324462, 0.000718253, 8.77378e-05, 2.63389e-07],
    [0.0145104, 0.00111914, 2.36354e-05, 3.86354e-07, 3.42457e-09],
    [0.00648925, 0.0003537, 2.92793e-05, 1.77021e-07, 2.06209e-09],
    [0.00290208, 0.000107153, 8.89134e-06, 5.3806e-08, 1.55452e-09],
    [0.00129785, 0.000105456, 1.90091e-06, 6.48105e-08, 1.94989e-10],
]


def test_ex28_1_ten_wave_solves():
    """ksp ex28_1 (tests/test_mg.py:795): all 49 monitor values of the ten
    solves, full MG with GMRES(1) + ILU(0) smoothers on the periodic
    dof = 2 hierarchy 12 → 6 → 3."""
    As, Ps = ex28_hierarchy()
    pc = tmg.make_full_mg_gmres_ilu(As, Ps, device=CPU)
    A = aij(As[0])
    x = wave1d.ex28_initial(12)
    for k, gold in enumerate(EX28_GOLDEN):
        r = ksp_solve(A, t(wave1d.ex28_rhs(12, x)), pc=pc,
                      ksp_type="fgmres", rtol=1e-5, atol=1e-50, maxits=10000)
        x = r.x.numpy()
        assert int(r.its) == len(gold) - 1, (k, int(r.its))
        np.testing.assert_allclose(hist(r, len(gold)), gold, rtol=2e-5,
                                   err_msg=f"solve {k}")


def test_periodic_da_hierarchy():
    """The periodic DA's refine/coarsen rules and the periodic
    interpolation (tests/test_mg.py:819)."""
    da = DA((3,), boundary=("periodic",))
    f = da.refine().refine()
    assert f.grid == (12,)
    assert f.can_coarsen() and f.coarsen().grid == (6,)
    P = q1_interp_scipy((12,), (6,), ("periodic",))
    assert P.shape == (12, 6)
    np.testing.assert_allclose(P @ np.ones(6), np.ones(12))
    row = P.getrow(11).toarray().ravel()
    np.testing.assert_allclose([row[5], row[0]], [0.5, 0.5])


def test_ex35_7_richardson_mg():
    """snes ex35_7 (tests/test_laplin.py:148): outer Richardson over MG with
    self-scaled Richardson smoothers on 13 → 7 → 4: 12 KSP values, 11 its."""
    As, Ps, b = ex35_hierarchy()
    pc = tmg.make_mg_selfscale_richardson(As, Ps, device=CPU)
    r = ksp_solve(aij(As[0]), t(b), pc=pc, ksp_type="richardson",
                  rtol=1e-12, atol=1e-50, maxits=10000)
    golden = [33.9803, 3.1922, 0.233905, 0.0148341, 0.00104285,
              8.11749e-05, 6.6244e-06, 5.47159e-07, 4.57667e-08,
              3.9511e-09, 3.490e-10, 3.141e-11]
    np.testing.assert_allclose(hist(r, 10), golden[:10], rtol=2e-5)
    np.testing.assert_allclose(r.history[10:12].numpy(), golden[10:],
                               rtol=2e-3)
    assert int(r.its) == 11


@pytest.mark.parametrize("etype,direct,golden", [
    ("face", False, [14.7649, 0.366269, 0.0201148, 0.000508032,
                     2.18155e-05]),
    ("wirebasket", True, [14.7649, 0.423, 0.015459, 0.000227489,
                          8.60837e-06])])
def test_ex45_exotic_oracle(etype, direct, golden):
    """runex45_1 serially (tests/test_exotic_tfs.py:76-120): the exotic
    coarse space on ex45's exact 7³ system, two-level MG with GMRES(1) +
    ILU(0) smoothers, FGMRES outer: 4 its, 5 monitor values."""
    from petsctpu_torch.pc.exotic import exotic_interpolation

    A, b = ex45_true_system(7)
    P = exotic_interpolation(A, (7, 7, 7), (1, 1, 1), etype,
                             direct_solve=direct, device=CPU)
    Ac = (P.T @ A @ P).tocsr()
    pc = tmg.make_full_mg_gmres_ilu([sp.csr_matrix(A), Ac], [P], sm_its=1,
                                    mg_type="multiplicative", device=CPU)
    r = ksp_solve(aij(A), t(b), pc=pc,
                  cfg=KSPConfig(ksp_type="fgmres", rtol=1e-5, atol=1e-50,
                                maxits=50))
    assert int(r.its) == 4
    np.testing.assert_allclose(hist(r, 5), golden, rtol=2e-5)


def five_point_pattern(mx, my):
    rows, cols = [], []
    for J in range(my):
        for I in range(mx):
            r0 = I + mx * J
            for ci, cj in ((I - 1, J), (I + 1, J), (I, J - 1), (I, J + 1),
                           (I, J)):
                if 0 <= ci < mx and 0 <= cj < my:
                    rows.append(r0)
                    cols.append(ci + mx * cj)
    N = mx * my
    return sp.csr_matrix((np.ones(len(rows)), (rows, cols)), shape=(N, N))


def newton_mg(F, x, mx, my, stop, extra, maxits):
    """tests/test_mg.py's Newton loop: the colored FD Jacobian on the
    5-point pattern, -pc_type mg on the DA with Chebyshev + SSOR smoothers
    (and `extra` options), FGMRES to rtol 1e-5. Returns (Newton its, its
    of every linear solve)."""
    from petsctpu_torch.mat import aij_to_scipy
    from petsctpu_torch.snes import ColoredJacobian

    patt = five_point_pattern(mx, my)
    plan = ColoredJacobian.from_sparsity(patt, aij(patt))
    da = DA((my, mx))
    lin, fnorm0 = [], None
    for _ in range(maxits):
        Fx = F(x)
        fn = float(torch.linalg.vector_norm(Fx))
        fnorm0 = fnorm0 or fn
        if stop(fn, fnorm0):
            break
        Jm = plan.assemble(F, x, Fx)
        Jh = aij_to_scipy(Jm)
        Jh.eliminate_zeros()
        pc = make_pc("mg", A=Jm, A_host=Jh,
                     options=Options({"pc_mg_da": da,
                                      "mg_levels_pc_type": "sor", **extra}))
        r = ksp_solve(Jm, Fx, pc=pc, ksp_type="fgmres", rtol=1e-5,
                      maxits=200)
        lin.append(int(r.its))
        x = x - r.x
    return len(lin), lin


def test_ex18_1_radiative_transport_newton_mg():
    """snes ex18_1 (tests/test_mg.py:313): radiative transport on 17²,
    Newton + FGMRES + 3-level Galerkin MG: 6 Newton and 24 linear its."""
    from petsctpu_torch.models import (radiative_initial_guess,
                                       radiative_residual)

    newton, lin = newton_mg(
        radiative_residual(17, 17),
        radiative_initial_guess(17, 17, device=CPU), 17, 17,
        lambda fn, fn0: fn < 1e-8 * 0.83248, {}, 12)
    assert newton == 6                           # reference: 6
    assert sum(lin) == 24                        # reference: 24


def minsurf_residual(mx, my):
    """snes ex25's minimum-surface residual (tests/test_mg.py:391), over
    leading batch dimensions."""
    hx, hy = 1.0 / (mx - 1), 1.0 / (my - 1)

    def F(uflat):
        T = uflat.reshape(*uflat.shape[:-1], my, mx)
        P = torch.nn.functional.pad(T, (1, 1, 1, 1))
        C = T
        E, W = P[..., 1:-1, 2:], P[..., 1:-1, :-2]
        N, S = P[..., 2:, 1:-1], P[..., :-2, 1:-1]
        gup, gdn = (N - C) / hy, (C - S) / hy
        grt, glt = (E - C) / hx, (C - W) / hx
        gx = 0.5 * (E - W) / hx
        gy = 0.5 * (N - S) / hy
        cup = 1.0 / torch.sqrt(1.0 + gup * gup + gx * gx)
        cdn = 1.0 / torch.sqrt(1.0 + gdn * gdn + gx * gx)
        clt = 1.0 / torch.sqrt(1.0 + glt * glt + gy * gy)
        crt = 1.0 / torch.sqrt(1.0 + grt * grt + gy * gy)
        interior = ((cup * gup - cdn * gdn) * hx
                    + (crt * grt - clt * glt) * hy)
        j, i = torch.meshgrid(torch.arange(my), torch.arange(mx),
                              indexing="ij")
        xb = (2.0 * hx * i - 1.0).to(T.dtype)
        bnd = (i == 0) | (j == 0) | (i == mx - 1) | (j == my - 1)
        return torch.where(bnd, T - (1.0 - xb * xb),
                           interior).reshape(uflat.shape)

    return F


def test_ex25_1_minsurf_newton_mg():
    """snes ex25_1 (tests/test_mg.py:381): minimum surface on 9², 2-level
    Galerkin MG with Chebyshev + SSOR smoothers: 4 Newton its (reference
    4) with at most 22 linear its (reference 17)."""
    newton, lin = newton_mg(minsurf_residual(9, 9),
                            torch.zeros(81, dtype=torch.float64), 9, 9,
                            lambda fn, fn0: fn <= 1e-8 * fn0,
                            {"pc_mg_coarse_size": 30}, 10)
    assert newton == 4                           # reference: 4
    assert sum(lin) <= 22                        # reference: 17


@pytest.mark.skipif(torch.cuda.is_available(), reason="needs a host "
                    "without CUDA: the builders default to the card")
@pytest.mark.parametrize("builder", ["make_full_mg_ref",
                                     "make_full_mg_gmres_ilu",
                                     "make_mg_selfscale_richardson",
                                     "make_mg_richardson_ilu"])
def test_builders_default_to_cuda(builder):
    """device=None means CUDA: without it the builders raise."""
    As, Ps = ex28_hierarchy()
    args = (As, Ps, np.ones(24)) if builder == "make_full_mg_ref" \
        else (As, Ps)
    with pytest.raises(RuntimeError):
        getattr(tmg, builder)(*args)


# ---------------------------------------------------------------------------
# (b) the model builders byte-equal to petsctpu's
# ---------------------------------------------------------------------------
def _same_bytes(a, b):
    if sp.issparse(a):
        a, b = sp.csr_matrix(a), sp.csr_matrix(b)
        assert a.shape == b.shape
        return all(getattr(a, k).tobytes() == getattr(b, k).tobytes()
                   for k in ("indptr", "indices", "data"))
    return np.asarray(a).tobytes() == np.asarray(b).tobytes()


@pytest.mark.parametrize("name,args", [
    ("cell_neumann_laplacian_3d", (7,)), ("cell_neumann_laplacian_3d", (12,)),
    ("ex34_system", (6,)), ("ex34_system", (12,)),
    ("ex29_system", (9, False)), ("ex29_system", (17, True)),
    ("ex45_true_system", (7,)), ("ex45_true_system", (21,)),
    ("ex54_system", (9,)), ("ex54_system", (24, 1e-2))])
def test_poisson_builders_byte_equal(name, args):
    got = getattr(poisson, name)(*args)
    ref = getattr(jpoisson, name)(*args)
    got = got if isinstance(got, tuple) else (got,)
    ref = ref if isinstance(ref, tuple) else (ref,)
    assert len(got) == len(ref)
    for g, r in zip(got, ref):
        assert _same_bytes(g, r)


@pytest.mark.parametrize("mx", [3, 6, 12, 31])
def test_wave1d_byte_equal(mx):
    assert _same_bytes(wave1d.ex28_matrix(mx), jwave.ex28_matrix(mx))
    x = wave1d.ex28_initial(mx)
    assert _same_bytes(x, jwave.ex28_initial(mx))
    assert _same_bytes(wave1d.ex28_rhs(mx, x), jwave.ex28_rhs(mx, x))


def test_models_reexports():
    import petsctpu.models as jm
    import petsctpu_torch.models as tm

    names = {n for n in dir(jm) if not n.startswith("_")
             and callable(getattr(jm, n))}
    assert names <= {n for n in dir(tm) if callable(getattr(tm, n))}
    assert set(jm.__all__) == set(tm.__all__)


# ---------------------------------------------------------------------------
# (c) the est bounds against petsctpu's
# ---------------------------------------------------------------------------
def _bound_cases():
    return {
        "ex34": lambda: ex34_hierarchy(poisson)[:3] + (True,),
        "ex29_neumann": lambda: ex29_hierarchy(True) + (True,),
        "ex50": lambda: ex50_hierarchy() + (True,),
        "ex45": lambda: ex45_hierarchy() + (False,),
    }


@pytest.mark.parametrize("case", ["ex34", "ex29_neumann", "ex50", "ex45"])
@pytest.mark.parametrize("convention", ["svd", "eigen"])
def test_est_bounds_match_petsctpu(case, convention):
    As, Ps, b, nullspace = _bound_cases()[case]()
    pc = tmg.make_full_mg_ref(As, Ps, b, nullspace=nullspace,
                              est_convention=convention, device=CPU)
    jpc = jmg.make_full_mg_ref(As, Ps, b, nullspace=nullspace,
                               est_convention=convention)
    for lv, jlv in zip(pc.levels, jpc.levels):
        for k in ("emin", "emax"):
            np.testing.assert_allclose(getattr(lv.smoother, k),
                                       float(getattr(jlv.smoother, k)),
                                       rtol=1e-14)
        assert lv.smoother.its == jlv.smoother.its
        assert lv.smoother.denull == jlv.smoother.denull == nullspace


def test_est_helpers_match_petsctpu():
    """The host est helpers are copies: the same Hessenberg bit for bit."""
    A = sp.csr_matrix(ex34_system(6)[0])
    b = np.random.default_rng(2).standard_normal(A.shape[0])
    H = tmg._est_hessenberg_host(A, tmg._ssor_minv_host(A), b)
    Hj = jmg._est_hessenberg_host(A, jmg._ssor_minv_host(A), b)
    assert H.tobytes() == Hj.tobytes()
    for conv in ("svd", "eigen"):
        assert tmg._est_sigma_max_host(A, tmg._ssor_minv_host(A), b, 10,
                                       conv) == \
            jmg._est_sigma_max_host(A, jmg._ssor_minv_host(A), b, 10, conv)


# ---------------------------------------------------------------------------
# (d) the smoothers and the coarse solve on petsctpu's own state
# ---------------------------------------------------------------------------
def _ell(M):
    return (np.asarray(M.cols), np.asarray(M.vals), M.shape, M.nnz)


def _plan(p):
    return dict(level_rows=np.asarray(p.level_rows), cols=np.asarray(p.cols),
                vals=np.asarray(p.vals), dinv=np.asarray(p.dinv), n=p.n,
                nlev=p.nlev)


def _smoother_state(sm):
    kind = type(sm).__name__
    if kind == "RefChebySmoother":
        s = sm.pc
        assert not s.forward_only
        return dict(kind="cheby", emin=float(sm.emin), emax=float(sm.emax),
                    its=sm.its, denull=sm.denull,
                    sor=dict(fwd=_plan(s.fwd_plan), bwd=_plan(s.bwd_plan),
                             U_ell=_ell(s.U_ell), L_ell=_ell(s.L_ell),
                             diag=np.asarray(s.diag), omega=s.omega,
                             sweeps=s.sweeps, symmetric=s.symmetric))
    if kind == "GmresSmoother":
        return dict(kind="gmres", its=sm.its,
                    ilu=dict(L=_plan(sm.pc.Lplan), U=_plan(sm.pc.Uplan)))
    if kind == "SelfScaleRichardsonSmoother":
        assert sm.pc is None
        return dict(kind="selfscale", its=sm.its)
    assert kind == "RichardsonSmoother"
    return dict(kind="richardson", scale=sm.scale, its=sm.its,
                ilu=dict(L=_plan(sm.pc.Lplan), U=_plan(sm.pc.Uplan)))


def port_of(jpc):
    """The port's MGPC on petsctpu's state (convert.ref_mg_from_arrays)."""
    levels = [dict(A=_ell(lv.A), P=_ell(lv.P),
                   smoother=_smoother_state(lv.smoother))
              for lv in jpc.levels]
    c = jpc.coarse
    if type(c).__name__ == "PinvCoarsePC":
        coarse = dict(kind="pinv", Ainv=np.asarray(c.Ainv), denull=c.denull)
    else:
        coarse = dict(kind="lu", L=_plan(c.Lplan), U=_plan(c.Uplan),
                      perm_r=np.asarray(c.perm_r),
                      perm_c=np.asarray(c.perm_c))
    return ref_mg_from_arrays(levels, coarse, _ell(jpc.coarse_A), jpc.cycles,
                              jpc.mg_type, device=CPU)


def _stack(name):
    """petsctpu's MGPC of each reference-exact stack, on a small
    hierarchy."""
    if name == "full_mg_ref":
        As, Ps, b, _ = ex34_hierarchy(jpoisson, 8)
        return jmg.make_full_mg_ref(As, Ps, b, nullspace=True)
    if name == "full_mg_ref_dirichlet":
        As, Ps, b = ex45_hierarchy()
        return jmg.make_full_mg_ref(As, Ps, b, est_convention="eigen")
    if name == "gmres_ilu":
        return jmg.make_full_mg_gmres_ilu(*ex28_hierarchy())
    if name == "gmres_ilu_its3":
        return jmg.make_full_mg_gmres_ilu(*ex28_hierarchy(), sm_its=3)
    if name == "selfscale":
        return jmg.make_mg_selfscale_richardson(*ex35_hierarchy()[:2])
    assert name == "richardson_ilu"
    return jmg.make_mg_richardson_ilu(*ex45_hierarchy()[:2], sm_its=2)


STACKS = ["full_mg_ref", "full_mg_ref_dirichlet", "gmres_ilu",
          "gmres_ilu_its3", "selfscale", "richardson_ilu"]


@pytest.fixture(scope="module", params=STACKS)
def stack(request):
    jpc = _stack(request.param)
    return request.param, jpc, port_of(jpc)


def test_smooth_on_reference_state(stack):
    """Each level's smooth from a nonzero x, within 1e-12 of petsctpu's."""
    name, jpc, pc = stack
    rng = np.random.default_rng(11)
    smooth = jax.jit(lambda sm, A, b, x: sm.smooth(A, b, x))
    for lv, jlv in zip(pc.levels, jpc.levels):
        n = lv.A.shape[0]
        b, x = rng.standard_normal(n), rng.standard_normal(n)
        got = lv.smoother.smooth(lv.A, t(b), t(x)).numpy()
        ref = smooth(jlv.smoother, jlv.A, jnp.asarray(b), jnp.asarray(x))
        assert _rel(got, ref) <= 1e-12, name


def test_coarse_and_cycle_on_reference_state(stack):
    """The coarse solve (PinvCoarsePC or the LU) and one whole MG apply,
    within 1e-12 of petsctpu's."""
    name, jpc, pc = stack
    rng = np.random.default_rng(12)
    nc = pc.coarse_A.shape[0]
    r = rng.standard_normal(nc)
    assert _rel(pc.coarse.apply(t(r)).numpy(),
                jax.jit(lambda c, v: c.apply(v))(jpc.coarse, jnp.asarray(r))) \
        <= 1e-12, name
    b = rng.standard_normal(pc.levels[0].A.shape[0])
    ref = jax.jit(lambda p, v: p.apply(v))(jpc, jnp.asarray(b))
    assert _rel(pc.apply(t(b)).numpy(), ref) <= 1e-12, name


def test_ref_cheby_scalars_match_petsctpu_recurrence():
    """RefChebySmoother's Python-number ω recurrence equals petsctpu's
    array recurrence bit for bit, in fp64 and fp32."""
    for dt in (np.float64, np.float32):
        emin, emax = dt(0.1 * 1.1066216006029244), dt(1.1 * 1.1066216)
        sm = tmg.RefChebySmoother(None, emin, emax, 4, dtype=dt)
        e0, e1 = jnp.asarray(emin), jnp.asarray(emax)
        scale = 2.0 / (e1 + e0)
        alpha = 1.0 - scale * e0
        mu, omegaprod = 1.0 / alpha, 2.0 / alpha
        ckm1, ck = jnp.ones_like(mu), mu
        assert sm.scale == float(scale)
        for omega, rest in sm.steps:
            ckp1 = 2.0 * mu * ck - ckm1
            om = omegaprod * ck / ckp1
            assert (omega, rest) == (float(om), float(1.0 - om))
            ckm1, ck = ck, ckp1


# ---------------------------------------------------------------------------
# (e) ksp ex34's 12³ solve as a whole against petsctpu's
# ---------------------------------------------------------------------------
def test_ex34_solve_matches_petsctpu():
    As, Ps, b, _ = ex34_hierarchy(poisson)
    pc = tmg.make_full_mg_ref(As, Ps, b, nullspace=True, device=CPU)
    r = ksp_solve(aij(As[0]), t(b), pc=pc, ksp_type="fgmres", rtol=1e-5,
                  atol=1e-50, maxits=10000)
    jpc = jmg.make_full_mg_ref(As, Ps, b, nullspace=True)
    jr = jksp_solve(jaij(As[0]), jnp.asarray(b), pc=jpc, ksp_type="fgmres",
                    rtol=1e-5, atol=1e-50, maxits=10000)
    k = int(jr.its)
    assert (int(r.its), int(r.reason)) == (k, int(jr.reason))
    np.testing.assert_allclose(hist(r, k + 1), np.asarray(jr.history[:k + 1]),
                               rtol=1e-10)
    assert _rel(r.x.numpy(), np.asarray(jr.x)) <= 1e-10
