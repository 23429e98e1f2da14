"""The port's GAMG device refresh (pc/gamg_device.py), its SELL
templates (mat/sell.py::sell_template/sell_fill) and its native graph
code (mat/host_graph.py) against petsctpu's, on the CPU.

* sell_template: pos and diag_idx equal petsctpu's; sell_fill of new
  values equals sell_from_scipy of the same matrix byte for byte.
* aggregate and greedy_color: the native copies equal the plain Python
  loops (pc/gamg.py::aggregate, mat/coloring.py::greedy_color) and
  petsctpu's (its native library, and its Python loop).
* gamg_device_plan (SpGEMM plans) and gamg_probe_plan (colored probes):
  the refreshed hierarchy (prolongators, Jacobi diagonals, Chebyshev
  bounds, coarse LU) and one V-cycle equal petsctpu's refresh within
  fp32 rounding (1e-5 of the largest entry; 1e-12 in fp64); each level
  operator equals scipy's PᵀAP of the frozen P0 smoothed with the host's
  ω; CG preconditioned by a refresh of D·A·D (d = exp(0.2·N(0,1)))
  converges as petsctpu's does (equal its and reason, history within
  1e-3). The blocked rigid-body-mode route runs on ksp ex55 (bs = 2)
  through asa_tentatives; the ex56 (bs = 3) case skips while its element
  file is not in the repository.
* The probe refresh of ksp ex55 (ne = 31) with D·A·D preconditions CG
  as petsctpu's does: equal its and reason; fp64 history and true
  residual within 1e-9, fp32 history within the port's own change
  under a one-ulp change of b and true residual within 10 %.
* The probe refresh on SELL templates (the card's choice; here the
  plain version of K2) equals the ELL refresh within fp32 rounding, and
  either refresh reads the host once (every level's λ in one copy).
* The cases of tests/test_gamg_device.py on the port (its Newton case
  waits for SNES, ROADMAP queue 1 item 11).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.linalg as sla
import scipy.sparse as sp
import torch

from tests.test_torch_refnative import ensure_reference_native
from petsctpu import native
from petsctpu.ksp import ksp_solve as jksp_solve
from petsctpu.mat import aij_from_scipy as jaij_from_scipy
from petsctpu.mat import coloring as jcoloring
from petsctpu.mat import sell as jsell
from petsctpu.pc import asa as jasa
from petsctpu.pc import gamg as jgamg
from petsctpu.pc import gamg_device as jgd
from petsctpu_torch.ksp import ksp_solve
from petsctpu_torch.mat import aij_from_scipy, aij_to_scipy, host_graph
from petsctpu_torch.mat import sell as tsell
from petsctpu_torch.mat.coloring import greedy_color
from petsctpu_torch.mat.sell import SellMat, sell_to_scipy
from petsctpu_torch.models import laplacian_2d, poisson_3d
from petsctpu_torch.models import elasticity as tel
from petsctpu_torch.pc import asa as tasa
from petsctpu_torch.pc import gamg as tgamg
from petsctpu_torch.pc import gamg_device as tgd

# one intra-op thread: the suite runs in parallel workers (pytest -n), and
# PyTorch's default of a thread a core oversubscribes the host's cores
torch.set_num_threads(1)
# the reference's native library loaded, not half-built by another
# test process (tests/test_torch_refnative.py)
ensure_reference_native()

CPU = "cpu"


def _rel(got, ref):
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    assert got.shape == ref.shape
    return float(np.abs(got - ref).max() / max(np.abs(ref).max(), 1e-300))


def _tol(dtype):
    return 1e-12 if dtype == np.float64 else 1e-5


# ---------------------------------------------------------- templates ----
def _missing_diag():
    A = laplacian_2d(48, 48, dtype=np.float32).tolil()
    A[5, 5] = 0.0
    A[700, 700] = 0.0
    A = A.tocsr()
    A.eliminate_zeros()
    return A


TEMPLATE_CASES = {
    "lap2d_64": lambda: laplacian_2d(64, 64, dtype=np.float32).tocsr(),
    "ex55_63": lambda: tel.ex55_system(63, 1e-3)[0],
    "missing_diagonal": _missing_diag,
}


@pytest.mark.parametrize("case", list(TEMPLATE_CASES))
def test_sell_template_equals_reference(case):
    A = TEMPLATE_CASES[case]()
    tmpl, pos, diag_idx = tsell.sell_template(A, device=CPU)
    jtmpl, jpos, jdiag = jsell.sell_template(A)
    assert pos.dtype == diag_idx.dtype == torch.int32
    np.testing.assert_array_equal(pos.numpy(), np.asarray(jpos))
    np.testing.assert_array_equal(diag_idx.numpy(), np.asarray(jdiag))
    for f in ("vals", "idx", "qs", "winstart", "diag"):
        np.testing.assert_array_equal(getattr(tmpl, f).numpy(),
                                      np.asarray(getattr(jtmpl, f)))


@pytest.mark.parametrize("case", list(TEMPLATE_CASES))
def test_sell_fill_equals_sell_from_scipy(case):
    A = sp.csr_matrix(TEMPLATE_CASES[case](), dtype=np.float32)
    A.sort_indices()
    tmpl, pos, diag_idx = tsell.sell_template(A, device=CPU)
    A2 = A.copy()
    A2.data = np.random.default_rng(3).uniform(0.5, 2.0, A.nnz) \
        .astype(np.float32)
    got = tsell.sell_fill(tmpl, pos, diag_idx, torch.from_numpy(A2.data))
    ref = tsell.sell_from_scipy(A2, device=CPU)
    assert isinstance(got, SellMat) and got.shape == ref.shape
    for f in ("vals", "idx", "qs", "winstart", "diag"):
        assert torch.equal(getattr(got, f), getattr(ref, f)), f
    assert (got.G, got.S, got.Lp, got.mode) == (ref.G, ref.S, ref.Lp,
                                                ref.mode)
    jgot = jsell.sell_fill(*jsell.sell_template(A), jnp.asarray(A2.data))
    np.testing.assert_array_equal(got.vals.numpy(), np.asarray(jgot.vals))
    np.testing.assert_array_equal(got.diag.numpy(), np.asarray(jgot.diag))


# ------------------------------------------------------- native graphs ----
GRAPH_CASES = {
    "lap2d_40": lambda: laplacian_2d(40, 40),
    "poisson3d_12": lambda: poisson_3d(12, 12, 12),
    "ex55_nodes_31": lambda: tasa._collapse_by_block(
        tel.ex55_system(31, 1e-3)[0], 2),
}


@pytest.mark.parametrize("case", list(GRAPH_CASES))
def test_native_aggregate_equals_plain_and_reference(case):
    assert native.available()
    A = GRAPH_CASES[case]()
    for theta in (0.0, 0.3):
        S = tgamg.strength_graph(A, theta)
        got = host_graph.aggregate(S)
        assert got.dtype == np.int64
        np.testing.assert_array_equal(got, tgamg.aggregate(S))
        np.testing.assert_array_equal(got, jgamg.aggregate(S))


def _coloring_patterns(case):
    A = GRAPH_CASES[case]()
    P0 = tgamg.tentative_prolongator(host_graph.aggregate(
        tgamg.strength_graph(A, 0.0)))
    prod = (abs(sp.csr_matrix(A)) @ abs(P0)).tocsr()
    return A, prod


@pytest.mark.parametrize("case", list(GRAPH_CASES))
def test_native_greedy_color_equals_plain_and_reference(case, monkeypatch):
    for M in _coloring_patterns(case):
        got = host_graph.greedy_color(M)
        assert got.dtype == np.int32
        np.testing.assert_array_equal(got, greedy_color(M))
        np.testing.assert_array_equal(got, jcoloring.greedy_color(M))
        with monkeypatch.context() as mp:
            mp.setattr(native, "available", lambda: False)
            np.testing.assert_array_equal(got, jcoloring.greedy_color(M))
        # a valid distance-2 coloring: no two columns of a row share one
        rows = sp.csr_matrix(M)
        for r in range(0, rows.shape[0], 7):
            c = got[rows.indices[rows.indptr[r]:rows.indptr[r + 1]]]
            assert np.unique(c).size == c.size


# ------------------------------------------------------ refresh plans ----
def _host_hierarchy(A2, p0s, v0s, power_its=12):
    """The refreshed hierarchy in fp64 on the host: A2, then per level
    P = P0 − ω D⁻¹A P0 with ω from the plan's power iteration, and
    PᵀAP."""
    As, A = [], sp.csr_matrix(A2, dtype=np.float64)
    for P0, v in zip(p0s, v0s):
        As.append(A)
        dinv = 1.0 / A.diagonal()
        v = np.asarray(v, np.float64)
        for _ in range(power_its):
            w = dinv * (A @ v)
            lam = np.linalg.norm(w)
            v = w / max(lam, 1e-30)
        P = (P0 - (4.0 / (3.0 * lam)) * sp.diags(dinv) @ A @ P0).tocsr()
        A = (P.T @ A @ P).tocsr()
    return As + [A]


def _as_scipy(op):
    return sell_to_scipy(op) if isinstance(op, SellMat) else aij_to_scipy(op)


def _check_against_host(plan, pc, A2, dtype):
    """Every refreshed level operator (and the coarse LU's product)
    against the host hierarchy of the same frozen P0s."""
    ref = _host_hierarchy(A2, [aij_to_scipy(lp.p0()).astype(np.float64)
                               for lp in plan.levels],
                          [lp.v0.numpy() for lp in plan.levels])
    got = [_as_scipy(lv.A) for lv in pc.levels]
    P, L, U = torch.lu_unpack(pc.coarse.lu, pc.coarse.pivots)
    got.append(sp.csr_matrix((P @ L @ U).double().numpy()))
    assert len(got) == len(ref)
    for g, r in zip(got, ref):
        assert g.shape == r.shape
        assert abs(g - r).max() <= 10 * _tol(dtype) * abs(r).max()


def _p_of(lv):
    return lv.P.P if isinstance(lv.P, tgd.PPair) else lv.P


def _j_p_of(lv):
    return lv.P.P if type(lv.P).__name__ == "PPair" else lv.P


def _compare_refresh(pc, jpc, b, dtype):
    tol = _tol(dtype)
    assert len(pc.levels) == len(jpc.levels)
    for lv, jlv in zip(pc.levels, jpc.levels):
        assert _rel(_p_of(lv).vals.numpy(), _j_p_of(jlv).vals) <= tol
        assert _rel(lv.smoother.dinv.numpy(), jlv.smoother.dinv) <= tol
        assert abs(lv.smoother.emax / float(jlv.smoother.emax) - 1) <= tol
    assert _rel(pc.coarse.lu.numpy(), jpc.coarse.lu) <= 10 * tol
    y = pc.apply(torch.from_numpy(b)).numpy()
    jy = jax.jit(lambda p, v: p.apply(v))(jpc, jnp.asarray(b))
    assert _rel(y, jy) <= 10 * tol


PLANS = {"device": (tgd.gamg_device_plan, jgd.gamg_device_plan),
         "probe": (tgd.gamg_probe_plan, jgd.gamg_probe_plan)}


@pytest.mark.parametrize("route", list(PLANS))
@pytest.mark.parametrize("dtype", [np.float64, np.float32])
def test_refresh_equals_reference(route, dtype):
    m = 40
    A = laplacian_2d(m, m, dtype=dtype).tocsr()
    make, jmake = PLANS[route]
    plan = make(A, dtype=dtype, coarse_n=32, device=CPU)
    jplan = jmake(A, dtype=dtype, coarse_n=32)
    assert len(plan.levels) == len(jplan.levels) >= 2
    a0 = tgd.csr_data_of_matching(A, dtype)
    pc = plan.refresh(torch.from_numpy(a0))
    jpc = jax.jit(jplan.refresh)(jnp.asarray(a0))
    b = np.random.default_rng(0).standard_normal(m * m).astype(dtype)
    _compare_refresh(pc, jpc, b, dtype)
    np.testing.assert_array_equal(pc.coarse.pivots.numpy(),
                                  np.asarray(jpc.coarse.piv) + 1)


@pytest.mark.parametrize("route", list(PLANS))
def test_refresh_new_coefficients_is_the_host_galerkin_product(route):
    """Same pattern, new values (a TS/Newton operator refresh): every
    level operator is PᵀAP of the frozen P0 smoothed with the new
    operator's ω, and CG + the refresh converges as petsctpu's does."""
    m = 40
    rng = np.random.default_rng(4)
    A = laplacian_2d(m, m, dtype=np.float32).tocsr()
    make, jmake = PLANS[route]
    plan = make(A, dtype=np.float32, coarse_n=32, device=CPU)
    d = np.exp(0.2 * rng.standard_normal(m * m))
    A2 = (sp.diags(d) @ A @ sp.diags(d)).tocsr().astype(np.float32)
    A2.sort_indices()
    assert (A2.indices == A.indices).all()
    a2 = tgd.csr_data_of_matching(A2, np.float32)
    pc = plan.refresh(torch.from_numpy(a2))
    _check_against_host(plan, pc, A2, np.float32)
    b = rng.standard_normal(m * m).astype(np.float32)
    res = ksp_solve(aij_from_scipy(A2, dtype=np.float32, device=CPU),
                    torch.from_numpy(b), pc=pc, ksp_type="cg", rtol=1e-6,
                    maxits=80)
    jpc = jax.jit(jmake(A, dtype=np.float32, coarse_n=32).refresh)(
        jnp.asarray(a2))
    jres = jksp_solve(jaij_from_scipy(A2, dtype=np.float32), jnp.asarray(b),
                      pc=jpc, ksp_type="cg", rtol=1e-6, maxits=80)
    its = int(res.its)
    assert its == int(jres.its) <= 25
    assert int(res.reason) == int(jres.reason) > 0
    np.testing.assert_allclose(res.history[:its + 1].numpy(),
                               np.asarray(jres.history)[:its + 1], rtol=1e-3)


def test_refresh_from_ell_equals_refresh():
    A = laplacian_2d(24, 24).tocsr()
    plan = tgd.gamg_device_plan(A, dtype=np.float64, coarse_n=32,
                                device=CPU)
    pc1 = plan.refresh(torch.from_numpy(tgd.csr_data_of_matching(
        A, np.float64)))
    pc2 = plan.refresh_from_ell(aij_from_scipy(A, device=CPU))
    for l1, l2 in zip(pc1.levels, pc2.levels):
        assert torch.equal(l1.P.vals, l2.P.vals)
    assert torch.equal(pc1.coarse.lu, pc2.coarse.lu)


@pytest.fixture(scope="module")
def ex55_blocked():
    A, b, coords = tel.ex55_system(15, 1e-3, dtype=np.float32)
    B = tgamg.rigid_body_modes(coords, dof=2)
    return A, b, tasa.asa_tentatives(A, B, coarse_n=30, bs=2), \
        jasa.asa_tentatives(A, B, coarse_n=30, bs=2)


@pytest.mark.parametrize("route", list(PLANS))
def test_blocked_rbm_route_on_ex55(ex55_blocked, route):
    """Elasticity through asa tentatives (p0s), bs = 2: the refresh
    equals petsctpu's and the host Galerkin products, and preconditions
    CG to rtol 1e-6 within 120 iterations."""
    A, b, p0s, jp0s = ex55_blocked
    make, jmake = PLANS[route]
    plan = make(A, p0s=p0s, coarse_n=60, dtype=np.float32, device=CPU)
    jplan = jmake(A, p0s=jp0s, coarse_n=60, dtype=np.float32)
    a0 = tgd.csr_data_of_matching(A, np.float32)
    pc = plan.refresh(torch.from_numpy(a0))
    jpc = jax.jit(jplan.refresh)(jnp.asarray(a0))
    _compare_refresh(pc, jpc, b.astype(np.float32), np.float32)
    _check_against_host(plan, pc, A, np.float32)
    res = ksp_solve(aij_from_scipy(A, dtype=np.float32, device=CPU),
                    torch.from_numpy(b.astype(np.float32)), pc=pc,
                    ksp_type="cg", rtol=1e-6, maxits=120)
    assert int(res.reason) > 0


def test_blocked_rbm_route_on_ex56():
    if not tel.ELEM_FILE.exists():
        pytest.skip("ksp ex56's element file elem_3d_elast_v_25.txt is not "
                    "in the repository")
    A, b, coords = tel.ex56_system(5, 1e-3, dtype=np.float32)
    B = tgamg.rigid_body_modes(coords, dof=3)
    p0s = tasa.asa_tentatives(A, B, coarse_n=30, bs=3)
    plan = tgd.gamg_probe_plan(A, p0s=p0s, coarse_n=60, dtype=np.float32,
                               device=CPU)
    pc = plan.refresh(torch.from_numpy(tgd.csr_data_of_matching(
        A, np.float32)))
    res = ksp_solve(aij_from_scipy(A, dtype=np.float32, device=CPU),
                    torch.from_numpy(b.astype(np.float32)), pc=pc,
                    ksp_type="cg", rtol=1e-6, maxits=120)
    assert int(res.reason) > 0


def test_probe_refresh_on_sell_templates_equals_ell(monkeypatch):
    """The card's choice (SELL templates for the square fp32 levels,
    probed one K2 product a color) against the CPU's ELL, here with
    K2's plain version."""
    A, _, coords = tel.ex55_system(31, 1e-3, dtype=np.float32)
    B = tgamg.rigid_body_modes(coords, dof=2)
    p0s = tasa.asa_tentatives(A, B, coarse_n=80, bs=2)
    a0 = torch.from_numpy(tgd.csr_data_of_matching(A, np.float32))
    pcs = []
    for on in (True, False):
        monkeypatch.setattr(tgd, "sell_templates_on", lambda dev: on)
        pcs.append(tgd.gamg_probe_plan(A, p0s=p0s, coarse_n=80,
                                       device=CPU).refresh(a0))
    assert isinstance(pcs[0].levels[0].A, SellMat)
    assert not isinstance(pcs[1].levels[0].A, SellMat)
    for ls, le in zip(pcs[0].levels, pcs[1].levels):
        assert _rel(_p_of(ls).vals.numpy(), _p_of(le).vals.numpy()) <= 1e-5
    y = [pc.apply(torch.ones(A.shape[0])).numpy() for pc in pcs]
    assert _rel(y[0], y[1]) <= 1e-4


def test_dense_lupc_from_lu_factor_takes_lapack_pivots():
    rng = np.random.default_rng(7)
    M = rng.standard_normal((9, 9))
    M[0, 0] = 1e-3                       # forces row interchanges
    lu, piv = torch.linalg.lu_factor(torch.from_numpy(M))
    pc = tgd.DenseLUPC.from_lu_factor(lu, piv)
    b = rng.standard_normal(9)
    assert _rel(pc.apply(torch.from_numpy(b)).numpy(),
                np.linalg.solve(M, b)) <= 1e-12
    slu, spiv = sla.lu_factor(M)
    np.testing.assert_array_equal(pc.pivots.numpy(), spiv + 1)


def test_plan_checks_scatter_slots_and_index_width():
    with pytest.raises(ValueError, match="repeated slots"):
        tgd._distinct(np.array([0, 3, 3]), "P0 -> Pu")
    tgd._distinct(np.array([2, 0, 1]), "P0 -> Pu")
    with pytest.raises(ValueError, match="int32"):
        tgd._i32(np.array([0, 2 ** 31]), CPU)
    assert tgd._i32(np.array([0, 2 ** 31 - 1]), CPU).dtype == torch.int32


# ------------------------------- tests/test_gamg_device.py, on the port ----
def test_refresh_preconditions_cg():
    m = 40
    A = laplacian_2d(m, m, dtype=np.float64).tocsr()
    plan = tgd.gamg_device_plan(A, dtype=np.float64, coarse_n=32,
                                device=CPU)
    assert len(plan.levels) >= 2
    pc = plan.refresh(torch.from_numpy(tgd.csr_data_of_matching(
        A, np.float64)))
    b = np.random.default_rng(0).standard_normal(m * m)
    r = ksp_solve(aij_from_scipy(A, device=CPU), torch.from_numpy(b), pc=pc,
                  ksp_type="cg", rtol=1e-8, maxits=60)
    assert int(r.reason) > 0 and int(r.its) <= 15


def test_refresh_new_coefficients_fp64():
    """D·A·D with d = exp(0.3·N(0,1)) in fp64: CG within 25 its, and the
    level-1 operator equals the host Galerkin product of the frozen P0
    smoothed with the plan's own power iteration (rtol 1e-9)."""
    m = 40
    rng = np.random.default_rng(1)
    A = laplacian_2d(m, m, dtype=np.float64).tocsr()
    plan = tgd.gamg_device_plan(A, dtype=np.float64, coarse_n=32,
                                device=CPU)
    d = np.exp(0.3 * rng.standard_normal(m * m))
    A2 = (sp.diags(d) @ A @ sp.diags(d)).tocsr()
    A2.sort_indices()
    assert (A2.indices == A.indices).all()
    pc = plan.refresh(torch.from_numpy(tgd.csr_data_of_matching(
        A2, np.float64)))
    b = rng.standard_normal(m * m)
    r = ksp_solve(aij_from_scipy(A2, device=CPU), torch.from_numpy(b), pc=pc,
                  ksp_type="cg", rtol=1e-8, maxits=80)
    assert int(r.reason) > 0 and int(r.its) <= 25
    P0 = tgamg.tentative_prolongator(tgamg.aggregate(
        tgamg.strength_graph(A, 0.0)))
    Ach = _host_hierarchy(A2, [P0], [plan.levels[0].v0.numpy()])[1]
    x = rng.standard_normal(Ach.shape[0])
    np.testing.assert_allclose(
        pc.levels[1].A.mult(torch.from_numpy(x)).numpy(), Ach @ x,
        rtol=1e-9, atol=1e-10)


def test_probe_plan_matches_spgemm_plan():
    m = 40
    A = laplacian_2d(m, m, dtype=np.float32).tocsr()
    a0 = torch.from_numpy(tgd.csr_data_of_matching(A, np.float32))
    pc_o = tgd.gamg_device_plan(A, dtype=np.float32, coarse_n=32,
                                device=CPU).refresh(a0)
    pc_n = tgd.gamg_probe_plan(A, dtype=np.float32, coarse_n=32,
                               device=CPU).refresh(a0)
    assert len(pc_o.levels) == len(pc_n.levels)
    for lo, ln in zip(pc_o.levels, pc_n.levels):
        np.testing.assert_allclose(ln.P.P.vals.numpy(), lo.P.vals.numpy(),
                                   atol=1e-5)
        np.testing.assert_allclose(ln.smoother.dinv.numpy(),
                                   lo.smoother.dinv.numpy(), rtol=1e-4)
    np.testing.assert_allclose(pc_n.coarse.lu.numpy(), pc_o.coarse.lu.numpy(),
                               rtol=1e-3, atol=1e-4)


@pytest.mark.parametrize("route", list(PLANS))
def test_refresh_reads_the_host_once(route, monkeypatch):
    """A refresh keeps every level's λ on its device and reads them in
    one copy at its end: one call of the tensor methods that read a
    device value on the host."""
    A = laplacian_2d(40, 40, dtype=np.float32).tocsr()
    plan = PLANS[route][0](A, dtype=np.float32, coarse_n=32, device=CPU)
    assert len(plan.levels) >= 2
    reads = []
    for name in ("cpu", "item", "tolist", "__bool__", "__float__",
                 "__int__"):
        real = getattr(torch.Tensor, name)

        def spy(self, *a, _real=real, _name=name, **k):
            reads.append(_name)
            return _real(self, *a, **k)
        monkeypatch.setattr(torch.Tensor, name, spy)
    plan.refresh(torch.from_numpy(tgd.csr_data_of_matching(A, np.float32)))
    monkeypatch.undo()
    assert reads == ["cpu"]


def _scaled(A, rng):
    """D·A·D, d = exp(0.2·N(0,1)), on A's own pattern (chip_smoke.py's)."""
    A2 = sp.csr_matrix(A, dtype=np.float64, copy=True)
    A2.sort_indices()
    d = np.exp(0.2 * rng.standard_normal(A.shape[0]))
    rows = np.repeat(np.arange(A.shape[0]), np.diff(A2.indptr))
    A2.data = A2.data * d[rows] * d[A2.indices]
    return A2


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
def test_probe_refresh_of_scaled_ex55_solves_as_reference(dtype):
    """The probe refresh of ksp ex55 (ne = 31, bs = 2, asa_tentatives
    P0s) with D·A·D, preconditioning CG to rtol 1e-5, as chip_smoke.py's
    refresh phase runs it, against petsctpu's refresh and CG: equal its
    and reason. History: fp64 within 1e-9; fp32 within the largest
    change that a one-ulp change of b makes in the port's own history
    (0.065-0.089 over four such b: the scaling breaks the rigid-body
    near-null space and fp32 CG follows rounding; petsctpu is 0.059
    away). True relative residual: fp64 within 1e-9 of petsctpu's; fp32
    within 10 % (0.8937e-3 against 0.9386e-3)."""
    A, b, coords = tel.ex55_system(31, 1e-3)
    B = tgamg.rigid_body_modes(coords, dof=2)
    A2 = _scaled(A, np.random.default_rng(0)).astype(dtype)
    a2 = tgd.csr_data_of_matching(A2, dtype)
    bb = b.astype(dtype)
    pc = tgd.gamg_probe_plan(A.astype(dtype), p0s=tasa.asa_tentatives(
        A, B, coarse_n=80, bs=2), coarse_n=80, dtype=dtype,
        device=CPU).refresh(torch.from_numpy(a2))
    jplan = jgd.gamg_probe_plan(A.astype(dtype), p0s=jasa.asa_tentatives(
        A, B, coarse_n=80, bs=2), coarse_n=80, dtype=dtype)
    jpc = jax.jit(jplan.refresh)(jnp.asarray(a2))
    M = aij_from_scipy(A2, dtype=dtype, device=CPU)
    kw = dict(ksp_type="cg", rtol=1e-5, maxits=2000)
    res = ksp_solve(M, torch.from_numpy(bb), pc=pc, **kw)
    jres = jksp_solve(jaij_from_scipy(A2, dtype=dtype), jnp.asarray(bb),
                      pc=jpc, **kw)
    its = int(res.its)
    assert its == int(jres.its)
    assert int(res.reason) == int(jres.reason) > 0
    h = res.history[:its + 1].numpy()
    diff = float(np.max(np.abs(h - np.asarray(jres.history)[:its + 1])
                        / np.abs(h)))
    true = [np.linalg.norm(b - A2 @ np.asarray(x, np.float64))
            / np.linalg.norm(b) for x in (res.x.numpy(), jres.x)]
    if dtype == np.float64:
        assert diff <= 1e-9
        assert abs(true[0] / true[1] - 1) <= 1e-9
        return
    sens = 0.0
    for seed in range(4):
        up = np.where(np.random.default_rng(seed).random(bb.size) < 0.5,
                      -np.inf, np.inf).astype(dtype)
        r = ksp_solve(M, torch.from_numpy(np.nextafter(bb, up)), pc=pc, **kw)
        k = min(its, int(r.its)) + 1
        sens = max(sens, float(np.max(np.abs(r.history[:k].numpy() - h[:k])
                                      / np.abs(h[:k]))))
    assert diff <= sens
    assert abs(true[0] / true[1] - 1) <= 0.1
