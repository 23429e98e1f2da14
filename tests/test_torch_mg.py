"""The port's LU coarse solve, geometric MG and CG+MG solves against
petsctpu's, on the CPU in fp64.

* SpTRSVPlan and LUPC.apply (plain and transpose) on the ex2 20×20 LU:
  the plans equal the reference's array for array, and the solves agree
  within 1e-12 relative (row sums in another order).
* MGPC.apply built by `mg_from_arrays` from the reference's own level
  state, for the multiplicative (V and W), full, kaskade and additive
  types: within 1e-12 relative of the reference's apply.
* The port's own setups (device and host) against the reference's:
  coefficient planes within 1e-13, Chebyshev bounds within 1e-12.
* CG+MG solves through KSP with Options — ex2 33² with the device and
  the host setup (as tests/test_mg.py:163-179) and the 7-point 9³
  Poisson (:181-192): equal its and reason, history within rtol 1e-10
  (atol 1e-13·‖r0‖ for entries at rounding noise), x within 1e-10.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse as sp
import scipy.sparse.linalg as spla
import torch

from petsctpu.core.options import Options as JOptions
from petsctpu.dm import DA as JDA
from petsctpu.ksp import KSP as JKSP
from petsctpu.mat import factor as jfactor
from petsctpu.mat import stencil as jst
from petsctpu.pc import factor as jpcf
from petsctpu.pc import make_pc as jmake_pc
from petsctpu_torch.convert import mg_from_arrays
from petsctpu_torch.core.options import Options
from petsctpu_torch.dm import DA
from petsctpu_torch.ksp import KSP
from petsctpu_torch.mat import aij_from_scipy
from petsctpu_torch.mat import factor as tfactor
from petsctpu_torch.mat.stencil import stencil_from_scipy
from petsctpu_torch.models import ex2_system, poisson_3d
from petsctpu_torch.pc import make_pc
from petsctpu_torch.pc.factor import make_lu

# one intra-op thread: the suite runs in parallel workers (pytest -n), and
# PyTorch's default of a thread a core oversubscribes the host's cores
torch.set_num_threads(1)

CPU = "cpu"


def _rel(got, ref):
    got, ref = np.asarray(got), np.asarray(ref)
    assert got.shape == ref.shape
    return float(np.abs(got - ref).max() / np.abs(ref).max())


@pytest.fixture(scope="module")
def ex2_20():
    A, b, _ = ex2_system(20, 20)
    return sp.csr_matrix(A), b


@pytest.mark.parametrize("factor,lower", [("L", True), ("U", False)])
def test_sptrsv_plan_matches_petsctpu(ex2_20, factor, lower):
    A, _ = ex2_20
    L, U, _, _ = tfactor.lu_factor(A)
    jL, jU, _, _ = jfactor.lu_factor(A)
    T = L if factor == "L" else U
    assert abs(T - (jL if factor == "L" else jU)).max() == 0.0
    plan = tfactor.make_sptrsv_plan(T, lower=lower, unit_diag=False,
                                    device=CPU)
    jplan = jfactor.make_sptrsv_plan(T, lower=lower, unit_diag=False)
    assert (plan.n, plan.nlev) == (jplan.n, jplan.nlev)
    for name in ("level_rows", "cols", "vals", "dinv"):
        np.testing.assert_array_equal(np.asarray(getattr(plan, name)),
                                      np.asarray(getattr(jplan, name)))
    b = np.random.default_rng(5).standard_normal(A.shape[0])
    got = plan.solve(torch.from_numpy(b)).numpy()
    assert _rel(got, jplan.solve(jnp.asarray(b))) <= 1e-12
    assert _rel(got, spla.spsolve_triangular(T.tocsr(), b, lower=lower)) \
        <= 1e-12


@pytest.mark.parametrize("transpose", [False, True])
def test_lupc_apply_matches_petsctpu(ex2_20, transpose):
    A, _ = ex2_20
    # a nonsymmetric operator, so the transpose apply is a different map
    A = (A + sp.diags(np.linspace(0.0, 0.5, A.shape[0] - 1), 1)).tocsr()
    b = np.random.default_rng(6).standard_normal(A.shape[0])
    got = make_lu(A, transpose=transpose, device=CPU).apply(
        torch.from_numpy(b)).numpy()
    ref = jpcf.make_lu(A, transpose=transpose).apply(jnp.asarray(b))
    assert _rel(got, ref) <= 1e-12
    assert _rel(got, spla.spsolve((A.T if transpose else A).tocsc(), b)) \
        <= 1e-12


@pytest.mark.parametrize("pc_type", ["lu", "cholesky", "redundant"])
def test_factor_pc_types_through_make_pc(ex2_20, pc_type):
    A, b = ex2_20
    pc = make_pc(pc_type, A=aij_from_scipy(A, device=CPU), A_host=A)
    jpc = jmake_pc(pc_type, A_host=A)
    assert _rel(pc.apply(torch.from_numpy(b)).numpy(),
                jpc.apply(jnp.asarray(b))) <= 1e-12
    with pytest.raises(ValueError, match="host"):
        make_pc(pc_type, A=aij_from_scipy(A, device=CPU))


@pytest.fixture(scope="module")
def ref_mg_33():
    """The reference's device-setup MG on ex2 33² (3 smoothed levels and
    a 25-row LU)."""
    A, b, _ = ex2_system(33, 33)
    J = jst.stencil_from_scipy(A, (33, 33))
    return A, b, jmake_pc("mg", A=J, options=JOptions({"pc_mg_da":
                                                         JDA((33, 33))}))


def _port_from_reference(jpc, cycles, mg_type):
    def op(S):
        return dict(coeffs=np.asarray(S.coeffs), offsets=S.offsets,
                    grid=S.grid, boundary=S.boundary)

    levels = [dict(op(lv.A), dinv=np.asarray(lv.smoother.dinv),
                   emin=float(lv.smoother.emin), emax=float(lv.smoother.emax),
                   its=lv.smoother.its, coarse_grid=lv.P.coarse)
              for lv in jpc.levels]
    L, U, pr, pc = jfactor.lu_factor(jst.stencil_to_scipy(jpc.coarse_A))
    coarse = dict(op(jpc.coarse_A), L=L, U=U, perm_r=pr, perm_c=pc)
    return mg_from_arrays(levels, coarse, cycles, mg_type, device=CPU)


@pytest.mark.parametrize("mg_type,cycles", [
    ("multiplicative", 1), ("multiplicative", 2), ("full", 1),
    ("kaskade", 1), ("additive", 1)])
def test_mgpc_apply_on_reference_state(ref_mg_33, mg_type, cycles):
    from dataclasses import replace

    _, _, jpc = ref_mg_33
    jpc = replace(jpc, cycles=cycles, mg_type=mg_type)
    pc = _port_from_reference(jpc, cycles, mg_type)
    assert len(pc.levels) == 3 and pc.coarse_A.grid == (5, 5)
    b = np.random.default_rng(8).standard_normal(33 * 33)
    ref = jax.jit(lambda p, v: p.apply(v))(jpc, jnp.asarray(b))
    assert _rel(pc.apply(torch.from_numpy(b)).numpy(), ref) <= 1e-12


@pytest.mark.parametrize("setup", ["device", "host"])
def test_setup_matches_reference_state(ref_mg_33, setup):
    A, _, jpc = ref_mg_33
    if setup == "host":
        jpc = jmake_pc("mg", A_host=A, options=JOptions({
            "pc_mg_da": JDA((33, 33)), "pc_mg_setup_type": "host"}))
    S = stencil_from_scipy(A, (33, 33), device=CPU)
    pc = make_pc("mg", A=S, A_host=A, options=Options({
        "pc_mg_da": DA((33, 33)), "pc_mg_setup_type": setup}))
    assert len(pc.levels) == len(jpc.levels)
    for lv, jlv in zip(pc.levels, jpc.levels):
        assert lv.A.offsets == jlv.A.offsets and lv.A.grid == jlv.A.grid
        ref = np.asarray(jlv.A.coeffs)
        np.testing.assert_allclose(lv.A.coeffs.numpy(), ref, rtol=1e-13,
                                   atol=1e-13 * np.abs(ref).max())
        np.testing.assert_allclose(lv.smoother.dinv.numpy(),
                                   np.asarray(jlv.smoother.dinv), rtol=1e-13)
        for k in ("emin", "emax"):
            np.testing.assert_allclose(getattr(lv.smoother, k),
                                       float(getattr(jlv.smoother, k)),
                                       rtol=1e-12)
        assert lv.smoother.its == jlv.smoother.its == 2
        assert lv.P.fine == jlv.P.fine and lv.P.coarse == jlv.P.coarse
    assert pc.coarse_A.grid == jpc.coarse_A.grid


def _solve_pair(A, b, grid, setup):
    flags = {"ksp_type": "cg", "pc_type": "mg", "ksp_rtol": "1e-8"}
    if setup == "host":
        flags["pc_mg_setup_type"] = "host"
    res = KSP(Options({**flags, "pc_mg_da": DA(grid)})).set_operators(
        stencil_from_scipy(A, grid, device=CPU), A_host=A).solve(
        torch.from_numpy(b))
    jres = JKSP(JOptions({**flags, "pc_mg_da": JDA(grid)})).set_operators(
        jst.stencil_from_scipy(A, grid), A_host=A).solve(jnp.asarray(b))
    return res, jres


@pytest.mark.parametrize("case,setup", [("ex2_33", "device"),
                                        ("ex2_33", "host"),
                                        ("poisson_9", "device")])
def test_cg_mg_solve_matches_petsctpu(case, setup):
    if case == "ex2_33":
        A, b, u = ex2_system(33, 33)
        grid = (33, 33)
    else:
        A, grid = poisson_3d(9, 9, 9), (9, 9, 9)
        u = np.ones(A.shape[0])
        b = A @ u
    res, jres = _solve_pair(sp.csr_matrix(A), b, grid, setup)
    its = int(res.its)
    assert its == int(jres.its) and int(res.reason) == int(jres.reason)
    assert int(res.reason) > 0 and its <= 10
    h, jh = res.history[:its + 1].numpy(), np.asarray(jres.history)[:its + 1]
    np.testing.assert_allclose(h, jh, rtol=1e-10, atol=1e-13 * jh[0])
    np.testing.assert_allclose(res.x.numpy(), np.asarray(jres.x), rtol=0,
                               atol=1e-10)
    np.testing.assert_allclose(res.x.numpy(), u, atol=1e-6)


def test_mg_option_errors():
    A, _, _ = ex2_system(9, 9)
    S = stencil_from_scipy(A, (9, 9), device=CPU)
    with pytest.raises(ValueError, match="pc_mg_da"):
        make_pc("mg", A=S)
    # SSOR level smoothers are ported (slice 5): the host setup builds
    # Chebyshev smoothers around an SSOR SORPC
    pc = make_pc("mg", A=S, A_host=A, options=Options({
        "pc_mg_da": DA((9, 9)), "mg_levels_pc_type": "sor"}))
    assert all(type(lv.smoother.pc).__name__ == "SORPC" for lv in pc.levels)
    with pytest.raises(ValueError, match="host"):
        make_pc("mg", A=aij_from_scipy(A, device=CPU),
                options=Options({"pc_mg_da": DA((9, 9))}))
