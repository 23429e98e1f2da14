"""The port's ILU, ICC, SOR, block Jacobi and ASM preconditioners against
petsctpu's, and slice 5 whole (ex45 CG + bjacobi(8) ILU), on the CPU.

* Applies through make_pc with the reference's options, on the same
  input: within 1e-12 relative of the reference's apply in fp64 (the
  reference sums a row's slots with jnp.sum, the port in slot order).
  Covered: ILU(k) for k = 0-3, every ordering, ILUTP (drop tolerance,
  the dense and the level plans), transpose solves (ILUPCT) and the
  permuted transpose apply; ICC(k) with orderings and shift types; SOR
  with ω ≠ 1, its > 1, forward, backward and symmetric sweeps, scalar
  (-mat_no_inode) and inode; bjacobi; ASM/GASM with overlap 0-2,
  restricted and basic, sub-LU with its permutations and sub-orderings.
* convert.*_from_arrays: the reference's own plans carried across as
  numpy arrays give the reference's apply.
* Slice 5: ex45 16³ through KSP options, CG + bjacobi(8) ILU, in fp64 on
  AIJ and in fp32 on SELL (the reference with sub_pc_factor_tri_solve
  level there, its fp32 default being its MXU band route): equal its
  and reason, histories within 1e-12 (fp64) and 1e-4 (fp32) relative;
  and KSP with a host matrix and no pc_type builds ILU.
* The reference's native ILUDT (-pc_factor_drop_solver petsc) gives
  the reference's factors and apply; the reference's banded plans raise,
  naming their ROADMAP item. The SSOR MG level smoother (geometric and
  algebraic routes) matches the reference's.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse as sp
import torch

from petsctpu.core.options import Options as JOptions
from petsctpu.ksp import KSP as JKSP
from petsctpu.mat import aij_from_scipy as jaij_from_scipy
from petsctpu.mat.factory import mat_from_options as jmat_from_options
from petsctpu.pc import make_pc as jmake_pc
from petsctpu_torch import convert
from petsctpu_torch.core.options import Options
from petsctpu_torch.ksp import KSP
from petsctpu_torch.mat import aij_from_scipy, mat_from_options
from petsctpu_torch.models import ex2_system, ex45_system
from petsctpu_torch.pc import make_pc

# one intra-op thread: the suite runs in parallel workers (pytest -n), and
# PyTorch's default of a thread a core oversubscribes the host's cores
torch.set_num_threads(1)

CPU = "cpu"


def _rel(got, ref):
    got, ref = np.asarray(got), np.asarray(ref)
    assert got.shape == ref.shape
    return float(np.abs(got - ref).max() / np.abs(ref).max())


def _ex2():
    A = sp.csr_matrix(ex2_system(20, 20)[0])
    # a nonsymmetric part, so transposes and sweeps differ
    return (A + sp.diags(np.linspace(0.0, 0.4, A.shape[0] - 1), 1)).tocsr()


def _inode_matrix():
    """kron(ex2 6×6, a dense 3×3 block): rows of a node share a pattern."""
    L = sp.csr_matrix(ex2_system(6, 6)[0])
    B = np.array([[4.0, 1.0, 0.5], [1.0, 5.0, 1.0], [0.5, 1.0, 6.0]])
    return sp.csr_matrix(sp.kron(L, B))


def _pc_pair(pc_type, opts, A):
    pc = make_pc(pc_type, A=aij_from_scipy(A, device=CPU), A_host=A,
                 options=Options(dict(opts)))
    jpc = jmake_pc(pc_type, A=jaij_from_scipy(A), A_host=A,
                   options=JOptions(dict(opts)))
    return pc, jpc


def _check_apply(pc, jpc, n, transpose=False, seed=0):
    b = np.random.default_rng(seed).standard_normal(n)
    f, jf = ((pc.apply_transpose, jpc.apply_transpose) if transpose
             else (pc.apply, jpc.apply))
    got = f(torch.from_numpy(b)).numpy()
    assert _rel(got, jf(jnp.asarray(b))) <= 1e-12


ILU_CASES = {
    "ilu0": {}, "ilu1": {"pc_factor_levels": "1"},
    "ilu2": {"pc_factor_levels": "2"}, "ilu3": {"pc_factor_levels": "3"},
    **{f"ilu_{o}": {"pc_factor_mat_ordering_type": o}
       for o in ("rcm", "nd", "ndrb", "qmd", "md", "1wd")},
    "ilu1_qmd": {"pc_factor_levels": "1",
                 "pc_factor_mat_ordering_type": "qmd"},
    "ilutp_dense": {"pc_factor_drop_tolerance": "0.01"},
    "ilutp_level": {"pc_factor_drop_tolerance": "0.01",
                    "pc_factor_tri_solve": "level"},
    "ilu_level": {"pc_factor_tri_solve": "level"},
}


@pytest.mark.parametrize("case", list(ILU_CASES))
def test_ilu_apply_matches_reference(case):
    A = _ex2()
    pc, jpc = _pc_pair("ilu", ILU_CASES[case], A)
    _check_apply(pc, jpc, A.shape[0])
    if case.startswith("ilutp"):
        kind = "DenseTRSVPlan" if case == "ilutp_dense" else "SpTRSVPlan"
        assert type(pc.Lplan).__name__ == kind


@pytest.mark.parametrize("ordering", ["natural", "rcm"])
def test_ilu_transpose_solves_match_reference(ordering):
    A = _ex2()
    opts = {"pc_factor_transpose_solves": None,
            "pc_factor_mat_ordering_type": ordering, "pc_factor_levels": "1"}
    pc, jpc = _pc_pair("ilu", opts, A)
    assert pc.has_transpose
    _check_apply(pc, jpc, A.shape[0])
    _check_apply(pc, jpc, A.shape[0], transpose=True, seed=1)
    # the transpose apply is the adjoint of the apply
    x, y = np.random.default_rng(2).standard_normal((2, A.shape[0]))
    Mx = pc.apply(torch.from_numpy(x)).numpy()
    Mty = pc.apply_transpose(torch.from_numpy(y)).numpy()
    assert abs(y @ Mx - x @ Mty) <= 1e-12 * abs(y @ Mx)


ICC_CASES = {
    "icc0": {}, "icc1": {"pc_factor_levels": "1"},
    "icc2": {"pc_factor_levels": "2"},
    "icc_rcm": {"pc_factor_mat_ordering_type": "rcm"},
    "icc1_nd": {"pc_factor_levels": "1", "pc_factor_mat_ordering_type": "nd"},
    "icc_nonzero": {"pc_factor_shift_type": "nonzero"},
    "icc_none": {"pc_factor_shift_type": "none"},
}


@pytest.mark.parametrize("case", list(ICC_CASES))
def test_icc_apply_matches_reference(case):
    A = sp.csr_matrix(ex45_system(8, 8, 8)[0])
    pc, jpc = _pc_pair("icc", ICC_CASES[case], A)
    _check_apply(pc, jpc, A.shape[0])


def test_icc_manteuffel_shift_apply_matches_reference():
    A = sp.csr_matrix(ex2_system(12, 12)[0])
    A = (A - sp.diags(0.8 * A.diagonal())).tocsr()      # needs a shift
    pc, jpc = _pc_pair("icc", {}, A)
    _check_apply(pc, jpc, A.shape[0])


SOR_CASES = {
    "ssor": {}, "ssor_w15": {"pc_sor_omega": "1.5"},
    "ssor_its2": {"pc_sor_its": "2"},
    "sor_forward": {"pc_sor_forward": None},
    "sor_backward": {"pc_sor_backward": None},
    "ssor_no_inode": {"mat_no_inode": None},
    "ssor_w08_its3": {"pc_sor_omega": "0.8", "pc_sor_its": "3"},
}


@pytest.mark.parametrize("case", list(SOR_CASES))
@pytest.mark.parametrize("matrix", ["ex2", "inode"])
def test_sor_apply_matches_reference(matrix, case):
    A = _ex2() if matrix == "ex2" else _inode_matrix()
    opts = SOR_CASES[case]
    pc, jpc = _pc_pair("sor", opts, A)
    inode = matrix == "inode" and "mat_no_inode" not in opts \
        and "pc_sor_omega" not in opts
    assert type(pc).__name__ == type(jpc).__name__ == \
        ("InodeSORPC" if inode else "SORPC")
    _check_apply(pc, jpc, A.shape[0])


ASM_CASES = {
    "bjacobi4": ("bjacobi", {"pc_bjacobi_blocks": "4"}),
    "bjacobi3_lu": ("bjacobi", {"pc_bjacobi_blocks": "3",
                                "sub_pc_type": "lu"}),
    "bjacobi7": ("bjacobi", {"pc_bjacobi_blocks": "7"}),
    "asm_ov0": ("asm", {"pc_asm_blocks": "4", "pc_asm_overlap": "0"}),
    "asm_ov1": ("asm", {"pc_asm_blocks": "4"}),
    "asm_ov2": ("asm", {"pc_asm_blocks": "3", "pc_asm_overlap": "2"}),
    "asm_basic": ("asm", {"pc_asm_blocks": "4", "pc_asm_type": "basic"}),
    "asm_basic_ov2": ("asm", {"pc_asm_blocks": "2", "pc_asm_overlap": "2",
                              "pc_asm_type": "basic"}),
    "asm_lu_ov2": ("asm", {"pc_asm_blocks": "4", "pc_asm_overlap": "2",
                           "sub_pc_type": "lu"}),
    "asm_rcm": ("asm", {"pc_asm_blocks": "4",
                        "sub_pc_factor_mat_ordering_type": "rcm"}),
    "asm_qmd_ov2": ("asm", {"pc_asm_blocks": "3", "pc_asm_overlap": "2",
                            "sub_pc_factor_mat_ordering_type": "qmd"}),
    "gasm": ("gasm", {"pc_asm_blocks": "4", "pc_asm_overlap": "1"}),
}


@pytest.mark.parametrize("case", list(ASM_CASES))
def test_asm_apply_matches_reference(case):
    A = _ex2()
    pc_type, opts = ASM_CASES[case]
    pc, jpc = _pc_pair(pc_type, opts, A)
    assert pc.contiguous == jpc.contiguous
    assert pc.Lplans.stacked and pc.Lplans.level_rows.shape[0] == \
        pc.idx.shape[0]
    _check_apply(pc, jpc, A.shape[0])


def _plan_dict(p):
    return dict(level_rows=np.asarray(p.level_rows), cols=np.asarray(p.cols),
                vals=np.asarray(p.vals), dinv=np.asarray(p.dinv), n=p.n,
                nlev=p.nlev)


def test_convert_carries_the_reference_plans_across():
    from petsctpu.pc.asm import make_asm as jmake_asm
    from petsctpu.pc.factor import make_icc as jmake_icc
    from petsctpu.pc.factor import make_ilu as jmake_ilu
    from petsctpu.pc.sor import make_sor as jmake_sor

    A = _ex2()
    b = np.random.default_rng(3).standard_normal(A.shape[0])
    bt, bj = torch.from_numpy(b), jnp.asarray(b)
    j = jmake_ilu(A, levels=1, tri="level", transpose_solves=True)
    pc = convert.ilu_from_arrays(*(_plan_dict(getattr(j, s)) for s in (
        "Lplan", "Uplan", "LTplan", "UTplan")), device=CPU)
    assert _rel(pc.apply(bt).numpy(), j.apply(bj)) <= 1e-12
    assert _rel(pc.apply_transpose(bt).numpy(), j.apply_transpose(bj)) \
        <= 1e-12
    j = jmake_ilu(A, ordering="rcm", tri="level")
    pc = convert.ilu_from_arrays(_plan_dict(j.inner.Lplan),
                                 _plan_dict(j.inner.Uplan),
                                 perm=np.asarray(j.perm), device=CPU)
    assert _rel(pc.apply(bt).numpy(), j.apply(bj)) <= 1e-12
    S = sp.csr_matrix(ex45_system(6, 6, 6)[0])
    j = jmake_icc(S, levels=1, tri="level")
    pc = convert.icc_from_arrays(_plan_dict(j.Lplan), _plan_dict(j.Uplan),
                                 np.asarray(j.dinv), device=CPU)
    bs = np.random.default_rng(4).standard_normal(S.shape[0])
    assert _rel(pc.apply(torch.from_numpy(bs)).numpy(),
                j.apply(jnp.asarray(bs))) <= 1e-12
    j = jmake_sor(A, omega=1.3, sweeps=2)
    U_ell, L_ell = ((np.asarray(e.cols), np.asarray(e.vals), e.shape, e.nnz)
                    for e in (j.U_ell, j.L_ell))
    pc = convert.sor_from_arrays(
        _plan_dict(j.fwd_plan), _plan_dict(j.bwd_plan), U_ell, L_ell,
        np.asarray(j.diag), j.omega, j.sweeps, j.symmetric, device=CPU)
    assert _rel(pc.apply(bt).numpy(), j.apply(bj)) <= 1e-12
    for kw in (dict(nblocks=4, overlap=1), dict(nblocks=3, overlap=2,
                                                sub_pc="lu"),
               dict(nblocks=4, overlap=0, restricted=False)):
        j = jmake_asm(A, tri="level", **kw)
        pc = convert.asm_from_arrays(
            np.asarray(j.idx), np.asarray(j.own), np.asarray(j.valid),
            _plan_dict(j.Lplans), _plan_dict(j.Uplans),
            np.asarray(j.perm_r), np.asarray(j.perm_c), j.n, j.restricted,
            j.use_perm, j.contiguous, device=CPU)
        assert _rel(pc.apply(bt).numpy(), j.apply(bj)) <= 1e-12


SLICE5 = {"ksp_type": "cg", "pc_type": "bjacobi", "pc_bjacobi_blocks": "8",
          "sub_pc_type": "ilu", "ksp_rtol": "1e-5"}


def test_slice5_fp64_aij_matches_reference():
    A, b, _ = ex45_system(16, 16, 16)
    ksp = KSP(Options(dict(SLICE5)))
    ksp.set_operators(aij_from_scipy(A, device=CPU), A)
    res = ksp.solve(torch.from_numpy(b))
    jksp = JKSP(JOptions(dict(SLICE5)))
    jksp.set_operators(jaij_from_scipy(A), A)
    jres = jksp.solve(jnp.asarray(b))
    its = int(res.its)
    assert (its, int(res.reason)) == (int(jres.its), int(jres.reason))
    assert int(res.reason) > 0 and ksp.pc.Lplans.level_rows.shape[0] == 8
    jh = np.asarray(jres.history)[:its + 1]
    np.testing.assert_allclose(res.history[:its + 1].numpy(), jh,
                               rtol=1e-12, atol=1e-13 * jh[0])
    np.testing.assert_allclose(res.x.numpy(), np.asarray(jres.x), rtol=0,
                               atol=1e-10)


def test_slice5_fp32_sell_matches_reference():
    A, b, _ = ex45_system(16, 16, 16)
    mopts = {"mat_type": "sell", "mat_ordering_type": "natural"}
    M, perm = mat_from_options(A, Options(mopts), device=CPU)
    J, jperm = jmat_from_options(A, JOptions(mopts))
    np.testing.assert_array_equal(perm, jperm)
    b32 = b.astype(np.float32)
    ksp = KSP(Options(dict(SLICE5)))
    ksp.set_operators(M, A)
    res = ksp.solve(torch.from_numpy(b32))
    jksp = JKSP(JOptions({**SLICE5, "sub_pc_factor_tri_solve": "level"}))
    jksp.set_operators(J, A)
    jres = jksp.solve(jnp.asarray(b32))
    its = int(res.its)
    assert res.history.dtype == torch.float32
    assert ksp.pc.Lplans.dtype == torch.float32
    assert (its, int(res.reason)) == (int(jres.its), int(jres.reason))
    assert int(res.reason) > 0
    jh = np.asarray(jres.history)[:its + 1]
    np.testing.assert_allclose(res.history[:its + 1].numpy(), jh, rtol=1e-4)
    x = res.x.double().numpy()
    assert np.linalg.norm(b - A @ x) / np.linalg.norm(b) <= 1e-4


def test_ksp_default_pc_with_host_matrix_is_ilu():
    A, b, _ = ex2_system(10, 10)
    ksp = KSP(Options({"ksp_type": "gmres"}))
    ksp.set_operators(aij_from_scipy(A, device=CPU), A_host=A)
    res = ksp.solve(torch.from_numpy(b))
    jksp = JKSP(JOptions({"ksp_type": "gmres"}))
    jksp.set_operators(jaij_from_scipy(A), A)
    jres = jksp.solve(jnp.asarray(b))
    assert type(ksp.pc).__name__ == "ILUPC"
    assert int(res.its) == int(jres.its) and int(res.reason) > 0
    np.testing.assert_allclose(res.history[:int(res.its) + 1].numpy(),
                               np.asarray(jres.history)[:int(res.its) + 1],
                               rtol=1e-10)


@pytest.mark.parametrize("drop", ["0.01", "0.005,0,3", "0.1"])
def test_native_iludt_matches_reference(drop):
    from petsctpu.pc.factor import iludt_factor_host as jiludt
    from petsctpu_torch.pc.factor import iludt_factor_host

    A = _ex2()
    opts = {"pc_factor_drop_tolerance": drop,
            "pc_factor_drop_solver": "petsc"}
    pc, jpc = _pc_pair("ilu", opts, A)
    assert type(pc).__name__ == "ILUPC"
    _check_apply(pc, jpc, A.shape[0])
    parts = [float(x) for x in drop.split(",")]
    kw = dict(dt=parts[0], dtcount=int(parts[2]) if len(parts) > 2 else None)
    for got, ref in zip(iludt_factor_host(A, **kw), jiludt(A, **kw)):
        np.testing.assert_array_equal(got.toarray(), ref.toarray())


@pytest.mark.parametrize("pc_type,opts,match", [
    ("ilu", {"pc_factor_tri_solve": "band"}, "BandTRSVPlan"),
    ("ilu", {"pc_factor_tri_solve": "band2"}, "BandTRSVHierPlan"),
    ("icc", {"pc_factor_tri_solve": "band2"}, "BandTRSVHierPlan"),
    ("asm", {"sub_pc_factor_tri_solve": "band2"}, "StackedPlans"),
])
def test_unported_routes_raise(pc_type, opts, match):
    """These routes raised until slice 12 ported the banded plans; each
    now builds its plans and solves as the level route does (tests/
    test_torch_band_trsv.py holds them to petsctpu's)."""
    A = sp.csr_matrix(ex2_system(6, 6)[0])
    Ad = aij_from_scipy(A, device=CPU)
    pc = make_pc(pc_type, A=Ad, A_host=A, options=Options(opts))
    plan = getattr(pc, "Lplan", None) or getattr(pc, "Lplans", None)
    assert type(plan).__name__ == match
    ref = make_pc(pc_type, A=Ad, A_host=A)
    b = torch.from_numpy(np.random.default_rng(0).standard_normal(36))
    np.testing.assert_allclose(pc.apply(b).numpy(), ref.apply(b).numpy(),
                               rtol=1e-11, atol=1e-12)


@pytest.mark.parametrize("pc_type", ["ilu", "icc", "sor", "bjacobi", "asm"])
def test_host_matrix_is_required(pc_type):
    A = sp.csr_matrix(ex2_system(4, 4)[0])
    with pytest.raises(ValueError, match="host"):
        make_pc(pc_type, A=aij_from_scipy(A, device=CPU))


@pytest.mark.parametrize("route", ["geometric", "algebraic"])
def test_ssor_mg_smoother_matches_reference(route):
    """Chebyshev around an SSOR SORPC on every level: -mg_levels_pc_type
    sor on the geometric host setup, and sm_pc="sor" in
    make_algebraic_mg_from_hierarchy (on the reference's GAMG
    hierarchy); bounds from the host Arnoldi estimate equal the
    reference's, the MG apply within 1e-12 of the reference's, and a CG
    solve gives equal its and reason."""
    from petsctpu.dm import DA as JDA
    from petsctpu.ksp import ksp_solve as jksp_solve
    from petsctpu.mat import stencil as jst
    from petsctpu.pc import gamg as jgamg
    from petsctpu.pc import mg as jmg
    from petsctpu_torch.dm import DA
    from petsctpu_torch.ksp import ksp_solve
    from petsctpu_torch.mat.stencil import stencil_from_scipy
    from petsctpu_torch.pc.mg import make_algebraic_mg_from_hierarchy

    A, b, _ = ex2_system(33, 33)
    A = sp.csr_matrix(A)
    if route == "geometric":
        flags = {"mg_levels_pc_type": "sor"}
        Ad, Aj = (stencil_from_scipy(A, (33, 33), device=CPU),
                  jst.stencil_from_scipy(A, (33, 33)))
        pc = make_pc("mg", A=Ad, A_host=A, options=Options(
            {**flags, "pc_mg_da": DA((33, 33))}))
        jpc = jmake_pc("mg", A=Aj, A_host=A, options=JOptions(
            {**flags, "pc_mg_da": JDA((33, 33))}))
    else:
        As, Ps = jgamg.gamg_hierarchy(A, coarse_n=64)
        Ad, Aj = aij_from_scipy(A, device=CPU), jaij_from_scipy(A)
        pc = make_algebraic_mg_from_hierarchy(As, Ps, sm_pc="sor", fmt="ell",
                                              device=CPU)
        jpc = jmg.make_algebraic_mg_from_hierarchy(As, Ps, sm_pc="sor",
                                                   fmt="ell")
    assert len(pc.levels) == len(jpc.levels) > 1
    for lv, jlv in zip(pc.levels, jpc.levels):
        assert type(lv.smoother.pc).__name__ == "SORPC"
        assert lv.smoother.emax == pytest.approx(float(jlv.smoother.emax),
                                                 rel=1e-12)
    _check_apply(pc, jpc, A.shape[0])
    kw = dict(ksp_type="cg", rtol=1e-8)
    res = ksp_solve(Ad, torch.from_numpy(b), pc=pc, **kw)
    jres = jksp_solve(Aj, jnp.asarray(b), pc=jpc, **kw)
    its = int(res.its)
    assert (its, int(res.reason)) == (int(jres.its), int(jres.reason))
    assert int(res.reason) > 0
    np.testing.assert_allclose(res.history[:its + 1].numpy(),
                               np.asarray(jres.history)[:its + 1],
                               rtol=1e-10)
