"""The KSP types of ROADMAP queue 1 item 7 through the port, against
petsctpu's, on the CPU in fp64.

Every name of petsctpu's KSP_REGISTRY runs on the same numpy-seeded
system through `petsctpu.ksp.ksp_solve` and `petsctpu_torch`'s
(`device="cpu"`): equal its and reason, the history within rtol 1e-10
(atol 1e-13·‖r0‖ for entries at rounding noise) and x within atol
1e-10. The symmetric types run on ex2 (8×7, SPD), the others on a
nonsymmetric convection-shifted 2-D Laplacian (8×8, +0.4 on the
superdiagonal), each with Jacobi, to rtol 1e-7. Each system is one on
which the type's stream is not chaotic: the port's own solve with b
and with b·(1 + 1e-15·noise) agrees to better than 1e-10. That is why
TCQMR, LSQR and CGNE run on the nonsymmetric Laplacian + 4I (on the
plain one they amplify that change to 2e-3–0.3 by iterations 25–50),
DGMRES on the SPD system (on a nonsymmetric one its Ritz basis takes a
direction set by rounding, ROADMAP queue 3), and the symmetric
indefinite cases on a shift with distinct eigenvalues, to rtol 1e-5
(MINRES, SYMMLQ and CR reach exact termination on a Laplacian's
repeated eigenvalues, where the last entries are noise). Then: the factor PCs (ILU with transpose solves, ICC,
SSOR) under the types that take them; the estimators with the chebyest
golden digits; DGMRES, LGMRES (augmentation 0 is GMRES bit for bit),
STCG's radius, SpecEstPC with fgmres_host, the Fischer guess, the null
space, mixed-precision refinement, complex128, and one host copy an
iteration for BiCGStab, TFQMR and MINRES.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse as sp
import torch

from petsctpu.core.options import Options as JOptions
from petsctpu.ksp import KSP as JKSP
from petsctpu.ksp import ksp_solve as jksp_solve
from petsctpu.ksp.api import KSP_REGISTRY as JREGISTRY
from petsctpu.mat import aij_from_scipy as jaij
from petsctpu.pc import make_pc as jmake_pc

from petsctpu_torch.core.options import Options
from petsctpu_torch.ksp import KSP, ksp_solve
from petsctpu_torch.ksp import api as tapi
from petsctpu_torch.mat import aij_from_scipy
from petsctpu_torch.models import ex2_system, laplacian_2d
from petsctpu_torch.pc import make_pc

# one intra-op thread: the suite runs in parallel workers (pytest -n), and
# PyTorch's default of a thread a core oversubscribes the host's cores
torch.set_num_threads(1)

CPU = "cpu"


def nonsym(n=8):
    A = laplacian_2d(n, n).tolil()
    for i in range(n * n - 1):
        A[i, i + 1] += 0.4
    return A.tocsr()


def spd():
    return sp.csr_matrix(ex2_system(8, 7)[0])


def wellcond():
    """nonsym() + 4I: κ about 3, for the types on the normal equations
    and TCQMR, which amplify rounding on nonsym() itself."""
    return (nonsym() + 4.0 * sp.eye(64)).tocsr()


def indefinite():
    """A symmetric indefinite Laplacian shift, its eigenvalues made
    distinct by a small random diagonal."""
    rng = np.random.default_rng(3)
    return (laplacian_2d(8, 8) - 0.75 * sp.eye(64)
            + sp.diags(rng.uniform(0, 0.05, 64))).tocsr()


def rhs(A, seed=0):
    return np.random.default_rng(seed).standard_normal(A.shape[0])


SYM = {"cg", "pipecg", "groppcg", "cr", "pipecr", "minres", "symmlq",
       "stcg", "nash", "gltr", "qcg", "chebyshev", "specest",
       "richardson", "preonly", "dgmres", "agmres"}
WELLCOND = {"cgne", "lsqr", "tcqmr"}
EXTRA = {"chebyshev": dict(cheby_emin=0.1, cheby_emax=2.2),
         "richardson": dict(richardson_scale=0.9),
         "gcr": dict(restart=10), "lcd": dict(restart=10),
         "lgmres": dict(restart=10), "dgmres": dict(restart=10),
         "agmres": dict(restart=10), "fgmres_host": dict(restart=10),
         "bcgsl": dict(bcgsl_ell=3)}


def both(A, b, ksp_type, pc_type="jacobi", opts=None, **kw):
    """(petsctpu's result, the port's) of one solve."""
    opts = opts or {}
    J = jaij(A)
    T = aij_from_scipy(A, device=CPU)
    jpc = None if pc_type == "none" else jmake_pc(
        pc_type, A=J, A_host=A, options=JOptions(dict(opts)))
    tpc = None if pc_type == "none" else make_pc(
        pc_type, A=T, A_host=A, options=Options(dict(opts)))
    jr = jksp_solve(J, jnp.asarray(b), pc=jpc, ksp_type=ksp_type, **kw)
    tr = ksp_solve(T, torch.from_numpy(b), pc=tpc, ksp_type=ksp_type, **kw)
    return jr, tr


def assert_same(jr, tr, x_atol=1e-10, rtol=1e-10, atol=None):
    its, reason = int(jr.its), int(jr.reason)
    assert (int(tr.its), int(tr.reason)) == (its, reason)
    # petsctpu's dgmres and fgmres_host return a complex solve's
    # history in the solve's dtype; its entries are real
    jh = np.real(np.asarray(jr.history))
    th = tr.history.numpy()
    assert th.dtype == jh.dtype and th.shape == jh.shape
    live = ~np.isnan(jh)
    np.testing.assert_array_equal(np.isnan(th), ~live)
    atol = 1e-13 * np.abs(jh[0]) if atol is None else atol
    np.testing.assert_allclose(th[live], jh[live], rtol=rtol, atol=atol)
    np.testing.assert_allclose(tr.x.numpy(), np.asarray(jr.x), rtol=0,
                               atol=x_atol)
    np.testing.assert_allclose(float(tr.rnorm), np.real(jr.rnorm),
                               rtol=rtol, atol=atol)


def test_registry_is_petsctpus():
    assert set(tapi.KSP_REGISTRY) == set(JREGISTRY)
    assert not hasattr(tapi, "_LATER")
    assert tapi.HOST_DRIVEN == {"dgmres", "agmres", "fgmres_host"}


@pytest.mark.parametrize("ksp_type", sorted(JREGISTRY))
def test_type_matches_jax(ksp_type):
    A = spd() if ksp_type in SYM else \
        wellcond() if ksp_type in WELLCOND else nonsym()
    b = rhs(A)
    jr, tr = both(A, b, ksp_type, rtol=1e-7, maxits=400,
                  **EXTRA.get(ksp_type, {}))
    assert int(jr.reason) > 0
    assert_same(jr, tr)


# the factor PCs under the types that take them (ILU with transpose
# solves where the type applies Mᵀ)
FACTOR_CASES = {
    "bcgs_ilu1": ("bcgs", "ilu", {"pc_factor_levels": "1"}),
    "bicg_ilu_transpose": ("bicg", "ilu",
                           {"pc_factor_transpose_solves": "true"}),
    "cgne_ilu_transpose": ("cgne", "ilu",
                           {"pc_factor_transpose_solves": "true"}),
    "tfqmr_ssor": ("tfqmr", "sor", {}),
    "minres_icc": ("minres", "icc", {}),
    "symmlq_ssor": ("symmlq", "sor", {"pc_sor_symmetric": "true"}),
    "bcgsl_ilu": ("bcgsl", "ilu", {}),
    "ibcgs_ilu": ("ibcgs", "ilu", {}),
    "cr_bjacobi_icc": ("cr", "bjacobi", {"pc_bjacobi_blocks": "4",
                                         "sub_pc_type": "icc"}),
    "bcgs_bjacobi_ilu": ("bcgs", "bjacobi", {"pc_bjacobi_blocks": "8",
                                             "sub_pc_type": "ilu"}),
}


@pytest.mark.parametrize("case", sorted(FACTOR_CASES))
def test_type_with_factor_pc_matches_jax(case):
    ksp_type, pc_type, opts = FACTOR_CASES[case]
    A = spd() if ksp_type in SYM else nonsym()
    jr, tr = both(A, rhs(A, 1), ksp_type, pc_type, opts, rtol=1e-7,
                  maxits=400)
    assert int(jr.reason) > 0
    assert_same(jr, tr)


@pytest.mark.parametrize("extra", [
    dict(norm_type="none", maxits=12),              # capped: max_it + 1
    dict(norm_type="unpreconditioned"),
    dict(guess_nonzero=True)], ids=["norm_none", "unpreconditioned",
                                    "nonzero_guess"])
@pytest.mark.parametrize("ksp_type", ["chebyshev", "richardson"])
def test_smoother_options_match_jax(ksp_type, extra):
    A = spd()
    b = rhs(A, 2)
    kw = {**EXTRA[ksp_type], "rtol": 1e-7, "maxits": 400, **extra}
    if extra.get("guess_nonzero"):
        x0 = rhs(A, 3)
        J, T = jaij(A), aij_from_scipy(A, device=CPU)
        jr = jksp_solve(J, jnp.asarray(b), jnp.asarray(x0),
                        pc=jmake_pc("jacobi", A=J), ksp_type=ksp_type, **kw)
        tr = ksp_solve(T, torch.from_numpy(b), torch.from_numpy(x0),
                       pc=make_pc("jacobi", A=T), ksp_type=ksp_type, **kw)
    else:
        jr, tr = both(A, b, ksp_type, **kw)
    assert_same(jr, tr)


def test_richardson_self_scale_and_auto_chebyshev_match_jax():
    A = spd()
    b = rhs(A, 4)
    assert_same(*both(A, b, "richardson", rtol=1e-7, maxits=400,
                      richardson_self_scale=True))
    assert_same(*both(A, b, "chebyshev", rtol=1e-7, maxits=400))


def test_estimators_match_jax():
    """The power-iteration and Arnoldi estimates of M⁻¹A, and the
    KSPComputeEigenvalues / ExtremeSingularValues analogs."""
    from petsctpu.ksp import cheby as jcheby
    from petsctpu_torch.ksp import cheby

    A = nonsym()
    b = rhs(A, 5)
    J, T = jaij(A), aij_from_scipy(A, device=CPU)
    jpc, tpc = jmake_pc("jacobi", A=J), make_pc("jacobi", A=T)
    lam_j = jcheby.estimate_lambda_max(J, jpc, A.shape[0], jnp.float64)
    lam_t = cheby.estimate_lambda_max(T, tpc, A.shape[0], torch.float64,
                                      device=CPU)
    np.testing.assert_allclose(float(lam_t), float(lam_j), rtol=1e-12)
    jb, tb = jnp.asarray(b), torch.from_numpy(b)
    for fn in ("estimate_eigen_arnoldi", "estimate_extreme_singular_arnoldi"):
        np.testing.assert_allclose(getattr(cheby, fn)(T, tpc, tb),
                                   getattr(jcheby, fn)(J, jpc, jb),
                                   rtol=1e-10)
    np.testing.assert_allclose(
        cheby.ksp_compute_extreme_singular_values(T, tpc, tb),
        jcheby.ksp_compute_extreme_singular_values(J, jpc, jb), rtol=1e-9)
    ev_t = np.sort_complex(cheby.ksp_compute_eigenvalues(T, tpc, tb))
    ev_j = np.sort_complex(jcheby.ksp_compute_eigenvalues(J, jpc, jb))
    np.testing.assert_allclose(ev_t, ev_j, rtol=1e-8)
    np.testing.assert_allclose(
        cheby._arnoldi_hessenberg(T, tpc, tb, 10),
        jcheby._arnoldi_hessenberg(J, jpc, jb, 10), rtol=1e-10, atol=1e-12)
    from petsctpu.ksp.specest import _arnoldi_ritz as j_ritz
    from petsctpu_torch.ksp.specest import _arnoldi_ritz
    np.testing.assert_allclose(np.sort_complex(_arnoldi_ritz(T, tpc, tb, 8)),
                               np.sort_complex(j_ritz(J, jpc, jb, 8)),
                               rtol=1e-10)


def test_chebyest_golden_singular_values():
    """ex2_chebyest_1's estimator (tests/test_ksp_extra.py:71): the
    10-step est-GMRES with ILU(0) on the 80×80 ex2 system gives the
    golden (σmin, σmax) = (0.0357405, 1.1495838)."""
    from petsctpu_torch.ksp.cheby import estimate_extreme_singular_arnoldi

    A, b, _ = ex2_system(80, 80)
    T = aij_from_scipy(A, device=CPU)
    smin, smax = estimate_extreme_singular_arnoldi(
        T, make_pc("ilu", A=T, A_host=sp.csr_matrix(A)),
        torch.from_numpy(np.asarray(b)), 10)
    np.testing.assert_allclose(smin, 0.035740492906, rtol=1e-9)
    np.testing.assert_allclose(smax, 1.149583756006, rtol=1e-9)


def test_dgmres_deflation_matches_jax():
    """The shifted Laplacian of tests/test_ksp_more.py:165: deflated
    restarts against petsctpu's, with the cycles' Ritz extraction."""
    A = (laplacian_2d(12, 12) - 0.55 * sp.eye(144)).tocsr()
    b = np.ones(144)
    jr, tr = both(A, b, "dgmres", "none", restart=15, rtol=1e-8,
                  maxits=2000)
    assert int(jr.reason) > 0
    assert_same(jr, tr, x_atol=1e-9)
    g = ksp_solve(aij_from_scipy(A, device=CPU), torch.from_numpy(b),
                  ksp_type="gmres", restart=15, rtol=1e-8, maxits=2000)
    assert int(tr.its) < 0.7 * int(g.its)


def test_dgmres_fp32_sell_deflates():
    """DGMRES(10) + Jacobi in fp32 on the SELL operator (ex45 16³):
    deflated restarts in fp32, against petsctpu's on its SELL operator.
    fp32 dot products round differently in XLA and PyTorch, so its may
    move by a cycle; both must converge to a true residual ≤ 1e-4."""
    from petsctpu.mat import sell as jsell
    from petsctpu_torch.mat.sell import sell_from_scipy
    from petsctpu_torch.models import ex45_system

    A, b, _ = ex45_system(16, 16, 16)
    b32 = b.astype(np.float32)
    J = jsell.sell_from_scipy(A, G=8)
    T = sell_from_scipy(A, G=8, device=CPU)
    kw = dict(ksp_type="dgmres", restart=10, rtol=1e-5, maxits=400)
    jr = jksp_solve(J, jnp.asarray(b32), pc=jmake_pc("jacobi", A=J), **kw)
    tr = ksp_solve(T, torch.from_numpy(b32), pc=make_pc("jacobi", A=T),
                   **kw)
    assert int(tr.reason) == int(jr.reason) > 0
    assert abs(int(tr.its) - int(jr.its)) <= 10
    assert tr.x.dtype == torch.float32
    x = tr.x.double().numpy()
    assert np.linalg.norm(b - A @ x) <= 1e-4 * np.linalg.norm(b)


def test_lgmres_augment0_is_gmres_bit_for_bit():
    A = nonsym(10)
    T = aij_from_scipy(A, device=CPU)
    b = torch.ones(100, dtype=torch.float64)
    plain = ksp_solve(T, b, ksp_type="gmres", restart=8, rtol=1e-9,
                      maxits=400)
    aug0 = ksp_solve(T, b, ksp_type="lgmres", restart=8, aug_dim=0,
                     rtol=1e-9, maxits=400)
    assert int(aug0.its) == int(plain.its)
    np.testing.assert_array_equal(aug0.history.numpy(),
                                  plain.history.numpy())
    assert torch.equal(aug0.x, plain.x)
    jr, tr = both(A, np.ones(100), "lgmres", "none", restart=12, aug_dim=4,
                  rtol=1e-9, maxits=400)
    assert_same(jr, tr)


@pytest.mark.parametrize("ksp_type,radius,system", [
    ("stcg", 0.5, "spd"), ("nash", 2.0, "spd"), ("gltr", 2.0, "indefinite"),
    ("gltr", 1e3, "indefinite"), ("qcg", 0.0, "spd")])
def test_trust_region_radius_matches_jax(ksp_type, radius, system):
    """-ksp_cg_radius: the step to the sphere ends the solve with
    CONVERGED_CG_CONSTRAINED, negative curvature with
    CONVERGED_CG_NEG_CURVE (radius 0: unconstrained)."""
    A = spd() if system == "spd" else indefinite()
    jr, tr = both(A, rhs(A, 6), ksp_type, "none", rtol=1e-7, maxits=300,
                  radius=radius)
    assert_same(jr, tr)
    want = {0.0: 2, 0.5: 6, 2.0: 6, 1e3: 5}[radius]
    assert int(tr.reason) == want
    if radius:
        np.testing.assert_allclose(float(torch.linalg.norm(tr.x)), radius,
                                   rtol=1e-10)


@pytest.mark.parametrize("ksp_type", ["symmlq", "cr", "minres"])
def test_symmetric_indefinite_matches_jax(ksp_type):
    A = indefinite()
    jr, tr = both(A, rhs(A, 7), ksp_type, "none", rtol=1e-5, maxits=500)
    assert int(jr.reason) > 0
    assert_same(jr, tr)


@pytest.mark.parametrize("est_type,cheap_type", [
    ("gmres", "chebyshev"), ("cg", "chebyshev"), ("gmres", "richardson")])
def test_specest_pc_with_fgmres_host_matches_jax(est_type, cheap_type):
    """KSPSPECEST as a host-stateful PC: ksp_solve routes fgmres to the
    host-driven flexible GMRES, the first apply estimates, the rest
    run the cheap smoother."""
    from petsctpu.ksp.specest import SpecEstPC as JSpecEst
    from petsctpu.pc.simple import make_jacobi as jmake_jacobi
    from petsctpu_torch.ksp.specest import SpecEstPC
    from petsctpu_torch.pc.simple import make_jacobi

    A = spd()
    b = rhs(A, 8)
    J, T = jaij(A), aij_from_scipy(A, device=CPU)
    jpc = JSpecEst(J, jmake_jacobi(J), est_type=est_type,
                   cheap_type=cheap_type)
    tpc = SpecEstPC(T, make_jacobi(T), est_type=est_type,
                    cheap_type=cheap_type)
    kw = dict(ksp_type="fgmres", rtol=1e-9, maxits=200, restart=30)
    jr = jksp_solve(J, jnp.asarray(b), pc=jpc, **kw)
    tr = ksp_solve(T, torch.from_numpy(b), pc=tpc, **kw)
    assert tpc.current and jpc.current
    np.testing.assert_allclose((tpc.emin, tpc.emax, tpc.radius),
                               (jpc.emin, jpc.emax, jpc.radius), rtol=1e-10)
    assert int(tr.reason) > 0
    assert_same(jr, tr)


def neumann_1d(n):
    d = 2.0 * np.ones(n)
    d[0] = d[-1] = 1.0
    return sp.diags([-np.ones(n - 1), d, -np.ones(n - 1)],
                    [-1, 0, 1]).tocsr()


def test_nullspace_matches_jax():
    """ksp_solve(nullspace=) on the singular Neumann Laplacian (CG) and
    on a user-vector null space (GMRES), and KSP.set_nullspace."""
    from petsctpu.mat.nullspace import make_nullspace as jmake_nullspace
    from petsctpu_torch.mat.nullspace import make_nullspace

    n = 50
    A = neumann_1d(n)
    b = rhs(A, 9)
    b -= b.mean()                       # consistent
    J, T = jaij(A), aij_from_scipy(A, device=CPU)
    jn = jmake_nullspace(n, has_constant=True)
    tn = make_nullspace(n, has_constant=True, device=CPU)
    assert tn.test(T)
    kw = dict(ksp_type="cg", rtol=1e-10, maxits=300)
    jr = jksp_solve(J, jnp.asarray(b), nullspace=jn, **kw)
    tr = ksp_solve(T, torch.from_numpy(b), nullspace=tn, **kw)
    assert_same(jr, tr)
    assert abs(float(tr.x.mean())) < 1e-10
    ksp = KSP(Options({"ksp_type": "cg", "ksp_rtol": "1e-10",
                       "pc_type": "jacobi"}))
    ksp.set_operators(T).set_nullspace(tn)
    jksp = JKSP(JOptions({"ksp_type": "cg", "ksp_rtol": "1e-10",
                          "pc_type": "jacobi"}))
    jksp.set_operators(J).set_nullspace(jn)
    assert_same(jksp.solve(jnp.asarray(b)), ksp.solve(torch.from_numpy(b)))

    v = np.zeros(20)
    v[3] = 1.0
    D = sp.diags(np.r_[np.arange(1.0, 4), 0.0, np.arange(5.0, 21)]).tocsr()
    tn = make_nullspace(20, has_constant=False, vecs=[v], device=CPU)
    jn = jmake_nullspace(20, has_constant=False, vecs=[v])
    np.testing.assert_array_equal(tn.vecs.numpy(), np.asarray(jn.vecs))
    assert tn.test(aij_from_scipy(D, device=CPU))
    bd = np.ones(20)
    bd[3] = 0.0
    kw = dict(ksp_type="gmres", rtol=1e-12, maxits=60)
    jr = jksp_solve(jaij(D), jnp.asarray(bd), nullspace=jn, **kw)
    tr = ksp_solve(aij_from_scipy(D, device=CPU), torch.from_numpy(bd),
                   nullspace=tn, **kw)
    assert_same(jr, tr)
    assert make_nullspace(10, has_constant=True, device=CPU,
                          vecs=[np.ones(10), np.arange(10.0)]).vecs.shape[0] \
        == 1


@pytest.mark.parametrize("model,ksp_type", [(1, "cg"), (2, "gmres")])
def test_fischer_guess_sequence_matches_jax(model, ksp_type):
    """KSP.set_use_fischer_guess over a slowly rotating RHS family: each
    solve's its, reason and history against petsctpu's."""
    A = laplacian_2d(16, 16)
    n = A.shape[0]
    opts = {"ksp_type": ksp_type, "ksp_rtol": "1e-14", "ksp_atol": "1e-6",
            "ksp_max_it": "400", "pc_type": "jacobi"}
    ksp = KSP(Options(dict(opts)))
    ksp.set_operators(aij_from_scipy(A, device=CPU), A)
    ksp.set_use_fischer_guess(model=model, size=4)
    jksp = JKSP(JOptions(dict(opts)))
    jksp.set_operators(jaij(A), A)
    jksp.set_use_fischer_guess(model=model, size=4)
    xs = np.linspace(0, 1, n)
    its = []
    for k in range(6):
        b = np.sin(2 * np.pi * (xs + 0.05 * k)) + 0.5
        jr = jksp.solve(jnp.asarray(b))
        tr = ksp.solve(torch.from_numpy(b))
        # the guess solves the normal equations of nearly dependent
        # stored solutions (regularized at 1e-12): their rounding moves
        # x0's residual by up to 1e-11·‖b‖
        assert_same(jr, tr, x_atol=1e-9, atol=1e-11 * np.linalg.norm(b))
        its.append(int(tr.its))
    assert min(its[2:]) < its[0]


def test_solve_ir_matches_jax():
    """Mixed-precision refinement: fp32 inner GMRES + Jacobi on AIJ
    (one CGS refinement pass, as tests/test_torch_ksp.py's fp32 GMRES
    comparison: XLA:CPU's fp32 vdot is the less accurate of the two),
    fp64 residuals. fp32 dot products and products round differently in
    XLA and PyTorch, so the inner its may move and each sweep's residual
    (at 1e-5, 1e-10, 1e-15 of ‖b‖) differs by up to 50 % and the total
    of inner its by 7 % (measured); the sweeps, the reason, each sweep's
    residual within a factor 2, the inner its within 10 % and the fp64
    accuracy must agree."""
    from petsctpu.ksp.common import KSPConfig as JKSPConfig
    from petsctpu.ksp.mixed import solve_ir as jsolve_ir
    from petsctpu_torch.ksp.common import KSPConfig
    from petsctpu_torch.ksp.mixed import solve_ir

    A, b, u = ex2_system(16, 16)
    A = sp.csr_matrix(A)
    J32 = jaij(A, dtype=np.float32)
    T32 = aij_from_scipy(A, dtype=np.float32, device=CPU)
    inner = dict(ksp_type="gmres", rtol=1e-5, maxits=200,
                 cgs_refine="always")
    jr = jsolve_ir(jaij(A), J32, np.asarray(b),
                   pc32=jmake_pc("jacobi", A=J32), rtol=1e-12,
                   inner_cfg=JKSPConfig(**inner))
    tr = solve_ir(aij_from_scipy(A, device=CPU), T32,
                  torch.from_numpy(np.asarray(b)),
                  pc32=make_pc("jacobi", A=T32), rtol=1e-12,
                  inner_cfg=KSPConfig(**inner))
    assert int(tr.reason) == int(jr.reason) > 0
    jh, th = np.asarray(jr.history), tr.history.numpy()
    np.testing.assert_array_equal(np.isnan(th), np.isnan(jh))
    live = ~np.isnan(jh)
    assert th[0] == jh[0]
    assert np.all((th[live] > 0.5 * jh[live]) & (th[live] < 2 * jh[live]))
    assert abs(int(tr.its) - int(jr.its)) <= 0.1 * int(jr.its)
    assert np.abs(tr.x.numpy() - u).max() < 1e-11


def _hermitian_pd(m=8, seed=0):
    n = m * m
    rng = np.random.default_rng(seed)
    L = laplacian_2d(m, m).astype(np.complex128) + 0.3 * sp.eye(n)
    D = sp.diags(np.exp(1j * rng.uniform(0, 2 * np.pi, n)))
    return (D.getH() @ L @ D).tocsr(), rng


HERM_KSP = ["cg", "cgne", "groppcg", "pipecg", "minres", "symmlq", "cr",
            "pipecr", "chebyshev", "stcg", "nash", "gltr", "qcg", "lsqr",
            "ibcgs", "tfqmr", "tcqmr"]
GEN_KSP = ["gmres", "fgmres", "lgmres", "dgmres", "pgmres", "agmres",
           "bcgs", "bcgsl", "fbcgs", "cgs", "bicg", "lcd", "gcr", "tfqmr"]


@pytest.mark.parametrize("kind,ksp_type",
                         [("hermitian", k) for k in HERM_KSP]
                         + [("general", k) for k in GEN_KSP])
def test_complex128_matches_jax(kind, ksp_type):
    """tests/test_complex.py's sweep: a Hermitian positive definite
    phase-rotated Laplacian, and the same + 0.2i·I (non-Hermitian)."""
    A, rng = _hermitian_pd(seed=0 if kind == "hermitian" else 1)
    if kind == "general":
        A = (A + 0.2j * sp.eye(A.shape[0])).tocsr()
    xex = rng.standard_normal(64) + 1j * rng.standard_normal(64)
    b = A @ xex
    kw = dict(ksp_type=ksp_type, rtol=1e-7, maxits=3000)
    jr = jksp_solve(jaij(A, dtype=np.complex128), jnp.asarray(b), **kw)
    tr = ksp_solve(aij_from_scipy(A, dtype=np.complex128, device=CPU),
                   torch.from_numpy(b), **kw)
    assert int(tr.reason) > 0
    assert tr.x.dtype == torch.complex128
    if ksp_type == "bcgsl":
        # bcgsl's Gram matrix is unconjugated (R @ Rᵀ), as petsctpu's:
        # for complex scalars its MR step is not a least-squares fit and
        # the stream is chaotic (a 1e-15 change in b moves its by 10);
        # held to tests/test_complex.py's own criterion
        err = np.linalg.norm(tr.x.numpy() - xex) / np.linalg.norm(xex)
        assert err < 1e-6
        return
    assert_same(jr, tr, x_atol=1e-9)


def test_ex11_complex_helmholtz_golden():
    """output/ex11_1.out (tests/test_ksp_more.py:246) through the port:
    complex Helmholtz, GMRES refine_always, 6 its to happy breakdown."""
    n = 6
    h2 = 1.0 / ((n + 1) * (n + 1))
    rows, cols, vals = [], [], []
    for ii in range(n * n):
        i, j = divmod(ii, n)
        for ci, cj in ((i - 1, j), (i + 1, j), (i, j - 1), (i, j + 1)):
            if 0 <= ci < n and 0 <= cj < n:
                rows.append(ii)
                cols.append(cj + n * ci)
                vals.append(-1.0 + 0j)
        rows.append(ii)
        cols.append(ii)
        vals.append(4.0 - 100.0 * h2 + 10.0j * h2)
    A = sp.csr_matrix((vals, (rows, cols)), shape=(n * n, n * n))
    u = np.full(n * n, 0.5 + 0j)
    r = ksp_solve(aij_from_scipy(A, dtype=np.complex128, device=CPU),
                  torch.from_numpy(A @ u), ksp_type="gmres", rtol=1e-5,
                  atol=1e-50, cgs_refine="always")
    assert int(r.its) == 6
    np.testing.assert_allclose(r.history[:6].numpy(),
                               [4.62271, 1.58711, 0.767563, 0.472102,
                                0.435655, 0.154866], rtol=2e-5)
    assert float(r.history[6]) < 1e-11
    assert np.linalg.norm(r.x.numpy() - u) < 1e-12


@pytest.mark.parametrize("module,ksp_type", [
    ("bcgs", "bcgs"), ("extra", "tfqmr"), ("minres", "minres")])
def test_one_host_copy_an_iteration(monkeypatch, module, ksp_type):
    """BiCGStab, TFQMR and MINRES bring the norm and every breakdown
    flag to the host in one copy an iteration, plus one for the
    initial norm."""
    import importlib
    from petsctpu_torch.ksp import common

    mod = importlib.import_module(f"petsctpu_torch.ksp.{module}")
    calls = [0]
    real = common.to_host

    def counted(*vals):
        calls[0] += 1
        return real(*vals)

    monkeypatch.setattr(common, "to_host", counted)
    monkeypatch.setattr(mod, "to_host", counted)
    A = nonsym() if ksp_type != "minres" else spd()
    T = aij_from_scipy(A, device=CPU)
    r = ksp_solve(T, torch.from_numpy(rhs(A)), pc=make_pc("jacobi", A=T),
                  ksp_type=ksp_type, rtol=1e-7, maxits=400)
    assert int(r.reason) > 0
    assert calls[0] == int(r.its) + 1, (calls[0], int(r.its))
