"""The port's KSP solves against petsctpu's, on the CPU.

* fp64 on AIJ (ex2 8×7, ex45 6³): cg, pipecg, single-reduction cg,
  gmres (cgs refine never/always, mgs) and fgmres, each with none,
  jacobi and pbjacobi, through `ksp_solve` and through `KSP` with
  Options. Against petsctpu: equal its and reason, history within rtol
  1e-10 (atol 1e-13·‖r0‖ for entries at rounding noise), x within atol
  1e-10 (the reductions sum in another order, a few ulps per
  iteration), and the -ksp_monitor_short text identical.
* The ex1_1 golden numbers (tests/test_golden.py:59).
* fp32 on SELL (ex45 16³): cg+jacobi and gmres+jacobi. fp32 dot
  products round differently between XLA and PyTorch, so its may move
  by one; the reason must agree and the history within rtol 1e-4, with
  an absolute floor of 1e-6·‖r0‖ (8 fp32 ulps of the initial residual:
  late CG entries sit near 1e-5·‖r0‖, where one rounding of ‖r0‖'s
  size is a large relative change). XLA:CPU's fp32 vdot is the less
  accurate of the two (measured on this 4096-row system: 6e-6 relative
  error in ‖M⁻¹b‖, against 1e-7 for PyTorch's), and classical
  Gram-Schmidt without refinement amplifies that until the JAX GMRES
  history is off the fp64 one by a factor of 5 at iteration 30 and
  needs 5 more iterations. So the JAX comparison runs GMRES with one
  refinement step, and the unrefined fp32 GMRES is held to the fp64
  solve instead.
"""

import contextlib
import io

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import petsctpu_torch.ksp as tksp
from petsctpu.core.options import Options as JOptions
from petsctpu.ksp import KSP as JKSP
from petsctpu.mat import aij_from_scipy as jaij_from_scipy
from petsctpu.mat import sell as jsell
from petsctpu.mat.factory import mat_from_options as jmat_from_options
from petsctpu_torch.core.options import Options
from petsctpu_torch.mat import aij_from_scipy, mat_from_options
from petsctpu_torch.mat.sell import sell_from_scipy
from petsctpu_torch.models import ex2_system, ex45_system
from petsctpu_torch.pc import make_pc

# one intra-op thread: the suite runs in parallel workers (pytest -n), and
# PyTorch's default of a thread a core oversubscribes the host's cores
torch.set_num_threads(1)

CPU = "cpu"
SYSTEMS = {"ex2": lambda: ex2_system(8, 7), "ex45": lambda: ex45_system(6, 6, 6)}
SOLVERS = {
    "cg": {"ksp_type": "cg"},
    "pipecg": {"ksp_type": "pipecg"},
    "cg_single": {"ksp_type": "cg", "ksp_cg_single_reduction": None},
    "gmres_never": {"ksp_type": "gmres",
                    "ksp_gmres_cgs_refinement_type": "refine_never"},
    "gmres_always": {"ksp_type": "gmres",
                     "ksp_gmres_cgs_refinement_type": "refine_always"},
    "gmres_mgs": {"ksp_type": "gmres", "ksp_gmres_modifiedgramschmidt": None,
                  "ksp_gmres_restart": "12"},
    "fgmres": {"ksp_type": "fgmres", "ksp_gmres_restart": "10"},
}
PCS = {"none": {}, "jacobi": {}, "pbjacobi": {"pc_pbjacobi_block_size": "2"}}


def _options(system, solver, pc):
    return {**SOLVERS[solver], **PCS[pc], "pc_type": pc,
            "ksp_rtol": "1e-9", "ksp_max_it": "300",
            "ksp_monitor_short": None}


def _captured(fn):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        res = fn()
        jax.effects_barrier()
    return res, buf.getvalue()


_JAX_RUNS = {}


def _jax_run(system, solver, pc):
    """petsctpu's KSP on the case (cached: both port routes use it)."""
    key = (system, solver, pc)
    if key not in _JAX_RUNS:
        A, b, _ = SYSTEMS[system]()

        def run():
            ksp = JKSP(JOptions(_options(system, solver, pc)))
            ksp.set_operators(jaij_from_scipy(A))
            return ksp.solve(jnp.asarray(b))

        res, text = _captured(run)
        _JAX_RUNS[key] = (int(res.its), int(res.reason),
                          np.asarray(res.history), np.asarray(res.x), text)
    return _JAX_RUNS[key]


def _port_run(system, solver, pc, route):
    A, b, _ = SYSTEMS[system]()
    opts = Options(_options(system, solver, pc))
    Ad = aij_from_scipy(A, device=CPU)
    bt = torch.from_numpy(b)
    if route == "ksp_object":
        def run():
            ksp = tksp.KSP(opts)
            ksp.set_operators(Ad)
            return ksp.solve(bt)
    else:
        def run():
            from petsctpu_torch.ksp.api import config_from_options
            cfg = config_from_options(opts)
            return tksp.ksp_solve(Ad, bt, pc=make_pc(pc, A=Ad, options=opts),
                                  cfg=cfg)
    return _captured(run)


@pytest.mark.parametrize("route", ["ksp_solve", "ksp_object"])
@pytest.mark.parametrize("pc", list(PCS))
@pytest.mark.parametrize("solver", list(SOLVERS))
@pytest.mark.parametrize("system", list(SYSTEMS))
def test_fp64_aij_matches_jax(system, solver, pc, route):
    its, reason, hist, x, text = _jax_run(system, solver, pc)
    res, got_text = _port_run(system, solver, pc, route)
    assert reason > 0, (its, reason)
    assert (int(res.its), int(res.reason)) == (its, reason)
    assert res.history.dtype == torch.float64
    # entries below 1e-13·‖r0‖ are rounding noise of an exactly
    # converged Krylov space (the monitor prints them as '< 1.e-11')
    np.testing.assert_allclose(res.history[:its + 1].numpy(),
                               hist[:its + 1], rtol=1e-10,
                               atol=1e-13 * hist[0])
    assert np.isnan(res.history[its + 1:].numpy()).all()
    np.testing.assert_allclose(res.x.numpy(), x, rtol=0, atol=1e-10)
    assert got_text == text
    assert float(res.rnorm) == float(res.history[its])


def test_ex1_1_gmres_jacobi_golden():
    """output/ex1_1.out (tests/test_golden.py:59): tridiagonal n=10,
    GMRES+Jacobi, rtol 1e-5."""
    import scipy.sparse as sp
    n = 10
    A = sp.diags([-np.ones(n - 1), 2 * np.ones(n), -np.ones(n - 1)],
                 [-1, 0, 1]).tocsr()
    b = A @ np.ones(n)
    Ad = aij_from_scipy(A, device=CPU)
    r = tksp.ksp_solve(Ad, torch.from_numpy(b), pc=make_pc("jacobi", A=Ad),
                       ksp_type="gmres", rtol=1e-5, atol=1e-50,
                       cgs_refine="always")
    golden = [0.707107, 0.316228, 0.188982, 0.129099, 0.0953463]
    assert int(r.its) == 5
    np.testing.assert_allclose(r.history[:5].numpy(), golden, rtol=2e-5)
    assert float(r.history[5]) < 1e-11


def _golden_ex2(m, n, pc_type, options=None):
    """ksp ex2 on an m×n grid with an ex2.c rtol of 1e-2/((m+1)(n+1))."""
    A, b, u = ex2_system(m, n)
    Ad = aij_from_scipy(A, device=CPU)
    pc = make_pc(pc_type, A=Ad, A_host=A, options=options)
    return A, torch.from_numpy(b), u, Ad, pc, 1e-2 / ((m + 1) * (n + 1))


def test_ex2_1_gmres_ilu_golden():
    """output/ex2_1.out (tests/test_golden.py:30): -m 5 -n 5, GMRES +
    ILU(0), refine_always."""
    _, b, u, Ad, pc, rtol = _golden_ex2(5, 5, "ilu")
    r = tksp.ksp_solve(Ad, b, pc=pc, ksp_type="gmres", rtol=rtol,
                       atol=1e-50, cgs_refine="always")
    golden = [3.21109, 0.93268, 0.103515, 0.00787798, 0.000387275]
    assert int(r.its) == 4
    np.testing.assert_allclose(r.history[:5].numpy(), golden, rtol=2e-5)
    np.testing.assert_allclose(np.linalg.norm(r.x.numpy() - u), 0.000392701,
                               rtol=1e-4)


def test_ex2_3_gmres_ssor_golden():
    """output/ex2_3.out (tests/test_golden.py:44): the default 8×7 grid,
    -pc_type sor -pc_sor_symmetric."""
    _, b, _, Ad, pc, rtol = _golden_ex2(8, 7, "sor", Options(
        {"pc_sor_symmetric": None}))
    r = tksp.ksp_solve(Ad, b, pc=pc, ksp_type="gmres", rtol=rtol,
                       atol=1e-50, cgs_refine="always")
    golden = [2.98499, 1.13133, 0.575925, 0.108871, 0.0213225,
              0.00325239, 0.000874208, 0.000179613]
    assert int(r.its) == 7
    np.testing.assert_allclose(r.history[:8].numpy(), golden, rtol=2e-5)


def test_ex1_2_gmres_ssor_golden():
    """output/ex1_2.out (tests/test_golden.py:73): tridiagonal n=10,
    GMRES + symmetric SOR, rtol 1e-5."""
    import scipy.sparse as sp
    n = 10
    A = sp.diags([-np.ones(n - 1), 2 * np.ones(n), -np.ones(n - 1)],
                 [-1, 0, 1]).tocsr()
    u = np.ones(n)
    Ad = aij_from_scipy(A, device=CPU)
    pc = make_pc("sor", A=Ad, A_host=A,
                 options=Options({"pc_sor_symmetric": None}))
    r = tksp.ksp_solve(Ad, torch.from_numpy(A @ u), pc=pc, ksp_type="gmres",
                       rtol=1e-5, atol=1e-50, cgs_refine="always")
    golden = [0.968764, 0.361001, 0.247329, 0.0808915, 0.01289,
              0.00375064, 0.000294092, 1.40861e-05, 3.48863e-07]
    assert int(r.its) == 8
    np.testing.assert_allclose(r.history[:9].numpy(), golden, rtol=2e-5)
    np.testing.assert_allclose(np.linalg.norm(r.x.numpy() - u), 4.10316e-07,
                               rtol=1e-3)


def test_ex2_fbcgs_ilu_golden():
    """output/ex2_fbcgs.out (tests/test_golden.py:90): -ksp_type fbcgs
    -pc_type ilu on the default 8×7 grid, 4 its, error 0.000319503."""
    _, b, u, Ad, pc, rtol = _golden_ex2(8, 7, "ilu")
    r = tksp.ksp_solve(Ad, b, pc=pc, ksp_type="fbcgs", rtol=rtol,
                       atol=1e-50)
    assert int(r.its) == 4
    np.testing.assert_allclose(np.linalg.norm(r.x.numpy() - u), 0.000319503,
                               rtol=1e-3)


def test_ex2_1_exact_output_text_golden(capsys):
    """A character-level diff of the monitor stream against
    output/ex2_1.out (tests/test_golden.py:102)."""
    _, b, u, Ad, pc, rtol = _golden_ex2(5, 5, "ilu")
    r = tksp.ksp_solve(Ad, b, pc=pc, ksp_type="gmres", rtol=rtol,
                       atol=1e-50, cgs_refine="always", monitor=True)
    out = capsys.readouterr().out
    out += (f"Norm of error {np.linalg.norm(r.x.numpy() - u):g} "
            f"iterations {int(r.its)}\n")
    assert out == ("  0 KSP Residual norm 3.21109 \n"
                   "  1 KSP Residual norm 0.93268 \n"
                   "  2 KSP Residual norm 0.103515 \n"
                   "  3 KSP Residual norm 0.00787798 \n"
                   "  4 KSP Residual norm 0.000387275 \n"
                   "Norm of error 0.000392701 iterations 4\n")


def _sell_ops(route):
    A, b, _ = ex45_system(16, 16, 16)
    if route == "mat_from_options":
        opts = {"mat_type": "sell", "mat_ordering_type": "natural"}
        J, jperm = jmat_from_options(A, JOptions(opts))
        T, tperm = mat_from_options(A, Options(opts), device=CPU)
        np.testing.assert_array_equal(tperm, jperm)
    else:
        J = jsell.sell_from_scipy(A, G=8)
        T = sell_from_scipy(A, G=8, device=CPU)
    return J, T, b.astype(np.float32)


@pytest.mark.parametrize("ksp_type", ["cg", "gmres"])
@pytest.mark.parametrize("route", ["mat_from_options", "sell_G8"])
def test_fp32_sell_matches_jax(route, ksp_type):
    from petsctpu.ksp import ksp_solve as jksp_solve
    from petsctpu.pc import make_pc as jmake_pc

    J, T, b = _sell_ops(route)
    kw = dict(ksp_type=ksp_type, rtol=1e-5, maxits=400, cgs_refine="always")
    jr = jksp_solve(J, jnp.asarray(b), pc=jmake_pc("jacobi", A=J), **kw)
    tr = tksp.ksp_solve(T, torch.from_numpy(b), pc=make_pc("jacobi", A=T),
                        **kw)
    assert tr.history.dtype == torch.float32 and tr.x.dtype == torch.float32
    assert int(tr.reason) == int(jr.reason) > 0
    assert abs(int(tr.its) - int(jr.its)) <= 1
    k = min(int(tr.its), int(jr.its)) + 1
    jh = np.asarray(jr.history[:k])
    np.testing.assert_allclose(tr.history[:k].numpy(), jh, rtol=1e-4,
                               atol=1e-6 * jh[0])


def test_fp32_sell_unrefined_gmres_tracks_fp64():
    """GMRES(30) without refinement on the SELL operator in fp32 against
    the same solve in fp64 on AIJ (itself held to petsctpu above): the
    same iteration count ±1, the history within 1e-2 relative (the
    loss of orthogonality of fp32 classical Gram-Schmidt, measured at
    5e-3 on this system)."""
    A, b, _ = ex45_system(16, 16, 16)
    T = sell_from_scipy(A, G=8, device=CPU)
    A64 = aij_from_scipy(A, device=CPU)
    kw = dict(ksp_type="gmres", rtol=1e-5, maxits=400)
    tr = tksp.ksp_solve(T, torch.from_numpy(b.astype(np.float32)),
                        pc=make_pc("jacobi", A=T), **kw)
    fr = tksp.ksp_solve(A64, torch.from_numpy(b),
                        pc=make_pc("jacobi", A=A64), **kw)
    assert int(tr.reason) == int(fr.reason) > 0
    assert abs(int(tr.its) - int(fr.its)) <= 1
    k = min(int(tr.its), int(fr.its)) + 1
    np.testing.assert_allclose(tr.history[:k].numpy(),
                               fr.history[:k].numpy(), rtol=1e-2)


def test_default_pc_with_host_matrix_is_ilu_and_not_ported():
    """The default PC with a host matrix is ILU(0), ported in slice 5:
    the solve builds an ILUPC and matches petsctpu's default."""
    A, b, _ = ex2_system(4, 4)
    ksp = tksp.KSP(Options({"ksp_type": "cg"}))
    ksp.set_operators(aij_from_scipy(A, device=CPU), A_host=A)
    res = ksp.solve(torch.from_numpy(b))
    assert type(ksp.pc).__name__ == "ILUPC"
    jksp = JKSP(JOptions({"ksp_type": "cg"}))
    jksp.set_operators(jaij_from_scipy(A), A)
    jres = jksp.solve(jnp.asarray(b))
    assert (int(res.its), int(res.reason)) == (int(jres.its),
                                               int(jres.reason))
    np.testing.assert_allclose(res.x.numpy(), np.asarray(jres.x), atol=1e-10)


@pytest.mark.parametrize("ksp_type", ["bcgs", "minres", "agmres"])
def test_unported_ksp_types_raise(ksp_type):
    """These types raised NotImplementedError until slice 6 ported them
    (ROADMAP queue 1 item 7): each now solves, and a name outside the
    registry raises ValueError."""
    A, b, _ = ex2_system(4, 4)
    Ad = aij_from_scipy(A, device=CPU)
    r = tksp.ksp_solve(Ad, torch.from_numpy(b), ksp_type=ksp_type,
                       rtol=1e-8)
    assert int(r.reason) > 0
    np.testing.assert_allclose(A @ r.x.numpy(), b, atol=1e-6)
    with pytest.raises(ValueError, match="unknown ksp_type"):
        tksp.ksp_solve(Ad, torch.from_numpy(b), ksp_type=ksp_type + "_x")


def test_options_mapping_to_fgmres():
    from petsctpu_torch.ksp.api import config_from_options
    right = config_from_options(Options({"ksp_type": "gmres",
                                         "ksp_pc_side": "right"}))
    unpre = config_from_options(Options({"ksp_type": "gmres",
                                         "ksp_norm_type": "unpreconditioned"}))
    assert right.ksp_type == unpre.ksp_type == "fgmres"


def test_solve_transpose_and_diagonal_scale_match_jax():
    from petsctpu.ksp.api import (diagonal_scale_system as jdss,
                                  ksp_solve_transpose as jkst)
    from petsctpu_torch.ksp.api import (diagonal_scale_system,
                                        ksp_solve_transpose)
    import scipy.sparse as sp

    A, b, _ = ex2_system(6, 5)
    A = (A + sp.diags(np.linspace(0, 1, A.shape[0]), 1,
                      shape=A.shape)).tocsr()          # nonsymmetric
    jr = jkst(jaij_from_scipy(A), jnp.asarray(b), ksp_type="gmres",
              rtol=1e-10)
    tr = ksp_solve_transpose(aij_from_scipy(A, device=CPU),
                             torch.from_numpy(b), ksp_type="gmres",
                             rtol=1e-10)
    assert int(tr.its) == int(jr.its)
    np.testing.assert_allclose(tr.x.numpy(), np.asarray(jr.x), atol=1e-10)
    S, sb, d = diagonal_scale_system(A, b)
    jS, jsb, jd = jdss(A, b)
    assert abs(S - jS).max() == 0
    np.testing.assert_array_equal(sb, jsb)
    np.testing.assert_array_equal(d, jd)


def _numbers(text):
    import re
    return [float(v) for v in re.findall(r"[-+]?\d+\.\d+e[-+]\d+", text)]


@pytest.mark.parametrize("ksp_type", ["cg", "gmres", "fgmres"])
def test_monitor_true_residual_matches_jax(ksp_type):
    """-ksp_monitor_true_residual: the same lines, the numbers (13
    digits printed) within rtol 1e-9."""
    from petsctpu.ksp import ksp_solve as jksp_solve
    from petsctpu.pc import make_pc as jmake_pc

    A, b, _ = ex2_system(8, 7)
    J = jaij_from_scipy(A)
    T = aij_from_scipy(A, device=CPU)
    kw = dict(ksp_type=ksp_type, rtol=1e-8, monitor_true=True)
    jr, jtext = _captured(lambda: jksp_solve(
        J, jnp.asarray(b), pc=jmake_pc("jacobi", A=J), **kw))
    tr, ttext = _captured(lambda: tksp.ksp_solve(
        T, torch.from_numpy(b), pc=make_pc("jacobi", A=T), **kw))
    assert int(tr.its) == int(jr.its)
    assert len(ttext.splitlines()) == len(jtext.splitlines()) == int(jr.its) + 1
    tn, jn = _numbers(ttext), _numbers(jtext)
    assert len(tn) == len(jn) == 3 * (int(jr.its) + 1)
    np.testing.assert_allclose(tn, jn, rtol=1e-9, atol=1e-13 * jn[0])


@pytest.mark.parametrize("ksp_type,norm_type", [
    ("cg", None), ("cg", "natural"), ("cg", "unpreconditioned"),
    ("pipecg", None), ("gmres", None), ("fgmres", None)])
def test_nonzero_initial_guess_matches_jax(ksp_type, norm_type):
    """-ksp_initial_guess_nonzero: the rtol base is the RHS norm of the
    norm type (rnorm0_reference), as in petsctpu."""
    from petsctpu.ksp import ksp_solve as jksp_solve
    from petsctpu.pc import make_pc as jmake_pc

    A, b, _ = ex45_system(6, 6, 6)
    x0 = np.random.default_rng(9).standard_normal(A.shape[0])
    J = jaij_from_scipy(A)
    T = aij_from_scipy(A, device=CPU)
    kw = dict(ksp_type=ksp_type, rtol=1e-7, guess_nonzero=True,
              norm_type=norm_type)
    jr = jksp_solve(J, jnp.asarray(b), x0=jnp.asarray(x0),
                    pc=jmake_pc("jacobi", A=J), **kw)
    tr = tksp.ksp_solve(T, torch.from_numpy(b), x0=torch.from_numpy(x0),
                        pc=make_pc("jacobi", A=T), **kw)
    its = int(jr.its)
    assert (int(tr.its), int(tr.reason)) == (its, int(jr.reason))
    jh = np.asarray(jr.history[:its + 1])
    np.testing.assert_allclose(tr.history[:its + 1].numpy(), jh,
                               rtol=1e-10, atol=1e-13 * jh[0])
    np.testing.assert_allclose(tr.x.numpy(), np.asarray(jr.x), atol=1e-10)


@pytest.mark.parametrize("variant", ["diag", "rowmax", "rowsum"])
def test_jacobi_variants_match_jax(variant):
    import scipy.sparse as sp
    from petsctpu.pc.simple import make_jacobi as jmake_jacobi
    from petsctpu_torch.pc.simple import make_jacobi

    A, _, _ = ex2_system(8, 7)
    A = (A + sp.diags(np.linspace(-1, 3, A.shape[0]))).tocsr()
    jd = np.asarray(jmake_jacobi(jaij_from_scipy(A), variant).dinv)
    td = make_jacobi(aij_from_scipy(A, device=CPU), variant).dinv.numpy()
    np.testing.assert_allclose(td, jd, rtol=1e-15)


def test_log_flops_follow_the_reference_model():
    """With logging on, a solve books its flops as petsctpu does
    (its·(2·nnz − n + 10n) under KSPSolve[type], its·(2·nnz − n) under
    MatMult) and times the solve once."""
    from petsctpu_torch.core import logging as plog

    A, b, _ = ex2_system(8, 7)
    T = aij_from_scipy(A, device=CPU)
    plog.log_begin()
    try:
        r = tksp.ksp_solve(T, torch.from_numpy(b), ksp_type="cg", rtol=1e-8)
        ev = plog.log_events()
    finally:
        plog._state.enabled = False
    its, spmv = int(r.its), 2.0 * A.nnz - A.shape[0]
    assert ev["KSPSolve[cg]"].count == 1 and ev["KSPSolve[cg]"].time > 0
    assert ev["KSPSolve[cg]"].flops == its * (spmv + 10.0 * A.shape[0])
    assert ev["MatMult"].flops == its * spmv
