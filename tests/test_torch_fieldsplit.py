"""PCFieldSplit through the port, against petsctpu's, on the CPU in fp64.

The port prints ksp ex43's golden monitor stream (FGMRES +
symmetric_multiplicative fieldsplit, LU on the velocity, Jacobi on the
pressure, SolCx with η₁/η₀ = 1e6 on 20×20) digit for digit and its
DMDAIntegrateErrors line, as tests/test_q1stokes.py holds petsctpu.

Each fieldsplit type and Schur factorization then solves the same
system through petsctpu and the port: equal its and reason, the history
within rtol 1e-10, with an atol of 1e-12·‖r0‖ for the entries that reach
rounding noise. Each system is one on which the port's own stream is
not chaotic: its solve with b and with b·(1 + 1e-15·noise) moves no
history entry by more than 4e-13·‖r0‖ (`python -m
petsctpu_torch.ex43_study noise --device cpu`: stokes_mac(8) up to
3.33e-13, multiplicative; the ex43 cases below 4.3e-15). So
stokes_mac(8), with its pressure null space, takes every type; ex43
takes multiplicative at mx = 12, η₁ = 1e2, the golden's own
symmetric_multiplicative at mx = 20 with its coefficients, and Schur
upper and full at mx = 8 with them. Not on ex43: additive and Schur diag
and lower, block-diagonal or triangular PCs on which FGMRES stagnates,
where a 1e-15 change of b moves the port's own history by
1.6e-11–5.0e-10·‖r0‖; multiplicative at mx = 20 moves it by
1.69e-10·‖r0‖.

MultiFieldSplitPC (three fields: vx, vy, p) and one apply of a
FieldSplitPC carried over from petsctpu's state by
convert.fieldsplit_from_arrays are held to petsctpu's applies within
1e-12 relative (the LU and ILU solves sum in another order).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_q1stokes import GOLDEN, GOLDEN_ERRORS

from petsctpu.core.options import Options as JOptions
from petsctpu.ksp import ksp_solve as jksp_solve
from petsctpu.mat import aij_from_scipy as jaij
from petsctpu.mat.nullspace import make_nullspace as jmake_nullspace
from petsctpu.pc import make_pc as jmake_pc
from petsctpu.pc.fieldsplit import make_fieldsplit as jmake_fieldsplit
from petsctpu.pc.fieldsplit import make_multi_fieldsplit as jmake_multi
from petsctpu.vec.indexset import IS as JIS

from petsctpu_torch.convert import (aij_from_arrays, fieldsplit_from_arrays,
                                    jacobi_from_arrays, sptrsv_from_arrays)
from petsctpu_torch.core.options import Options
from petsctpu_torch.ksp import ksp_solve
from petsctpu_torch.mat import aij_from_scipy
from petsctpu_torch.mat.nullspace import make_nullspace
from petsctpu_torch.models.q1stokes import (integrate_errors,
                                            q1q1_stokes_system,
                                            solcx_nodal_solution)
from petsctpu_torch.models.stokes import stokes_mac
from petsctpu_torch.pc import make_pc
from petsctpu_torch.pc.factor import LUPC
from petsctpu_torch.pc.fieldsplit import (FieldSplitPC, MultiFieldSplitPC,
                                          make_fieldsplit,
                                          make_multi_fieldsplit)
from petsctpu_torch.vec.indexset import IS

# one intra-op thread: the suite runs in parallel workers (pytest -n), and
# PyTorch's default of a thread a core oversubscribes the host's cores
torch.set_num_threads(1)

CPU = "cpu"
SOLCX = dict(c_str=0, eta0=1.0, eta1=1.0e6, xc=0.5, nz=2)
GOLDEN_OPTS = {"pc_fieldsplit_type": "symmetric_multiplicative",
               "fieldsplit_0_pc_type": "lu", "fieldsplit_1_pc_type": "jacobi"}
TYPES = {"additive": {}, "multiplicative": {},
         "symmetric_multiplicative": {},
         **{f"schur_{f}": {"pc_fieldsplit_type": "schur",
                           "pc_fieldsplit_schur_fact_type": f}
            for f in ("diag", "lower", "upper", "full")}}
EX43_CASES = {"multiplicative": (12, 1e2), "symmetric_multiplicative":
              (20, 1e6), "schur_upper": (8, 1e6), "schur_full": (8, 1e6)}


def type_options(name):
    o = {"pc_fieldsplit_type": name, **TYPES[name]}
    return {**o, "fieldsplit_0_pc_type": "lu",
            "fieldsplit_1_pc_type": "jacobi"}


def ex43(mx, eta1=1e6):
    A, B, f = q1q1_stokes_system(mx, mx, **{**SOLCX, "eta1": eta1})
    c = np.arange(A.shape[0]) % 3
    return A, B, f, [np.flatnonzero(c != 2), np.flatnonzero(c == 2)]


def assert_same_solve(r, jr):
    its = int(r.its)
    assert its == int(jr.its) and int(r.reason) == int(jr.reason), \
        (its, int(jr.its), int(r.reason), int(jr.reason))
    h, jh = r.history.numpy()[:its + 1], np.asarray(jr.history)[:its + 1]
    np.testing.assert_allclose(h, jh, rtol=1e-10, atol=1e-12 * jh[0])


@pytest.fixture(scope="module")
def golden_solve():
    A, B, f, fields = ex43(20)
    pc = make_fieldsplit(B, fields, options=Options(dict(GOLDEN_OPTS)),
                         Amat_host=A, device=CPU)
    return A, f, pc


def test_ex43_golden_stream_and_errors(golden_solve, capsys):
    A, f, pc = golden_solve
    capsys.readouterr()
    r = ksp_solve(aij_from_scipy(A, device=CPU), torch.from_numpy(f), pc=pc,
                  ksp_type="fgmres", rtol=1e-8, maxits=10000, monitor=True)
    assert capsys.readouterr().out == GOLDEN
    assert int(r.its) == 8 and int(r.reason) > 0
    Xa = solcx_nodal_solution(20, 20, eta0=1.0, eta1=1.0e6, xc=0.5, nz=2)
    h, pL2, uL2, uH1 = integrate_errors(20, 20, r.x.numpy(), Xa)
    assert f"{h:1.4e}   {pL2:1.4e}   {uL2:1.4e}   {uH1:1.4e} " \
        == GOLDEN_ERRORS


@pytest.mark.parametrize("name", sorted(EX43_CASES))
def test_ex43_type_against_petsctpu(name):
    mx, eta1 = EX43_CASES[name]
    A, B, f, fields = ex43(mx, eta1)
    o = type_options(name)
    jpc = jmake_fieldsplit(B, fields, options=JOptions(dict(o)), Amat_host=A)
    jr = jksp_solve(jaij(A), jnp.asarray(f), pc=jpc, ksp_type="fgmres",
                    rtol=1e-8, maxits=200)
    pc = make_fieldsplit(B, fields, options=Options(dict(o)), Amat_host=A,
                         device=CPU)
    r = ksp_solve(aij_from_scipy(A, device=CPU), torch.from_numpy(f), pc=pc,
                  ksp_type="fgmres", rtol=1e-8, maxits=200)
    assert_same_solve(r, jr)


@pytest.mark.parametrize("name", sorted(TYPES))
def test_stokes_mac_type_against_petsctpu(name):
    """stokes_mac(8) through make_pc("fieldsplit") with IS fields and its
    pressure null space, as tests/test_stokes.py solves it."""
    K, b, (vi, pi), blk = stokes_mac(8)
    n = K.shape[0]
    v = np.zeros(n)
    v[pi] = 1.0
    o = type_options(name)
    jpc = jmake_pc("fieldsplit", A=jaij(K), A_host=K, options=JOptions(
        {**o, "pc_fieldsplit_fields": [JIS.general(vi), JIS.general(pi)]}))
    jr = jksp_solve(jaij(K), jnp.asarray(b), pc=jpc, ksp_type="fgmres",
                    rtol=1e-8, maxits=200, nullspace=jmake_nullspace(
                        n, has_constant=False, vecs=[v]))
    Kd = aij_from_scipy(K, device=CPU)
    pc = make_pc("fieldsplit", A=Kd, A_host=K, options=Options(
        {**o, "pc_fieldsplit_fields": [IS.general(vi), IS.general(pi)]}))
    r = ksp_solve(Kd, torch.from_numpy(b), pc=pc, ksp_type="fgmres",
                  rtol=1e-8, maxits=200, nullspace=make_nullspace(
                      n, has_constant=False, vecs=[v], device=CPU))
    assert isinstance(pc, FieldSplitPC)
    assert_same_solve(r, jr)
    # as tests/test_stokes.py: a divergence-free velocity
    assert np.abs(blk["D"] @ r.x.numpy()[vi]).max() < 1e-5


@pytest.mark.parametrize("fs_type", ["additive", "multiplicative",
                                     "symmetric_multiplicative"])
def test_multi_fieldsplit_apply_against_petsctpu(fs_type):
    A, B, f, _ = ex43(8)
    c = np.arange(A.shape[0]) % 3
    fields = [np.flatnonzero(c == k) for k in range(3)]
    o = {"pc_fieldsplit_type": fs_type, "fieldsplit_2_pc_type": "jacobi"}
    jpc = jmake_multi(A, fields, options=JOptions(dict(o)))
    pc = make_multi_fieldsplit(A, [IS.general(f_) for f_ in fields],
                               options=Options(dict(o)), device=CPU)
    assert isinstance(pc, MultiFieldSplitPC)
    x = np.random.default_rng(0).standard_normal(A.shape[0])
    y = pc.apply(torch.from_numpy(x)).numpy()
    jy = np.asarray(jpc.apply(jnp.asarray(x)))
    np.testing.assert_allclose(y, jy, rtol=1e-12,
                               atol=1e-12 * np.abs(jy).max())
    # make_pc takes the N-field route for more than two fields
    assert isinstance(make_pc("fieldsplit", A=aij_from_scipy(A, device=CPU),
                              A_host=A, options=Options(
                                  {**o, "pc_fieldsplit_fields": fields})),
                      MultiFieldSplitPC)


def _plan(p):
    return sptrsv_from_arrays(np.asarray(p.level_rows), np.asarray(p.cols),
                              np.asarray(p.vals), np.asarray(p.dinv), p.n,
                              p.nlev, device=CPU)


def _ell(M):
    return np.asarray(M.cols), np.asarray(M.vals), M.shape, M.nnz


def test_fieldsplit_from_arrays_applies_as_petsctpu():
    """petsctpu's FieldSplitPC (ex43 mx = 8, the golden's options) carried
    over array by array: its fields, pmat and amat blocks, the LU's plans
    and permutations and the Jacobi's 1/d; one apply on the same x."""
    A, B, f, fields = ex43(8)
    jpc = jmake_fieldsplit(B, fields, options=JOptions(dict(GOLDEN_OPTS)),
                           Amat_host=A)
    lu = jpc.pc0
    pc0 = LUPC(_plan(lu.Lplan), _plan(lu.Uplan),
               torch.from_numpy(np.asarray(lu.perm_r, np.int64)),
               torch.from_numpy(np.asarray(lu.perm_c, np.int64)))
    pc = fieldsplit_from_arrays(
        np.asarray(jpc.isa), np.asarray(jpc.isb),
        [_ell(M) for M in (jpc.A00, jpc.A01, jpc.A10, jpc.A11)], pc0,
        jacobi_from_arrays(np.asarray(jpc.pc1.dinv), device=CPU), jpc.n,
        jpc.fs_type, jpc.schur_fact,
        amat_blocks=[_ell(M) for M in (jpc.A00a, jpc.A01a, jpc.A10a)],
        device=CPU)
    x = np.random.default_rng(1).standard_normal(A.shape[0])
    y = pc.apply(torch.from_numpy(x)).numpy()
    jy = np.asarray(jpc.apply(jnp.asarray(x)))
    np.testing.assert_allclose(y, jy, rtol=1e-12,
                               atol=1e-12 * np.abs(jy).max())
    # and the port's own setup builds the same blocks
    own = make_fieldsplit(B, fields, options=Options(dict(GOLDEN_OPTS)),
                          Amat_host=A, device=CPU)
    for a, b_ in ((own.A00, pc.A00), (own.A10a, pc.A10a)):
        assert torch.equal(a.vals, b_.vals) and torch.equal(a.cols, b_.cols)
    assert isinstance(aij_from_arrays(*_ell(jpc.A11), device=CPU).vals,
                      torch.Tensor)


def test_index_sets_as_petsctpu():
    for ours, ref in ((IS.general([4, 1, 7]), JIS.general([4, 1, 7])),
                      (IS.stride(5, 2, 3), JIS.stride(5, 2, 3)),
                      (IS.block(3, [0, 2, 5]), JIS.block(3, [0, 2, 5]))):
        assert ours.indices.dtype == ref.indices.dtype
        np.testing.assert_array_equal(ours.indices, ref.indices)


def test_overlapping_fields_accumulate():
    """Fields that share an index add both corrections there, as the
    reference's ADD_VALUES scatter does (runex19_8's duplicate fields)."""
    A, B, f, _ = ex43(4)
    n = A.shape[0]
    ia, ib = np.arange(0, n // 2 + 3), np.arange(n // 2, n)
    o = {"pc_fieldsplit_type": "additive", "fieldsplit_0_pc_type": "jacobi",
         "fieldsplit_1_pc_type": "jacobi"}
    jpc = jmake_fieldsplit(A, [ia, ib], options=JOptions(dict(o)))
    pc = make_fieldsplit(A, [ia, ib], options=Options(dict(o)), device=CPU)
    x = np.random.default_rng(2).standard_normal(n)
    np.testing.assert_array_equal(pc.apply(torch.from_numpy(x)).numpy(),
                                  np.asarray(jpc.apply(jnp.asarray(x))))
