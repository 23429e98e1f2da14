"""The port's host factor numerics, triangular plans and orderings against
petsctpu's, and the host library against its numpy plain versions, on
the CPU.

* ilu0, ILU(k) for k = 1, 2, 3 and ICC(k) for k = 0, 1, 2 (the
  Manteuffel shift and the other shift types included) give factors
  equal to the reference's byte for byte, on the ex2 20×20 and ex45 8³
  operators and a random SPD matrix. The reference runs its native
  library where its .so loads, as its own tests run it.
* The port's host library (csrc/host_factor.cpp) equals the numpy plain
  versions in mat/factor.py: the same bits.
* _levels, make_sptrsv_plan with and without pad_to, and the stacked
  plan equal the reference's arrays (int32 level_rows and cols).
* The plain solve (a left fold over each row's slots) equals the
  reference's SpTRSVPlan.solve within 1e-14 relative in fp64 (the
  reference sums the slots with jnp.sum) and 1e-6 in fp32.
* nd, ndrb, qmd, md, 1wd and rcm give the reference's permutations.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse as sp
import torch

from tests.test_torch_refnative import ensure_reference_native
from petsctpu.mat import factor as jfactor
from petsctpu.mat import order as jorder
from petsctpu.pc import parallel as jparallel
from petsctpu_torch.mat import factor as tfactor
from petsctpu_torch.mat import order as torder
from petsctpu_torch.models import ex2_system, ex45_system

# one intra-op thread: the suite runs in parallel workers (pytest -n), and
# PyTorch's default of a thread a core oversubscribes the host's cores
torch.set_num_threads(1)
# the reference's native library loaded, not half-built by another
# test process (tests/test_torch_refnative.py)
ensure_reference_native()

CPU = "cpu"


def _random_spd(n=300, seed=3):
    rng = np.random.default_rng(seed)
    R = sp.random(n, n, density=4.0 / n, random_state=rng, format="csr")
    S = (R + R.T).tocsr()
    S.data = -np.abs(S.data)
    d = np.asarray(abs(S).sum(axis=1)).ravel() + rng.uniform(0.1, 1.0, n)
    return (S + sp.diags(d)).tocsr()


def _indefinite(n=200, seed=4):
    """Symmetric, with diagonal entries too small for IC without a shift."""
    A = _random_spd(n, seed)
    return (A - sp.diags(0.9 * A.diagonal())).tocsr()


MATRICES = {"ex2": lambda: sp.csr_matrix(ex2_system(20, 20)[0]),
            "ex45": lambda: sp.csr_matrix(ex45_system(8, 8, 8)[0]),
            "spd": _random_spd}


def _same_csr(a, b):
    a, b = sp.csr_matrix(a), sp.csr_matrix(b)
    assert a.shape == b.shape and a.dtype == b.dtype
    np.testing.assert_array_equal(a.indptr, b.indptr)
    np.testing.assert_array_equal(a.indices, b.indices)
    np.testing.assert_array_equal(a.data, b.data)


@pytest.mark.parametrize("name", list(MATRICES))
def test_ilu0_equals_reference_and_plain(name):
    A = MATRICES[name]()
    L, U = tfactor.ilu0(A)
    jL, jU = jfactor.ilu0(A)
    _same_csr(L, jL)
    _same_csr(U, jU)
    pL, pU = tfactor.ilu0_plain(A)
    _same_csr(L, pL)
    _same_csr(U, pU)
    A32 = A.astype(np.float32)           # factored in fp64, cast back
    L32, U32 = tfactor.ilu0(A32)
    assert L32.dtype == np.float32
    _same_csr(L32, jfactor.ilu0(A32)[0])
    _same_csr(U32, jfactor.ilu0(A32)[1])


@pytest.mark.parametrize("k", [1, 2, 3])
@pytest.mark.parametrize("name", list(MATRICES))
def test_iluk_factors_equal_reference(name, k):
    """ILU(k) plans (pattern, widening, numeric, plan) against the
    reference's make_ilu(levels=k, tri='level'), array for array."""
    from petsctpu.pc.factor import _iluk_pattern as jpattern
    from petsctpu.pc.factor import make_ilu as jmake_ilu
    from petsctpu_torch.pc.factor import make_ilu

    A = MATRICES[name]()
    rows = tfactor.iluk_pattern(A, k)
    for r, jr, pr in zip(rows, jpattern(sp.csr_matrix(A), k),
                         tfactor.iluk_pattern_plain(A, k)):
        np.testing.assert_array_equal(r, jr)
        np.testing.assert_array_equal(r, pr)
    pc = make_ilu(A, levels=k, device=CPU)
    jpc = jmake_ilu(A, levels=k, tri="level")
    for side in ("Lplan", "Uplan"):
        p, jp = getattr(pc, side), getattr(jpc, side)
        assert (p.n, p.nlev) == (jp.n, jp.nlev)
        for f in ("level_rows", "cols", "vals", "dinv"):
            got, ref = np.asarray(getattr(p, f)), np.asarray(getattr(jp, f))
            assert got.dtype == ref.dtype, f
            np.testing.assert_array_equal(got, ref)


@pytest.mark.parametrize("k", [0, 1, 2])
@pytest.mark.parametrize("name", list(MATRICES) + ["indefinite"])
def test_icc_factors_equal_reference_and_plain(name, k):
    A = _indefinite() if name == "indefinite" else MATRICES[name]()
    patt = None if k == 0 else tfactor.icc_pattern(A, k)
    if k:
        for r, jr, pr in zip(patt, jfactor.icc_pattern(A, k),
                             tfactor.icc_pattern_plain(A, k)):
            np.testing.assert_array_equal(r, jr)
            np.testing.assert_array_equal(r, pr)
    U, d, nshift, shift = tfactor.icc_factor(A, pattern_rows=patt)
    jU, jd, jnshift, jshift = jfactor.icc_factor(A, pattern_rows=patt)
    _same_csr(U, jU)
    np.testing.assert_array_equal(d, jd)
    assert (nshift, shift) == (jnshift, jshift)
    pU, pd, pnshift, pshift = tfactor.icc_factor(
        A, pattern_rows=patt, numeric=tfactor.icc_numeric_plain)
    _same_csr(U, pU)
    np.testing.assert_array_equal(d, pd)
    assert (nshift, shift) == (pnshift, pshift)
    if name == "indefinite":
        assert nshift > 0          # the Manteuffel shift was taken


@pytest.mark.parametrize("shift_type", ["nonzero", "inblocks", "none"])
def test_icc_shift_types_equal_reference_and_plain(shift_type):
    A = _indefinite() if shift_type != "none" else _random_spd()
    kw = dict(shift_type=shift_type, zeropivot=1e-2, shift_amount=0.5)
    got = tfactor.icc_factor(A, **kw)
    ref = jfactor.icc_factor(A, **kw)
    plain = tfactor.icc_factor(A, numeric=tfactor.icc_numeric_plain, **kw)
    for other in (ref, plain):
        _same_csr(got[0], other[0])
        np.testing.assert_array_equal(got[1], other[1])
        assert got[2:] == other[2:]
    B = _indefinite()
    B = (B - sp.diags(B.diagonal())).tocsr()           # zero pivots
    B.setdiag(0.0)
    with pytest.raises(ZeroDivisionError):
        tfactor.icc_factor(B, shift_type="none")
    with pytest.raises(ZeroDivisionError):
        tfactor.icc_factor(B, shift_type="none",
                           numeric=tfactor.icc_numeric_plain)


def test_ilu0_raises_on_a_missing_diagonal():
    A = sp.csr_matrix(np.array([[0.0, 1.0], [1.0, 2.0]]))
    A.eliminate_zeros()
    with pytest.raises(ValueError, match="missing diagonal"):
        tfactor.ilu0(A)
    with pytest.raises(ValueError, match="missing diagonal"):
        tfactor.ilu0_plain(A)


def _triangles(A):
    L, U = tfactor.ilu0(A)
    return {"L": (L, True, True), "U": (U, False, False),
            "LU_L": (tfactor.lu_factor(A)[0], True, False)}


@pytest.mark.parametrize("tri", ["L", "U", "LU_L"])
@pytest.mark.parametrize("name", list(MATRICES))
def test_levels_and_plans_equal_reference(name, tri):
    T, lower, unit = _triangles(MATRICES[name]())[tri]
    lev = tfactor._levels(T, lower)
    np.testing.assert_array_equal(lev, jfactor._levels(T, lower))
    np.testing.assert_array_equal(lev, tfactor.levels_plain(T, lower))
    nlev = int(lev.max()) + 1
    for pad in (None, (nlev + 3, 7, 9)):
        for dt in (np.float64, np.float32):
            plan = tfactor.make_sptrsv_plan(T, lower, unit, dtype=dt,
                                            pad_to=pad, device=CPU)
            jplan = jfactor.make_sptrsv_plan(T, lower, unit, dtype=dt,
                                             pad_to=pad)
            assert (plan.n, plan.nlev) == (jplan.n, jplan.nlev)
            for f in ("level_rows", "cols", "vals", "dinv"):
                got, ref = np.asarray(getattr(plan, f)), np.asarray(
                    getattr(jplan, f))
                assert got.dtype == ref.dtype, f
                np.testing.assert_array_equal(got, ref)


@pytest.mark.parametrize("tri", ["L", "U", "LU_L"])
@pytest.mark.parametrize("name", list(MATRICES))
def test_plain_solve_matches_reference(name, tri):
    T, lower, unit = _triangles(MATRICES[name]())[tri]
    b = np.random.default_rng(7).standard_normal(T.shape[0])
    for dt, tol in ((np.float64, 1e-14), (np.float32, 1e-6)):
        plan = tfactor.make_sptrsv_plan(T, lower, unit, dtype=dt,
                                        device=CPU)
        jplan = jfactor.make_sptrsv_plan(T, lower, unit, dtype=dt)
        got = plan.solve(torch.from_numpy(b.astype(dt))).numpy()
        ref = np.asarray(jplan.solve(jnp.asarray(b.astype(dt))))
        assert got.dtype == dt
        assert np.abs(got - ref).max() <= tol * np.abs(ref).max()


def test_stacked_plan_equals_reference_and_solves_each_block():
    A = MATRICES["ex45"]()
    blocks = [A[s:s + 128][:, s:s + 128] for s in range(0, 512, 128)]
    blocks[1] = (blocks[1] + sp.diags(np.linspace(1, 2, 128))).tocsr()
    Ls = [tfactor.ilu0(B)[0] for B in blocks]
    plan = tfactor.stacked_sptrsv_plan(Ls, True, True, np.float64,
                                       device=CPU)
    jplan = jparallel._stacked_tri_plans(Ls, True, True, np.float64)
    assert plan.stacked and plan.level_rows.shape[0] == 4
    for f in ("level_rows", "cols", "vals", "dinv"):
        np.testing.assert_array_equal(np.asarray(getattr(plan, f)),
                                      np.asarray(getattr(jplan, f)))
    b = np.random.default_rng(8).standard_normal((4, 128))
    x = plan.solve(torch.from_numpy(b)).numpy()
    for k, L in enumerate(Ls):
        one = tfactor.make_sptrsv_plan(L, True, True, device=CPU)
        np.testing.assert_array_equal(
            x[k], one.solve(torch.from_numpy(b[k])).numpy())


def test_plan_levels_and_front_packing():
    A = MATRICES["ex2"]()
    L, _ = tfactor.ilu0(A)
    plan = tfactor.make_sptrsv_plan(L, True, True, pad_to=(60, 30, 4),
                                    device=CPU)
    assert int(plan.nlevs[0]) == 39 and plan.nlev == 60
    # the device plan is the level order alone, its all-padding slots
    # dropped: ILU(0)'s L of the 5-point operator has two a row
    lstart, lrows, lcols, lvals, ldinv = plan.order
    assert tuple(lcols.shape) == (1, plan.n, 2) and plan.cols.shape[1] == 4
    assert plan.rmax == int((lstart[0, 1:] - lstart[0, :-1]).max())
    b = np.random.default_rng(9).standard_normal(plan.n)
    ref = jfactor.make_sptrsv_plan(L, True, True).solve(jnp.asarray(b))
    got, ref = plan.solve(torch.from_numpy(b)).numpy(), np.asarray(ref)
    assert np.abs(got - ref).max() <= 1e-14 * np.abs(ref).max()
    bad = plan.level_rows.copy()
    bad[3, :2] = bad[3, :2][::-1].copy()
    bad[3, 0] = plan.n
    with pytest.raises(ValueError, match="before its padding"):
        tfactor.SpTRSVPlan(bad, plan.cols, plan.vals, plan.dinv, plan.n,
                           plan.nlev, device=CPU)
    bad = plan.level_rows.copy()
    bad[5] = plan.n
    with pytest.raises(ValueError, match="padded levels"):
        tfactor.SpTRSVPlan(bad, plan.cols, plan.vals, plan.dinv, plan.n,
                           plan.nlev, device=CPU)
    bad = plan.level_rows.copy()
    bad[0, 0] = bad[1, 0]
    with pytest.raises(ValueError, match="each of its rows once"):
        tfactor.SpTRSVPlan(bad, plan.cols, plan.vals, plan.dinv, plan.n,
                           plan.nlev, device=CPU)


@pytest.mark.parametrize("kind", ["nd", "ndrb", "qmd", "md", "1wd", "rcm"])
@pytest.mark.parametrize("name", list(MATRICES))
def test_orderings_equal_reference(name, kind):
    A = MATRICES[name]()
    perm = torder.get_ordering(A, kind)
    np.testing.assert_array_equal(perm, jorder.get_ordering(A, kind))
    np.testing.assert_array_equal(np.sort(perm), np.arange(A.shape[0]))
    Ap = torder.permute_symmetric(A, perm)
    _same_csr(Ap, jorder.permute_symmetric(A, perm))
    assert torder.bandwidth(Ap) == jorder.bandwidth(Ap)


def test_dense_plan_matches_reference():
    A = MATRICES["ex2"]()
    L, U = tfactor.ilu0(A)
    b = np.random.default_rng(9).standard_normal(A.shape[0])
    for T, lower, unit in ((L + sp.eye(A.shape[0]), True, True),
                           (U, False, False)):
        got = tfactor.make_dense_trsv_plan(T, lower, unit, device=CPU) \
            .solve(torch.from_numpy(b)).numpy()
        ref = np.asarray(jfactor.make_dense_trsv_plan(T, lower, unit)
                         .solve(jnp.asarray(b)))
        assert np.abs(got - ref).max() <= 1e-13 * np.abs(ref).max()


def test_band_viability_probe_equals_reference():
    A = MATRICES["ex45"]()
    L, U = tfactor.ilu0(A)
    for dt in (np.float32, np.float64):
        for cap in (2 * 1024 ** 3, 10 ** 6):
            assert tfactor.band_solve_viable([L], [U], dt, cap) == \
                jparallel.band_solve_viable([L], [U], dt, cap)
    assert tfactor.band_dims(U, False) == jfactor.band_dims(U, False)


def test_host_library_builds_into_the_build_directory():
    from petsctpu_torch.mat import host_factor
    from petsctpu_torch.ops import _build

    host_factor._lib()
    assert _build.lib_path("host_factor").exists()
    assert _build.lib_path("host_factor").parent == _build.BUILD
