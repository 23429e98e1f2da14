"""The port's mat/spgemm.py against petsctpu's, on the CPU.

* the host products (matmatmult, ptap, rart) against scipy;
* SpGEMMPlan and PtAPPlan: the contribution tables, inverse
  permutation, ELL positions and templates equal petsctpu's plans;
* their numerics on new values of the frozen patterns against scipy's
  products and petsctpu's numerics: fp64 within 1e-12 absolute (the
  tests/test_spgemm.py bound), fp32 within fp32 rounding (2e-6 of the
  largest entry; the row sums fold in PyTorch's order, not XLA's).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse as sp
import torch

from petsctpu.mat import spgemm as jsp
from petsctpu_torch.dm.da import q1_interp_scipy
from petsctpu_torch.mat import aij_to_scipy
from petsctpu_torch.mat import spgemm as tsp
from petsctpu_torch.models import laplacian_2d

# one intra-op thread: the suite runs in parallel workers (pytest -n), and
# PyTorch's default of a thread a core oversubscribes the host's cores
torch.set_num_threads(1)

CPU = "cpu"


def rand_pattern_values(M, seed):
    """Same pattern, fresh values."""
    rng = np.random.default_rng(seed)
    M = sp.csr_matrix(M, copy=True)
    M.data = rng.standard_normal(M.nnz)
    return M


def _tol(dtype, ref):
    return 1e-12 if dtype == np.float64 else 2e-6 * np.abs(ref).max()


def test_host_products():
    A = laplacian_2d(9, 9)
    P = q1_interp_scipy((9, 9), (5, 5))
    np.testing.assert_allclose(tsp.matmatmult(A, A).toarray(),
                               (A @ A).toarray())
    np.testing.assert_allclose(tsp.ptap(A, P).toarray(),
                               (P.T @ A @ P).toarray())
    np.testing.assert_allclose(tsp.rart(A, P.T).toarray(),
                               (P.T @ A @ P).toarray())


def _plans_equal(got, ref, fields):
    for f in fields:
        g, r = getattr(got, f), getattr(ref, f)
        if isinstance(g, tuple):
            assert len(g) == len(r)
            for a, b in zip(g, r):
                np.testing.assert_array_equal(a.numpy(), np.asarray(b))
        else:
            np.testing.assert_array_equal(g.numpy(), np.asarray(r))
    np.testing.assert_array_equal(got.template.cols.numpy(),
                                  np.asarray(ref.template.cols))
    assert got.c_nnz == ref.c_nnz and got.a_nnz == ref.a_nnz


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
def test_spgemm_plan_and_numeric(dtype):
    A0 = laplacian_2d(6, 6)
    B0 = sp.random(36, 20, density=0.2, random_state=3, format="csr")
    plan = tsp.SpGEMMPlan.plan(A0, B0, dtype=dtype, device=CPU)
    jplan = jsp.SpGEMMPlan.plan(A0, B0, dtype=dtype)
    _plans_equal(plan, jplan, ("cls_ai", "cls_bi", "inv", "ell_pos"))
    assert plan.b_nnz == jplan.b_nnz
    A1, B1 = rand_pattern_values(A0, 1), rand_pattern_values(B0, 2)
    a = tsp.csr_data_of(A1).astype(dtype)
    b = tsp.csr_data_of(B1).astype(dtype)
    C = plan.numeric(torch.from_numpy(a), torch.from_numpy(b))
    ref = (A1 @ B1).toarray()
    np.testing.assert_allclose(aij_to_scipy(C).toarray(), ref, rtol=0,
                               atol=_tol(dtype, ref))
    jdata = np.asarray(jplan.numeric_data(jnp.asarray(a), jnp.asarray(b)))
    got = plan.numeric_data(torch.from_numpy(a), torch.from_numpy(b))
    np.testing.assert_allclose(got.numpy(), jdata, rtol=0,
                               atol=_tol(dtype, jdata))


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
def test_ptap_plan_and_numeric_galerkin(dtype):
    A0 = laplacian_2d(9, 9)
    P = q1_interp_scipy((9, 9), (5, 5))
    plan = tsp.PtAPPlan.plan(A0, P, dtype=dtype, device=CPU)
    jplan = jsp.PtAPPlan.plan(A0, P, dtype=dtype)
    _plans_equal(plan, jplan, ("cls_ai", "cls_w", "inv", "ell_pos"))
    A1 = rand_pattern_values(A0, 3)
    a = tsp.csr_data_of(A1).astype(dtype)
    Ac = plan.numeric(torch.from_numpy(a))
    ref = (P.T @ A1 @ P).toarray()
    np.testing.assert_allclose(aij_to_scipy(Ac).toarray(), ref, rtol=0,
                               atol=_tol(dtype, ref))
    jref = np.asarray(jplan.numeric(jnp.asarray(a)).vals)
    np.testing.assert_allclose(Ac.vals.numpy(), jref, rtol=0,
                               atol=_tol(dtype, jref))


def test_numeric_rescales_linearly():
    """The point of the split: re-coarsen as values change."""
    A0 = laplacian_2d(9, 9)
    P = q1_interp_scipy((9, 9), (5, 5))
    plan = tsp.PtAPPlan.plan(A0, P, device=CPU)
    a0 = torch.from_numpy(tsp.csr_data_of(A0))
    s1 = float(torch.sum(plan.numeric(a0).diagonal()))
    s2 = float(torch.sum(plan.numeric(2.0 * a0).diagonal()))
    np.testing.assert_allclose(s2, 2 * s1, rtol=1e-12)
    np.testing.assert_allclose(s1, (P.T @ A0 @ P).diagonal().sum(),
                               rtol=1e-12)
