"""The port's pc/asa.py (the multi-candidate SA hierarchy and PCASA)
against petsctpu's, on the CPU.

* tentative_prolongator_multi, _collapse_by_block, asa_hierarchy and
  asa_tentatives: equal patterns and shapes, values within 1e-14 in
  fp64 (the same numpy/scipy calls on the same inputs), on ksp ex55 with
  its rigid-body modes and with its translational candidates, and on a
  seeded random block;
* asa_candidates: the same candidate block within 1e-12 on an
  anisotropic Laplacian;
* the cases of tests/test_asa.py on the port alone (the SA invariant
  P0·Bc = B, orthonormal columns, rank-deficient aggregates, candidates
  growing on anisotropy, PCASA solves);
* -pc_type asa on the 2-D Laplacian through KSP, fp64 AIJ: equal its
  and reason, history within 1e-10 relative.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse as sp
import torch

from petsctpu.ksp import ksp_solve as jksp_solve
from petsctpu.mat import aij_from_scipy as jaij_from_scipy
from petsctpu.pc import asa as jasa
from petsctpu.pc import make_pc as jmake_pc
from petsctpu_torch.ksp import ksp_solve
from petsctpu_torch.mat import aij_from_scipy
from petsctpu_torch.models import laplacian_2d
from petsctpu_torch.models.elasticity import ex55_system
from petsctpu_torch.pc import asa as tasa
from petsctpu_torch.pc import make_pc
from petsctpu_torch.pc.gamg import rigid_body_modes

# one intra-op thread: the suite runs in parallel workers (pytest -n), and
# PyTorch's default of a thread a core oversubscribes the host's cores
torch.set_num_threads(1)

CPU = "cpu"


def anisotropic_laplacian(m, eps=1e-3):
    """2-D anisotropic Laplacian: -u_xx - eps*u_yy (the constant vector
    alone interpolates the smooth-in-x error badly)."""
    ex = sp.diags([-1.0, 2.0, -1.0], [-1, 0, 1], (m, m))
    I = sp.eye(m)
    return (sp.kron(I, ex) + eps * sp.kron(ex, I)).tocsr()


def _close_csr(got, ref, atol=1e-14):
    got, ref = sp.csr_matrix(got), sp.csr_matrix(ref)
    got.sort_indices()
    ref.sort_indices()
    assert got.shape == ref.shape
    np.testing.assert_array_equal(got.indptr, ref.indptr)
    np.testing.assert_array_equal(got.indices, ref.indices)
    np.testing.assert_allclose(got.data, ref.data, rtol=0, atol=atol)


@pytest.fixture(scope="module")
def ex55_candidates():
    A, _, coords = ex55_system(31, 1e-3)
    n = A.shape[0]
    return {"rbm": (A, rigid_body_modes(coords, dof=2)),
            "nc": (A, np.tile(np.eye(2), (n // 2, 1)))}


@pytest.mark.parametrize("seed,k,sizes", [(0, 2, (4, 4, 4, 4, 4)),
                                          (1, 3, (1, 2, 3, 5, 8)),
                                          (2, 1, (3, 3, 7))])
def test_tentative_prolongator_multi_equals_petsctpu(seed, k, sizes):
    rng = np.random.default_rng(seed)
    agg = rng.permutation(np.repeat(np.arange(len(sizes)), sizes))
    B = rng.standard_normal((agg.size, k))
    P0, Bc = tasa.tentative_prolongator_multi(agg, B)
    jP0, jBc = jasa.tentative_prolongator_multi(agg, B)
    _close_csr(P0, jP0)
    np.testing.assert_allclose(Bc, jBc, rtol=0, atol=1e-14)
    np.testing.assert_allclose(P0 @ Bc, B, atol=1e-12)


def test_tentative_multi_exact_interpolation():
    rng = np.random.default_rng(0)
    agg = np.repeat(np.arange(5), 4)
    B = rng.standard_normal((20, 2))
    P0, Bc = tasa.tentative_prolongator_multi(agg, B)
    np.testing.assert_allclose(P0 @ Bc, B, atol=1e-12)
    np.testing.assert_allclose((P0.T @ P0).toarray(), np.eye(10),
                               atol=1e-12)


def test_tentative_multi_small_aggregates():
    agg = np.array([0, 1, 1, 1])
    B = np.random.default_rng(1).standard_normal((4, 2))
    P0, Bc = tasa.tentative_prolongator_multi(agg, B)
    np.testing.assert_allclose(P0 @ Bc, B, atol=1e-12)
    assert P0.shape[1] == 3                  # the zero column was pruned


def test_collapse_by_block_equals_petsctpu(ex55_candidates):
    A, _ = ex55_candidates["rbm"]
    _close_csr(tasa._collapse_by_block(A, 2), jasa._collapse_by_block(A, 2),
               atol=0)


@pytest.mark.parametrize("route", ["rbm", "nc"])
def test_asa_hierarchy_equals_petsctpu(ex55_candidates, route):
    A, B = ex55_candidates[route]
    As, Ps = tasa.asa_hierarchy(A, B, coarse_n=80, bs=2)
    jAs, jPs = jasa.asa_hierarchy(A, B, coarse_n=80, bs=2)
    assert len(As) == len(jAs) >= 3 and len(Ps) == len(As) - 1
    for got, ref in zip(As + Ps, jAs + jPs):
        _close_csr(got, ref)


@pytest.mark.parametrize("route", ["rbm", "nc"])
def test_asa_tentatives_equal_petsctpu(ex55_candidates, route):
    A, B = ex55_candidates[route]
    P0s = tasa.asa_tentatives(A, B, coarse_n=30, bs=2)
    jP0s = jasa.asa_tentatives(A, B, coarse_n=30, bs=2)
    assert len(P0s) == len(jP0s) >= 2
    for got, ref in zip(P0s, jP0s):
        _close_csr(got, ref)


def test_asa_candidates_equal_petsctpu():
    A = anisotropic_laplacian(24, 1e-3)
    B = tasa.asa_candidates(A, max_candidates=3, target_factor=0.1)
    jB = jasa.asa_candidates(A, max_candidates=3, target_factor=0.1)
    assert B.shape == jB.shape and B.shape[1] >= 2
    np.testing.assert_allclose(B, jB, rtol=0, atol=1e-12)


def test_host_vcycle_and_relax_equal_petsctpu():
    A = sp.csr_matrix(laplacian_2d(16, 16))
    rng = np.random.default_rng(5)
    x = rng.standard_normal(A.shape[0])
    np.testing.assert_allclose(tasa._relax_candidate(A, x),
                               jasa._relax_candidate(A, x), rtol=0,
                               atol=1e-14)
    B = np.ones((A.shape[0], 1)) / 16.0
    As, Ps = tasa.asa_hierarchy(A, B, coarse_n=20)
    b = rng.standard_normal(A.shape[0])
    np.testing.assert_allclose(
        tasa._host_vcycle(As, Ps, b, np.zeros_like(b)),
        jasa._host_vcycle(As, Ps, b, np.zeros_like(b)), rtol=0, atol=1e-13)


def test_asa_pc_converges():
    A = laplacian_2d(24, 24)
    Ad = aij_from_scipy(A, dtype=np.float64, device=CPU)
    pc = make_pc("asa", A=Ad, A_host=A)
    res = ksp_solve(Ad, torch.ones(A.shape[0], dtype=torch.float64), pc=pc,
                    ksp_type="cg", rtol=1e-8, maxits=40)
    assert int(res.its) < 20
    np.testing.assert_allclose(A @ res.x.numpy(), 1.0, atol=1e-6)


def test_asa_beats_plain_sa_on_anisotropy():
    A = anisotropic_laplacian(32, 1e-3)
    Ad = aij_from_scipy(A, dtype=np.float64, device=CPU)
    b = torch.ones(A.shape[0], dtype=torch.float64)
    r_asa = ksp_solve(Ad, b, pc=make_pc("asa", A=Ad, A_host=A),
                      ksp_type="cg", rtol=1e-8, maxits=200)
    r_sa = ksp_solve(Ad, b, pc=make_pc("gamg", A=Ad, A_host=A),
                     ksp_type="cg", rtol=1e-8, maxits=200)
    assert int(r_asa.its) <= int(r_sa.its)


def test_asa_solve_matches_reference():
    A = laplacian_2d(24, 24)
    b = np.random.default_rng(6).standard_normal(A.shape[0])
    Ad = aij_from_scipy(A, dtype=np.float64, device=CPU)
    res = ksp_solve(Ad, torch.from_numpy(b), pc=make_pc("asa", A=Ad,
                                                       A_host=A),
                    ksp_type="cg", rtol=1e-8, maxits=40)
    jA = jaij_from_scipy(A, dtype=np.float64)
    jres = jksp_solve(jA, jnp.asarray(b), pc=jmake_pc("asa", A=jA, A_host=A),
                      ksp_type="cg", rtol=1e-8, maxits=40)
    its = int(res.its)
    assert its == int(jres.its) and int(res.reason) == int(jres.reason) > 0
    np.testing.assert_allclose(res.history[:its + 1].numpy(),
                               np.asarray(jres.history)[:its + 1],
                               rtol=1e-10)
