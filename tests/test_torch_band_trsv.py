"""The banded triangular plans and their routes, against petsctpu's.

* make_band_trsv_plan: the inverted diagonal tiles and the off tiles
  equal petsctpu's byte for byte (the same host numpy); a solve within
  1e-12 of petsctpu's and of a dense solve.
* make_band_trsv_hier_plan: its tiles byte for byte, the propagators Pg
  and prefix rows R within 1e-10 relative (products on the device in
  another order than XLA's scan), a solve within 1e-11.
* -pc_factor_tri_solve band|band2 for ILU(k), ILUTP and ICC, bjacobi's
  -sub_pc_factor_tri_solve band2, and -pc_gamg_mat_type band: each
  apply within 1e-11 of petsctpu's same route, and of the level route.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse as sp
import torch

from petsctpu.core.options import Options as JOptions
from petsctpu.mat import factor as jfactor
from petsctpu.mat.ell import aij_from_scipy as jaij
from petsctpu.models import ex2_system, laplacian_2d
from petsctpu.pc import make_pc as jmake_pc
from petsctpu_torch.core.options import Options
from petsctpu_torch.ksp import ksp_solve
from petsctpu_torch.mat import factor as tfactor
from petsctpu_torch.mat.ell import aij_from_scipy
from petsctpu_torch.pc import make_pc

# one intra-op thread: the suite runs in parallel workers (pytest -n), and
# PyTorch's default of a thread a core oversubscribes the host's cores
torch.set_num_threads(1)

CPU = "cpu"


def close(got, ref, rtol):
    got, ref = np.asarray(got), np.asarray(ref)
    assert got.shape == ref.shape
    assert np.abs(got - ref).max() <= rtol * np.abs(ref).max()


def triangles(mx, my, wide=False):
    A = sp.csr_matrix(ex2_system(mx, my)[0])
    if wide:        # a bandwidth of several tiles (W > T)
        n = A.shape[0]
        A = (A + sp.diags(np.full(n - 300, -0.01), 300)
             + sp.diags(np.full(n - 300, -0.01), -300)).tocsr()
    L, U = jfactor.ilu0(A)
    return A, L, U


@pytest.mark.parametrize("mx,my,tile,wide", [(14, 14, None, False),
                                             (13, 11, 64, False),
                                             (40, 40, None, False),
                                             (30, 30, 128, True)])
def test_flat_plan_tiles_and_solve(mx, my, tile, wide):
    A, L, U = triangles(mx, my, wide)
    x = np.random.default_rng(0).standard_normal(A.shape[0])
    for Tm, lower, unit in ((L, True, True), (U, False, False)):
        p = tfactor.make_band_trsv_plan(Tm, lower, unit, tile=tile,
                                        device=CPU)
        q = jfactor.make_band_trsv_plan(Tm, lower, unit, tile=tile)
        np.testing.assert_array_equal(p.dinv_tiles.numpy(),
                                      np.asarray(q.dinv_tiles))
        np.testing.assert_array_equal(p.off_tiles.numpy(),
                                      np.asarray(q.off_tiles))
        assert (p.tile, p.n, p.lower) == (q.tile, q.n, q.lower)
        y = p.solve(torch.from_numpy(x)).numpy()
        close(y, q.solve(jnp.asarray(x)), 1e-12)
        Td = Tm.toarray()
        if unit:
            np.fill_diagonal(Td, 1.0)
        close(y, np.linalg.solve(Td, x), 1e-11)


@pytest.mark.parametrize("mx,my,group_len,wide", [(14, 14, None, False),
                                                  (40, 40, None, False),
                                                  (40, 40, 3, False),
                                                  (30, 30, None, True)])
def test_hier_plan_tiles_propagators_and_solve(mx, my, group_len, wide):
    A, L, U = triangles(mx, my, wide)
    x = np.random.default_rng(1).standard_normal(A.shape[0])
    for Tm, lower, unit in ((L, True, True), (U, False, False)):
        p = tfactor.make_band_trsv_hier_plan(Tm, lower, unit,
                                             group_len=group_len, device=CPU)
        q = jfactor.make_band_trsv_hier_plan(Tm, lower, unit,
                                             group_len=group_len)
        np.testing.assert_array_equal(p.dinv_tiles.numpy(),
                                      np.asarray(q.dinv_tiles))
        np.testing.assert_array_equal(p.off_tiles.numpy(),
                                      np.asarray(q.off_tiles))
        close(p.Pg.numpy(), q.Pg, 1e-10)
        close(p.R.numpy(), q.R, 1e-10)
        assert (p.nt, p.n, p.tile) == (q.nt, q.n, q.tile)
        y = p.solve(torch.from_numpy(x)).numpy()
        close(y, q.solve(jnp.asarray(x)), 1e-11)
        Td = Tm.toarray()
        if unit:
            np.fill_diagonal(Td, 1.0)
        close(y, np.linalg.solve(Td, x), 1e-10)


ROUTES = [
    ("ilu", {"pc_factor_tri_solve": "band"}),
    ("ilu", {"pc_factor_tri_solve": "band2"}),
    ("ilu", {"pc_factor_tri_solve": "band2", "pc_factor_levels": "1"}),
    ("ilu", {"pc_factor_tri_solve": "band", "pc_factor_drop_tolerance":
             "0.01"}),
    ("icc", {"pc_factor_tri_solve": "band"}),
    ("icc", {"pc_factor_tri_solve": "band2"}),
    ("bjacobi", {"pc_bjacobi_blocks": "3", "sub_pc_factor_tri_solve":
                 "band2"}),
]


@pytest.mark.parametrize("pc_type,opts", ROUTES)
def test_banded_routes_match_petsctpu_and_levels(pc_type, opts):
    A = sp.csr_matrix(ex2_system(17, 15)[0])
    Ad = aij_from_scipy(A, device=CPU)
    pc = make_pc(pc_type, A=Ad, A_host=A, options=Options(opts))
    jpc = jmake_pc(pc_type, A=jaij(A), A_host=A, options=JOptions(opts))
    level = make_pc(pc_type, A=Ad, A_host=A, options=Options(
        {k: v for k, v in opts.items() if "tri_solve" not in k}))
    b = np.random.default_rng(2).standard_normal(A.shape[0])
    y = pc.apply(torch.from_numpy(b)).numpy()
    close(y, jpc.apply(jnp.asarray(b)), 1e-11)
    close(y, level.apply(torch.from_numpy(b)).numpy(), 1e-11)


def test_ilu_band_solve_has_the_level_solves_its():
    A, b, _ = ex2_system(10, 10)
    Ad = aij_from_scipy(A, device=CPU)
    its = []
    for tri in ("level", "band", "band2"):
        pc = make_pc("ilu", A=Ad, A_host=A,
                     options=Options({"pc_factor_tri_solve": tri}))
        r = ksp_solve(Ad, torch.from_numpy(np.asarray(b)), pc=pc,
                      ksp_type="gmres", rtol=1e-10)
        its.append(int(r.its))
    assert its[0] == its[1] == its[2]


def test_gamg_band_levels_match_petsctpu():
    A = laplacian_2d(24, 24)
    o = {"pc_gamg_mat_type": "band", "pc_gamg_coarse_eq_limit": "30"}
    pc = make_pc("gamg", A=aij_from_scipy(A, device=CPU), A_host=A,
                 options=Options(o))
    jpc = jmake_pc("gamg", A=jaij(A), A_host=A, options=JOptions(o))
    assert type(pc).__name__ == "PermutedPC"
    assert all(type(lev.A).__name__ == "BandMat" for lev in pc.inner.levels)
    b = np.random.default_rng(3).standard_normal(A.shape[0])
    close(pc.apply(torch.from_numpy(b)).numpy(), jpc.apply(jnp.asarray(b)),
          1e-11)
