"""Distributed multigrid (petsctpu_torch/pc/distmg.py) against petsctpu
(tests/test_distmg.py's seven cases).

The port's ranks are threads of the test process (parallel.comm.World,
device "cpu"), 4 of them, or 2 x 4 for make_dist_mg_hier; petsctpu runs
under a Mesh of as many CPU devices. In fp64: iterations and reasons
equal to petsctpu's, histories within 1e-10·‖r0‖ (the sums' orders
differ: XLA's against PyTorch's), x within the reference test's 1e-6 of
the exact solution; transfers within 1e-12 of scipy; the collectives an
iteration (counted at run time over two short solves) equal to
petsctpu's jaxpr audit of the same program.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax import shard_map
from jax.sharding import Mesh, PartitionSpec as PS

from petsctpu.models import ex2_system, ex45_system
from petsctpu.parallel.api import par_ksp_solve as r_par_ksp_solve
from petsctpu.pc import distmg as rdistmg

from petsctpu_torch.parallel import World, par_ksp_solve, unshard_vector
from petsctpu_torch.parallel.api import audit_par_ksp
from petsctpu_torch.pc import distmg as tdistmg

torch.set_num_threads(1)

P = 4
_WORLDS = {}


@pytest.fixture(autouse=True, scope="module")
def _close_worlds():
    yield
    for w in _WORLDS.values():
        w.close()
    _WORLDS.clear()


def world(mesh_shape=None) -> World:
    key = mesh_shape or P
    if key not in _WORLDS or _WORLDS[key].closed:
        n = P if mesh_shape is None else mesh_shape[0] * mesh_shape[1]
        _WORLDS[key] = World(n, "cpu", timeout=60.0, mesh=mesh_shape)
    return _WORLDS[key]


def mesh(n=P) -> Mesh:
    return Mesh(np.array(jax.devices()[:n]), ("rows",))


def hier_mesh(H, C) -> Mesh:
    return Mesh(np.array(jax.devices()[:H * C]).reshape(H, C),
                ("dcn", "ici"))


def assert_same_solve(rt, rr, u, n):
    assert int(rt.its) == int(rr.its), (int(rt.its), int(rr.its))
    assert int(rt.reason) == int(rr.reason) and int(rt.reason) > 0
    k = int(rt.its) + 1
    ref = np.asarray(rr.history[:k])
    np.testing.assert_allclose(rt.history[:k].numpy(), ref, rtol=0,
                               atol=1e-10 * ref[0])
    np.testing.assert_allclose(unshard_vector(rt.x, n), u, atol=1e-6)


def ref_audit(mesh_, A, b, pc, maxits=5):
    """petsctpu's jaxpr audit of CG + pc over mesh_ (its axes: A.axis)."""
    from petsctpu.core.commaudit import audit_collectives
    from petsctpu.ksp.api import KSP_REGISTRY
    from petsctpu.ksp.common import KSPConfig, SolveResult
    from petsctpu.parallel.api import _local, _pc_specs

    cfg = KSPConfig(ksp_type="cg", maxits=maxits, rtol=0.0, atol=0.0)
    ax = A.axis
    run = shard_map(
        lambda A_, b_, x_, pc_: KSP_REGISTRY["cg"](A_.local(), b_, x_,
                                                   _local(pc_), cfg, ax),
        mesh=mesh_, in_specs=(PS(ax), PS(ax), PS(ax), _pc_specs(pc, ax)),
        out_specs=SolveResult(PS(ax), PS(), PS(), PS(), PS()),
        check_vma=False)
    bp = np.zeros(A.shape[0])
    bp[:len(b)] = b
    bp = jnp.asarray(bp)
    return audit_collectives(run, A, bp, jnp.zeros_like(bp), pc).per_iteration


def assert_audit_equal(w, pc_t, b, mesh_, pc_r):
    ta = audit_par_ksp(w, pc_t.A, b, pc=pc_t, ksp_type="cg",
                       key=f"test distmg[{w.size}]").per_iteration
    ra = ref_audit(mesh_, pc_r.A, b, pc_r)
    assert ta.counts == ra.counts, (ta.counts, ra.counts)
    assert ta.bytes == ra.bytes, (ta.bytes, ra.bytes)
    return ta


@pytest.mark.parametrize("m,nlev,maxits", [(33, 1, None), (65, 2, 10)])
def test_cg_distmg_2d_matches_reference(m, nlev, maxits):
    """test_cg_distmg_matches_serial_quality (33²) and
    test_multilevel_sharded_hierarchy (65²: two sharded levels): CG +
    make_dist_mg to rtol 1e-8; the 33² its at most the serial MG's + 4
    (the port's serial -pc_type mg on the same grid); the collectives an
    iteration of 33² equal petsctpu's audit (all_gather 1, ppermute 16,
    psum 2 at 8 ranks in its dry run; here at 4)."""
    A, b, u = ex2_system(m, m)
    b = np.asarray(b)
    pr = rdistmg.make_dist_mg(A, (m, m), P)
    pt = tdistmg.make_dist_mg(A, (m, m), P, device="cpu")
    assert len(pt.levels) == len(pr.levels) == nlev
    assert len(pt.transfers) == nlev - 1
    assert pt.grids == pr.grids and pt.A.grid == pr.A.grid
    rr = r_par_ksp_solve(mesh(), pr.A, b, pc=pr, ksp_type="cg", rtol=1e-8)
    rt = par_ksp_solve(world(), pt.A, b, pc=pt, ksp_type="cg", rtol=1e-8)
    assert_same_solve(rt, rr, u, m * m)
    if maxits is not None:
        assert int(rt.its) <= maxits
        return
    from petsctpu_torch.core.options import Options
    from petsctpu_torch.dm import DA
    from petsctpu_torch.ksp import ksp_solve
    from petsctpu_torch.mat import aij_from_scipy
    from petsctpu_torch.pc import make_pc

    Ad = aij_from_scipy(A, device="cpu")
    rs = ksp_solve(Ad, torch.from_numpy(b), pc=make_pc(
        "mg", A=Ad, A_host=A, options=Options({"pc_mg_da": DA((m, m))})),
        ksp_type="cg", rtol=1e-8)
    assert int(rt.its) <= int(rs.its) + 4, (int(rt.its), int(rs.its))
    ta = assert_audit_equal(world(), pt, b, mesh(), pr)
    assert ta.counts == {"all_gather": 1, "ppermute": 16, "psum": 2}


def test_distmg_3d_matches_reference():
    """test_distmg_3d: ex45 at 17³ (fp64), CG + make_dist_mg, at most 12
    its; the per-rank true and padded rows of the sharded levels."""
    g = 17
    A, b, u = ex45_system(g, g, g)
    b = np.asarray(b)
    pr = rdistmg.make_dist_mg(A, (g, g, g), P)
    pt = tdistmg.make_dist_mg(A, (g, g, g), P, device="cpu")
    assert [lv.A.grid for lv in pt.levels] == [lv.A.grid for lv in pr.levels]
    rr = r_par_ksp_solve(mesh(), pr.A, b, pc=pr, ksp_type="cg", rtol=1e-8)
    rt = par_ksp_solve(world(), pt.A, b, pc=pt, ksp_type="cg", rtol=1e-8)
    assert_same_solve(rt, rr, u, g ** 3)
    assert int(rt.its) <= 12


def test_hier_dcn_ici_mg_matches_reference():
    """test_hier_dcn_ici_mg: a 2 x 4 World, the fine level sharded over
    all 8 ranks, the next re-sharded onto each row's 4 (the same on both
    rows), the coarsest replicated; its, history and the collectives an
    iteration (all_gather 3) equal petsctpu's."""
    m = 65
    A, b, u = ex2_system(m, m)
    b = np.asarray(b)
    pr = rdistmg.make_dist_mg_hier(A, (m, m), 2, 4)
    pt = tdistmg.make_dist_mg_hier(A, (m, m), 2, 4, device="cpu")
    assert pt.inner is not None and pt.coarse is None
    assert pt.inner.nshards == 4 and pt.nshards == 8
    assert pt.inner.grids == pr.inner.grids and pt.grids == pr.grids
    w = world((2, 4))
    rr = r_par_ksp_solve(hier_mesh(2, 4), pr.A, b, pc=pr, ksp_type="cg",
                         rtol=1e-8)
    rt = par_ksp_solve(w, pt.A, b, pc=pt, ksp_type="cg", rtol=1e-8)
    assert_same_solve(rt, rr, u, m * m)
    assert int(rt.its) <= 10
    ta = assert_audit_equal(w, pt, b, hier_mesh(2, 4), pr)
    assert ta.counts["all_gather"] == 3


def test_sharded_q1_transfer_matches_scipy():
    """test_sharded_q1_transfer_matches_scipy: ShardedQ1Interp's mult and
    multT on the true entries within 1e-12 of scipy's Q1 operator, the
    pad entries zero."""
    from petsctpu.dm.da import q1_interp_scipy

    from petsctpu_torch.parallel.pstencil import sharded_q1_interp

    fg, cg = (33, 9), (17, 5)
    T = sharded_q1_interp(fg, cg, P, mloc_f=2 * (-(-cg[0] // P)),
                          device="cpu")
    Ps = q1_interp_scipy(fg, cg)
    rng = np.random.default_rng(3)
    xc = rng.standard_normal(cg[0] * cg[1])
    xf = rng.standard_normal(fg[0] * fg[1])
    nc, nf = int(np.prod(T.coarse)), int(np.prod(T.fine))
    xcp, xfp = np.zeros(nc), np.zeros(nf)
    xcp[:xc.size], xfp[:xf.size] = xc, xf
    sc, sf = nc // P, nf // P
    out = world().run(
        lambda c, a, f: (T.rank(c).mult(a), T.rank(c).multT(f)),
        [(torch.from_numpy(xcp[p * sc:(p + 1) * sc].copy()),
          torch.from_numpy(xfp[p * sf:(p + 1) * sf].copy()))
         for p in range(P)])
    yf = torch.cat([o[0] for o in out]).numpy()
    yc = torch.cat([o[1] for o in out]).numpy()
    np.testing.assert_allclose(yf[:xf.size], Ps @ xc, atol=1e-12)
    np.testing.assert_array_equal(yf[xf.size:], 0.0)
    np.testing.assert_allclose(yc[:xc.size], Ps.T @ xf, atol=1e-12)
    np.testing.assert_array_equal(yc[xc.size:], 0.0)


def test_sharded_rect_transfer_matches_scipy():
    """test_sharded_rect_transfer_matches_scipy: the sharded GAMG
    prolongator of ex2 17² (ShardedRectAIJ), mult and multT within 1e-12
    of scipy's."""
    from petsctpu_torch.parallel.pmat import sharded_rect_from_scipy
    from petsctpu_torch.pc.gamg import gamg_hierarchy

    A, b, u = ex2_system(17, 17)
    _, Ps = gamg_hierarchy(A)
    Psc = Ps[0]
    T = sharded_rect_from_scipy(Psc, P, device="cpu")
    nf, nc = Psc.shape
    rng = np.random.default_rng(5)
    xc, xf = rng.standard_normal(nc), rng.standard_normal(nf)
    xcp, xfp = np.zeros(T.shape[1]), np.zeros(T.shape[0])
    xcp[:nc], xfp[:nf] = xc, xf
    sc, sf = T.shape[1] // P, T.shape[0] // P
    out = world().run(
        lambda c, a, f: (T.rank(c).mult(a), T.rank(c).multT(f)),
        [(torch.from_numpy(xcp[p * sc:(p + 1) * sc].copy()),
          torch.from_numpy(xfp[p * sf:(p + 1) * sf].copy()))
         for p in range(P)])
    yf = torch.cat([o[0] for o in out]).numpy()
    yc = torch.cat([o[1] for o in out]).numpy()
    np.testing.assert_allclose(yf[:nf], Psc @ xc, atol=1e-12)
    np.testing.assert_allclose(yc[:nc], Psc.T @ xf, atol=1e-12)


def test_dist_gamg_matches_reference():
    """test_dist_gamg_matches_serial_iterations: ex2 65², CG +
    make_dist_gamg (sharded AIJ levels, ShardedRectAIJ transfers, the
    replicated tail) to petsctpu's its and history, within 1 of the
    port's serial GAMG; the collectives an iteration equal petsctpu's
    audit."""
    from petsctpu_torch.ksp import ksp_solve
    from petsctpu_torch.mat import aij_from_scipy
    from petsctpu_torch.pc import make_pc

    m = 65
    A, b, u = ex2_system(m, m)
    b = np.asarray(b)
    pr = rdistmg.make_dist_gamg(A, P)
    pt = tdistmg.make_dist_gamg(A, P, device="cpu")
    assert len(pt.levels) == len(pr.levels) >= 2
    rr = r_par_ksp_solve(mesh(), pr.A, b, pc=pr, ksp_type="cg", rtol=1e-8)
    rt = par_ksp_solve(world(), pt.A, b, pc=pt, ksp_type="cg", rtol=1e-8)
    assert_same_solve(rt, rr, u, m * m)
    Ad = aij_from_scipy(A, device="cpu")
    rs = ksp_solve(Ad, torch.from_numpy(b),
                   pc=make_pc("gamg", A=Ad, A_host=A), ksp_type="cg",
                   rtol=1e-8)
    assert abs(int(rt.its) - int(rs.its)) <= 1, (int(rt.its), int(rs.its))
    assert_audit_equal(world(), pt, b, mesh(), pr)
