"""The distributed nonlinear solvers of slice 15 against petsctpu, over 4
rank threads (parallel.comm.World, device "cpu") and petsctpu's 4-device
CPU mesh.

* tests/test_psnes.py's distributed-MG and cavity cases (:119-214):
  Bratu λ 6 with FGMRES and a lagged make_dist_mg; ex19's cavity through
  cavity_residual_sharded with GMRES, and with FGMRES and a lagged
  make_dist_gamg. Newton its and reasons equal to petsctpu's
  par_snes_solve, x within the reference test's tolerances of its x.
* Anderson, NGMRES and NASM on a small Bratu, through par_snes_solve's
  `solver`. Anderson against petsctpu's snes_anderson under shard_map:
  equal its and reason, histories within 1e-8 of the first norm (the
  residuals' exp rounds apart by an ulp now and then, XLA's against
  PyTorch's). NGMRES and NASM against petsctpu's SERIAL solve on the
  whole grid, which the distributed method is (the same subdomains,
  rank by rank, for NASM): petsctpu's shard_map NGMRES reduces its Gram
  products per shard and takes 40+ iterations where its serial run
  takes 25, and its shard_map NASM waits forever in a collective (its
  shards' inner Newton solves end at different iterations); ROADMAP
  queue 3.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse as sp
import torch
from jax import shard_map
from jax.sharding import Mesh, PartitionSpec as PS

from petsctpu.core.options import Options as ROptions
from petsctpu.dm.da import DA as RDA
from petsctpu.ksp.common import KSPConfig as RKSPConfig
from petsctpu.models import bratu as rbratu
from petsctpu.models import cavity as rcavity
from petsctpu.parallel import ShardedFDJac as RFDJac
from petsctpu.parallel import par_snes_solve as r_par_snes
from petsctpu.snes.api import SNESConfig as RSNESConfig
from petsctpu.snes.api import SNESResult as RSNESResult

from petsctpu_torch.core.options import Options
from petsctpu_torch.dm import DA
from petsctpu_torch.ksp.common import KSPConfig
from petsctpu_torch.models import bratu as tbratu
from petsctpu_torch.models import cavity as tcavity
from petsctpu_torch.parallel import ShardedFDJac, World, par_snes_solve
from petsctpu_torch.snes.api import SNESConfig

torch.set_num_threads(1)

P = 4
STAR5 = ((0, 0), (-1, 0), (1, 0), (0, -1), (0, 1))
_WORLDS = {}


@pytest.fixture(autouse=True, scope="module")
def _close_worlds():
    yield
    for w in _WORLDS.values():
        w.close()
    _WORLDS.clear()


def world() -> World:
    if P not in _WORLDS or _WORLDS[P].closed:
        _WORLDS[P] = World(P, "cpu", timeout=60.0)
    return _WORLDS[P]


def mesh() -> Mesh:
    return Mesh(np.array(jax.devices()[:P]), ("rows",))


def cavity_offsets():
    return tuple((oj, oi, od) for (oj, oi) in STAR5 for od in range(-3, 4))


def assert_same_newton(rt, rr, n, rtol, atol):
    assert int(rt.its) == int(rr.its), (int(rt.its), int(rr.its))
    assert int(rt.reason) == int(rr.reason) and int(rt.reason) > 0
    np.testing.assert_allclose(rt.x.numpy()[:n], np.asarray(rr.x)[:n],
                               rtol=rtol, atol=atol)


def test_bratu_newton_distmg_matches_reference():
    """test_bratu_newton_distmg: Bratu λ 6 at 33², FGMRES + a lagged
    make_dist_mg of the Jacobian at x0 (pc_mg_repl_size 600), the
    residual and FD plan padded to the PC's mloc."""
    from petsctpu.pc.distmg import make_dist_mg as r_make
    from petsctpu.snes.fdjac import ColoredJacobian as RCJ

    from petsctpu_torch.pc.distmg import make_dist_mg

    m = 33
    lam = 6.0
    da = RDA((m, m))
    Fs = rbratu.bratu_residual(da, lam)
    x0 = rbratu.bratu_initial_guess(da, lam)
    plan_s = RCJ.from_stencil(rbratu.bratu_jacobian_template(da))
    J0 = plan_s.assemble(Fs, x0, Fs(x0))
    J0h = sp.csr_matrix(np.array([np.asarray(J0.mult(v))
                                  for v in np.eye(m * m)]).T)
    opts = {"pc_mg_repl_size": 600}
    pr = r_make(J0h, (m, m), P, dtype=np.float64, options=ROptions(opts))
    pt = make_dist_mg(J0h, (m, m), P, dtype=np.float64,
                      options=Options(opts), device="cpu")
    mloc = pt.A.mloc
    assert mloc == pr.A.mloc
    scfg = dict(rtol=1e-8, atol=1e-12)
    kcfg = dict(ksp_type="fgmres", rtol=1e-8, maxits=100)
    Fr, _ = rbratu.bratu_residual_sharded(da, P, mloc=mloc, lam=lam)
    rr = r_par_snes(mesh(), Fr, np.asarray(x0),
                    jac=RFDJac.plan((m, m), STAR5, P, mloc=mloc), pc=pr,
                    cfg=RSNESConfig(**scfg), ksp_cfg=RKSPConfig(**kcfg))
    Ft, _ = tbratu.bratu_residual_sharded(DA((m, m)), P, mloc=mloc, lam=lam)
    rt = par_snes_solve(world(), Ft, np.asarray(x0),
                        jac=ShardedFDJac.plan((m, m), STAR5, P, mloc=mloc,
                                              device="cpu"),
                        pc=pt, cfg=SNESConfig(**scfg),
                        ksp_cfg=KSPConfig(**kcfg))
    assert_same_newton(rt, rr, m * m, 1e-6, 1e-8)


@pytest.mark.parametrize("gamg", (False, True))
def test_cavity_newton_matches_reference(gamg):
    """test_cavity_newton_matches_serial (GMRES) and
    test_cavity_newton_dist_gamg (FGMRES + make_dist_gamg of the
    Jacobian at x0, pc_mg_repl_size 200): ex19 at 12 x 16 (my % P = 0),
    4 dofs a node, cavity_residual_sharded's ppermute halo and the
    sharded colored FD Jacobian; the residual itself bit for bit close to
    petsctpu's serial one."""
    from petsctpu.pc.distmg import make_dist_gamg as r_make

    from petsctpu_torch.pc.distmg import make_dist_gamg

    mx, my = 12, 16
    n = 4 * mx * my
    Fs = rcavity.cavity_residual(mx, my)
    x0 = np.asarray(rcavity.cavity_initial_guess(mx, my))
    scfg = dict(rtol=1e-8, atol=1e-12)
    kcfg = (dict(ksp_type="fgmres", rtol=1e-8, maxits=200) if gamg
            else dict(ksp_type="gmres", rtol=1e-8, maxits=400))
    pr = pt = None
    if gamg:
        Jc = jax.vmap(lambda v: jax.jvp(Fs, (jnp.asarray(x0),), (v,))[1])(
            jnp.eye(n))
        J0h = sp.csr_matrix(np.asarray(Jc).T)
        opts = {"pc_mg_repl_size": 200}
        pr = r_make(J0h, P, dtype=np.float64, options=ROptions(opts))
        pt = make_dist_gamg(J0h, P, dtype=np.float64, options=Options(opts),
                            device="cpu")
    Fr, grid = rcavity.cavity_residual_sharded(mx, my, P)
    Ft, grid_t = tcavity.cavity_residual_sharded(mx, my, P)
    assert grid == grid_t == (my, mx, 4)
    # the sharded residual at a random state against the serial one
    xr = np.random.default_rng(0).standard_normal(n)
    k = n // P
    Fx = torch.cat(world().run(lambda c, u: Ft(u, c), [
        (torch.from_numpy(xr[p * k:(p + 1) * k].copy()),)
        for p in range(P)])).numpy()
    np.testing.assert_allclose(Fx, np.asarray(Fs(jnp.asarray(xr))),
                               rtol=1e-14, atol=1e-14)
    rr = r_par_snes(mesh(), Fr, x0,
                    jac=RFDJac.plan((my, mx, 4), cavity_offsets(), P),
                    pc=pr, cfg=RSNESConfig(**scfg),
                    ksp_cfg=RKSPConfig(**kcfg))
    rt = par_snes_solve(world(), Ft, x0,
                        jac=ShardedFDJac.plan((my, mx, 4), cavity_offsets(),
                                              P, device="cpu"),
                        pc=pt, cfg=SNESConfig(**scfg),
                        ksp_cfg=KSPConfig(**kcfg))
    assert_same_newton(rt, rr, n, 1e-5 if gamg else 1e-6,
                       1e-7 if gamg else 1e-8)


# ---------------------------------------------------------------------------
# Anderson, NGMRES, NASM over the ranks
# ---------------------------------------------------------------------------
def small_bratu(m, lam):
    Ft, grid = tbratu.bratu_residual_sharded(DA((m, m)), P, lam=lam)
    x0 = np.asarray(rbratu.bratu_initial_guess(RDA((m, m)), lam))
    return Ft, grid, x0


def assert_same_history(rt, rr, rtol=1e-8, converged=True):
    assert int(rt.its) == int(rr.its), (int(rt.its), int(rr.its))
    assert int(rt.reason) == int(rr.reason)
    assert (int(rt.reason) > 0) == converged
    k = int(rt.its) + 1
    ref = np.asarray(rr.history[:k])
    np.testing.assert_allclose(rt.history[:k].numpy(), ref, rtol=0,
                               atol=rtol * ref[0])


def test_distributed_anderson_matches_reference_shard_map():
    """snes_anderson (window 5, β 0.2) on Bratu λ 5 at 8² over 4 ranks:
    its two Gram contractions psum'd, as petsctpu's under shard_map."""
    from petsctpu.snes.variants import snes_anderson as r_anderson

    from petsctpu_torch.snes.variants import snes_anderson

    m, lam = 8, 5.0
    Ft, grid, x0 = small_bratu(m, lam)
    Fr, _ = rbratu.bratu_residual_sharded(RDA((m, m)), P, lam=lam)
    cfg = dict(rtol=1e-8, atol=1e-12, maxits=100)
    kw = dict(window=5, beta=0.2)
    run = jax.jit(shard_map(
        lambda x: r_anderson(Fr, x, cfg=RSNESConfig(**cfg), axis="rows",
                             **kw),
        mesh=mesh(), in_specs=(PS("rows"),),
        out_specs=RSNESResult(PS("rows"), PS(), PS(), PS(), PS()),
        check_vma=False))
    rr = run(jnp.asarray(x0))
    world().reset_counts()
    rt = par_snes_solve(world(), Ft, x0, cfg=SNESConfig(**cfg),
                        n_pad=grid[0] * grid[1], solver=snes_anderson,
                        solver_kw=kw)
    assert_same_history(rt, rr)
    np.testing.assert_allclose(rt.x.numpy()[:m * m], np.asarray(rr.x),
                               rtol=1e-8, atol=1e-10)
    # two psums a mixing step, beside the norms
    assert world().comms[0].counts["psum"][0] >= 2 * int(rt.its)


def test_distributed_ngmres_matches_reference_serial():
    """snes_ngmres (the reference's defaults) on Bratu λ 5 at 16² over 4
    ranks: the subspace's inner products and distances summed over the
    ranks, so every rank takes the serial method's selections and
    restarts; its, reason and history those of petsctpu's serial
    snes_ngmres on the whole grid."""
    from petsctpu.snes.variants import snes_ngmres as r_ngmres

    from petsctpu_torch.snes.variants import snes_ngmres

    m, lam = 16, 5.0
    Ft, grid, x0 = small_bratu(m, lam)
    cfg = dict(rtol=1e-8, atol=1e-12, maxits=60)
    rr = r_ngmres(rbratu.bratu_residual(RDA((m, m)), lam), jnp.asarray(x0),
                  cfg=RSNESConfig(**cfg))
    rt = par_snes_solve(world(), Ft, x0, cfg=SNESConfig(**cfg),
                        n_pad=grid[0] * grid[1], solver=snes_ngmres)
    assert_same_history(rt, rr, rtol=1e-7)
    np.testing.assert_allclose(rt.x.numpy()[:m * m], np.asarray(rr.x),
                               rtol=1e-7, atol=1e-9)


def test_distributed_nasm_matches_reference_serial():
    """snes_nasm on Bratu λ 5 at 8² over 4 ranks, two overlapping
    subdomains a rank (local indices), the halos frozen at the outer
    iterate (Comm.recording_halos / replaying_halos): its, reason and
    history those of petsctpu's serial snes_nasm with the same
    subdomains in global numbering, rank by rank, over 12 outer
    iterations (the method needs 67 to rtol 1e-8, about a minute of
    matrix-free inner solves on the CPU)."""
    from petsctpu.snes.nasm import snes_nasm as r_nasm

    from petsctpu_torch.snes.nasm import snes_nasm

    m, lam = 8, 5.0
    Ft, grid, x0 = small_bratu(m, lam)
    nloc = m * m // P
    local = [np.arange(0, nloc // 2 + m), np.arange(nloc // 2 - m, nloc)]
    glob = [s + p * nloc for p in range(P) for s in local]
    cfg = dict(rtol=1e-8, atol=1e-12, maxits=12)
    rr = r_nasm(rbratu.bratu_residual(RDA((m, m)), lam), jnp.asarray(x0),
                glob, cfg=RSNESConfig(**cfg))
    world().reset_counts()
    rt = par_snes_solve(world(), Ft, x0, cfg=SNESConfig(**cfg),
                        n_pad=grid[0] * grid[1], solver=snes_nasm,
                        solver_kw=dict(subdomains=local))
    assert_same_history(rt, rr, rtol=1e-8, converged=False)
    assert int(rt.its) == 12
    np.testing.assert_allclose(rt.x.numpy()[:m * m], np.asarray(rr.x),
                               rtol=1e-8, atol=1e-10)
    # the subdomain solves send nothing: one halo exchange (two
    # ppermutes) an outer iteration and the first and last evaluations
    assert world().comms[0].counts["ppermute"][0] == 2 * (int(rt.its) + 2)
