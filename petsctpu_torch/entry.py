"""Driver entry points of the port.

Counterpart of petsctpu's `__graft_entry__.py`.

entry(device=None): the single-card step on the flagship problem — a
preconditioned CG iteration block on the 64² 2-D Poisson system (SpMV,
PC apply and the reductions). Returns (step, args); step(*args) gives
(x, rnorm).

dryrun_multichip(n, device=None): the distributed solves of the
reference's dryrun over a parallel.comm.World of n rank threads on one
device (row-sharded operators with halo exchanges and collectives),
each run once on tiny shapes; it prints the reference's lines.

    python -m petsctpu_torch.entry            # entry() on the card
    python -m petsctpu_torch.entry dryrun 4   # dryrun_multichip(4)
"""

from __future__ import annotations

import json
import sys

import numpy as np
import scipy.sparse as sp
import torch

from petsctpu_torch.device import resolve_device

STAR5 = ((0, 0), (-1, 0), (1, 0), (0, -1), (0, 1))


def entry(device=None):
    from petsctpu_torch.ksp import ksp_solve
    from petsctpu_torch.mat import aij_from_scipy
    from petsctpu_torch.models import laplacian_2d
    from petsctpu_torch.pc.simple import make_jacobi

    dev = resolve_device(device)
    m = 64
    A = laplacian_2d(m, m, dtype=np.float32)
    Ad = aij_from_scipy(A, dtype=np.float32, device=dev)
    pc = make_jacobi(Ad)
    b = torch.from_numpy((A @ np.ones(m * m)).astype(np.float32)).to(dev)
    x0 = torch.zeros(m * m, dtype=torch.float32, device=dev)

    def step(Ad, b, x0, pc):
        res = ksp_solve(Ad, b, x0=x0, pc=pc, ksp_type="cg", rtol=1e-6,
                        maxits=25)
        return res.x, res.rnorm

    return step, (Ad, b, x0, pc)


def _check(ok: bool, what) -> None:
    if not ok:
        raise RuntimeError(f"dryrun: {what}")


def dryrun_multichip(n_devices: int, device=None) -> dict:
    """Returns {solve: (its, reason)} of every solve it ran (Newton its
    for the nonlinear ones, steps for the TS)."""
    from petsctpu_torch.parallel import World

    dev = resolve_device(device)
    out = {}
    with World(n_devices, dev) as world:
        audited = _flat_solves(world, n_devices, dev, out)
        if n_devices >= 4 and n_devices % 2 == 0:
            _subcomm_solves(world, n_devices, dev, out)
        _nonlinear_solves(world, n_devices, dev, out)
        _comm_tables(world, *audited)
    return out


def _comm_tables(world, Ash, part, pc, b):
    """The collective table (the -log_summary Mess columns, counted at
    run time over two short runs) of the GMRES and IBCGS programs, and
    the halo plan's volume."""
    from petsctpu_torch.core.commaudit import comm_table, halo_audit
    from petsctpu_torch.parallel.api import audit_par_ksp

    audit_par_ksp(world, Ash, b, pc=pc, ksp_type="gmres")
    audit_par_ksp(world, Ash, b, ksp_type="ibcgs")
    print(comm_table())
    print("halo plan (ex2 GMRES operator):",
          json.dumps(halo_audit(part.halo, np.float32)))


def _flat_solves(world, P, dev, out):
    from petsctpu_torch.mat import stencil_from_scipy
    from petsctpu_torch.models import ex2_system
    from petsctpu_torch.parallel import (par_ksp_solve,
                                         sharded_aij_from_scipy,
                                         sharded_stencil_from,
                                         unshard_vector)
    from petsctpu_torch.pc.distmg import make_dist_gamg, make_dist_mg
    from petsctpu_torch.pc.parallel import RankPCs, make_par_pc
    from petsctpu_torch.pc.simple import JacobiPC

    f32 = np.float32
    A, b, u = ex2_system(8, 2 * P)              # tiny, divisible-ish
    Ash, part = sharded_aij_from_scipy(A, P, dtype=f32, device=dev)
    pc = make_par_pc("bjacobi", Ash, part)      # per-shard ILU(0) blocks
    res = par_ksp_solve(world, Ash, b.astype(f32), pc=pc, ksp_type="gmres",
                        rtol=1e-6, maxits=50)
    x = unshard_vector(res.x, part.layout)
    err = float(np.linalg.norm(x - u))
    _check(int(res.reason) > 0, f"solve did not converge: {int(res.reason)}")
    _check(err < 1e-3, f"solution error {err}")
    out["gmres_bjacobi"] = (int(res.its), int(res.reason))
    print(f"dryrun_multichip({P}): GMRES+BJacobi(ILU0) converged in "
          f"{int(res.its)} its, err={err:.2e}")

    # the structured path: sharded stencil + halo rows + pipecg
    m = 2 * P
    A2, b2, u2 = ex2_system(m, m)
    S = stencil_from_scipy(A2, (m, m), dtype=f32, device=dev)
    Sh = sharded_stencil_from(S, P, device=dev)
    dpad = np.ones(Sh.shape[0], f32)
    dpad[: m * m] = A2.diagonal()
    dinv = (1.0 / dpad).reshape(P, -1)
    pc2 = RankPCs([JacobiPC(torch.from_numpy(d.copy()).to(dev))
                   for d in dinv])
    r2 = par_ksp_solve(world, Sh, b2.astype(f32), pc=pc2, ksp_type="pipecg",
                       rtol=1e-5, maxits=200)
    err2 = float(np.linalg.norm(r2.x.cpu().numpy()[: m * m] - u2))
    _check(int(r2.reason) > 0 and err2 < 1e-2, (int(r2.reason), err2))
    out["pipecg_stencil"] = (int(r2.its), int(r2.reason))
    print(f"dryrun_multichip({P}): PIPECG on sharded stencil "
          f"(ppermute halos) converged in {int(r2.its)} its, err={err2:.2e}")

    # single-reduction IBCGS over the same sharded operator (one fused
    # reduction an iteration)
    r3 = par_ksp_solve(world, Ash, b.astype(f32), ksp_type="ibcgs",
                       rtol=1e-5, maxits=100)
    _check(int(r3.reason) > 0, f"ibcgs: {int(r3.reason)}")
    out["ibcgs"] = (int(r3.its), int(r3.reason))
    print(f"dryrun_multichip({P}): IBCGS (one fused reduction/it) "
          f"converged in {int(r3.its)} its")

    # distributed multigrid: sharded fine-level smoothing + agglomerated
    # replicated coarse hierarchy (gamg.c:174-198's pattern)
    m3 = 17
    A3, b3, u3 = ex2_system(m3, m3)
    pc3 = make_dist_mg(A3, (m3, m3), P, dtype=f32, device=dev)
    r4 = par_ksp_solve(world, pc3.A, b3.astype(f32), pc=pc3,
                       ksp_type="cg", rtol=1e-5, maxits=60)
    err4 = float(np.linalg.norm(r4.x.cpu().numpy()[: m3 * m3] - u3))
    _check(int(r4.reason) > 0 and err4 < 1e-2, (int(r4.reason), err4))
    out["dist_mg"] = (int(r4.its), int(r4.reason))
    print(f"dryrun_multichip({P}): distributed MG (sharded "
          f"smoothing + agglomerated coarse) converged in {int(r4.its)} its")

    # distributed algebraic multigrid: sharded GAMG levels + sharded
    # rectangular prolongators + replicated tail
    m5 = 33
    A5, b5, u5 = ex2_system(m5, m5)
    pc5 = make_dist_gamg(A5, P, dtype=f32, device=dev)
    r6 = par_ksp_solve(world, pc5.A, b5.astype(f32), pc=pc5,
                       ksp_type="cg", rtol=1e-5, maxits=60)
    err6 = float(np.linalg.norm(r6.x.cpu().numpy()[: m5 * m5] - u5))
    _check(int(r6.reason) > 0 and err6 < 1e-2, (int(r6.reason), err6))
    out["dist_gamg"] = (int(r6.its), int(r6.reason))
    print(f"dryrun_multichip({P}): distributed GAMG (sharded "
          f"algebraic levels) converged in {int(r6.its)} its")
    return Ash, part, pc, b.astype(f32)


def _subcomm_solves(world, P, dev, out):
    from petsctpu_torch.core.options import Options
    from petsctpu_torch.models import ex2_system
    from petsctpu_torch.parallel import (World, nested_mesh, par_ksp_solve,
                                         sharded_aij_from_scipy,
                                         sharded_aij_hier_from_scipy,
                                         sub_ksp_solve, unshard_vector)
    from petsctpu_torch.pc.distmg import make_dist_mg_hier

    f32 = np.float32
    A, b, u = ex2_system(8, 2 * P)
    # subcommunicator nesting: two independent group solves at once
    Ash2, _ = sharded_aij_from_scipy(A, P // 2, dtype=f32, device=dev)
    rs = sub_ksp_solve(nested_mesh(world, 2), [Ash2, Ash2],
                       [b.astype(f32), 2 * b.astype(f32)],
                       ksp_type="cg", rtol=1e-5, maxits=100)
    _check(int(rs.reason[0]) > 0 and int(rs.reason[1]) > 0,
           f"subcomm solves: {rs.reason}")
    out["subcomm"] = ((int(rs.its[0]), int(rs.its[1])),
                      (int(rs.reason[0]), int(rs.reason[1])))
    print(f"dryrun_multichip({P}): 2x{P // 2} subcomm "
          f"mesh solves converged in {int(rs.its[0])}/{int(rs.its[1])} "
          "its")

    # two-level (dcn, ici) halos over an H x C World
    Hh, Cc = 2, P // 2
    with World(P, dev, mesh=(Hh, Cc)) as world_h:
        Ah, part_h = sharded_aij_hier_from_scipy(A, Hh, Cc, dtype=f32,
                                                 device=dev)
        rh = par_ksp_solve(world_h, Ah, b.astype(f32), ksp_type="cg",
                           rtol=1e-5, maxits=200)
        errh = float(np.linalg.norm(unshard_vector(rh.x, part_h.layout)
                                    - u))
        _check(int(rh.reason) > 0 and errh < 1e-2, (int(rh.reason), errh))
        out["hier_cg"] = (int(rh.its), int(rh.reason))
        print(f"dryrun_multichip({P}): two-level (dcn,ici) halo "
              f"CG converged in {int(rh.its)} its, err={errh:.2e}")

        # hierarchical MG over the same mesh: fine levels sharded over
        # all H*C ranks, mid levels over each host's ici axis, coarsest
        # replicated
        m4 = 33
        A4, b4, u4 = ex2_system(m4, m4)
        opts4 = Options({"pc_mg_dcn_repl_size": 256, "pc_mg_repl_size": 64})
        pc4 = make_dist_mg_hier(A4, (m4, m4), Hh, Cc, dtype=f32,
                                options=opts4, device=dev)
        _check(pc4.inner is not None, "make_dist_mg_hier has no ici stage")
        r5 = par_ksp_solve(world_h, pc4.A, b4.astype(f32), pc=pc4,
                           ksp_type="cg", rtol=1e-5, maxits=60)
        err5 = float(np.linalg.norm(r5.x.cpu().numpy()[: m4 * m4] - u4))
        _check(int(r5.reason) > 0 and err5 < 1e-2, (int(r5.reason), err5))
        out["hier_mg"] = (int(r5.its), int(r5.reason))
        print(f"dryrun_multichip({P}): hierarchical MG "
              f"(HxC-sharded -> ici-resharded -> replicated) converged "
              f"in {int(r5.its)} its, err={err5:.2e}")


def _nonlinear_solves(world, P, dev, out):
    from petsctpu_torch.core.options import Options
    from petsctpu_torch.dm.da import DA
    from petsctpu_torch.dm.plex import PlexQuad, fem_assemble_poisson
    from petsctpu_torch.dm.plexdist import distribute_plex
    from petsctpu_torch.ksp import ksp_solve
    from petsctpu_torch.ksp.common import KSPConfig
    from petsctpu_torch.mat import stencil_to_scipy
    from petsctpu_torch.models.bratu import (bratu_initial_guess,
                                             bratu_jacobian_template,
                                             bratu_residual,
                                             bratu_residual_sharded)
    from petsctpu_torch.models.cavity import (cavity_initial_guess,
                                              cavity_residual,
                                              cavity_residual_sharded)
    from petsctpu_torch.parallel import (ShardedFDJac, par_ksp_solve,
                                         par_snes_solve, par_ts_solve)
    from petsctpu_torch.parallel.pstencil import exchange_rows
    from petsctpu_torch.pc.distmg import make_dist_gamg, make_dist_mg
    from petsctpu_torch.snes.api import SNESConfig, snes_solve
    from petsctpu_torch.snes.fdjac import ColoredJacobian
    from petsctpu_torch.ts.steppers import TSConfig

    # Newton-Krylov over the ranks: the sharded residual (halo rows),
    # per-rank colored-FD Jacobians, FGMRES + distributed MG — Newton
    # counts must match the serial run
    m7 = 17
    da = DA((m7, m7))
    scfg = SNESConfig(rtol=1e-5, atol=1e-10)
    x0b = bratu_initial_guess(da, 6.0, device=dev)
    F7 = bratu_residual(da, 6.0)
    jac7 = ColoredJacobian.from_stencil(bratu_jacobian_template(
        da, device=dev))
    rs = snes_solve(F7, x0b, jac=jac7, cfg=scfg,
                    ksp_cfg=KSPConfig(ksp_type="fgmres", rtol=1e-8,
                                      maxits=1000, restart=150))
    J0h = stencil_to_scipy(jac7.assemble(F7, x0b, F7(x0b)))
    pcN = make_dist_mg(J0h, (m7, m7), P, dtype=np.float64,
                       options=Options({"pc_mg_repl_size": 200}),
                       device=dev)
    FpN, _ = bratu_residual_sharded(da, P, mloc=pcN.A.mloc, lam=6.0)
    planN = ShardedFDJac.plan((m7, m7), STAR5, P, mloc=pcN.A.mloc,
                              device=dev)
    rN = par_snes_solve(world, FpN, x0b.cpu().numpy(), jac=planN, pc=pcN,
                        cfg=scfg, ksp_cfg=KSPConfig(ksp_type="fgmres",
                                                    rtol=1e-8, maxits=100))
    _check(int(rN.reason) > 0 and int(rN.its) == int(rs.its),
           (int(rN.reason), int(rN.its), int(rs.its)))
    out["newton_dist_mg"] = (int(rN.its), int(rN.reason))
    print(f"dryrun_multichip({P}): distributed Newton-Krylov-MG "
          f"(Bratu ex5: colored-FD shard Jacobians + fgmres + dist MG) "
          f"converged in {int(rN.its)} Newton its == serial {int(rs.its)}")

    # ex19 driven cavity: Newton-Krylov-GAMG over the ranks
    mxc, myc = 8, 2 * P
    x0c = cavity_initial_guess(mxc, myc, device=dev)
    Fsc = cavity_residual(mxc, myc)
    rsc = snes_solve(Fsc, x0c, jac="jvp", cfg=scfg,
                     ksp_cfg=KSPConfig(ksp_type="fgmres", rtol=1e-6,
                                       maxits=1000, restart=150))
    Jc = torch.func.jacfwd(Fsc)(x0c)            # the AD Jacobian at x0
    pcC = make_dist_gamg(sp.csr_matrix(Jc.cpu().numpy()), P,
                         dtype=np.float64,
                         options=Options({"pc_mg_repl_size": 128}),
                         device=dev)
    FpC, _ = cavity_residual_sharded(mxc, myc, P)
    offsC = tuple((oj, oi, od) for (oj, oi) in STAR5 for od in range(-3, 4))
    planC = ShardedFDJac.plan((myc, mxc, 4), offsC, P, device=dev)
    rC = par_snes_solve(world, FpC, x0c.cpu().numpy(), jac=planC, pc=pcC,
                        cfg=scfg, ksp_cfg=KSPConfig(ksp_type="fgmres",
                                                    rtol=1e-6, maxits=100))
    _check(int(rC.reason) > 0 and int(rC.its) == int(rsc.its),
           (int(rC.reason), int(rC.its), int(rsc.its)))
    out["newton_dist_gamg"] = (int(rC.its), int(rC.reason))
    print(f"dryrun_multichip({P}): distributed Newton-Krylov-GAMG "
          f"(ex19 driven cavity, 4-dof colored shard Jacobians) converged "
          f"in {int(rC.its)} Newton its == serial {int(rsc.its)}")

    # distributed unstructured FEM (DMPlex): k-way cell partition, the
    # device assembly over one all_to_all, CG against the serial solve
    plq = PlexQuad.create_box_mesh(12, 12)
    dpl = distribute_plex(plq, P, device=dev)
    Mpl = dpl.assembled(world)
    Adev_s, _, b_s = fem_assemble_poisson(plq, device=dev)
    r_ser = ksp_solve(Adev_s, b_s, ksp_type="cg", rtol=1e-8, maxits=500)
    r_par = par_ksp_solve(world, Mpl, dpl.b, ksp_type="cg", rtol=1e-8,
                          maxits=500)
    x_par = r_par.x.cpu().numpy()[dpl.perm]
    errP = float(np.linalg.norm(x_par - r_ser.x.cpu().numpy()))
    _check(int(r_par.reason) > 0 and errP < 1e-6, (int(r_par.reason), errP))
    out["plex_cg"] = (int(r_par.its), int(r_par.reason))
    print(f"dryrun_multichip({P}): distributed Plex FEM "
          f"(device-assembled quads, routed stash) CG converged in "
          f"{int(r_par.its)} its (serial {int(r_ser.its)}), solution "
          f"err={errP:.2e}")

    # distributed implicit TS: a backward Euler heat step with colored
    # stage Jacobians over the halos
    mt, nt = 2 * P, 5
    ht = 1.0 / (mt + 1)

    def rhs_sh(t, u, comm):
        U = u.reshape(*u.shape[:-1], mt // P, nt)
        Ue = exchange_rows(U, comm, 1, axis=U.dim() - 2)
        Pd = torch.nn.functional.pad(Ue, (1, 1))
        lap = (Pd[..., :-2, 1:-1] + Pd[..., 2:, 1:-1] + Pd[..., 1:-1, :-2]
               + Pd[..., 1:-1, 2:] - 4 * U)
        return (lap / ht ** 2).reshape(u.shape)

    ij = np.indices((mt, nt))
    u0t = (np.sin(np.pi * (ij[0] + 1) / (mt + 1))
           * np.sin(np.pi * (ij[1] + 1) / (nt + 1))).reshape(-1)
    planT = ShardedFDJac.plan((mt, nt), STAR5, P, device=dev)
    rT = par_ts_solve(world, rhs_sh, u0t,
                      cfg=TSConfig(ts_type="beuler", dt=1e-3, max_steps=3,
                                   max_time=3e-3,
                                   ksp=KSPConfig(ksp_type="cg", rtol=1e-10,
                                                 maxits=300)),
                      jac=planT)
    _check(int(rT.steps) == 3 and bool(torch.isfinite(rT.u).all()),
           f"TS took {int(rT.steps)} steps")
    out["ts_beuler"] = (int(rT.steps), 0)
    print(f"dryrun_multichip({P}): distributed implicit TS "
          f"(beuler, colored stage Jacobians over halos) took "
          f"{int(rT.steps)} steps to t={float(rT.t):g}")


if __name__ == "__main__":
    if len(sys.argv) > 1 and sys.argv[1] == "dryrun":
        dryrun_multichip(int(sys.argv[2]) if len(sys.argv) > 2 else 8)
    else:
        fn, args = entry()
        x, rnorm = fn(*args)
        print("entry() ok:", (tuple(x.shape), tuple(rnorm.shape)))
