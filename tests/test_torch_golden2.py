"""The KSP tutorial goldens of tests/test_golden2.py through the port.

Each test replays its counterpart in tests/test_golden2.py (ex5, ex7,
ex12, ex16, ex23, ex15, ex2's eisenstat, bjacobi and specest runs, ex9,
ex1_3, ex13, ex18) on the CPU in fp64 through petsctpu_torch, against
the same checked-in golden digits (output/exN_*.out) with the same
bounds: residual monitor histories, iteration counts exactly, and the
final error norms. ex7_1 runs the port's make_bjacobi_ksp
(pc/parallel.py); the goldens that petsctpu reproduces serially for a
multi-rank run (ex5_2, ex7_1, ex16_1, ex18) stay serial here as there.
"""

import numpy as np
import scipy.sparse as sp
import torch

from petsctpu_torch.core.options import Options
from petsctpu_torch.ksp import ksp_solve
from petsctpu_torch.ksp.common import KSPConfig
from petsctpu_torch.mat import aij_from_scipy as _aij
from petsctpu_torch.models import ex2_system
from petsctpu_torch.pc import make_pc, register_pc

from test_golden2 import grid5pt

# one intra-op thread: the suite runs in parallel workers (pytest -n), and
# PyTorch's default of a thread a core oversubscribes the host's cores
torch.set_num_threads(1)


def aij_from_scipy(A):
    return _aij(sp.csr_matrix(A), device="cpu")


def vec(x):
    return torch.from_numpy(np.asarray(x, dtype=np.float64).copy())


class TestEx5:
    """ex5.c: two systems, same sparsity, re-used solver (the
    KSPSetOperators SAME_NONZERO_PATTERN workflow)."""

    def _run(self, size, rtol):
        m, n = 3, 2 * size
        A1 = grid5pt(m, n, diag=4.0)
        A2 = grid5pt(m, n, diag=6.0)
        # u_i = local_index + 100*rank over equal row chunks (ex5.c:157)
        loc = m * n // size
        u = np.concatenate([np.arange(loc) + 100.0 * r
                            for r in range(size)])
        hists, its, errs = [], [], []
        for A in (A1, A2):
            Ad = aij_from_scipy(A)
            b = vec(A @ u)
            pc = make_pc("jacobi", A=Ad)
            r = ksp_solve(Ad, b, pc=pc, ksp_type="gmres", rtol=rtol,
                          atol=1e-50, cgs_refine="always")
            hists.append(r.history[:int(r.its) + 1].numpy())
            its.append(int(r.its))
            errs.append(np.linalg.norm(r.x.numpy() - u))
        return hists, its, errs

    def test_ex5_1_serial(self):
        """output/ex5_1.out (makefile:410-414): 1 rank, jacobi,
        monitor_short, default rtol — both solves end in happy
        breakdown (< 1.e-11 displayed)."""
        hists, its, errs = self._run(size=1, rtol=1e-5)
        np.testing.assert_allclose(
            hists[0][:5], [4.16083, 1.32287, 0.625076, 0.211511,
                           0.0201553], rtol=2e-5)
        np.testing.assert_allclose(
            hists[1][:5], [5.16667, 1.01143, 0.241047, 0.0452703,
                           0.00290094], rtol=2e-5)
        assert its == [5, 5]
        assert hists[0][5] < 1e-11 and hists[1][5] < 1e-11
        assert max(errs) < 1e-13          # ex5.c prints only if > 1e-13

    def test_ex5_2_two_ranks(self):
        """output/ex5_2.out (makefile:415-419): 2 ranks (n=4 grid,
        rank-offset exact solution), rtol 1e-6. PCJACOBI is
        layout-independent, so the serial run must reproduce the
        2-rank golden digits."""
        hists, its, errs = self._run(size=2, rtol=1e-6)
        np.testing.assert_allclose(
            hists[0][:10],
            [142.26, 56.7664, 28.4652, 16.0205, 6.37762, 2.18849,
             0.698897, 0.1896, 0.0311023, 0.00173053], rtol=2e-5)
        assert its[0] == 10 and hists[0][10] < 1e-11
        np.testing.assert_allclose(
            hists[1][:10],
            [171.949, 51.7756, 16.2674, 5.93715, 0.787126, 0.156071,
             0.0363183, 0.005189, 0.000484311, 1.74022e-05], rtol=2e-5)
        assert its[1] == 9


class TestEx7:
    def test_ex7_1_bjacobi_sub_ksps(self):
        """output/ex7_1.out (makefile:432-436, mpiexec -n 2): outer
        GMRES + block Jacobi where block 0 runs BCGS/none (rtol 1e-6)
        and block 1 runs GMRES/jacobi (rtol 1e-7) — the
        PCBJacobiGetSubKSP customization loop (ex7.c:136-172)."""
        from petsctpu_torch.pc.parallel import make_bjacobi_ksp

        m = 8
        n = m + 2
        A = grid5pt(m, n)
        u = np.ones(m * n)
        b = vec(A @ u)
        Ad = aij_from_scipy(A)
        # PCBJacobiSetTotalBlocks(m, [n]*m) (ex7.c:114-116): 8 blocks
        # of one grid row each. On 2 ranks the customization loop gives
        # rank-0 blocks (local i even) BCGS/none, (odd) default
        # preonly+ILU; rank-1 blocks GMRES/jacobi.
        blocks = [(n * i, n * (i + 1)) for i in range(m)]
        cfg_bcgs = KSPConfig(ksp_type="bcgs", rtol=1e-6, atol=1e-50,
                             maxits=10000)
        cfg_pre = KSPConfig(ksp_type="preonly", maxits=1)
        cfg_gm = KSPConfig(ksp_type="gmres", rtol=1e-7, atol=1e-50,
                           maxits=10000, cgs_refine="always")
        cfgs = [cfg_bcgs, cfg_pre, cfg_bcgs, cfg_pre,
                cfg_gm, cfg_gm, cfg_gm, cfg_gm]
        sub_pcs = ["none", "ilu", "none", "ilu",
                   "jacobi", "jacobi", "jacobi", "jacobi"]
        pc = make_bjacobi_ksp(A, blocks=blocks, cfgs=cfgs,
                              sub_pcs=sub_pcs, device="cpu")
        r = ksp_solve(Ad, b, pc=pc, ksp_type="gmres", rtol=1e-5,
                      atol=1e-50, cgs_refine="always", maxits=200)
        golden = [2.5957, 1.31906, 0.794907, 0.550346, 0.342665,
                  0.245084, 0.122389, 0.047222, 0.0124074, 0.00345483,
                  0.000635046, 0.0002212, 4.91689e-05, 9.352e-06]
        assert int(r.its) == 13
        np.testing.assert_allclose(r.history[:14].numpy(), golden,
                                   rtol=2e-4)
        np.testing.assert_allclose(
            np.linalg.norm(r.x.numpy() - u), 1.09983e-05, rtol=1e-3)


class TestEx12:
    def test_ex12_1_registered_pc(self):
        """output/ex12_1.out (makefile:808-812): PCRegister("ourjacobi",
        PCCreate_Jacobi) then -pc_type ourjacobi (ex12.c:150-156) —
        the dynamic PC registry; solve matches GMRES+jacobi."""
        register_pc("ourjacobi",
                    lambda A, A_host, opts, axis: make_pc("jacobi", A=A))
        A, b, u = ex2_system(8, 7)
        Ad = aij_from_scipy(A)
        from petsctpu_torch.pc.api import PC_REGISTRY
        pc = PC_REGISTRY["ourjacobi"](Ad, A, Options(), None)
        r = ksp_solve(Ad, vec(b), pc=pc, ksp_type="gmres",
                      rtol=1e-5, atol=1e-50, cgs_refine="always")
        assert int(r.its) == 14
        np.testing.assert_allclose(
            np.linalg.norm(r.x.numpy() - u), 2.10144e-06, rtol=1e-3)
        PC_REGISTRY.pop("ourjacobi")

    def test_ex12_2_bcgs(self):
        """output/ex12_2.out (runex12_2: -ksp_type bcgs)."""
        register_pc("ourjacobi",
                    lambda A, A_host, opts, axis: make_pc("jacobi", A=A))
        A, b, u = ex2_system(8, 7)
        Ad = aij_from_scipy(A)
        from petsctpu_torch.pc.api import PC_REGISTRY
        pc = PC_REGISTRY["ourjacobi"](Ad, A, Options(), None)
        r = ksp_solve(Ad, vec(b), pc=pc, ksp_type="bcgs",
                      rtol=1e-5, atol=1e-50)
        assert np.linalg.norm(r.x.numpy() - u) < 1e-4
        PC_REGISTRY.pop("ourjacobi")


class TestEx16:
    def test_ex16_1_repeated_solves(self):
        """output/ex16_1.out (makefile:838-842, mpiexec -n 2, -ntimes 4):
        solve the same operator with rhs scaled by k=1..4 — iteration
        counts stay 9, error norms scale linearly. The 2-rank default
        PC is bjacobi(2)+ILU(0); reproduced with explicit 2-block ILU
        like the ex2_2 golden."""
        A, _, _ = ex2_system(8, 7)
        Ad = aij_from_scipy(A)
        pc = make_pc("bjacobi", A=Ad, A_host=A,
                     options=Options({"pc_bjacobi_blocks": 2}))
        golden_err = [5.34462e-05, 0.000106892, 0.000160339, 0.000213785]
        for k in range(1, 5):
            u = np.full(56, float(k))
            b = vec(A @ u)
            r = ksp_solve(Ad, b, pc=pc, ksp_type="gmres", rtol=1e-5,
                          atol=1e-50, cgs_refine="always")
            assert int(r.its) == 9, k
            np.testing.assert_allclose(
                np.linalg.norm(r.x.numpy() - u), golden_err[k - 1],
                rtol=1e-3)


class TestEx23:
    def test_ex23_1_tridiag(self):
        """output/ex23_1.out (makefile:862-866): tridiag(-1,2,-1) n=10,
        GMRES+Jacobi (ex23.c:140), rtol 1e-7, monitor_short; 5 its to
        happy breakdown."""
        n = 10
        A = sp.diags([-np.ones(n - 1), 2 * np.ones(n), -np.ones(n - 1)],
                     [-1, 0, 1]).tocsr()
        u = np.ones(n)
        b = vec(A @ u)
        Ad = aij_from_scipy(A)
        pc = make_pc("jacobi", A=Ad)
        r = ksp_solve(Ad, b, pc=pc, ksp_type="gmres", rtol=1e-7,
                      atol=1e-50, cgs_refine="always")
        golden = [0.707107, 0.316228, 0.188982, 0.129099, 0.0953463]
        assert int(r.its) == 5
        np.testing.assert_allclose(r.history[:5].numpy(), golden,
                                   rtol=2e-5)
        assert float(r.history[5]) < 1e-11
        assert np.linalg.norm(r.x.numpy() - u) < 1e-12


class TestEx15:
    def test_ex15_1_user_defined_shell_pc(self):
        """output/ex15_1.out (makefile runex15): 8x7 five-point grid,
        GMRES cgs refine_always, rtol 1e-7, PCShell applying the
        user's reciprocal-diagonal scaling (ex15.c:280 VecReciprocal +
        :310 VecPointwiseMult): 15 its, error 5.90715e-08."""
        from petsctpu_torch.pc.composite import ShellPC

        A = grid5pt(8, 7)
        u = np.ones(56)
        b = vec(A @ u)
        Ad = aij_from_scipy(A)
        diag_recip = 1.0 / vec(A.diagonal())
        pc = ShellPC(ctx=diag_recip, apply_fn=lambda d, x: d * x)
        r = ksp_solve(Ad, b, pc=pc, ksp_type="gmres", rtol=1e-7,
                      atol=1e-50, cgs_refine="always")
        assert int(r.its) == 15
        np.testing.assert_allclose(
            np.linalg.norm(r.x.numpy() - u), 5.90715e-08, rtol=2e-5)


class TestEx2Eisenstat:
    def test_ex2_4_eisenstat(self):
        """output/ex2_4.out (runex2_4: -pc_type eisenstat
        refine_always): the reference's literal Eisenstat transformed
        system — monitored norms 8.27636 ... 0.000575025, 7 its,
        error 0.000372942."""
        from petsctpu_torch.pc.extra import make_eisenstat_system

        A, b, u = ex2_system(8, 7)
        shell, pc, pre, post = make_eisenstat_system(A, device="cpu")
        r = ksp_solve(shell, pre(vec(b)), pc=pc, ksp_type="gmres",
                      rtol=1e-2 / 72, atol=1e-50, cgs_refine="always")
        x = post(r.x)
        golden = [8.27636, 2.71231, 1.42381, 0.36228, 0.0646682,
                  0.00995895, 0.00236302, 0.000575025]
        assert int(r.its) == 7
        np.testing.assert_allclose(r.history[:8].numpy(), golden,
                                   rtol=2e-5)
        np.testing.assert_allclose(np.linalg.norm(x.numpy() - u),
                                   0.000372942, rtol=1e-4)

    def test_eisenstat_matches_ssor_solution(self):
        """The transformed-system solve returns the same solution as
        plain SSOR-preconditioned GMRES (they are the same
        preconditioned operator up to a change of variables)."""
        from petsctpu_torch.pc.extra import make_eisenstat_system

        A, b, u = ex2_system(6, 5)
        shell, pc, pre, post = make_eisenstat_system(A, device="cpu")
        r1 = ksp_solve(shell, pre(vec(b)), pc=pc,
                       ksp_type="gmres", rtol=1e-10, atol=1e-50)
        Ad = aij_from_scipy(A)
        pc2 = make_pc("sor", A=Ad, A_host=A,
                      options=Options({"pc_sor_symmetric": None}))
        r2 = ksp_solve(Ad, vec(b), pc=pc2, ksp_type="gmres",
                       rtol=1e-10, atol=1e-50)
        np.testing.assert_allclose(post(r1.x).numpy(),
                                   r2.x.numpy(), atol=1e-9)


class TestEx9:
    def test_ex9_1_two_systems_prefixes_nonzero_guess(self):
        """output/ex9_1.out (runex9 -t 2): two different systems solved
        twice — system 1 GMRES+Jacobi refine_always, system 2 (s2_
        prefix) BCGS+Jacobi; at t=1 system 1 reuses the previous
        solution via KSPSetInitialGuessNonzero and converges at
        iteration 0 because the rtol base switches to ‖M⁻¹b‖
        (KSPDefaultConverged iterativ.c:703-733). All four monitor
        histories digit-exact."""

        def nonsym(m, n, t):
            N = m * n
            rows, cols, vals = [], [], []
            for Ii in range(N):
                i = Ii // n
                if i > 0:
                    rows.append(Ii); cols.append(Ii - n)
                    vals.append(-1.0 * (t + 0.5))
            return sp.csr_matrix((vals, (rows, cols)), shape=(N, N))

        m, n = 3, 2
        u = np.arange(6.0)
        x1 = torch.zeros(6, dtype=torch.float64)
        gold_s1_t0 = [3.70388, 1.17021, 0.659553, 0.223905, 0.0231247,
                      0.0027912]
        gold_s2 = {0: [4.86341, 0.34437, 0.0222537, 0.000517559,
                       2.18157e-06],
                   1: [4.49655, 0.362629, 0.0285572, 0.000207309,
                       5.00173e-06]}
        for t in range(2):
            C1 = (grid5pt(m, n, 4.0) + nonsym(m, n, t)).tocsr()
            Ad = aij_from_scipy(C1)
            r = ksp_solve(Ad, vec(C1 @ u), x0=x1,
                          pc=make_pc("jacobi", A=Ad), ksp_type="gmres",
                          rtol=1e-5, atol=1e-50, cgs_refine="always",
                          guess_nonzero=(t > 0))
            if t == 0:
                assert int(r.its) == 6
                np.testing.assert_allclose(r.history[:6].numpy(),
                                           gold_s1_t0, rtol=2e-5)
                assert float(r.history[6]) < 1e-11
            else:
                # "0 KSP Residual norm < 1.e-11" — converged at it 0
                assert int(r.its) == 0
                assert float(r.history[0]) < 1e-11
            x1 = r.x
            C2 = (grid5pt(m, n, 6.0 + t * 0.5) + nonsym(m, n, t)).tocsr()
            Ad2 = aij_from_scipy(C2)
            r2 = ksp_solve(Ad2, vec(C2 @ u),
                           pc=make_pc("jacobi", A=Ad2), ksp_type="bcgs",
                           rtol=1e-5, atol=1e-50)
            assert int(r2.its) == 4
            np.testing.assert_allclose(r2.history[:5].numpy(),
                                       gold_s2[t], rtol=2e-5)


class TestEx1Eisenstat:
    def test_ex1_3_eisenstat_tridiag(self):
        """output/ex1_3.out (runex1_3: -pc_type eisenstat on the ex1
        tridiagonal system, refine_always): all 9 monitored norms of
        the transformed system digit-exact (1.5288 … 9.0696e-07) and
        the final error 4.28168e-07, 8 its."""
        from petsctpu_torch.pc.extra import make_eisenstat_system

        n = 10
        A = sp.diags([-np.ones(n - 1), 2 * np.ones(n),
                      -np.ones(n - 1)], [-1, 0, 1]).tocsr()
        u = np.ones(n)
        shell, pc, pre, post = make_eisenstat_system(A, device="cpu")
        r = ksp_solve(shell, pre(vec(A @ u)), pc=pc,
                      ksp_type="gmres", rtol=1e-5, atol=1e-50,
                      cgs_refine="always")
        golden = [1.5288, 0.461115, 0.284905, 0.139317, 0.0192523,
                  0.00651144, 0.00059631, 3.67561e-05, 9.0696e-07]
        assert int(r.its) == 8
        np.testing.assert_allclose(r.history[:9].numpy(), golden,
                                   rtol=2e-5)
        np.testing.assert_allclose(
            np.linalg.norm(post(r.x).numpy() - u), 4.28168e-07,
            rtol=1e-4)


class TestEx13:
    def test_ex13_1_variable_coefficient_poisson(self):
        """output/ex13_1.out (runex13 -m 19 -n 20): −div(ρ∇ψ)=F with
        ρ(x,y)=x (harmonic-mean 5-point coefficients, ex13.c
        UserDoLinearSolver), LU-preconditioned solve called twice from
        a "non-PETSc" host program; squared-L2 error norm 1.44146e-05
        both times."""
        m, n = 19, 20
        hx, hy = 1.0 / (m + 1), 1.0 / (n + 1)
        hx2, hy2 = (m + 1.0) ** 2, (n + 1.0) ** 2
        N = m * n
        xs = (np.arange(m) + 1) * hx
        ys = (np.arange(n) + 1) * hy
        X, Y = np.meshgrid(xs, ys)
        rho = X.reshape(-1)
        sol = (np.sin(2 * np.pi * X) * np.sin(2 * np.pi * Y)).reshape(-1)
        b = (-2 * np.pi * np.cos(2 * np.pi * X) * np.sin(2 * np.pi * Y)
             + 8 * np.pi ** 2 * X * np.sin(2 * np.pi * X)
             * np.sin(2 * np.pi * Y)).reshape(-1)
        rows, cols, vals = [], [], []
        for Ii in range(N):
            j, i = divmod(Ii, m)
            for cond, J, w in (
                    (j > 0, Ii - m, hy2), (j < n - 1, Ii + m, hy2),
                    (i > 0, Ii - 1, hx2), (i < m - 1, Ii + 1, hx2)):
                if cond:
                    rows.append(Ii); cols.append(J)
                    vals.append(-.5 * (rho[Ii] + rho[J]) * w)
            rows.append(Ii); cols.append(Ii)
            vals.append(2.0 * rho[Ii] * (hx2 + hy2))
        A = sp.csr_matrix((vals, (rows, cols)), shape=(N, N))
        Ad = aij_from_scipy(A)
        pc = make_pc("lu", A=Ad, A_host=A)
        for _ in range(2):
            r = ksp_solve(Ad, vec(b), pc=pc, ksp_type="gmres",
                          rtol=1e-5, atol=1e-50, cgs_refine="always")
            err = r.x.numpy() - sol
            np.testing.assert_allclose(float(np.sum(err * err) * hx * hy),
                                       1.44146e-05, rtol=2e-5)


class TestEx2BJacobi:
    """runex2_bjacobi[_2/_3] (makefile:349-363, mpiexec -n 4): outer
    GMRES (rtol 1e-2/72, ex2.c:182) + PCBJACOBI with 1/2/4 blocks,
    every block solved by an inner GMRES+Jacobi at the sub-KSP
    defaults (rtol 1e-5; no CGS refinement on either level)."""

    def _solve(self, nblocks):
        from petsctpu_torch.pc.parallel import make_bjacobi_ksp

        m, n = 8, 7
        A, b, u = ex2_system(m, n)
        N = m * n
        bs = N // nblocks
        blocks = [(i * bs, (i + 1) * bs) for i in range(nblocks)]
        cfg = KSPConfig(ksp_type="gmres", rtol=1e-5, atol=1e-50,
                        maxits=10000)
        pc = make_bjacobi_ksp(A, blocks=blocks, cfgs=[cfg] * nblocks,
                              sub_pcs=["jacobi"] * nblocks, device="cpu")
        r = ksp_solve(aij_from_scipy(A), vec(b), pc=pc,
                      ksp_type="gmres", rtol=1e-2 / ((m + 1) * (n + 1)),
                      atol=1e-50, maxits=10000)
        return r, u

    def test_ex2_bjacobi_one_block(self):
        """output/ex2_bjacobi.out: a single block = the whole system
        solved by the inner GMRES → outer converges in 1 iteration."""
        r, u = self._solve(1)
        assert int(r.its) == 1
        np.testing.assert_allclose(r.history[:2].numpy(),
                                   [7.48331, 2.10143e-06], rtol=2e-5)
        np.testing.assert_allclose(
            np.linalg.norm(r.x.numpy() - u), 2.10144e-06, rtol=1e-3)

    def test_ex2_bjacobi_two_blocks(self):
        """output/ex2_bjacobi_2.out: 2 blocks of 28 rows."""
        r, u = self._solve(2)
        assert int(r.its) == 4
        golden = [5.18566, 0.882327, 0.232433, 0.0193881, 0.000403063]
        np.testing.assert_allclose(r.history[:5].numpy(), golden,
                                   rtol=2e-5)
        np.testing.assert_allclose(
            np.linalg.norm(r.x.numpy() - u), 0.000496964, rtol=1e-3)

    def test_ex2_bjacobi_four_blocks(self):
        """output/ex2_bjacobi_3.out: 4 blocks of 14 rows."""
        r, u = self._solve(4)
        assert int(r.its) == 7
        golden = [3.44632, 1.321, 0.720888, 0.383469, 0.0585789,
                  0.0187709, 0.00119179, 0.000321916]
        np.testing.assert_allclose(r.history[:8].numpy(), golden,
                                   rtol=2e-5)
        np.testing.assert_allclose(
            np.linalg.norm(r.x.numpy() - u), 0.000404746, rtol=1e-3)


class TestEx18Permuted:
    """runex18[_2] (makefile:843-850, mpiexec -n 3): solve the 39x18
    Poisson system in ND- / RCM-permuted indexing (ex18.c:168-175:
    parallel MatGetOrdering orders each rank's DIAGONAL block and
    shifts by rstart — sorder.c:198-223), default GMRES + BJacobi(3)
    ILU(0), rtol 1e-2/760."""

    def _solve(self, kind):
        from petsctpu_torch.mat.order import get_ordering

        m, n = 39, 18
        A, b, u = ex2_system(m, n)
        N = m * n
        P = 3
        bs = N // P
        perm = np.concatenate([
            r * bs + get_ordering(
                sp.csr_matrix(A[r * bs:(r + 1) * bs,
                                r * bs:(r + 1) * bs]), kind)
            for r in range(P)])
        Ap = sp.csr_matrix(A[perm][:, perm])
        pc = make_pc("bjacobi", A=aij_from_scipy(Ap), A_host=Ap,
                     options=Options({"pc_bjacobi_blocks": P}))
        r = ksp_solve(aij_from_scipy(Ap), vec(b[perm]), pc=pc,
                      ksp_type="gmres", rtol=1e-2 / ((m + 1) * (n + 1)),
                      atol=1e-50, maxits=10000)
        xun = np.empty(N)
        xun[perm] = r.x.numpy()        # VecPermute(x, rowperm, TRUE)
        return r, float(np.linalg.norm(xun - u))

    def test_ex18_1_nd(self):
        """output/ex18_1.out: -permute nd — requires the SPARSPAK
        gennd separator choice exactly (mat/order.gennd)."""
        r, err = self._solve("nd")
        assert int(r.its) == 26
        golden = [5.51398, 2.02732, 1.2223, 0.845891, 0.6166, 0.490831,
                  0.428377, 0.360329, 0.28561, 0.225126, 0.177985]
        np.testing.assert_allclose(r.history[:11].numpy(), golden,
                                   rtol=2e-5)
        np.testing.assert_allclose(
            r.history[24:27].numpy(),
            [0.00013449, 8.52232e-05, 6.6145e-05], rtol=2e-5)
        np.testing.assert_allclose(err, 0.00127187, rtol=1e-4)

    def test_ex18_2_rcm(self):
        """output/ex18_2.out: -permute rcm."""
        r, err = self._solve("rcm")
        assert int(r.its) == 20
        golden = [6.86661, 2.58242, 1.45553, 1.01322, 0.793201,
                  0.632822, 0.448455, 0.322895, 0.240618, 0.174347]
        np.testing.assert_allclose(r.history[:10].numpy(), golden,
                                   rtol=2e-5)
        np.testing.assert_allclose(
            r.history[18:21].numpy(),
            [0.000187022, 0.000110275, 6.73336e-05], rtol=2e-5)
        np.testing.assert_allclose(err, 0.000348016, rtol=1e-4)


class TestEx2SpecEst:
    """runex2_specest_1/_2 (makefile:364-371): -m 80 -n 80 -ksp_type
    fgmres -pc_type ksp -ksp_ksp_type specest [-ksp_specest_ksp_type
    cg]. The TRUE two-phase KSPSPECEST (specest.c): first PC
    application runs the estimation KSP (maxits 5) and bakes
    [0.9·σmin, 1.1·σmax] Chebyshev bounds from its own Krylov process
    (GMRES H̄ SVD / CG Lanczos tridiagonal eigenvalues); later
    applications run the 5-step norm-free Chebyshev. Host-stateful PC
    + host-driven flexible outer (ksp/specest.py)."""

    def _run(self, extra):
        m = n = 80
        A, b, u = ex2_system(m, n)
        Ad = aij_from_scipy(A)
        opts = Options(dict({"ksp_ksp_type": "specest"}, **extra))
        pc = make_pc("ksp", A=Ad, A_host=A, options=opts)
        r = ksp_solve(Ad, vec(b), pc=pc, ksp_type="fgmres",
                      rtol=1e-2 / ((m + 1) * (n + 1)), atol=1e-50,
                      maxits=10000)
        return r, float(np.linalg.norm(r.x.numpy() - u))

    def test_ex2_specest_1_gmres_estimator(self):
        """output/ex2_specest_1.out."""
        r, err = self._run({})
        assert int(r.its) == 10
        golden = [18.1108, 0.7762, 0.27643, 0.152954, 0.111672,
                  0.0703825, 0.0136785, 0.00246763, 0.000273231,
                  0.000106717, 2.31197e-05]
        np.testing.assert_allclose(r.history[:11].numpy(), golden,
                                   rtol=2e-5)
        np.testing.assert_allclose(err, 0.000963735, rtol=1e-4)

    def test_ex2_specest_2_cg_estimator(self):
        """output/ex2_specest_2.out: -ksp_specest_ksp_type cg."""
        r, err = self._run({"ksp_specest_ksp_type": "cg"})
        assert int(r.its) == 10
        golden = [18.1108, 1.37858, 0.252385, 0.153389, 0.109447,
                  0.0557274, 0.011307, 0.00200416, 0.000233753,
                  8.63144e-05, 1.62899e-05]
        np.testing.assert_allclose(r.history[:11].numpy(), golden,
                                   rtol=2e-5)
        np.testing.assert_allclose(err, 0.000747533, rtol=1e-4)
