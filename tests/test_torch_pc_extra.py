"""The compositional and specialty PCs through the port, against
petsctpu's, on the CPU in fp64.

Each type is built by both packages' make_pc (or factory) from the same
numpy-seeded system and held to petsctpu's apply on the same x, with
the bound stated per type:
- bit for bit where both run the same elementwise arithmetic: shell,
  Jacobi's part of composite, the Eisenstat PC (D·x);
- rtol 1e-12 where sums run in another order (ELL row sums, triangular
  solves, dense products, MG cycles): composite, mat, SOR-based
  (eisenstat, cp), LU-based (galerkin, redistribute, lsc,
  supportgraph), svd, tfs, spai, exotic with direct interior solves;
- rtol 1e-9 where an inner Krylov solve stops on a tolerance: the ksp
  PC (GMRES + ILU to 1e-2, its its equal) and SpecEstPC's two phases;
- exotic's face space with the reference's default inexact interior
  solves (GMRES + ILU(0) to 1e-5 in each package's own KSP): P within
  1e-9 of petsctpu's (the inner GMRES streams agree, so P agrees to
  rounding), far inside the solves' own 1e-5, and its MG apply within
  1e-12.
The setup products that are host numpy in both (spai's M, the support
tree, the exotic P, the SVD and XXT factors) are equal. Solves through
the ksp, galerkin, cp and supportgraph PCs and the Eisenstat system take
petsctpu's iterations; the Eisenstat system's stream is also held to the
oracle sweep (tests/test_torch_sweep.py SLICE10).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse as sp
import torch

from petsctpu.core.options import Options as JOptions
from petsctpu.dm.da import DA as JDA
from petsctpu.ksp import ksp_solve as jksp_solve
from petsctpu.mat import aij_from_scipy as jaij
from petsctpu.pc import make_pc as jmake_pc
from petsctpu.pc import exotic as jexotic
from petsctpu.pc.extra import make_eisenstat_system as jeisen_system
from petsctpu.pc.spai import spai_host as jspai_host
from petsctpu.pc.supportgraph import support_tree as jsupport_tree

from petsctpu_torch.convert import eisenstat_from_arrays
from petsctpu_torch.core.options import Options
from petsctpu_torch.dm import DA
from petsctpu_torch.ksp import ksp_solve
from petsctpu_torch.mat import aij_from_scipy
from petsctpu_torch.models import ex2_system, laplacian_2d
from petsctpu_torch.pc import exotic, make_pc
from petsctpu_torch.pc.composite import (CompositePC, KSPPC, MatPC,
                                         ShellPC)
from petsctpu_torch.pc.extra import make_eisenstat_system
from petsctpu_torch.pc.spai import spai_host
from petsctpu_torch.pc.supportgraph import support_tree

# one intra-op thread: the suite runs in parallel workers (pytest -n), and
# PyTorch's default of a thread a core oversubscribes the host's cores
torch.set_num_threads(1)

CPU = "cpu"


def ex2(m=8, n=7):
    A, b, _ = ex2_system(m, n)
    return sp.csr_matrix(A), np.asarray(b)


def nonsym(m=6):
    A = laplacian_2d(m, m).tolil()
    for i in range(m * m - 1):
        A[i, i + 1] += 0.3
    return A.tocsr()


def dirichlet_laplacian(n=7):
    """The 2-D Laplacian with identity boundary rows of
    tests/test_pc_extra.py's redistribute case."""
    Ah = sp.lil_matrix((n * n, n * n))
    for i in range(n):
        for j in range(n):
            k = i * n + j
            if i in (0, n - 1) or j in (0, n - 1):
                Ah[k, k] = 1.0
            else:
                Ah[k, k] = 4.0
                Ah[k, k - 1] = Ah[k, k + 1] = -1.0
                Ah[k, k - n] = Ah[k, k + n] = -1.0
    return Ah.tocsr()


def lap3d(m):
    """The 7-point Laplacian on an m³ grid (tests/test_exotic_tfs.py)."""
    n = m ** 3
    idx = np.arange(n).reshape(m, m, m)
    rows, cols, vals = [idx.ravel()], [idx.ravel()], [np.full(n, 6.0)]
    for ax in range(3):
        lo = np.take(idx, np.arange(m - 1), axis=ax).ravel()
        hi = np.take(idx, np.arange(1, m), axis=ax).ravel()
        rows += [lo, hi]
        cols += [hi, lo]
        vals += [np.full(lo.size, -1.0)] * 2
    return sp.csr_matrix((np.concatenate(vals), (np.concatenate(rows),
                                                 np.concatenate(cols))),
                         shape=(n, n))


def both(name, A, opts=None, jopts=None):
    """(port PC, petsctpu PC) of make_pc(name) on host matrix A."""
    pc = make_pc(name, A=aij_from_scipy(A, device=CPU), A_host=A,
                 options=Options(dict(opts or {})))
    jpc = jmake_pc(name, A=jaij(A), A_host=A,
                   options=JOptions(dict(jopts if jopts is not None
                                         else opts or {})))
    return pc, jpc


def assert_apply(pc, jpc, n, rtol, seed=0, exact=False):
    x = np.random.default_rng(seed).standard_normal(n)
    y = pc.apply(torch.from_numpy(x)).numpy()
    jy = np.asarray(jpc.apply(jnp.asarray(x)))
    if exact:
        np.testing.assert_array_equal(y, jy)
    else:
        np.testing.assert_allclose(y, jy, rtol=rtol,
                                   atol=rtol * np.abs(jy).max())
    return y


def assert_same_solve(r, jr, rtol=1e-10):
    its = int(r.its)
    assert (its, int(r.reason)) == (int(jr.its), int(jr.reason))
    h, jh = r.history.numpy()[:its + 1], np.asarray(jr.history)[:its + 1]
    np.testing.assert_allclose(h, jh, rtol=rtol, atol=1e-13 * jh[0])


@pytest.mark.parametrize("mode", ["additive", "multiplicative"])
def test_composite(mode):
    A, _ = ex2()
    o = {"pc_composite_pcs": "jacobi,sor", "pc_composite_type": mode}
    pc, jpc = both("composite", A, o)
    assert isinstance(pc, CompositePC) and len(pc.pcs) == 2
    assert_apply(pc, jpc, A.shape[0], 1e-12)


@pytest.mark.parametrize("specest", [False, True])
def test_ksp_pc(specest):
    A, b = ex2()
    o = {"ksp_ksp_type": "specest"} if specest else {}
    pc, jpc = both("ksp", A, o)
    assert isinstance(pc, KSPPC) != specest
    # the first apply (SpecEstPC: its estimate solve), then a second
    # (the cheap Chebyshev phase on the estimated bounds)
    for seed in (0, 1):
        assert_apply(pc, jpc, A.shape[0], 1e-9, seed=seed)
    if not specest:
        Ad = aij_from_scipy(A, device=CPU)
        r = ksp_solve(Ad, torch.from_numpy(b), pc=pc, ksp_type="fgmres",
                      rtol=1e-8)
        jr = jksp_solve(jaij(A), jnp.asarray(b), pc=jpc, ksp_type="fgmres",
                        rtol=1e-8)
        assert_same_solve(r, jr, rtol=1e-8)


def test_shell_and_mat():
    A, _ = ex2()
    d = np.random.default_rng(5).uniform(1, 2, A.shape[0])

    def scale(ctx, x):
        return ctx * x

    pc, jpc = both("shell", A, {"pc_shell_apply": scale,
                                "pc_shell_ctx": torch.from_numpy(d)},
                   {"pc_shell_apply": scale, "pc_shell_ctx": jnp.asarray(d)})
    assert isinstance(pc, ShellPC)
    assert_apply(pc, jpc, A.shape[0], 0.0, exact=True)
    pc, jpc = both("mat", A)
    assert isinstance(pc, MatPC)
    assert_apply(pc, jpc, A.shape[0], 1e-13)


@pytest.mark.parametrize("omega", [1.0, 1.4])
def test_eisenstat_pc_and_system(omega):
    A, b = ex2()
    o = {"pc_eisenstat_omega": str(omega)}
    assert_apply(*both("eisenstat", A, o), A.shape[0], 1e-12)
    shell, dpc, pre, post = make_eisenstat_system(A, omega=omega,
                                                  device=CPU)
    jshell, jdpc, jpre, jpost = jeisen_system(A, omega=omega)
    x = np.random.default_rng(3).standard_normal(A.shape[0])
    tx, jx = torch.from_numpy(x), jnp.asarray(x)
    for ours, ref in ((shell.mult, jshell.mult), (pre, jpre),
                      (post, jpost)):
        np.testing.assert_allclose(ours(tx).numpy(), np.asarray(ref(jx)),
                                   rtol=1e-12, atol=1e-12)
    assert_apply(dpc, jdpc, A.shape[0], 0.0, exact=True)
    # the system carried over from petsctpu's plans applies alike
    plan = ({f: np.asarray(getattr(p, f)) for f in
             ("level_rows", "cols", "vals", "dinv")} | {"n": p.n,
                                                        "nlev": p.nlev}
            for p in jshell.ctx[:2])
    cshell, *_ = eisenstat_from_arrays(*plan, np.asarray(jshell.ctx[2]),
                                       omega=omega, device=CPU)
    np.testing.assert_allclose(cshell.mult(tx).numpy(),
                               np.asarray(jshell.mult(jx)), rtol=1e-12,
                               atol=1e-12)
    r = ksp_solve(shell, pre(torch.from_numpy(b)), pc=dpc, ksp_type="cg",
                  rtol=1e-6)
    jr = jksp_solve(jshell, jpre(jnp.asarray(b)), pc=jdpc, ksp_type="cg",
                    rtol=1e-6)
    assert_same_solve(r, jr)
    u = post(r.x).numpy()
    assert np.linalg.norm(A @ u - b) <= 1e-4 * np.linalg.norm(b)


def test_galerkin():
    A, b = ex2(9, 9)
    da, jda = DA((9, 9)), JDA((9, 9))
    c, jc = da.coarsen(), jda.coarsen()
    Ph = da.interpolation_scipy(c)
    pc = make_pc("galerkin", A=aij_from_scipy(A, device=CPU), A_host=A,
                 options=Options({"pc_galerkin_interpolation":
                                  da.interpolation(c),
                                  "pc_galerkin_interpolation_host": Ph}))
    jpc = jmake_pc("galerkin", A=jaij(A), A_host=A, options=JOptions({
        "pc_galerkin_interpolation": jda.interpolation(jc),
        "pc_galerkin_interpolation_host": Ph}))
    assert_apply(pc, jpc, A.shape[0], 1e-12)
    r = ksp_solve(aij_from_scipy(A, device=CPU), torch.from_numpy(b), pc=pc,
                  ksp_type="fgmres", rtol=1e-8, maxits=300)
    jr = jksp_solve(jaij(A), jnp.asarray(b), pc=jpc, ksp_type="fgmres",
                    rtol=1e-8, maxits=300)
    assert_same_solve(r, jr, rtol=1e-8)


def test_redistribute():
    A = dirichlet_laplacian()
    pc, jpc = both("redistribute", A)
    y = assert_apply(pc, jpc, A.shape[0], 1e-12)
    xex = np.random.default_rng(0).standard_normal(A.shape[0])
    pc2, _ = both("redistribute", A)
    np.testing.assert_allclose(pc2.apply(torch.from_numpy(A @ xex)).numpy(),
                               xex, atol=1e-10)
    assert np.isfinite(y).all()
    # no Dirichlet row: the inner LU alone
    A2, _ = ex2()
    assert_apply(*both("redistribute", A2), A2.shape[0], 1e-12)


def test_lsc():
    rng = np.random.default_rng(0)
    A00 = (laplacian_2d(6, 4) + 0.5 * sp.eye(24)).tocsr()
    B = sp.csr_matrix(rng.standard_normal((8, 24)) * 0.5)
    o = {"pc_lsc_a00": A00, "pc_lsc_b": B}
    jpc = jmake_pc("lsc", options=JOptions(dict(o)))
    # no operator given: it builds on CUDA, and raises without it
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            make_pc("lsc", options=Options(dict(o)))
    pc = make_pc("lsc", A=aij_from_scipy(A00, device=CPU),
                 options=Options(dict(o)))
    assert_apply(pc, jpc, 8, 1e-12)


def test_svd_and_tfs():
    A, _ = ex2(6, 6)
    pc, jpc = both("svd", A)
    for ours, ref in ((pc.U, jpc.U), (pc.sinv, jpc.sinv), (pc.Vt, jpc.Vt)):
        assert ours.numpy().tobytes() == np.asarray(ref).tobytes()
    assert_apply(pc, jpc, A.shape[0], 1e-12)
    S = sp.diags([0.0, 1.0, 2.0, 3.0]).tocsr()
    pc, jpc = both("svd", S)
    np.testing.assert_allclose(pc.apply(torch.ones(4, dtype=torch.float64))
                               .numpy(), [0.0, 1.0, 0.5, 1 / 3], atol=1e-12)
    A3 = lap3d(5)
    for drop in ("0", "1e-3"):
        o = {"pc_tfs_drop_tolerance": drop}
        pc, jpc = both("tfs", A3, o)
        assert pc.X.numpy().tobytes() == np.asarray(jpc.X).tobytes()
        assert_apply(pc, jpc, A3.shape[0], 1e-12)


def test_cp():
    A = nonsym()
    pc, jpc = both("cp", A)
    assert_apply(pc, jpc, A.shape[0], 1e-12)
    b = np.ones(A.shape[0])
    r = ksp_solve(aij_from_scipy(A, device=CPU), torch.from_numpy(b), pc=pc,
                  ksp_type="fgmres", rtol=1e-9, maxits=300)
    jr = jksp_solve(jaij(A), jnp.asarray(b), pc=jpc, ksp_type="fgmres",
                    rtol=1e-9, maxits=300)
    assert_same_solve(r, jr, rtol=1e-8)


def test_spai():
    A = nonsym()
    for p in (1, 2):
        M, jM = spai_host(A, pattern_power=p), jspai_host(A, pattern_power=p)
        assert (M != jM).nnz == 0
        o = {"pc_spai_nbsteps": str(p)}
        assert_apply(*both("spai", A, o), A.shape[0], 1e-12)


def test_supportgraph():
    m = 12
    ex = sp.diags([-1.0, 2.0, -1.0], [-1, 0, 1], (m, m))
    A = (sp.kron(sp.eye(m), ex) + 1e-2 * sp.kron(ex, sp.eye(m))).tocsr()
    for aug in (0, 5):
        T, jT = support_tree(A, augment=aug), jsupport_tree(A, augment=aug)
        assert (T != jT).nnz == 0
        o = {"pc_supportgraph_augment": str(aug)}
        pc, jpc = both("supportgraph", A, o)
        assert_apply(pc, jpc, A.shape[0], 1e-12)
    b = np.ones(m * m)
    r = ksp_solve(aij_from_scipy(A, device=CPU), torch.from_numpy(b), pc=pc,
                  ksp_type="cg", rtol=1e-8, maxits=600)
    jr = jksp_solve(jaij(A), jnp.asarray(b), pc=jpc, ksp_type="cg",
                    rtol=1e-8, maxits=600)
    assert_same_solve(r, jr, rtol=1e-8)


@pytest.mark.parametrize("etype,direct", [("wirebasket", True),
                                          ("face", False)])
def test_exotic(etype, direct):
    m = 8
    A = lap3d(m)
    P = exotic.exotic_interpolation(A, (m, m, m), (2, 2, 2), etype,
                                    direct_solve=direct, device=CPU)
    jP = jexotic.exotic_interpolation(A, (m, m, m), (2, 2, 2), etype,
                                      direct_solve=direct)
    assert P.shape == jP.shape
    err = abs(P - jP).max() / abs(jP).max()
    assert err <= (1e-14 if direct else 1e-9), err
    o = {"pc_exotic_grid": (m, m, m), "pc_exotic_type": etype,
         "pc_exotic_direct_solver": "true" if direct else "false"}
    pc, jpc = both("exotic" if direct else "wb", A, o)
    assert_apply(pc, jpc, A.shape[0], 1e-12)


def test_every_slice8_type_builds_and_later_types_name_their_item():
    from petsctpu_torch.pc.api import _LATER, _SLICE8

    assert set(_SLICE8) == {
        "fieldsplit", "ksp", "composite", "mat", "shell", "eisenstat",
        "galerkin", "redistribute", "lsc", "svd", "cp", "supportgraph",
        "exotic", "wb", "tfs", "spai"}
    A, _ = ex2()
    # bddc, nn and fft came with the Mat formats (slice 12); only hmpi
    # still waits for its item
    from petsctpu_torch.pc.api import _SLICE12
    assert set(_SLICE12) == {"bddc", "nn", "fft"}
    assert set(_LATER) == {"hmpi"}
    for name, item in (("hmpi", 14),):
        assert _LATER[name] == f"ROADMAP queue 1 item {item}"
        with pytest.raises(NotImplementedError, match=f"item {item}\\)"):
            make_pc(name, A=aij_from_scipy(A, device=CPU), A_host=A)
