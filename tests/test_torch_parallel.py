"""The distributed layer of the port (petsctpu_torch/parallel, pc/parallel,
core/layout, core/commaudit, mat/partition, dm/decomp) against petsctpu.

The port's ranks are threads of the test process with gloo groups
(parallel.comm.World, device "cpu"); petsctpu runs under its 8-device
CPU mesh (tests/conftest.py). Each test runs at np = 2, 4 and 8 where
the reference's own test does. Host plans (Layout, PartitionedCSR, the
halo plan, the ELL and SELL packs, the k-way, RCM and RCB partitions,
the DMDA decomposition) are held byte for byte; products within fp64
rtol 1e-12 (the reductions' order differs: XLA's against the port's);
solves to equal iteration counts and reasons and their histories within
rtol 1e-8 (fp64; entries below 1e-12 of the first are rounding noise);
collective counts an iteration equal to petsctpu's
jaxpr audit of the same program.
"""

import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse as sp
import torch
from jax import shard_map
from jax.sharding import Mesh, PartitionSpec as PS

from petsctpu.core.layout import Layout as RLayout
from petsctpu.models import ex2_system, laplacian_2d
from petsctpu.parallel import plan as rplan
from petsctpu.parallel import sharded_aij_from_scipy as r_sharded
from petsctpu.parallel.api import par_ksp_solve as r_par_ksp_solve

from petsctpu_torch.convert import sharded_aij_from_arrays
from petsctpu_torch.core.layout import Layout
from petsctpu_torch.parallel import (ParKSP, World, par_ksp_solve,
                                     shard_vector, sharded_aij_from_scipy,
                                     unshard_vector)
from petsctpu_torch.parallel import plan as tplan
from petsctpu_torch.pc.parallel import make_par_pc

# one intra-op thread: the suite runs in parallel workers (pytest -n), and
# PyTorch's default of a thread a core oversubscribes the host's cores
torch.set_num_threads(1)

NPS = (2, 4, 8)
_WORLDS = {}


@pytest.fixture(autouse=True, scope="module")
def _close_worlds():
    yield
    for w in _WORLDS.values():
        w.close()
    _WORLDS.clear()


def world(P: int) -> World:
    """One World of P CPU rank threads per test process (closed when the
    module's tests end)."""
    if P not in _WORLDS or _WORLDS[P].closed:
        _WORLDS[P] = World(P, "cpu", timeout=60.0)
    return _WORLDS[P]


def mesh(P: int) -> Mesh:
    return Mesh(np.array(jax.devices()[:P]), ("rows",))


def run_ranks(P, fn, *vecs):
    """[fn(comm, *pieces of vecs)] over the World of P ranks."""
    w = world(P)
    return w.run(fn, list(zip(*vecs)) if vecs else None)


def ref_apply(M, x_padded, method, P):
    """petsctpu's local method of a stacked sharded object under its
    shard_map on P devices (the reference side of every product)."""
    f = jax.jit(shard_map(lambda A, v: getattr(A.local(), method)(v),
                          mesh=mesh(P), in_specs=(PS("rows"), PS("rows")),
                          out_specs=PS("rows"), check_vma=False))
    return np.asarray(f(M, jnp.asarray(x_padded)))


def nonsym(n=63, seed=0):
    A = laplacian_2d(9, 7).tolil()
    rng = np.random.default_rng(seed)
    for i in range(n - 1):
        A[i, i + 1] += 0.3 * rng.random()
    A[n - 1, 3] = 0.2                 # one long-range coupling
    return A.tocsr()


def poisson3d(m):
    e = np.ones(m)
    T1 = sp.diags([-e[:-1], 2 * e, -e[:-1]], [-1, 0, 1])
    I1 = sp.eye(m)
    return (sp.kron(sp.kron(T1, I1), I1) + sp.kron(sp.kron(I1, T1), I1)
            + sp.kron(sp.kron(I1, I1), T1)).tocsr()


def assert_csr_equal(a, b):
    a, b = sp.csr_matrix(a), sp.csr_matrix(b)
    assert a.shape == b.shape and a.dtype == b.dtype
    for f in ("indptr", "indices", "data"):
        np.testing.assert_array_equal(getattr(a, f), getattr(b, f))


# ---------------------------------------------------------------------------
# host plans, byte for byte
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("P", NPS)
def test_layout_matches_reference(P):
    for n in (1, 7, 63, 64, 1000):
        a, b = Layout(n, P), RLayout(n, P)
        assert (a.shard_size, a.n_padded, a.n_pad) == \
            (b.shard_size, b.n_padded, b.n_pad)
        g = np.arange(n)
        np.testing.assert_array_equal(a.owner(g), b.owner(g))
        np.testing.assert_array_equal(a.local_index(g), b.local_index(g))
        assert [a.range(p) for p in range(P)] == [b.range(p)
                                                  for p in range(P)]
        x = np.arange(n, dtype=np.float64)
        np.testing.assert_array_equal(a.pad_vector(x), b.pad_vector(x))


def assert_part_equal(pt, pr):
    assert (pt.layout.n, pt.layout.nshards) == (pr.layout.n,
                                                pr.layout.nshards)
    for Dt, Dr in zip(pt.diag_blocks, pr.diag_blocks):
        assert_csr_equal(Dt, Dr)
    for Ot, Or in zip(pt.off_blocks, pr.off_blocks):
        assert_csr_equal(Ot, Or)
    for gt, gr in zip(pt.garrays, pr.garrays):
        np.testing.assert_array_equal(gt, gr)
        assert gt.dtype == gr.dtype
    assert_halo_equal(pt.halo, pr.halo)


def assert_halo_equal(ht, hr):
    for f in ("send_idx", "ghost_src", "ghost_gidx", "n_ghost"):
        a, b = getattr(ht, f), getattr(hr, f)
        assert a.dtype == b.dtype, f
        np.testing.assert_array_equal(a, b, err_msg=f)
    assert (ht.smax, ht.gmax, ht.offsets) == (hr.smax, hr.gmax, hr.offsets)


@pytest.mark.parametrize("P", NPS)
def test_partition_csr_and_halo_plan_byte_equal(P):
    from petsctpu_torch.convert import partitioned_csr_from_arrays

    for A in (laplacian_2d(9, 7), nonsym(), poisson3d(5)):
        pr = rplan.partition_csr(A, P)
        assert_part_equal(tplan.partition_csr(A, P), pr)
        # and carried across from petsctpu's arrays
        h = pr.halo
        assert_part_equal(partitioned_csr_from_arrays(
            pr.layout.n, P, pr.diag_blocks, pr.off_blocks, pr.garrays,
            dict(send_idx=h.send_idx, ghost_src=h.ghost_src,
                 ghost_gidx=h.ghost_gidx, n_ghost=h.n_ghost, smax=h.smax,
                 gmax=h.gmax, offsets=h.offsets)), pr)
    R = sp.random(50, 13, density=0.2, random_state=P, format="csr")
    for a, b in zip(tplan.partition_rect_csr(R, P),
                    rplan.partition_rect_csr(R, P)):
        if isinstance(a, list):
            for x, y in zip(a, b):
                if sp.issparse(x):
                    assert_csr_equal(x, y)
                else:
                    np.testing.assert_array_equal(x, y)
        elif hasattr(a, "send_idx"):
            assert_halo_equal(a, b)
        else:
            assert (a.n, a.nshards) == (b.n, b.nshards)


@pytest.mark.parametrize("P", NPS)
def test_ell_packs_byte_equal(P):
    for A in (laplacian_2d(9, 7), nonsym()):
        for style in ("alltoall", "allgather", "ppermute", "auto"):
            R, _ = r_sharded(A, P, style=style)
            T, _ = sharded_aij_from_scipy(A, P, style=style, device="cpu")
            assert T.style == R.style and T.offsets == R.offsets
            assert T.shape == R.shape and T.nnz == R.nnz
            for f in ("diag_cols", "diag_vals", "off_cols", "off_vals",
                      "send_idx", "ghost_src", "ghost_gidx"):
                ref = np.asarray(getattr(R, f))
                for p in range(P):
                    np.testing.assert_array_equal(
                        getattr(T, f)[p].numpy(), ref[p], err_msg=f)


def assert_sell_ranks_equal(T, R, P):
    """Each rank's SELL pack of T is row p of R's stacked diag_sell."""
    S = R.diag_sell
    assert T.fmt == "sell"
    for p in range(P):
        M = T.diag_ops[p]
        for f in ("vals", "idx", "qs", "winstart", "diag"):
            np.testing.assert_array_equal(getattr(M, f).numpy(),
                                          np.asarray(getattr(S, f))[p],
                                          err_msg=f)
        assert (M.G, M.S, M.Lp, M.nnz, M.mode) == \
            (S.G, S.S, S.Lp, S.nnz, S.mode)


@pytest.mark.parametrize("P", NPS)
def test_sell_packs_byte_equal(P):
    """fmt="sell": each rank's SELL pack (K2's operand) is row p of
    petsctpu's stacked diag_sell, with the common (passes, S, Lp); fmt
    "auto" takes the same packs on these fp32 SELL-viable blocks."""
    A = poisson3d(32 if P == 8 else 24).astype(np.float32)
    R, _ = r_sharded(A, P, dtype=np.float32, fmt="sell")
    for fmt in ("sell", "auto"):
        T, _ = sharded_aij_from_scipy(A, P, dtype=np.float32, fmt=fmt,
                                      device="cpu")
        assert_sell_ranks_equal(T, R, P)


@pytest.mark.parametrize("P", NPS)
def test_auto_fmt_follows_the_accelerator_rule(P, monkeypatch):
    """fmt="auto" on the CPU takes petsctpu's accelerator rule
    (pmat.py's TPU branch, run here with jax.default_backend patched to
    "tpu"): SELL packs byte-equal to its diag_sell where every fp32 rank
    block is SELL-viable; the ELL packs where one is not (blocks under
    2,048 rows) or the dtype is fp64."""
    monkeypatch.setattr(jax, "default_backend", lambda: "tpu")
    big = poisson3d(32 if P == 8 else 24)
    small = poisson3d(9)
    for A, dtype, want in ((big, np.float32, "sell"),
                           (small, np.float32, "ell"),
                           (big, np.float64, "ell")):
        R, _ = r_sharded(A, P, dtype=dtype, fmt="auto")
        T, _ = sharded_aij_from_scipy(A, P, dtype=dtype, fmt="auto",
                                      device="cpu")
        assert T.fmt == want and (R.diag_sell is not None) == \
            (want == "sell")
        if want == "sell":
            assert_sell_ranks_equal(T, R, P)
        for f in ("diag_cols", "diag_vals", "off_cols", "off_vals"):
            ref = np.asarray(getattr(R, f))
            for p in range(P):
                np.testing.assert_array_equal(getattr(T, f)[p].numpy(),
                                              ref[p], err_msg=f)


@pytest.mark.parametrize("P", NPS)
def test_partitions_byte_equal(P):
    from petsctpu.mat import partition as rpart

    from petsctpu_torch.mat import partition as tpart

    rng = np.random.default_rng(P)
    for A in (laplacian_2d(30, 20), nonsym(), poisson3d(9)):
        for f in ("partition_kway", "partition_rcm"):
            a, b = getattr(tpart, f)(A, P), getattr(rpart, f)(A, P)
            np.testing.assert_array_equal(a, b)
            assert a.dtype == b.dtype
        assert tpart.edge_cut(A, a) == rpart.edge_cut(A, b)
    xy = rng.random((300, 2))
    np.testing.assert_array_equal(tpart.partition_rcb(xy, P),
                                  rpart.partition_rcb(xy, P))
    mp = tpart.MatPartitioning(laplacian_2d(12, 12), nparts=P,
                               ptype="kway")
    np.testing.assert_array_equal(mp.apply(), rpart.MatPartitioning(
        laplacian_2d(12, 12), nparts=P, ptype="kway").apply())


@pytest.mark.parametrize("P", NPS)
def test_dm_decomp_byte_equal(P):
    from petsctpu.dm import decomp as rdec

    from petsctpu_torch.dm import decomp as tdec

    for M, N, dof in ((13, 9, 1), (20, 20, 2), (33, 17, 3)):
        assert tdec.da_proc_grid(M, N, P) == rdec.da_proc_grid(M, N, P)
        dt = tdec.DADecomp2D.create(M, N, dof, P)
        dr = rdec.DADecomp2D.create(M, N, dof, P)
        for f in ("natural_to_petsc", "petsc_row_ranges", "element_owner",
                  "element_order"):
            np.testing.assert_array_equal(getattr(dt, f)(),
                                          getattr(dr, f)())
    rng = np.random.default_rng(P)
    n = 40
    rows, cols = rng.integers(0, n, 300), rng.integers(0, n, 300)
    vals = rng.standard_normal(300)
    rk, seq = rng.integers(0, P, 300), np.arange(300)
    owner = np.arange(n) * P // n
    assert_csr_equal(tdec.coo_sum_parallel(rows, cols, vals, rk, seq, owner,
                                           n),
                     rdec.coo_sum_parallel(rows, cols, vals, rk, seq, owner,
                                           n))
    A = sp.random(n, n, density=0.2, random_state=P, format="csr")
    x = rng.standard_normal(n)
    np.testing.assert_array_equal(tdec.mpiaij_matmult(A, x, owner),
                                  rdec.mpiaij_matmult(A, x, owner))


# ---------------------------------------------------------------------------
# products
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("P", NPS)
@pytest.mark.parametrize("style", ("alltoall", "allgather", "ppermute"))
def test_sharded_aij_mult_multT(P, style):
    """mult and multT of ShardedAIJ against petsctpu's under shard_map,
    both built from petsctpu's stacked arrays (convert), rtol 1e-12."""
    A = nonsym()
    R, part = r_sharded(A, P, style=style)
    T = sharded_aij_from_arrays(
        {f: np.asarray(getattr(R, f)) for f in (
            "diag_cols", "diag_vals", "off_cols", "off_vals", "send_idx",
            "ghost_src", "ghost_gidx")},
        dict(shape=R.shape, nshards=P, style=R.style, nnz=R.nnz,
             offsets=R.offsets), device="cpu")
    lay = part.layout
    x = np.random.default_rng(P).standard_normal(lay.n)
    xs = shard_vector(world(P), x, lay)
    for method, ref in (("mult", A @ x), ("multT", A.T @ x)):
        y = unshard_vector(run_ranks(
            P, lambda c, v: getattr(T.rank(c), method)(v), xs), lay)
        if P == 8:
            yr = ref_apply(R, lay.pad_vector(x), method, P)[:lay.n]
            np.testing.assert_allclose(y, yr, rtol=1e-12, atol=1e-14)
        np.testing.assert_allclose(y, ref, rtol=1e-12, atol=1e-14)


def block_system(bs=3, gx=6, gy=5, seed=0):
    """tests/test_pbaij.py's blocked system."""
    L = laplacian_2d(gx, gy)
    rng = np.random.default_rng(seed)
    blocks = rng.standard_normal((gx * gy, bs, bs)) * 0.1
    Bd = sp.block_diag([np.eye(bs) * 4 + b for b in blocks])
    return sp.csr_matrix(sp.kron(L, np.eye(bs)) + Bd)


@pytest.mark.parametrize("P", NPS)
def test_sharded_baij_mult_diagonal_and_plan(P):
    from petsctpu.parallel import sharded_baij_from_scipy as r_baij

    from petsctpu_torch.parallel.pbaij import baij_plan, \
        sharded_baij_from_scipy

    for bs, gx, gy in ((3, 6, 5), (2, 7, 3)):
        A = block_system(bs, gx, gy)
        n = A.shape[0]
        R = r_baij(A, P, bs=bs)
        plan = baij_plan(A, P, bs)
        for f, g in (("dc", "diag_bcols"), ("dv", "diag_bvals"),
                     ("oc", "off_bcols"), ("ov", "off_bvals"),
                     ("send_idx", "send_idx"), ("ghost_src", "ghost_src")):
            np.testing.assert_array_equal(plan[f], np.asarray(getattr(R, g)))
        T = sharded_baij_from_scipy(A, P, bs=bs, device="cpu")
        assert T.shape == R.shape
        lay = Layout(n, P)
        x = np.zeros(T.shape[0])
        x[:n] = np.random.default_rng(bs).standard_normal(n)
        s = T.shape[0] // P
        xs = [torch.from_numpy(x[p * s:(p + 1) * s].copy())
              for p in range(P)]
        y = torch.cat(run_ranks(P, lambda c, v: T.rank(c).mult(v), xs))
        np.testing.assert_allclose(y.numpy()[:n], A @ x[:n], rtol=1e-12,
                                   atol=1e-13)
        if P == 4:
            yr = ref_apply(R, x, "mult", P)
            np.testing.assert_allclose(y.numpy(), yr, rtol=1e-12,
                                       atol=1e-13)
        d = torch.cat(run_ranks(P, lambda c: T.rank(c).diagonal()))
        np.testing.assert_array_equal(d.numpy()[:n], A.diagonal())
        del lay


def stencil_pair(grid, offsets, seed):
    """A random-coefficient stencil as petsctpu's and the port's
    StencilMat, from the same arrays."""
    from petsctpu.mat.stencil import StencilMat as RStencil

    from petsctpu_torch.convert import stencil_from_arrays

    rng = np.random.default_rng(seed)
    C = rng.standard_normal((len(offsets),) + tuple(grid))
    return (RStencil(jnp.asarray(C), offsets, tuple(grid)),
            stencil_from_arrays(C, offsets, tuple(grid), device="cpu"))


@pytest.mark.parametrize("P", NPS)
def test_sharded_stencil_mult(P):
    """ShardedStencil (two ppermutes of the halo rows, the shifted sums
    on the extended slab) against petsctpu's, 2-D star and 3-D box."""
    from petsctpu.parallel import sharded_stencil_from as r_stencil

    from petsctpu_torch.parallel import sharded_stencil_from

    star = ((0, 0), (-1, 0), (1, 0), (0, -1), (0, 1))
    box = tuple((i, j, k) for i in (-1, 0, 1) for j in (-1, 0, 1)
                for k in (-1, 0, 1))
    for grid, offs in (((19, 7), star), ((13, 5, 4), box)):
        RS, TS = stencil_pair(grid, offs, P)
        R = r_stencil(RS, P)
        T = sharded_stencil_from(TS, P, device="cpu")
        assert T.grid == R.grid and T.halo == R.halo
        n = int(np.prod(grid))
        x = np.zeros(int(np.prod(T.grid)))
        x[:n] = np.random.default_rng(P).standard_normal(n)
        k = x.size // P
        xs = [torch.from_numpy(x[p * k:(p + 1) * k].copy())
              for p in range(P)]
        y = torch.cat(run_ranks(P, lambda c, v: T.rank(c).mult(v),
                                xs)).numpy()
        np.testing.assert_allclose(y[:n], np.asarray(RS.mult(
            jnp.asarray(x[:n]))), rtol=1e-12, atol=1e-13)
        if P == 8:
            np.testing.assert_allclose(y, ref_apply(R, x, "mult", P),
                                       rtol=1e-12, atol=1e-13)


@pytest.mark.parametrize("P", NPS)
def test_sharded_q1_interp_and_rect_aij(P):
    """ShardedQ1Interp (mult = P, multT = Pᵀ) against petsctpu's, and
    ShardedRectAIJ (a prolongator's rows and columns each split over
    the ranks) against scipy."""
    from petsctpu.parallel.pstencil import sharded_q1_interp as r_q1

    from petsctpu_torch.parallel.pmat import sharded_rect_from_scipy
    from petsctpu_torch.parallel.pstencil import sharded_q1_interp

    fine, coarse = (17, 9), (9, 5)
    mloc_f = 2 * -(-17 // (2 * P))
    R = r_q1(fine, coarse, P, mloc_f)
    T = sharded_q1_interp(fine, coarse, P, mloc_f, device="cpu")
    rng = np.random.default_rng(P)
    nc, nf = int(np.prod(T.coarse)), int(np.prod(T.fine))
    xc = np.zeros(nc)
    xc[:int(np.prod(coarse))] = rng.standard_normal(int(np.prod(coarse)))
    xf = np.zeros(nf)
    xf[:int(np.prod(fine))] = rng.standard_normal(int(np.prod(fine)))
    for method, x in (("mult", xc), ("multT", xf)):
        k = x.size // P
        xs = [torch.from_numpy(x[p * k:(p + 1) * k].copy())
              for p in range(P)]
        y = torch.cat(run_ranks(
            P, lambda c, v: getattr(T.rank(c), method)(v), xs)).numpy()
        np.testing.assert_allclose(y, ref_apply(R, x, method, P),
                                   rtol=1e-12, atol=1e-14)

    Pm = sp.random(60, 17, density=0.15, random_state=P, format="csr")
    Rm = sharded_rect_from_scipy(Pm, P, device="cpu")
    rl, cl = Layout(60, P), Layout(17, P)
    xc = rng.standard_normal(17)
    xf = rng.standard_normal(60)
    y = unshard_vector(run_ranks(P, lambda c, v: Rm.rank(c).mult(v),
                                 shard_vector(world(P), xc, cl)), rl)
    np.testing.assert_allclose(y, Pm @ xc, rtol=1e-12, atol=1e-14)
    y = unshard_vector(run_ranks(P, lambda c, v: Rm.rank(c).multT(v),
                                 shard_vector(world(P), xf, rl)), cl)
    np.testing.assert_allclose(y, Pm.T @ xf, rtol=1e-12, atol=1e-14)


# ---------------------------------------------------------------------------
# distributed solves
# ---------------------------------------------------------------------------
SOLVES = (("cg", "jacobi", {}), ("gmres", "bjacobi", {}),
          ("pipecg", "jacobi", {}), ("groppcg", "jacobi", {}),
          ("bcgs", "bjacobi", {}), ("gmres", "bjacobi",
                                    {"sub_pc_type": "lu"}))


def assert_same_solve(rt, rr, rtol=1e-8):
    assert int(rt.its) == int(rr.its), (int(rt.its), int(rr.its))
    assert int(rt.reason) == int(rr.reason)
    k = int(rt.its) + 1
    ref = np.asarray(rr.history[:k])
    # entries below 1e-12 of the first are rounding noise of either side
    np.testing.assert_allclose(rt.history[:k].numpy(), ref, rtol=rtol,
                               atol=1e-12 * ref[0])


@pytest.mark.parametrize("P", NPS)
def test_par_ksp_solve_matches_reference(P):
    """par_ksp_solve with CG, GMRES, PIPECG, GROPPCG and BiCGStab over
    jacobi and block Jacobi ILU(0)/LU: the iteration count and reason of
    petsctpu's par_ksp_solve on the same partition, the history within
    rtol 1e-8 and x within tests/test_parallel.py's 1e-8 of the exact
    solution."""
    from petsctpu.core.options import Options as ROptions
    from petsctpu.pc.parallel import make_par_pc as r_make_par_pc

    from petsctpu_torch.core.options import Options

    A, b, u = ex2_system(8, 8)
    A = sp.csr_matrix(A)
    b = np.asarray(b)
    R, rpart = r_sharded(A, P)
    T, part = sharded_aij_from_scipy(A, P, device="cpu")
    for ksp, pct, o in SOLVES:
        rr = r_par_ksp_solve(mesh(P), R, b, pc=r_make_par_pc(
            pct, R, rpart, options=ROptions(o)), ksp_type=ksp, rtol=1e-10)
        rt = par_ksp_solve(world(P), T, b, pc=make_par_pc(
            pct, T, part, options=Options(o)), ksp_type=ksp, rtol=1e-10)
        assert_same_solve(rt, rr)
        assert int(rt.reason) > 0
        np.testing.assert_allclose(unshard_vector(rt.x, part.layout), u,
                                   atol=1e-7 if ksp == "pipecg" else 1e-8)


@pytest.mark.parametrize("P", NPS)
def test_parksp_object_and_blocked_operator(P):
    """ParKSP from options (tests/test_parallel.py::test_parksp_object)
    and CG on a ShardedBAIJ (tests/test_pbaij.py's blocked solve)."""
    from petsctpu.parallel import sharded_baij_from_scipy as r_baij

    from petsctpu_torch.core.options import Options
    from petsctpu_torch.parallel import sharded_baij_from_scipy

    A, b, u = ex2_system(8, 8)
    A = sp.csr_matrix(A)
    T, part = sharded_aij_from_scipy(A, P, device="cpu")
    ksp = ParKSP(world(P), options=Options({"ksp_type": "bcgs",
                                           "ksp_rtol": "1e-9"}))
    ksp.set_operators(T, part)
    res = ksp.solve(np.asarray(b))
    assert int(res.reason) > 0
    np.testing.assert_allclose(unshard_vector(res.x, part.layout), u,
                               atol=1e-7)

    Ab = block_system(3)
    Ab = sp.csr_matrix(Ab + Ab.T)
    bb = np.random.default_rng(3).standard_normal(Ab.shape[0])
    rr = r_par_ksp_solve(mesh(P), r_baij(Ab, P, bs=3), bb, ksp_type="cg",
                         rtol=1e-10, maxits=200)
    rt = par_ksp_solve(world(P), sharded_baij_from_scipy(
        Ab, P, bs=3, device="cpu"), bb, ksp_type="cg", rtol=1e-10,
        maxits=200)
    assert_same_solve(rt, rr)


def irregular_system():
    from test_dist_asm import _irregular_system
    return _irregular_system()


def test_dist_asm_matches_reference():
    """Distributed overlap-1 restricted ASM + GMRES at 4 ranks (the rank
    count of tests/test_dist_asm.py): petsctpu's iterations and history."""
    from petsctpu.pc.parallel import make_dist_asm as r_dist_asm

    from petsctpu_torch.pc.parallel import make_dist_asm

    A, b = irregular_system()
    P = 4
    R, rpart = r_sharded(A, P)
    T, part = sharded_aij_from_scipy(A, P, device="cpu")
    rr = r_par_ksp_solve(mesh(P), R, b, pc=r_dist_asm(A, rpart, overlap=1),
                         ksp_type="gmres", rtol=1e-8, maxits=400)
    rt = par_ksp_solve(world(P), T, b, pc=make_dist_asm(A, part, overlap=1,
                                                        device="cpu"),
                       ksp_type="gmres", rtol=1e-8, maxits=400)
    assert int(rt.reason) > 0
    assert_same_solve(rt, rr)


def test_subcomm_groups_and_hmpi():
    """Two systems solved at once, each on its own 2-rank group of a
    4-rank World (tests/test_subcomm.py), their iterations those of a
    plain 2-rank solve; and PCHMPI (-pc_type hmpi): an outer serial
    FGMRES whose PC is an inner 2-rank distributed solve."""
    import scipy.sparse.linalg as spla

    from petsctpu_torch.core.options import Options
    from petsctpu_torch.ksp import ksp_solve
    from petsctpu_torch.mat import aij_from_scipy
    from petsctpu_torch.parallel import nested_mesh, sub_ksp_solve
    from petsctpu_torch.pc import make_pc

    A1, b1, u1 = ex2_system(8, 8)
    A1 = sp.csr_matrix(A1)
    A2 = (A1 + 0.7 * sp.eye(64)).tocsr()
    b2 = np.linspace(0.0, 1.0, 64)
    u2 = spla.spsolve(A2, b2)
    As = [sharded_aij_from_scipy(A, 2, device="cpu")[0] for A in (A1, A2)]
    res = sub_ksp_solve(nested_mesh(world(4), 2), As, [np.asarray(b1), b2],
                        ksp_type="cg", rtol=1e-10, maxits=300)
    np.testing.assert_allclose(res.x[0].numpy()[:64], u1, atol=1e-7)
    np.testing.assert_allclose(res.x[1].numpy()[:64], u2, atol=1e-7)
    assert int(res.reason[0]) > 0 and int(res.reason[1]) > 0
    assert int(res.its[0]) != int(res.its[1])
    for g, (A, b) in enumerate(((A1, b1), (A2, b2))):
        flat = par_ksp_solve(world(2), As[g], np.asarray(b), ksp_type="cg",
                             rtol=1e-10, maxits=300)
        assert int(res.its[g]) == int(flat.its)

    A, b, u = ex2_system(16, 16)
    A = sp.csr_matrix(A)
    Ad = aij_from_scipy(A, device="cpu")
    pc = make_pc("hmpi", A=Ad, A_host=A,
                 options=Options({"hmpi_ksp_rtol": "1e-10"}))
    r = ksp_solve(Ad, torch.from_numpy(np.asarray(b)), pc=pc,
                  ksp_type="fgmres", rtol=1e-8, maxits=50)
    assert int(r.reason) > 0 and int(r.its) <= 3, int(r.its)
    np.testing.assert_allclose(r.x.numpy(), u, atol=1e-8)
    pc.close()                  # the World the PC made
    assert pc.world.closed


@pytest.mark.parametrize("P", (4, 8))
def test_partitioned_sharding_perm(P):
    """A scrambled matrix split through its k-way (and RCM) partition
    permutation builds a smaller halo and solves to the same x
    (tests/test_subcomm.py::test_perm_reduces_halo_and_matches)."""
    rng = np.random.default_rng(7)
    scram = rng.permutation(144)
    A = laplacian_2d(12, 12).tocsr()[scram][:, scram]
    b = rng.standard_normal(144)
    T0, part0 = sharded_aij_from_scipy(A, P, device="cpu")
    x0 = unshard_vector(par_ksp_solve(world(P), T0, b, ksp_type="cg",
                                      rtol=1e-10).x, part0.layout)
    for name in ("kway", "rcm"):
        T1, part1 = sharded_aij_from_scipy(A, P, perm=name, device="cpu")
        R1, rpart1 = r_sharded(A, P, perm=name)
        np.testing.assert_array_equal(part1.perm, rpart1.perm)
        assert part1.halo.gmax < part0.halo.gmax
        perm = part1.perm
        x1p = unshard_vector(par_ksp_solve(world(P), T1, b[perm],
                                           ksp_type="cg", rtol=1e-10).x,
                             part1.layout)
        x1 = np.empty_like(x1p)
        x1[perm] = x1p
        np.testing.assert_allclose(x0, x1, atol=1e-8)


# ---------------------------------------------------------------------------
# collective audit
# ---------------------------------------------------------------------------
AUDITED = (("cg", {}), ("pipecg", {}), ("ibcgs", {}),
           ("ibcgs", {"lag_norm": True}),
           ("cg", {"cg_single_reduction": True, "norm_type": "natural"}),
           ("bcgs", {}), ("groppcg", {}), ("tfqmr", {}))


@pytest.mark.parametrize("style", ("ppermute", "alltoall"))
def test_commaudit_counts_an_iteration_equal_reference(style):
    """The collectives an iteration (by kind, with their bytes a rank),
    counted at run time over two short solves, equal petsctpu's jaxpr
    audit of the same program at 8 ranks (tests/test_commaudit.py).
    The single-loop solvers: petsctpu's audit of GMRES counts the
    restart loop's body in every iteration too (nested while loops),
    which a run never repeats."""
    from petsctpu.parallel.api import audit_par_ksp as r_audit

    from petsctpu_torch.core.commaudit import COMM_AUDITS, comm_table, \
        halo_audit
    from petsctpu_torch.parallel.api import audit_par_ksp

    P = 8
    A = poisson3d(16).astype(np.float32)
    R, _ = r_sharded(A, P, dtype=np.float32, style=style)
    T, part = sharded_aij_from_scipy(A, P, dtype=np.float32, style=style,
                                     device="cpu")
    assert T.style == style
    b = np.random.default_rng(0).standard_normal(A.shape[0]) \
        .astype(np.float32)
    for ksp, kw in AUDITED:
        ra = r_audit(P, R, jnp.zeros(R.shape[0], jnp.float32), ksp_type=ksp,
                     maxits=5, **kw).per_iteration
        ta = audit_par_ksp(world(P), T, b, ksp_type=ksp, **kw).per_iteration
        assert ta.counts == ra.counts, (ksp, kw, ta.counts, ra.counts)
        assert ta.bytes == ra.bytes, (ksp, kw, ta.bytes, ra.bytes)
    assert "ksp:cg[8]" in comm_table()
    assert any(k.startswith("ksp:cg[8]") for k in COMM_AUDITS)
    h = halo_audit(part.halo, np.float32)
    from petsctpu.core.commaudit import halo_audit as r_halo_audit
    assert h == r_halo_audit(part.halo, np.float32)


# ---------------------------------------------------------------------------
# distributed SNES and TS
# ---------------------------------------------------------------------------
STAR5 = ((0, 0), (-1, 0), (1, 0), (0, -1), (0, 1))


@pytest.mark.parametrize("P", NPS)
def test_sharded_fd_jacobian_matches_reference(P):
    """The sharded colored-FD Jacobian of the sharded Bratu residual
    (tests/test_psnes.py::test_bratu_jacobian_matches_serial): J·v equal
    to petsctpu's serial colored-FD J·v within 1e-6, with the coloring
    and plan arrays of petsctpu's ShardedFDJac."""
    from petsctpu.dm.da import DA as RDA
    from petsctpu.mat.stencil import StencilMat as RStencil
    from petsctpu.models.bratu import (bratu_initial_guess as r_init,
                                       bratu_jacobian_template as r_tmpl,
                                       bratu_residual as r_res)
    from petsctpu.parallel import ShardedFDJac as RFDJac
    from petsctpu.snes.fdjac import ColoredJacobian as RCJ

    from petsctpu_torch.dm import DA
    from petsctpu_torch.models.bratu import bratu_residual_sharded
    from petsctpu_torch.parallel import ShardedFDJac

    m = n = 11
    lam = 5.0
    Fs = r_res(RDA((m, n)), lam)
    x0 = r_init(RDA((m, n)), lam)
    Js = RCJ.from_stencil(r_tmpl(RDA((m, n)))).assemble(Fs, x0, Fs(x0))
    assert isinstance(Js, RStencil)
    Fp, grid_pad = bratu_residual_sharded(DA((m, n)), P, lam=lam)
    plan = ShardedFDJac.plan((m, n), STAR5, P, device="cpu")
    rplan_ = RFDJac.plan((m, n), STAR5, P)
    assert plan.grid == grid_pad == rplan_.grid
    assert plan.ncolors == rplan_.ncolors
    for f in ("color", "colj", "ok"):
        np.testing.assert_array_equal(
            np.stack([t.numpy() for t in getattr(plan, f)]),
            np.asarray(getattr(rplan_, f)))
    n_pad = plan.n_pad
    xp = np.zeros(n_pad)
    xp[: m * n] = np.asarray(x0)
    rng = np.random.default_rng(0)
    k = n_pad // P
    for _ in range(2):
        v = np.zeros(n_pad)
        v[: m * n] = rng.standard_normal(m * n)

        def apply_J(comm, xl, vl):
            F = (lambda u: Fp(u, comm))
            J = plan.rank(comm).assemble(F, xl, F(xl))
            return J.mult(vl)

        out = torch.cat(run_ranks(
            P, apply_J, [torch.from_numpy(xp[p * k:(p + 1) * k].copy())
                         for p in range(P)],
            [torch.from_numpy(v[p * k:(p + 1) * k].copy())
             for p in range(P)])).numpy()[: m * n]
        ref = np.asarray(Js.mult(jnp.asarray(v[: m * n])))
        np.testing.assert_allclose(out, ref, rtol=1e-6, atol=1e-8)


def test_par_snes_bratu_matches_reference():
    """Distributed Newton-Krylov on Bratu λ 6 at 17² over 8 ranks
    (tests/test_psnes.py::test_bratu_newton_matches_serial): the Newton
    count of petsctpu's distributed and serial solves, x within the
    test's 1e-6 of petsctpu's distributed x."""
    from petsctpu.dm.da import DA as RDA
    from petsctpu.ksp.common import KSPConfig as RKSPConfig
    from petsctpu.models.bratu import (bratu_initial_guess as r_init,
                                       bratu_residual_sharded as r_res_sh)
    from petsctpu.parallel import ShardedFDJac as RFDJac
    from petsctpu.parallel import par_snes_solve as r_par_snes
    from petsctpu.snes.api import SNESConfig as RSNESConfig

    from petsctpu_torch.dm import DA
    from petsctpu_torch.ksp.common import KSPConfig
    from petsctpu_torch.models.bratu import bratu_residual_sharded
    from petsctpu_torch.parallel import ShardedFDJac, par_snes_solve
    from petsctpu_torch.snes.api import SNESConfig

    P, m = 8, 17
    lam = 6.0
    x0 = np.asarray(r_init(RDA((m, m)), lam))
    Fr, _ = r_res_sh(RDA((m, m)), P, lam=lam)
    rr = r_par_snes(mesh(P), Fr, x0, jac=RFDJac.plan((m, m), STAR5, P),
                    cfg=RSNESConfig(rtol=1e-8, atol=1e-12),
                    ksp_cfg=RKSPConfig(ksp_type="gmres", rtol=1e-8,
                                       maxits=400))
    Fp, _ = bratu_residual_sharded(DA((m, m)), P, lam=lam)
    rt = par_snes_solve(world(P), Fp, x0,
                        jac=ShardedFDJac.plan((m, m), STAR5, P,
                                              device="cpu"),
                        cfg=SNESConfig(rtol=1e-8, atol=1e-12),
                        ksp_cfg=KSPConfig(ksp_type="gmres", rtol=1e-8,
                                          maxits=400))
    assert int(rt.reason) > 0 and int(rt.its) == int(rr.its)
    np.testing.assert_allclose(rt.x.numpy()[: m * m],
                               np.asarray(rr.x)[: m * m], rtol=1e-6,
                               atol=1e-8)


def test_par_ts_heat_beuler_matches_reference():
    """Distributed backward Euler on the 2-D heat equation over 8 ranks
    with a colored stage Jacobian (tests/test_psnes.py::
    test_heat_beuler_matches_serial): petsctpu's step count and u within
    the test's 1e-8."""
    from jax import lax

    from petsctpu.ksp.common import KSPConfig as RKSPConfig
    from petsctpu.parallel import ShardedFDJac as RFDJac
    from petsctpu.parallel import par_ts_solve as r_par_ts
    from petsctpu.ts.steppers import TSConfig as RTSConfig

    from petsctpu_torch.ksp.common import KSPConfig
    from petsctpu_torch.parallel import ShardedFDJac, par_ts_solve
    from petsctpu_torch.ts.steppers import TSConfig

    P, m, n = 8, 16, 9
    h = 1.0 / (m + 1)

    def rhs_ref(t, u):
        U = u.reshape(m // P, n)
        above = lax.ppermute(U[-1:], "rows", [(i, i + 1)
                                              for i in range(P - 1)])
        below = lax.ppermute(U[:1], "rows", [(i + 1, i)
                                             for i in range(P - 1)])
        Ue = jnp.concatenate([above, U, below], axis=0)
        Pd = jnp.pad(Ue, ((0, 0), (1, 1)))
        lap = (Pd[:-2, 1:-1] + Pd[2:, 1:-1] + Pd[1:-1, :-2]
               + Pd[1:-1, 2:] - 4 * U)
        return (lap / h ** 2).reshape(-1)

    def rhs_port(t, u, comm):
        from petsctpu_torch.parallel.pstencil import exchange_rows
        U = u.reshape(*u.shape[:-1], m // P, n)
        Ue = exchange_rows(U, comm, 1, axis=U.dim() - 2)
        Pd = torch.nn.functional.pad(Ue, (1, 1))
        lap = (Pd[..., :-2, 1:-1] + Pd[..., 2:, 1:-1] + Pd[..., 1:-1, :-2]
               + Pd[..., 1:-1, 2:] - 4 * U)
        return (lap / h ** 2).reshape(u.shape)

    ij = np.indices((m, n))
    u0 = (np.sin(np.pi * (ij[0] + 1) / (m + 1))
          * np.sin(np.pi * (ij[1] + 1) / (n + 1))).reshape(-1)
    kw = dict(ts_type="beuler", dt=1e-3, max_steps=5, max_time=5e-3)
    rr = r_par_ts(mesh(P), rhs_ref, u0, cfg=RTSConfig(
        **kw, ksp=RKSPConfig(ksp_type="cg", rtol=1e-10, maxits=500)),
        jac=RFDJac.plan((m, n), STAR5, P))
    rt = par_ts_solve(world(P), rhs_port, u0, cfg=TSConfig(
        **kw, ksp=KSPConfig(ksp_type="cg", rtol=1e-10, maxits=500)),
        jac=ShardedFDJac.plan((m, n), STAR5, P, device="cpu"))
    assert int(rt.steps) == int(rr.steps)
    np.testing.assert_allclose(rt.u.numpy(), np.asarray(rr.u), rtol=1e-8,
                               atol=1e-10)


# ---------------------------------------------------------------------------
# the World
# ---------------------------------------------------------------------------
def test_world_run_raises_a_rank_failure_within_the_timeout():
    """A rank that raises makes World.run raise (with that rank's error
    as the cause) within the groups' timeout; the World then refuses
    further runs instead of hanging."""
    w = World(4, "cpu", timeout=5.0)

    def fn(comm):
        if comm.rank == 2:
            raise ValueError("rank 2 fails")
        return comm.psum(torch.ones(()))

    t0 = time.perf_counter()
    with pytest.raises(RuntimeError, match="rank 2 of 4") as err:
        w.run(fn)
    assert isinstance(err.value.__cause__, ValueError)
    assert time.perf_counter() - t0 < 30.0
    with pytest.raises(RuntimeError, match="closed"):
        w.run(fn)


@pytest.mark.parametrize("P", NPS)
def test_comm_collectives_and_counts(P):
    """psum sums in rank order (every rank the same bits), all_gather,
    all_to_all and ppermute move what lax's do, and each call counts
    itself with its operand's bytes."""
    rng = np.random.default_rng(P)
    vals = rng.standard_normal((P, 3))

    def fn(comm):
        me = comm.rank
        x = torch.from_numpy(vals[me].copy())
        s = comm.psum(x)
        g = comm.all_gather(x)
        a = comm.all_to_all(torch.arange(P, dtype=torch.float64) + 10 * me)
        r = comm.ppermute(x, [(p, (p + 1) % P) for p in range(P)])
        z = comm.ppermute(x, [(0, 1)])
        c = comm.psum(torch.tensor(1j * me, dtype=torch.complex128))
        return s, g, a, r, z, c, dict(comm.counts)

    with World(P, "cpu") as w:
        out = w.run(fn)
    assert w.closed
    seq = vals[0].copy()
    for k in range(1, P):
        seq = seq + vals[k]
    for me, (s, g, a, r, z, c, counts) in enumerate(out):
        np.testing.assert_array_equal(s.numpy(), seq)
        np.testing.assert_array_equal(g.numpy(), vals.reshape(-1))
        np.testing.assert_array_equal(a.numpy(), me + 10.0 * np.arange(P))
        np.testing.assert_array_equal(r.numpy(), vals[(me - 1) % P])
        np.testing.assert_array_equal(
            z.numpy(), vals[0] if me == 1 else np.zeros(3))
        assert complex(c) == 1j * sum(range(P))
        assert counts == {"psum": [2, 24 + 16], "all_gather": [1, 24],
                          "all_to_all": [1, 8 * P], "ppermute": [2, 48]}
