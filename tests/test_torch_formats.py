"""The port's Mat formats against petsctpu's, on the CPU.

* Packs byte for byte: BAIJ cols/vals, SellBAIJ's K2 pack (of the block
  expansion, explicit zeros kept), SBAIJ bcols/bvals/nnzb, BandMat
  tiles, DiaMat coeffs/offsets, COO's merged ELL.
* Folds bit for bit: AIJ.multT, BAIJ.multT's and SBAIJ's transpose
  scatter and COO's merge fold in petsctpu's slot order (mat/fold.py),
  so they equal XLA:CPU's scatter-adds on the same contributions.
* Products in fp64 within 1e-13 relative (a batched contraction may
  round in another order), fp32 within 1e-6·max.
* MAIJ, Nest, MatIS and the NN/BDDC applies within 1e-10 (dense
  pseudo-inverses), their solves with equal iteration counts; FFTMat
  and the DST Poisson PC within fp32/fp64 rounding.
* The factory covers every format, pbjacobi takes a BAIJ's own blocks,
  and convert carries petsctpu's arrays across.
"""

import sys
import pathlib

import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse as sp
import torch

from petsctpu.core.options import Options as JOptions
from petsctpu.ksp import ksp_solve as jksp_solve
from petsctpu.mat import band as jband
from petsctpu.mat import bsr as jbsr
from petsctpu.mat import coo as jcoo
from petsctpu.mat import dia as jdia
from petsctpu.mat import ell as jell
from petsctpu.mat import fft as jfft
from petsctpu.mat import maij as jmaij
from petsctpu.mat import nest as jnest
from petsctpu.mat import sbaij as jsbaij
from petsctpu.mat.factory import mat_from_options as jmat_from_options
from petsctpu.models import laplacian_2d
from petsctpu.pc import make_pc as jmake_pc
from petsctpu.pc.bddc import make_bddc as jmake_bddc
from petsctpu.pc.nn import make_nn as jmake_nn
from petsctpu.pc.simple import make_pbjacobi as jmake_pbjacobi
from petsctpu_torch import convert
from petsctpu_torch.core.options import Options
from petsctpu_torch.ksp import ksp_solve
from petsctpu_torch.mat import band as tband
from petsctpu_torch.mat import bsr as tbsr
from petsctpu_torch.mat import coo as tcoo
from petsctpu_torch.mat import dia as tdia
from petsctpu_torch.mat import ell as tell
from petsctpu_torch.mat import fft as tfft
from petsctpu_torch.mat import maij as tmaij
from petsctpu_torch.mat import matis as tmatis
from petsctpu_torch.mat import nest as tnest
from petsctpu_torch.mat import sbaij as tsbaij
from petsctpu_torch.mat.factory import mat_from_options
from petsctpu_torch.mat.fold import fold_plan
from petsctpu_torch.models.ddpoisson import matis_poisson_2d
from petsctpu_torch.models.elasticity import ex55_system
from petsctpu_torch.pc import make_pc
from petsctpu_torch.pc.bddc import make_bddc
from petsctpu_torch.pc.nn import make_nn
from petsctpu_torch.pc.simple import make_pbjacobi

sys.path.insert(0, str(pathlib.Path(__file__).parent))
from test_bddc import matis_poisson_2d as jmatis_poisson_2d  # noqa: E402

# one intra-op thread: the suite runs in parallel workers (pytest -n), and
# PyTorch's default of a thread a core oversubscribes the host's cores
torch.set_num_threads(1)

CPU = "cpu"


def t(a):
    return torch.from_numpy(np.asarray(a))


def close(got, ref, rtol=1e-13):
    got, ref = np.asarray(got), np.asarray(ref)
    assert got.shape == ref.shape
    assert np.abs(got - ref).max() <= rtol * max(np.abs(ref).max(), 1e-300)


def block_random(nb, bs, k, seed, sym=False):
    """A random block-sparse matrix with full bs×bs blocks (k blocks a
    block row, the diagonal one dominant)."""
    rng = np.random.default_rng(seed)
    r = np.repeat(np.arange(nb), k)
    c = np.clip(r + rng.integers(-4, 5, r.size), 0, nb - 1)
    B = sp.coo_matrix((np.ones(r.size), (r, c)), shape=(nb, nb)).tocsr()
    B.data[:] = 1.0
    A = sp.kron(B, np.ones((bs, bs))).tocsr()
    A.data = rng.standard_normal(A.nnz)
    A = A + sp.eye(nb * bs) * 4 * k * bs
    if sym:
        A = (A + A.T) * 0.5
    return sp.csr_matrix(A)


# ----------------------------------------------------------- fold plan --
@pytest.mark.parametrize("bs", [1, 2, 3])
def test_fold_plan_is_xla_scatter_bit_for_bit(bs):
    rng = np.random.default_rng(bs)
    tg = rng.integers(0, 40, 600)
    contrib = rng.standard_normal((600, bs)) * 10.0 ** rng.integers(
        -8, 8, (600, 1))
    start = rng.standard_normal((40, bs))
    ref = np.asarray(jnp.asarray(start).at[jnp.asarray(tg)].add(
        jnp.asarray(contrib)))
    plan = fold_plan(t(tg))
    assert plan.ranks == np.bincount(tg).max()
    np.testing.assert_array_equal(plan.fold(t(start), t(contrib)).numpy(),
                                  ref)
    # leaving out slots whose contribution is zero changes no bit
    keep = rng.random(600) < 0.7
    c0 = np.where(keep[:, None], contrib, 0.0)
    ref0 = np.asarray(jnp.asarray(start).at[jnp.asarray(tg)].add(
        jnp.asarray(c0)))
    np.testing.assert_array_equal(
        fold_plan(t(tg), keep=t(keep)).fold(t(start), t(c0)).numpy(),
        ref0)


def test_aij_multT_is_petsctpu_bit_for_bit_and_repeatable():
    rng = np.random.default_rng(7)
    A = sp.random(400, 350, density=0.03, random_state=8, format="csr")
    A.data = rng.standard_normal(A.nnz)
    Ad, Aj = tell.aij_from_scipy(A, device=CPU), jell.aij_from_scipy(A)
    x = rng.standard_normal(400)
    y = Ad.multT(t(x))
    np.testing.assert_array_equal(y.numpy(), np.asarray(Aj.multT(
        jnp.asarray(x))))
    assert torch.equal(y, Ad.multT(t(x)))
    # the padding (col 0, val 0) stays out of the plan
    assert Ad.transpose_fold().src.numel() == A.nnz


# ---------------------------------------------------------------- BAIJ --
@pytest.mark.parametrize("bs,dtype", [(1, np.float64), (2, np.float64),
                                      (3, np.float64), (2, np.float32)])
def test_baij_pack_and_products(bs, dtype):
    A = block_random(60, bs, 5, seed=bs)
    Bt = tbsr.baij_from_scipy_bsr(A, bs=bs, dtype=dtype, device=CPU)
    Bj = jbsr.baij_from_scipy_bsr(A, bs=bs, dtype=dtype, fmt="ell")
    assert type(Bt).__name__ == "BAIJ"
    np.testing.assert_array_equal(Bt.cols.numpy(), np.asarray(Bj.cols))
    assert Bt.cols.dtype == torch.int32
    np.testing.assert_array_equal(Bt.vals.numpy(), np.asarray(Bj.vals))
    assert (Bt.shape, Bt.bs, Bt.nnz) == (Bj.shape, Bj.bs, Bj.nnz)
    assert Bt.flops_per_mult() == Bj.flops_per_mult()
    rng = np.random.default_rng(0)
    x = rng.standard_normal(A.shape[0]).astype(dtype)
    rtol = 1e-13 if dtype == np.float64 else 1e-6
    close(Bt.mult(t(x)).numpy(), Bj.mult(jnp.asarray(x)), rtol)
    close(Bt.mult_add(t(x), t(x)).numpy(), Bj.mult_add(jnp.asarray(x),
                                                       jnp.asarray(x)), rtol)
    yT = Bt.multT(t(x))
    close(yT.numpy(), Bj.multT(jnp.asarray(x)), rtol)
    if bs == 1:     # the contributions are plain products: every bit
        np.testing.assert_array_equal(yT.numpy(),
                                      np.asarray(Bj.multT(jnp.asarray(x))))
    assert torch.equal(yT, Bt.multT(t(x)))
    np.testing.assert_array_equal(Bt.diag_blocks().numpy(),
                                  np.asarray(Bj.diag_blocks()))
    np.testing.assert_array_equal(Bt.diagonal().numpy(),
                                  np.asarray(Bj.diagonal()))
    # the transpose fold equals XLA's scatter on the same contributions
    contrib = rng.standard_normal((Bt.cols.numel(), bs)).astype(dtype)
    keep = (Bt.vals != 0).flatten(2).any(2).reshape(-1).numpy()
    contrib[~keep] = 0.0
    ref = jnp.zeros((A.shape[1] // bs, bs), dtype).at[
        jnp.asarray(Bj.cols).reshape(-1)].add(jnp.asarray(contrib))
    got = Bt.transpose_fold().fold(
        torch.zeros(A.shape[1] // bs, bs, dtype=Bt.dtype), t(contrib))
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))


def test_sellbaij_k2_pack_is_petsctpus_of_the_block_expansion():
    """ex55 at ne = 31 (n = 2048, bs 2): fmt 'sell' builds SellBAIJ on
    any device; its K2 pack equals petsctpu's, array for array, and is
    not the pack of the CSR without the blocks' explicit zeros."""
    A, _, _ = ex55_system(31, 1e-3)
    A.data[::7] = 0.0                   # explicit zeros inside blocks
    St = tbsr.baij_from_scipy_bsr(A, bs=2, dtype=np.float32, fmt="sell",
                                  device=CPU)
    Sj = jbsr.baij_from_scipy_bsr(A, bs=2, dtype=np.float32, fmt="sell")
    assert type(St).__name__ == "SellBAIJ" == type(Sj).__name__
    for f in ("vals", "idx", "qs", "winstart", "diag"):
        np.testing.assert_array_equal(getattr(St.sell, f).numpy(),
                                      np.asarray(getattr(Sj.sell, f)), f)
    for f in ("shape", "nnz", "G", "S", "Lp", "mode"):
        assert getattr(St.sell, f) == getattr(Sj.sell, f), f
    Ae = sp.csr_matrix(A).copy()
    Ae.eliminate_zeros()
    assert St.sell.nnz != Ae.nnz
    x = np.random.default_rng(1).standard_normal(A.shape[0]).astype(
        np.float32)
    y = St.mult(t(x)).numpy()
    ref = np.asarray(Sj.mult(jnp.asarray(x)))
    assert np.abs(y - ref).max() <= 1e-6 * np.abs(ref).max()
    close(St.multT(t(x)).numpy(), Sj.multT(jnp.asarray(x)), 1e-6)
    np.testing.assert_array_equal(St.diag_blocks().numpy(),
                                  np.asarray(Sj.diag_blocks()))
    assert St.bs == 2 and St.flops_per_mult() == Sj.flops_per_mult()
    # auto keeps the block ops on the CPU; fp64 'sell' raises
    assert type(tbsr.baij_from_scipy_bsr(A, bs=2, dtype=np.float32,
                                         device=CPU)).__name__ == "BAIJ"
    with pytest.raises(ValueError, match="float32"):
        tbsr.baij_from_scipy_bsr(A, bs=2, fmt="sell", device=CPU)


def test_sellbaij_is_a_baij_over_the_same_arrays():
    """SellBAIJ is a BAIJ (only its forward product differs): its
    block_ops() is the plain BAIJ on the same tensors, equal to the one
    fmt 'ell' builds, and its product agrees with K2's in fp32."""
    A, _, _ = ex55_system(31, 1e-3)
    St = tbsr.baij_from_scipy_bsr(A, bs=2, dtype=np.float32, fmt="sell",
                                  device=CPU)
    Bt = tbsr.baij_from_scipy_bsr(A, bs=2, dtype=np.float32, fmt="ell",
                                  device=CPU)
    B = St.block_ops()
    assert isinstance(St, tbsr.BAIJ) and type(B) is tbsr.BAIJ
    assert B.cols is St.cols and B.vals is St.vals
    assert (B.shape, B.bs, B.nnz) == (Bt.shape, Bt.bs, Bt.nnz)
    x = t(np.random.default_rng(2).standard_normal(A.shape[0]).astype(
        np.float32))
    np.testing.assert_array_equal(B.mult(x).numpy(), Bt.mult(x).numpy())
    y = St.mult(x).numpy()
    assert np.abs(B.mult(x).numpy() - y).max() <= 1e-6 * np.abs(y).max()
    np.testing.assert_array_equal(St.mult_add(x, x).numpy(),
                                  (x + St.mult(x)).numpy())


def test_pbjacobi_takes_the_baij_blocks():
    A, _, _ = ex55_system(7, 1e-3)
    Bt = tbsr.baij_from_scipy_bsr(A, bs=2, device=CPU)
    Bj = jbsr.baij_from_scipy_bsr(A, bs=2)
    pc, jpc = make_pbjacobi(Bt), jmake_pbjacobi(Bj)
    assert pc.bs == jpc.bs == 2
    close(pc.binv.numpy(), jpc.binv, 1e-13)
    # and through make_pc, without -pc_pbjacobi_block_size
    pc2 = make_pc("pbjacobi", A=Bt)
    x = np.random.default_rng(2).standard_normal(A.shape[0])
    close(pc2.apply(t(x)).numpy(), jpc.apply(jnp.asarray(x)), 1e-13)


# --------------------------------------------------------------- SBAIJ --
@pytest.mark.parametrize("case", ["ex55", "bs1", "bs3"])
def test_sbaij_pack_and_products(case):
    if case == "ex55":
        A, bs = ex55_system(7, 1e-3)[0], 2
    else:
        bs = 1 if case == "bs1" else 3
        A = block_random(50, bs, 6, seed=11 + bs, sym=True)
    St = tsbaij.sbaij_from_scipy(A, bs=bs, device=CPU)
    Sj = jsbaij.sbaij_from_scipy(A, bs=bs)
    np.testing.assert_array_equal(St.bcols.numpy(), np.asarray(Sj.bcols))
    assert St.bcols.dtype == torch.int32
    np.testing.assert_array_equal(St.bvals.numpy(), np.asarray(Sj.bvals))
    assert (St.nnzb, St.shape, St.bs) == (Sj.nnzb, Sj.shape, Sj.bs)
    assert St.flops_per_mult() == Sj.flops_per_mult()
    rng = np.random.default_rng(3)
    x = rng.standard_normal(A.shape[0])
    y = St.mult(t(x))
    close(y.numpy(), Sj.mult(jnp.asarray(x)))
    close(y.numpy(), A @ x, 1e-12)
    assert torch.equal(y, St.mult(t(x))) and torch.equal(y, St.multT(t(x)))
    np.testing.assert_array_equal(St.diag_blocks().numpy(),
                                  np.asarray(Sj.diag_blocks()))
    np.testing.assert_array_equal(St.diagonal().numpy(),
                                  np.asarray(Sj.diagonal()))
    close(St.rows_sum().numpy(), Sj.rows_sum(), 1e-12)
    np.testing.assert_array_equal(St.bvals_strict.numpy(),
                                  np.asarray(Sj.bvals_strict))
    # the strict part's fold equals XLA's scatter on the same
    # contributions (the own-row slots contribute zero blocks)
    contrib = rng.standard_normal((St.bcols.numel(), bs))
    own = (St.bcols == torch.arange(St.brows)[:, None]).reshape(-1).numpy()
    contrib[own] = 0.0
    start = rng.standard_normal((St.brows, bs))
    ref = jnp.asarray(start).at[jnp.asarray(Sj.bcols).reshape(-1)].add(
        jnp.asarray(contrib))
    np.testing.assert_array_equal(
        St.transpose_fold().fold(t(start), t(contrib)).numpy(),
        np.asarray(ref))
    assert St.transpose_fold().ranks <= 4 if case == "ex55" else True


def test_sbaij_rejects_a_nonsymmetric_matrix():
    A = sp.csr_matrix(np.array([[1.0, 2.0], [0.0, 1.0]]))
    with pytest.raises(ValueError, match="symmetric"):
        tsbaij.sbaij_from_scipy(A, device=CPU)


# ----------------------------------------------------------------- COO --
def test_ell_from_coo_merges_duplicates_in_petsctpus_order():
    rng = np.random.default_rng(4)
    m, n, k = 40, 30, 500
    rows = rng.integers(-2, m + 2, k).astype(np.int32)
    cols = rng.integers(-1, n + 1, k).astype(np.int32)
    vals = rng.standard_normal(k) * 10.0 ** rng.integers(-6, 6, k)
    # a run of triples and pairs of one (row, col)
    rows[:9], cols[:9] = 3, 5
    rows[9:11], cols[9:11] = 7, 0
    Aj = jcoo.ell_from_coo(jnp.asarray(rows), jnp.asarray(cols),
                           jnp.asarray(vals), (m, n), 16)
    At = tcoo.ell_from_coo(t(rows), t(cols), t(vals), (m, n), 16)
    np.testing.assert_array_equal(At.cols.numpy(), np.asarray(Aj.cols))
    np.testing.assert_array_equal(At.vals.numpy(), np.asarray(Aj.vals))
    assert At.shape == Aj.shape and At.cols.dtype == torch.int32
    # a width below a row's merged count drops its slots past it
    Aj4 = jcoo.ell_from_coo(jnp.asarray(rows), jnp.asarray(cols),
                            jnp.asarray(vals), (m, n), 4)
    At4 = tcoo.ell_from_coo(t(rows), t(cols), t(vals), (m, n), 4)
    np.testing.assert_array_equal(At4.vals.numpy(), np.asarray(Aj4.vals))


# ---------------------------------------------------------- band / dia --
@pytest.mark.parametrize("nx,ny,tile,perm", [(12, 12, None, False),
                                             (13, 7, 64, True),
                                             (40, 30, None, True)])
def test_band_pack_and_products(nx, ny, tile, perm):
    from petsctpu_torch.mat.order import get_ordering

    A = laplacian_2d(nx, ny)
    n = A.shape[0]
    A = (A + sp.diags(np.linspace(0, 1, n))
         + sp.coo_matrix(([0.25], ([0], [5])), shape=(n, n))).tocsr()
    p = get_ordering(A, "rcm") if perm else None
    Bt = tband.band_from_scipy(A, perm=p, tile=tile, device=CPU)
    Bj = jband.band_from_scipy(A, perm=p, tile=tile)
    np.testing.assert_array_equal(Bt.tiles.numpy(), np.asarray(Bj.tiles))
    assert (Bt.bandwidth, Bt.tile, Bt.shape, Bt.nnz) == \
        (Bj.bandwidth, Bj.tile, Bj.shape, Bj.nnz)
    assert Bt.traffic_per_mult() == Bj.traffic_per_mult()
    x = np.random.default_rng(5).standard_normal(A.shape[0])
    close(Bt.mult(t(x)).numpy(), Bj.mult(jnp.asarray(x)))
    close(Bt.multT(t(x)).numpy(), Bj.multT(jnp.asarray(x)))
    np.testing.assert_array_equal(Bt.diagonal().numpy(),
                                  np.asarray(Bj.diagonal()))
    x32 = x.astype(np.float32)
    B32 = tband.band_from_scipy(A, perm=p, tile=tile, dtype=np.float32,
                                device=CPU)
    close(B32.mult(t(x32)).numpy(), jband.band_from_scipy(
        A, perm=p, tile=tile, dtype=np.float32).mult(jnp.asarray(x32)), 1e-6)


@pytest.mark.parametrize("perm", [False, True])
def test_dia_pack_and_products(perm):
    from petsctpu_torch.mat.order import get_ordering

    A = laplacian_2d(11, 9)
    n = A.shape[0]
    A = (A + sp.diags(np.linspace(0, 1, n - 3), 3)).tocsr()
    p = get_ordering(A, "rcm") if perm else None
    Dt = tdia.dia_from_scipy(A, perm=p, device=CPU)
    Dj = jdia.dia_from_scipy(A, perm=p)
    np.testing.assert_array_equal(Dt.coeffs.numpy(), np.asarray(Dj.coeffs))
    assert Dt.offsets == Dj.offsets and Dt.nnz == Dj.nnz
    assert Dt.traffic_per_mult() == Dj.traffic_per_mult()
    assert tdia.dia_fill(A, p) == jdia.dia_fill(A, p)
    x = np.random.default_rng(6).standard_normal(A.shape[0])
    close(Dt.mult(t(x)).numpy(), Dj.mult(jnp.asarray(x)))
    close(Dt.multT(t(x)).numpy(), Dj.multT(jnp.asarray(x)))
    np.testing.assert_array_equal(Dt.diagonal().numpy(),
                                  np.asarray(Dj.diagonal()))
    close(Dt.rows_sum().numpy(), Dj.rows_sum())
    with pytest.raises(ValueError, match="max_fill"):
        tdia.dia_from_scipy(sp.random(200, 200, density=0.01,
                                      random_state=1), max_fill=2.0,
                            device=CPU)


# ------------------------------------------------- MAIJ, Nest, MatIS ----
def test_maij_products():
    A = laplacian_2d(5, 4)
    Mt = tmaij.MAIJ(tell.aij_from_scipy(A, device=CPU), dof=3)
    Mj = jmaij.MAIJ(jell.aij_from_scipy(A), dof=3)
    x = np.random.default_rng(8).standard_normal(60)
    assert Mt.shape == Mj.shape == (60, 60)
    close(Mt.mult(t(x)).numpy(), Mj.mult(jnp.asarray(x)))
    close(Mt.multT(t(x)).numpy(), Mj.multT(jnp.asarray(x)))
    close(Mt.mult(t(x)).numpy(), sp.kron(A, sp.eye(3)) @ x)
    assert Mt.flops_per_mult() == Mj.flops_per_mult()


def test_nest_products_and_submatrix():
    A = laplacian_2d(4, 4)
    B = sp.random(16, 9, density=0.3, random_state=2, format="csr")
    C = laplacian_2d(3, 3)
    blocks = [[A, B], [B.T.tocsr(), None], [None, C]]
    Nt = tnest.make_nest([[None if b is None else tell.aij_from_scipy(
        b, device=CPU) for b in row] for row in blocks])
    Nj = jnest.make_nest([[None if b is None else jell.aij_from_scipy(b)
                           for b in row] for row in blocks])
    assert Nt.shape == Nj.shape == (34, 25)
    rng = np.random.default_rng(9)
    x, y = rng.standard_normal(25), rng.standard_normal(34)
    close(Nt.mult(t(x)).numpy(), Nj.mult(jnp.asarray(x)))
    close(Nt.multT(t(y)).numpy(), Nj.multT(jnp.asarray(y)))
    np.testing.assert_array_equal(Nt.diagonal().numpy(),
                                  np.asarray(Nj.diagonal()))
    full = sp.bmat(blocks).tocsr()
    close(Nt.mult(t(x)).numpy(), full @ x)
    idx = np.array([3, 1, 7])
    assert abs(tnest.get_submatrix(full, idx) -
               jnest.get_submatrix(full, idx)).max() == 0


def _matis_pair(ncell=16, sub=4):
    Mj = jmatis_poisson_2d(ncell, sub)
    locs = [jell.aij_to_scipy(Ai) for Ai in Mj.locals_]
    Mt = tmatis.matis_from_subdomains(locs, [np.asarray(g) for g in Mj.l2g],
                                      Mj.shape[0], device=CPU)
    return Mt, Mj


def test_matis_products_and_the_ported_builder():
    Mt, Mj = _matis_pair()
    x = np.random.default_rng(10).standard_normal(Mt.shape[0])
    close(Mt.mult(t(x)).numpy(), Mj.mult(jnp.asarray(x)))
    close(Mt.multT(t(x)).numpy(), Mj.multT(jnp.asarray(x)))
    close(Mt.diagonal().numpy(), Mj.diagonal())
    assert abs(Mt.assemble_host() - Mj.assemble_host()).max() <= 1e-14
    assert Mt.flops_per_mult() == Mj.flops_per_mult()
    # models/ddpoisson.py builds the same MatIS without petsctpu
    P = matis_poisson_2d(16, 4, device=CPU)
    assert abs(P.assemble_host() - Mj.assemble_host()).max() <= 1e-14
    for a, b in zip(P.l2g, Mj.l2g):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))


@pytest.mark.parametrize("kind", ["nn", "nn_unbalanced", "bddc",
                                  "bddc_edges_only"])
def test_nn_and_bddc_applies_and_solves(kind):
    Mt, Mj = _matis_pair()
    if kind.startswith("nn"):
        bal = kind == "nn"
        pc, jpc = make_nn(Mt, balanced=bal), jmake_nn(Mj, balanced=bal)
    else:
        v = kind == "bddc"
        pc, jpc = make_bddc(Mt, vertices=v), jmake_bddc(Mj, vertices=v)
    r = np.random.default_rng(11).standard_normal(Mt.shape[0])
    close(pc.apply(t(r)).numpy(), jpc.apply(jnp.asarray(r)), 1e-10)
    b = Mt.assemble_host() @ np.random.default_rng(12).standard_normal(
        Mt.shape[0])
    rt = ksp_solve(Mt, t(b), pc=pc, ksp_type="fgmres", rtol=1e-8,
                   maxits=200)
    rj = jksp_solve(Mj, jnp.asarray(b), pc=jpc, ksp_type="fgmres",
                    rtol=1e-8, maxits=200)
    assert int(rt.its) == int(rj.its) and int(rt.reason) == int(rj.reason)
    close(rt.history[:int(rt.its) + 1].numpy(),
          np.asarray(rj.history[:int(rj.its) + 1]), 1e-8)


def test_nn_and_bddc_through_make_pc():
    Mt, Mj = _matis_pair(8, 2)
    r = np.random.default_rng(13).standard_normal(Mt.shape[0])
    for name, o in (("nn", {}), ("bddc", {"pc_bddc_use_edges": "false"})):
        pc = make_pc(name, A=Mt, options=Options(o))
        jpc = jmake_pc(name, A=Mj, options=JOptions(o))
        close(pc.apply(t(r)).numpy(), jpc.apply(jnp.asarray(r)), 1e-10)
    with pytest.raises(ValueError, match="MatIS"):
        make_pc("bddc", A=tell.aij_from_scipy(laplacian_2d(3, 3),
                                              device=CPU))


# ----------------------------------------------------------------- FFT --
def test_fftmat_and_dst():
    rng = np.random.default_rng(14)
    F, Fj = tfft.FFTMat((6, 8)), jfft.FFTMat((6, 8))
    x = rng.standard_normal(48).astype(np.float32)
    y = F.mult(t(x))
    assert y.dtype == torch.complex64 and F.shape == Fj.shape
    close(y.numpy(), Fj.mult(jnp.asarray(x)), 1e-5)
    close(F.multT(t(x)).numpy(), Fj.multT(jnp.asarray(x)), 1e-5)
    z = (rng.standard_normal(48) + 1j * rng.standard_normal(48))
    close(F.mult_hermitian(t(z)).numpy(), Fj.mult_hermitian(jnp.asarray(z)))
    close(F.solve(t(z)).numpy(), Fj.solve(jnp.asarray(z)))
    v = rng.standard_normal((5, 9))
    for ax in (0, 1):
        close(tfft.dst1(t(v), axis=ax).numpy(), jfft.dst1(jnp.asarray(v),
                                                          axis=ax), 1e-12)


@pytest.mark.parametrize("dims,dtype", [((12, 12), np.float64),
                                        ((6, 5, 7), np.float64),
                                        ((16, 16), np.float32)])
def test_poisson_fft_pc(dims, dtype):
    pc = tfft.make_poisson_fft(dims, dtype=dtype, scale=2.0, shift=0.5,
                               device=CPU)
    jpc = jfft.make_poisson_fft(dims, dtype=dtype, scale=2.0, shift=0.5)
    np.testing.assert_array_equal(pc.inv_eig.numpy(), np.asarray(jpc.inv_eig))
    b = np.random.default_rng(15).standard_normal(int(np.prod(dims))) \
        .astype(dtype)
    close(pc.apply(t(b)).numpy(), jpc.apply(jnp.asarray(b)),
          1e-12 if dtype == np.float64 else 2e-5)


def test_fft_pc_solves_the_dirichlet_laplacian_through_make_pc():
    m = 16
    A = laplacian_2d(m, m)
    Ad = tell.aij_from_scipy(A, device=CPU)
    o = {"pc_fft_dims": (m, m)}
    pc = make_pc("fft", A=Ad, A_host=A, options=Options(o))
    x = pc.apply(t(np.ones(m * m))).numpy()
    close(A @ x, np.ones(m * m), 1e-10)
    res = ksp_solve(Ad, t(np.ones(m * m)), pc=pc, ksp_type="gmres",
                    rtol=1e-10, maxits=5)
    jA = jell.aij_from_scipy(A)
    jres = jksp_solve(jA, jnp.asarray(np.ones(m * m)), pc=jmake_pc(
        "fft", A=jA, A_host=A, options=JOptions(o)), ksp_type="gmres",
        rtol=1e-10, maxits=5)
    assert int(res.its) == int(jres.its) <= 2
    with pytest.raises(ValueError, match="pc_fft_dims"):
        make_pc("fft", A=Ad)


# ------------------------------------------------------ factory, convert --
@pytest.mark.parametrize("mat_type", ["aij", "baij", "sbaij", "dense", "band",
                                      "dia"])
def test_mat_from_options_every_format(mat_type):
    A, _, _ = ex55_system(5, 1e-3)
    o = {"mat_type": mat_type, "mat_block_size": "2"}
    Mt, pt = mat_from_options(A, Options(o), device=CPU)
    Mj, pj = jmat_from_options(A, JOptions(o))
    assert type(Mt).__name__ == type(Mj).__name__
    assert (pt is None) == (pj is None)
    if pt is not None:
        np.testing.assert_array_equal(pt, np.asarray(pj))
    x = np.random.default_rng(16).standard_normal(A.shape[0])
    close(Mt.mult(t(x)).numpy(), Mj.mult(jnp.asarray(x)), 1e-12)
    if mat_type in ("baij", "sbaij"):
        assert Mt.bs == 2


def test_convert_carries_the_formats_across():
    A, _, _ = ex55_system(5, 1e-3)
    x = np.random.default_rng(17).standard_normal(A.shape[0])
    Bj = jbsr.baij_from_scipy_bsr(A, bs=2)
    Sj = jsbaij.sbaij_from_scipy(A, bs=2)
    Nj = jband.band_from_scipy(A)
    Dj = jdia.dia_from_scipy(A)
    pairs = (
        (convert.baij_from_arrays(np.asarray(Bj.cols), np.asarray(Bj.vals),
                                  Bj.shape, Bj.bs, Bj.nnz, device=CPU), Bj),
        (convert.sbaij_from_arrays(np.asarray(Sj.bcols),
                                   np.asarray(Sj.bvals), Sj.shape, Sj.bs,
                                   Sj.nnzb, device=CPU), Sj),
        (convert.band_from_arrays(np.asarray(Nj.tiles), Nj.bandwidth,
                                  Nj.tile, Nj.shape, Nj.nnz, device=CPU), Nj),
        (convert.dia_from_arrays(np.asarray(Dj.coeffs), Dj.offsets,
                                 Dj.shape, Dj.nnz, device=CPU), Dj))
    for Mt, Mj in pairs:
        close(Mt.mult(t(x)).numpy(), Mj.mult(jnp.asarray(x)))
        close(Mt.multT(t(x)).numpy(), Mj.multT(jnp.asarray(x)))
