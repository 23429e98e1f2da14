"""The port's operator wrappers and host helpers (mat/base.py), the
pointwise vector ops and aij_from_dense against petsctpu's, on the CPU.

* Each wrapper's products (mult, multT, diagonal, apply where it has
  them) through both packages on the same operands, fp64, within 1e-13
  relative; ScatterMat.multT (a scatter-add folded through mat/fold.py)
  bit for bit, and BlockMat over both packages' AIJ blocks.
* mat_axpy's three structures: the result's indptr, indices and data
  (and their dtypes) byte for byte, explicit zeros of the union pattern
  kept; ksp ex53's stale-LU solve and ex58's GMRES + Jacobi on the sums.
* LocalRef's forwarded adds, aij_from_dense's pack byte for byte,
  pointwise_mult/divide bit for bit.
"""

import pathlib
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse as sp
import torch

from petsctpu.mat import base as rbase
from petsctpu.mat import aij_from_dense as r_aij_from_dense
from petsctpu.mat import aij_from_scipy as r_aij
from petsctpu.mat.dense import Dense as RDense
from petsctpu.vec import ops as rops
from petsctpu_torch.ksp import ksp_solve
from petsctpu_torch.mat import base as tbase
from petsctpu_torch.mat import aij_from_dense, aij_from_scipy
from petsctpu_torch.mat.dense import Dense
from petsctpu_torch.pc.factor import make_lu
from petsctpu_torch.pc.simple import make_jacobi
from petsctpu_torch.vec import ops as tops

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent))
from test_axpy_transpose import (GOLDEN_58, ex53_matrix,  # noqa: E402
                                 ex58_matrices)
from test_mat import random_csr  # noqa: E402

torch.set_num_threads(1)

A12 = random_csr(12, 12, density=0.4, seed=8)
R12 = random_csr(12, 7, density=0.4, seed=5)
X12 = np.random.default_rng(9).standard_normal(12)
X7 = np.random.default_rng(10).standard_normal(7)
U = np.random.default_rng(10).standard_normal((12, 2))
C = np.random.default_rng(11).standard_normal((2, 2))
V = np.random.default_rng(12).standard_normal((12, 2))
M8 = np.random.default_rng(11).standard_normal((12, 12))
D12 = np.random.default_rng(13).standard_normal(12) + 3.0
IDX = np.array([3, 0, 2, 2, 1, 6, 0, 5, 4])


def _t(a):
    return torch.from_numpy(np.array(a))


def _ops(pkg):
    """The operands of every case in one package: (aij, dense, vector
    maker)."""
    if pkg == "ref":
        return (lambda A: r_aij(A, dtype=np.float64), lambda M: RDense(
            jnp.asarray(M)), jnp.asarray)
    return (lambda A: aij_from_scipy(A, dtype=np.float64, device="cpu"),
            lambda M: Dense(_t(M)), _t)


def build(name, pkg):
    """(operator, [(method, argument)]) of case `name` in one package."""
    b = rbase if pkg == "ref" else tbase
    aij, dense, vec = _ops(pkg)
    A, R = aij(A12), aij(R12)
    x, x7 = vec(X12), vec(X7)
    if name == "transpose":
        return b.Transpose(R), [("mult", x), ("multT", x7)]
    if name == "normal":
        return b.Normal(R), [("mult", x7)]
    if name == "normal_hermitian":
        return b.NormalHermitian(R), [("mult", x), ("multT", x)]
    if name == "shift_scale":
        return b.ShiftScale(A, 2.0, -1.5), [("mult", x), ("multT", x),
                                             ("diagonal", None)]
    if name == "composite_additive":
        return b.Composite((A, b.Diagonal(vec(D12)), dense(M8)),
                           "additive"), [("mult", x)]
    if name == "composite_multiplicative":
        return b.Composite((dense(M8), A, R), "multiplicative"), [
            ("mult", x7)]
    if name == "lrc":
        return b.LRC(A, vec(U), vec(C), vec(V)), [("mult", x)]
    if name == "shell":
        return b.Shell(A, lambda ctx, v: ctx.mult(v) * 2.0, (12, 12)), [
            ("mult", x)]
    if name == "diagonal":
        return b.Diagonal(vec(D12)), [("mult", x), ("multT", x),
                                      ("diagonal", None)]
    if name == "identity":
        return b.Identity((12, 12)), [("mult", x), ("apply", x)]
    if name == "scatter":
        idx = (jnp.asarray(IDX, jnp.int32) if pkg == "ref"
               else IDX)
        S = (b.ScatterMat(idx, (9, 7)) if pkg == "ref"
             else b.ScatterMat(idx, (9, 7), device="cpu"))
        y = vec(np.arange(9.0) + 1.5)
        return S, [("mult", x7), ("multT", y), ("diagonal", None)]
    if name == "block":
        A00 = aij(random_csr(5, 5, density=0.8, seed=1))
        A01 = aij(random_csr(5, 7, density=0.6, seed=2))
        A10 = aij(random_csr(12, 5, density=0.5, seed=3))
        B = b.block_mat({(1, 1): R, (0, 1): A01, (0, 0): A00,
                         (1, 0): A10}, [5, 12], [5, 7])
        return B, [("mult", x), ("multT", vec(np.concatenate(
            [X7[:5], X12])))]
    if name == "block_square":
        A00 = aij(random_csr(5, 5, density=0.8, seed=1))
        A01 = aij(random_csr(5, 12, density=0.4, seed=2))
        B = b.block_mat({(1, 1): A, (0, 0): A00, (0, 1): A01}, [5, 12],
                        [5, 12])
        z = vec(np.concatenate([X7[:5], X12]))
        return B, [("mult", z), ("multT", z), ("diagonal", None)]
    raise KeyError(name)


CASES = ("transpose", "normal", "normal_hermitian", "shift_scale",
         "composite_additive", "composite_multiplicative", "lrc", "shell",
         "diagonal", "identity", "scatter", "block", "block_square")


@pytest.mark.parametrize("name", CASES)
def test_wrapper_products_equal_reference(name):
    """Every product of the wrapper through both packages: fp64 within
    1e-13 relative; ScatterMat's products bit for bit."""
    R, rcalls = build(name, "ref")
    T, tcalls = build(name, "port")
    assert tuple(T.shape) == tuple(R.shape)
    for (meth, ra), (_, ta) in zip(rcalls, tcalls):
        r = np.asarray(getattr(R, meth)() if ra is None
                       else getattr(R, meth)(ra))
        t = (getattr(T, meth)() if ta is None else getattr(T, meth)(ta))
        t = t.numpy()
        assert t.shape == r.shape, (meth, t.shape, r.shape)
        if name == "scatter":
            np.testing.assert_array_equal(t, r, err_msg=meth)
        else:
            np.testing.assert_allclose(t, r, rtol=1e-13,
                                       atol=1e-13 * np.abs(r).max(),
                                       err_msg=meth)


def test_scatter_multT_two_calls_bit_equal():
    """ScatterMat.multT folds in slot order: repeat calls give the same
    bits (on the card the fold replaces atomics)."""
    S = tbase.ScatterMat(IDX, (9, 7), device="cpu")
    y = _t(np.random.default_rng(1).standard_normal(9))
    assert torch.equal(S.multT(y), S.multT(y))
    Sd = np.zeros((9, 7))
    Sd[np.arange(9), IDX] = 1.0
    np.testing.assert_allclose(S.multT(y).numpy(), Sd.T @ y.numpy(),
                               rtol=1e-15)


def test_normal_hermitian_has_no_conjugate():
    """petsctpu's NormalHermitian is A·Aᵀ without a conjugate, kept as
    it is: on a complex A the port gives A(Aᵀx), as petsctpu does."""
    rng = np.random.default_rng(3)
    M = rng.standard_normal((6, 4)) + 1j * rng.standard_normal((6, 4))
    x = rng.standard_normal(6) + 1j * rng.standard_normal(6)
    t = tbase.NormalHermitian(Dense(_t(M))).mult(_t(x)).numpy()
    r = np.asarray(rbase.NormalHermitian(RDense(jnp.asarray(M))).mult(
        jnp.asarray(x)))
    np.testing.assert_allclose(t, r, rtol=1e-13)
    np.testing.assert_allclose(t, M @ (M.T @ x), rtol=1e-13)


def assert_csr_equal(a, b):
    for f in ("indptr", "indices", "data"):
        u, v = getattr(a, f), getattr(b, f)
        assert u.dtype == v.dtype, f
        np.testing.assert_array_equal(u, v, err_msg=f)
    assert a.shape == b.shape


def _axpy_cases():
    A53 = ex53_matrix(10)
    E = sp.csr_matrix(([1.e-2], ([0], [9])), shape=(10, 10))
    A58, B58 = ex58_matrices()
    Y = random_csr(15, 15, density=0.3, seed=4)
    X = random_csr(15, 15, density=0.3, seed=6)
    Xsub = Y.copy()
    Xsub.data = np.where(np.arange(Y.nnz) % 3 == 0, -Y.data / 2.0,
                         np.arange(Y.nnz) * 0.25)
    Yz = Y.copy()
    Yz.data[::4] = 0.0                           # explicit zeros of Y
    return {"ex53_same": (A53, 1.0, E, "same"),
            "ex58_different": (A58, 2.0, B58, "different"),
            "random_different": (Y, -0.75, X, "different"),
            "cancel_different": (Y, -1.0, Y, "different"),
            "zeros_different": (Yz, 1.5, X, "different"),
            "cancel_same": (Y, 2.0, Xsub, "same"),
            "random_subset": (Y, 0.5, Xsub, "subset")}


AXPY = _axpy_cases()


@pytest.mark.parametrize("name", sorted(AXPY))
def test_mat_axpy_equals_reference(name):
    """The sum's CSR arrays byte for byte, in all three structures."""
    Y, a, X, structure = AXPY[name]
    assert_csr_equal(tbase.mat_axpy(Y, a, X, structure),
                     rbase.mat_axpy(Y, a, X, structure))


def test_ex58_union_pattern_solve():
    """ksp ex58: C = A + 2B with the union pattern (its cancelled
    diagonal stored), GMRES + Jacobi through the port: 19 its on the
    golden stream, error 0.181393."""
    A, B = ex58_matrices()
    Cm = tbase.mat_axpy(A, 2.0, B, "different")
    d = Cm.diagonal()
    assert d[13] == 6.0 and np.all(np.delete(d, 13) == 0.0)
    for i in range(20):
        assert i in Cm[i].indices
    u = np.ones(20)
    Ad = aij_from_scipy(Cm, dtype=np.float64, device="cpu")
    r = ksp_solve(Ad, torch.from_numpy(Cm @ u), pc=make_jacobi(Ad),
                  ksp_type="gmres", rtol=1e-5, atol=1e-50)
    assert int(r.its) == 19
    np.testing.assert_allclose(r.history[:20].numpy(), GOLDEN_58, rtol=2e-5)
    np.testing.assert_allclose(np.linalg.norm(r.x.numpy() - u), 0.181393,
                               rtol=1e-4)


def test_ex53_stale_lu_on_axpy_same():
    """ksp ex53's third solve: the rank-1 change by mat_axpy("same"),
    GMRES with the stale LU of A: 2 its, x within 1e-14."""
    n = 10
    A = ex53_matrix(n)
    u = np.ones(n)
    A2 = tbase.mat_axpy(A, 1.0, sp.csr_matrix(([1.e-2], ([0], [n - 1])),
                                              shape=(n, n)), "same")
    r = ksp_solve(aij_from_scipy(A2, device="cpu"),
                  torch.from_numpy(A2 @ u), pc=make_lu(A, device="cpu"),
                  ksp_type="gmres", rtol=1e-5, atol=1e-50,
                  cgs_refine="always")
    assert int(r.its) == 2
    assert np.linalg.norm(r.x.numpy() - u) < 1e-14
    np.testing.assert_allclose(r.history[:2].numpy(),
                               [3.177411413277, 7.830060686403e-03],
                               rtol=1e-9)


class _COOBuilder:
    def __init__(self):
        self.r, self.c, self.v = [], [], []

    def add(self, rows, cols, vals):
        self.r += list(np.atleast_1d(rows))
        self.c += list(np.atleast_1d(cols))
        self.v += list(np.atleast_1d(vals))


@pytest.mark.parametrize("cmap", (None, [1, 3, 5, 8]))
def test_local_ref_equals_reference(cmap):
    """MatSetValuesLocal through a LocalRef: the parent's stream of
    global adds equals petsctpu's."""
    streams = []
    for mod in (tbase, rbase):
        parent = _COOBuilder()
        sub = mod.LocalRef(parent, rmap=[4, 7, 9, 2], cmap=cmap)
        sub.add_values([0, 1, 2, 3], [2, 0, 1, 3], [1.0, 2.0, 3.0, 4.0])
        sub.add_values(np.array([3]), np.array([0]), np.array([5.0]))
        streams.append((parent.r, parent.c, parent.v, sub.shape))
    assert streams[0] == streams[1]


@pytest.mark.parametrize("tol", (0.0, 0.5))
def test_aij_from_dense_pack_equals_reference(tol):
    M = np.random.default_rng(5).standard_normal((9, 11))
    M[np.abs(M) < 0.3] = 0.0
    t = aij_from_dense(M, tol=tol, dtype=np.float64, device="cpu")
    r = r_aij_from_dense(M, tol=tol, dtype=np.float64)
    np.testing.assert_array_equal(t.cols.numpy(), np.asarray(r.cols))
    np.testing.assert_array_equal(t.vals.numpy(), np.asarray(r.vals))
    assert (t.shape, t.nnz) == (tuple(r.shape), int(r.nnz))


@pytest.mark.parametrize("op", ("pointwise_mult", "pointwise_divide"))
def test_pointwise_ops_equal_reference(op):
    rng = np.random.default_rng(6)
    x, y = rng.standard_normal(50), rng.standard_normal(50) + 2.0
    np.testing.assert_array_equal(
        getattr(tops, op)(_t(x), _t(y)).numpy(),
        np.asarray(getattr(rops, op)(jnp.asarray(x), jnp.asarray(y))))


def _extra_case(name, pkg):
    """tests/test_mat_extra.py's cases through one package's `mat`
    re-exports: a list of numpy results."""
    import petsctpu.mat as rmat
    import petsctpu_torch.mat as tmat
    from petsctpu.models import ex2_system, laplacian_2d

    m = rmat if pkg == "ref" else tmat
    kw = {} if pkg == "ref" else {"device": "cpu"}
    vec = jnp.asarray if pkg == "ref" else _t
    host = lambda v: np.asarray(v)
    A, _, _ = ex2_system(4, 4)
    if name == "maij":
        M = m.MAIJ(m.aij_from_scipy(A, **kw), dof=3)
        x = vec(np.random.default_rng(2).standard_normal(48))
        return [host(M.mult(x)), host(M.multT(x))]
    if name == "matis":
        loc = sp.csr_matrix(np.array([[1.0, -1.0, 0.0], [-1.0, 2.0, -1.0],
                                      [0.0, -1.0, 1.0]]))
        M = m.matis_from_subdomains([loc, loc], [[0, 1, 2], [2, 3, 4]], 5,
                                    **kw)
        x = vec(np.random.default_rng(4).standard_normal(5))
        return [host(M.mult(x)), host(M.diagonal()),
                M.assemble_host().toarray()]
    if name == "sbaij":
        S = m.sbaij_from_scipy(A, bs=1, **kw)
        x = vec(np.random.default_rng(0).standard_normal(16))
        return [host(S.mult(x)), host(S.diagonal()), host(S.rows_sum()),
                np.asarray(S.nnzb)]
    if name == "partition":
        perm = np.random.default_rng(5).permutation(144)
        L = laplacian_2d(12, 12).tocsr()[perm][:, perm]
        part = m.partition_rcm(L, 4)
        xs, ys = np.meshgrid(np.arange(8), np.arange(8), indexing="ij")
        coords = np.stack([xs.ravel(), ys.ravel()], axis=1)
        mp = m.MatPartitioning().set_adjacency(laplacian_2d(6, 6)) \
            .set_n_parts(3)
        p3 = mp.apply()
        return [part, np.asarray(m.edge_cut(L, part)),
                m.partition_rcb(coords, 4), p3, mp.counts(p3)]
    raise KeyError(name)


@pytest.mark.parametrize("name", ("maij", "matis", "sbaij", "partition"))
def test_mat_extra_cases_through_reexports(name):
    """tests/test_mat_extra.py's MAIJ, MatIS, SBAIJ and partitioning
    cases through `petsctpu_torch.mat`'s re-exported names against
    `petsctpu.mat`'s: products within 1e-13, partitions equal."""
    for t, r in zip(_extra_case(name, "port"), _extra_case(name, "ref")):
        if np.issubdtype(np.asarray(r).dtype, np.integer):
            np.testing.assert_array_equal(t, r)
        else:
            np.testing.assert_allclose(t, r, rtol=1e-13,
                                       atol=1e-13 * np.abs(r).max())
