"""The port's blocked SBAIJ Cholesky / IC(k) (mat/sbaijfact.py) against
petsctpu's, on the CPU.

* The factor's scalar expansion: Wstrict's pattern (indptr, indices and
  their dtypes) byte for byte, its values and d within 1e-13 relative, at
  bs 1-4 and levels 0, 1, 2 and None (full fill), on a block-tridiagonal
  matrix (petsctpu's own test matrix) and a block 5-point grid (fill at
  every level).
* The C++ block recurrence against the port's plain Python copy of it
  (within 1e-14); bs 1 against the port's scalar ICC (1e-13).
* CG + blocked IC(k) on ksp ex55 at ne = 15: equal its and reason, the
  history within 1e-10 relative, tri "level" and "band".
* convert.sbaij_cholesky_from_arrays: the port's apply over petsctpu's
  factor against petsctpu's apply (1e-12).
"""

import os
import pathlib
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse as sp
import torch

from petsctpu.ksp import ksp_solve as r_ksp_solve
from petsctpu.mat import aij_from_scipy as r_aij_from_scipy
from petsctpu.mat import sbaijfact as rsf
from petsctpu.models.elasticity import ex55_system as r_ex55_system
from petsctpu_torch import convert
from petsctpu_torch.ksp import ksp_solve
from petsctpu_torch.mat import aij_from_scipy
from petsctpu_torch.mat import host_factor
from petsctpu_torch.mat import sbaijfact as tsf
from petsctpu_torch.mat.factor import icc_factor
from petsctpu_torch.models.elasticity import ex55_system

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent))
from test_sbaijfact import block_spd  # noqa: E402
from test_torch_refnative import ensure_reference_native  # noqa: E402

torch.set_num_threads(1)
# petsctpu's factor takes its native C++ route, of which the port's is a
# copy; its Python fallback inverts the pivots otherwise
ensure_reference_native()

LEVELS = (0, 1, 2, None)


def block_grid(nx=6, ny=5, bs=2, seed=0):
    """An SPD matrix of bs×bs dense blocks on a 5-point grid graph of
    nodes: the IC(k) pattern of its block graph fills at every level."""
    rng = np.random.default_rng(seed)
    nb = nx * ny
    rows, cols, vals = [], [], []
    for i in range(ny):
        for j in range(nx):
            k = i * nx + j
            for di, dj in ((0, 1), (1, 0)):
                if i + di < ny and j + dj < nx:
                    m = (i + di) * nx + j + dj
                    B = rng.standard_normal((bs, bs))
                    for a in range(bs):
                        for b in range(bs):
                            rows += [k * bs + a, m * bs + b]
                            cols += [m * bs + b, k * bs + a]
                            vals += [B[a, b], B[a, b]]
    A = sp.csr_matrix((vals, (rows, cols)), shape=(nb * bs, nb * bs))
    D = rng.standard_normal((nb, bs, bs))
    D = np.einsum("kab,kcb->kac", D, D)
    A = A + sp.block_diag(list(D)).tocsr()
    A = A + sp.diags(np.abs(A).sum(axis=1).A1 + 1.0)
    return sp.csr_matrix(A)


MATRICES = {"tridiag": lambda bs: block_spd(30, bs, seed=bs),
            "grid": lambda bs: block_grid(6, 5, bs, seed=bs)}


def assert_factor_equal(W, d, Wr, dr):
    for f in ("indptr", "indices"):
        a, b = getattr(W, f), getattr(Wr, f)
        assert a.dtype == b.dtype, f
        np.testing.assert_array_equal(a, b, err_msg=f)
    assert W.shape == Wr.shape and W.data.dtype == Wr.data.dtype
    np.testing.assert_allclose(W.data, Wr.data, rtol=1e-13,
                               atol=1e-13 * np.abs(Wr.data).max())
    np.testing.assert_allclose(d, dr, rtol=1e-13)


@pytest.mark.parametrize("levels", LEVELS)
@pytest.mark.parametrize("bs", (1, 2, 3, 4))
@pytest.mark.parametrize("kind", sorted(MATRICES))
def test_factor_equals_reference(kind, bs, levels):
    """Wstrict's pattern byte for byte, values and d within 1e-13."""
    A = MATRICES[kind](bs)
    W, d = tsf.sbaij_cholesky_factor(A, bs, levels=levels)
    Wr, dr = rsf.sbaij_cholesky_factor(A, bs, levels=levels)
    assert_factor_equal(W, d, Wr, dr)


@pytest.mark.parametrize("levels", (0, None))
@pytest.mark.parametrize("bs", (2, 3))
def test_native_udu_equals_plain(bs, levels):
    """csrc/host_factor.cpp::sbaij_block_udu against its plain copy
    (sbaij_block_udu_plain), with a shift: within 1e-14."""
    A = block_grid(5, 4, bs, seed=10 + bs)
    ai, aj, av, ui, uj = tsf.block_pattern(A, bs, levels)
    uv, dv = host_factor.sbaij_block_udu(ai, aj, av, ui, uj, bs, 0.25)
    up, dp = tsf.sbaij_block_udu_plain(ai, aj, av, ui, uj, bs, 0.25)
    np.testing.assert_allclose(uv, up, rtol=1e-14, atol=1e-14)
    np.testing.assert_allclose(dv, dp, rtol=1e-14)


def test_bs1_matches_scalar_icc():
    """bs 1 blocked IC(0) is the port's scalar ICC(0) (no shift)."""
    A = block_grid(7, 6, 1, seed=8)
    W, d = tsf.sbaij_cholesky_factor(A, 1, levels=0)
    Us, ds, _, _ = icc_factor(A, shift_type="none")
    np.testing.assert_allclose(d, ds, rtol=1e-13)
    np.testing.assert_allclose(W.toarray(), sp.csr_matrix(Us).toarray(),
                               rtol=1e-12, atol=1e-15)


def test_dense_udu_matches_reference_and_raises_on_zero_pivot():
    rng = np.random.default_rng(1)
    B = rng.standard_normal((5, 4, 4))
    D = np.einsum("kab,kcb->kac", B, B) + 4 * np.eye(4)
    u, d = tsf.dense_udu(D)
    for k in range(5):
        ur, dr = rsf._dense_udu(D[k])
        np.testing.assert_array_equal(u[k], ur)
        np.testing.assert_array_equal(d[k], dr)
    D[3, 1, 1] = 0.0
    D[3, 0] = D[3, :, 0] = 0.0
    D[3, 0, 0] = 0.0
    with pytest.raises(ZeroDivisionError):
        rsf._dense_udu(D[3])
    with pytest.raises(ZeroDivisionError):
        tsf.dense_udu(D)


def test_full_fill_is_exact():
    """levels None: an exact blocked Cholesky, one apply solves A x = b."""
    A = block_grid(6, 6, 3, seed=2)
    pc = tsf.make_sbaij_cholesky(A, 3, levels=None, device="cpu")
    xex = np.random.default_rng(2).standard_normal(A.shape[0])
    x = pc.apply(torch.from_numpy(A @ xex)).numpy()
    np.testing.assert_allclose(x, xex, rtol=1e-9, atol=1e-9)


@pytest.mark.parametrize("levels,tri", ((0, "level"), (1, "level"),
                                        (None, "level"), (0, "band")))
def test_cg_stream_equals_reference_on_ex55(levels, tri):
    """ksp ex55 at ne = 15 (512 dofs, bs 2), CG + blocked IC(levels):
    equal its and reason, the history within 1e-10 relative."""
    A, b, _ = ex55_system(15, 1e-3)
    Ar, br, _ = r_ex55_system(15, 1e-3)
    np.testing.assert_array_equal(sp.csr_matrix(A).toarray(),
                                  sp.csr_matrix(Ar).toarray())
    r = r_ksp_solve(r_aij_from_scipy(Ar, dtype=np.float64),
                    jnp.asarray(br),
                    pc=rsf.make_sbaij_cholesky(Ar, bs=2, levels=levels,
                                               tri=tri),
                    ksp_type="cg", rtol=1e-10, maxits=500)
    t = ksp_solve(aij_from_scipy(A, dtype=np.float64, device="cpu"),
                  torch.from_numpy(b),
                  pc=tsf.make_sbaij_cholesky(A, 2, levels=levels, tri=tri,
                                             device="cpu"),
                  ksp_type="cg", rtol=1e-10, maxits=500)
    its = int(r.its)
    assert (int(t.its), int(t.reason)) == (its, int(r.reason))
    assert int(t.reason) > 0
    hr = np.asarray(r.history[:its + 1])
    np.testing.assert_allclose(t.history[:its + 1].numpy(), hr, rtol=1e-10,
                               atol=1e-10 * hr[0])


@pytest.mark.parametrize("tri", ("level", "band"))
def test_apply_from_reference_factor(tri):
    """convert.sbaij_cholesky_from_arrays over petsctpu's (Wstrict, d):
    the port's apply equals petsctpu's apply on the same factor."""
    A = block_grid(8, 7, 2, seed=3)
    W, d = rsf.sbaij_cholesky_factor(A, 2, levels=1)
    pc = convert.sbaij_cholesky_from_arrays(W, d, np.float64, tri, "cpu")
    pr = rsf.make_sbaij_cholesky(A, bs=2, levels=1, tri=tri)
    r = np.random.default_rng(4).standard_normal(A.shape[0])
    z = pc.apply(torch.from_numpy(r)).numpy()
    zr = np.asarray(pr.apply(jnp.asarray(r)))
    np.testing.assert_allclose(z, zr, rtol=1e-12, atol=1e-12 * np.abs(zr).max())


def _datafile():
    """PETSc's spd-real-int32-float64 datafile, under PETSC_DIR (a PETSc
    source tree) where one is given and holds it."""
    root = os.environ.get("PETSC_DIR")
    path = root and os.path.join(root, "share", "petsc", "datafiles",
                                 "matrices", "spd-real-int32-float64")
    return path if path and os.path.exists(path) else None


@pytest.mark.parametrize("k", (0, 2, 4))
def test_datafile_sbaij_stream_equals_reference(k):
    """runex10_19's matrix (where PETSc's datafiles are at hand): the
    port's CG + SBAIJ IC(k) stream (bs 1) equals petsctpu's SBAIJ
    stream. petsctpu's own test of the same file holds AIJ-ICC(k)
    against SBAIJ inside petsctpu; the port does not copy that."""
    path = _datafile()
    if path is None:
        pytest.skip("PETSc's datafiles are not at hand (PETSC_DIR)")
    from petsctpu_torch.io.viewer import petsc_binary_read_mat

    A = sp.csr_matrix(petsc_binary_read_mat(path, complex_scalars=False))
    b = np.ones(A.shape[0])
    r = r_ksp_solve(r_aij_from_scipy(A, dtype=np.float64), jnp.asarray(b),
                    pc=rsf.make_sbaij_cholesky(A, bs=1, levels=k),
                    ksp_type="cg", rtol=1e-8, maxits=200)
    t = ksp_solve(aij_from_scipy(A, dtype=np.float64, device="cpu"),
                  torch.from_numpy(b),
                  pc=tsf.make_sbaij_cholesky(A, 1, levels=k, device="cpu"),
                  ksp_type="cg", rtol=1e-8, maxits=200)
    its = int(r.its)
    assert int(t.its) == its
    hr = np.asarray(r.history[:its + 1])
    np.testing.assert_allclose(t.history[:its + 1].numpy(), hr, rtol=1e-10,
                               atol=1e-10 * hr[0])
