"""The ELL SpMV of AIJ.mult (petsctpu_torch/ops/ell_spmv.py) on the CPU.

The plain version is held bit for bit to a slot-order loop (each row
folded over its slots from +0.0, the kernel's and MatMult_SeqAIJ's
order), and to scipy within 1e-13 relative (another summation order);
AIJ.mult goes through it. A CUDA tensor never reaches the plain
version: the wrapper launches the kernel or raises (with no kernel
built here, the build raises). The launch tile is checked for the
shared-memory budget and the odd row stride. The kernel itself is held
to the plain version on the card by chip_smoke.py.
"""

import numpy as np
import pytest
import scipy.sparse as sp
import torch

from petsctpu_torch.mat import aij_from_scipy
from petsctpu_torch.ops import _build
from petsctpu_torch.ops import ell_spmv as ell


class _OnCard(torch.Tensor):
    """A CPU tensor that reports CUDA device 0 (the wrapper's CUDA path)."""

    @property
    def is_cuda(self):
        return True

    def get_device(self):
        return 0


def _slot_loop(cols, vals, x):
    m, K = cols.shape
    y = np.zeros(m, dtype=np.result_type(vals, x))
    for i in range(m):
        s = y.dtype.type(0.0)
        for k in range(K):
            s = s + vals[i, k] * x[cols[i, k]]
        y[i] = s
    return y


CASES = [
    # (m, n, density, dtype, min_width): square, rectangular both ways,
    # an all-padding row, K = 1, fp32
    (40, 40, 0.15, np.float64, 1),
    (37, 90, 0.08, np.float64, 1),
    (90, 23, 0.2, np.float32, 1),
    (30, 30, 0.0, np.float64, 1),
    (25, 60, 0.1, np.float64, 40),
]


@pytest.mark.parametrize("m,n,density,dtype,min_width", CASES)
def test_plain_matches_slot_loop_and_scipy(m, n, density, dtype, min_width):
    A = sp.random(m, n, density=density, random_state=m + n, format="csr",
                  dtype=dtype)
    if density == 0.0:
        A = sp.eye(m, n, format="csr", dtype=dtype)
    A = sp.lil_matrix(A)
    A[m // 2, :] = 0                                # an all-padding row
    A = sp.csr_matrix(A)
    Ad = aij_from_scipy(A, device="cpu", min_width=min_width)
    x = np.random.default_rng(m).standard_normal(n).astype(dtype)
    y = ell.ell_spmv_plain(Ad.cols, Ad.vals, torch.from_numpy(x)).numpy()
    np.testing.assert_array_equal(
        y, _slot_loop(Ad.cols.numpy(), Ad.vals.numpy(), x))
    assert y[m // 2] == 0.0 and not np.signbit(y[m // 2])
    tol = 1e-13 if dtype == np.float64 else 1e-5
    np.testing.assert_allclose(y, A @ x, rtol=tol,
                               atol=tol * np.abs(A).sum(axis=1).max())
    np.testing.assert_array_equal(Ad.mult(torch.from_numpy(x)).numpy(), y)


@pytest.mark.parametrize("dtype", [np.complex128, np.complex64])
def test_complex_plain_folds_the_parts(dtype):
    """A complex slot is (vr·xr − vi·xi) + (vr·xi + vi·xr)i, each part
    folded from +0.0: the kernel's arithmetic, operation for operation."""
    rng = np.random.default_rng(12)
    A = sp.random(30, 24, density=0.2, random_state=3, format="csr")
    A = (A + 1j * sp.random(30, 24, density=0.2, random_state=4,
                            format="csr")).astype(dtype)
    Ad = aij_from_scipy(A, device="cpu")
    x = (rng.standard_normal(24) + 1j * rng.standard_normal(24)).astype(dtype)
    y = Ad.mult(torch.from_numpy(x)).numpy()
    cols, vals = Ad.cols.numpy(), Ad.vals.numpy()
    real = np.float64 if dtype == np.complex128 else np.float32
    for i in range(30):
        re = im = real(0.0)
        for k in range(cols.shape[1]):
            v, u = vals[i, k], x[cols[i, k]]
            re = re + (v.real * u.real - v.imag * u.imag)
            im = im + (v.real * u.imag + v.imag * u.real)
        assert y[i] == re + 1j * im
    tol = 1e-13 if dtype == np.complex128 else 1e-5
    np.testing.assert_allclose(y, A @ x, rtol=tol, atol=tol)


def test_empty_and_k_one():
    cols = torch.zeros((0, 3), dtype=torch.int64)
    y = ell.ell_spmv(cols, torch.zeros((0, 3)), torch.ones(4))
    assert y.shape == (0,)
    cols = torch.tensor([[2], [0], [1]])
    vals = torch.tensor([[2.0], [-1.0], [0.5]], dtype=torch.float64)
    x = torch.tensor([1.0, 2.0, 4.0], dtype=torch.float64)
    np.testing.assert_array_equal(ell.ell_spmv(cols, vals, x).numpy(),
                                  [8.0, -1.0, 1.0])


@pytest.mark.parametrize("K,itemsize", [(1, 8), (7, 8), (8, 8), (27, 8),
                                        (27, 4), (95, 8), (96, 8), (97, 8),
                                        (300, 8), (300, 4)])
def test_tile_fits_and_keeps_an_odd_stride(K, itemsize):
    R, Kc, Ks = ell.tile(K, itemsize)
    assert R % 32 == 0 and 32 <= R <= ell.ROWS
    assert Ks % 2 == 1 and Ks >= Kc >= 1
    assert R * Ks * (8 + itemsize) <= ell.SMEM
    if Kc < K:
        assert R == 32                      # chunked only past whole rows
    else:
        assert Kc == K


def test_cuda_tensors_never_reach_the_plain_version(monkeypatch):
    """On the wrapper's CUDA path the plain version is never called: with
    no kernel built (no nvcc here) the call raises."""
    A = sp.random(20, 20, density=0.2, random_state=1, format="csr")
    Ad = aij_from_scipy(A, device="cpu")
    x = torch.ones(20, dtype=torch.float64)

    def boom(*a):
        raise AssertionError("the plain version ran on a CUDA tensor")

    monkeypatch.setattr(ell, "ell_spmv_plain", boom)
    monkeypatch.setattr(_build, "launch", lambda fn, index, a: fn(*a, None))
    ell._launcher.cache_clear()
    monkeypatch.setattr(_build, "_nvcc", lambda: (_ for _ in ()).throw(
        RuntimeError("nvcc not found")))
    monkeypatch.setattr(_build, "_stale", lambda name: True)
    card = [t.as_subclass(_OnCard) for t in (Ad.cols, Ad.vals, x)]
    with pytest.raises(RuntimeError, match="nvcc"):
        ell.ell_spmv(*card)
    ell._launcher.cache_clear()


@pytest.mark.parametrize("change,exc", [
    (dict(vals=torch.zeros((4, 3), dtype=torch.float16),
          x=torch.zeros(6, dtype=torch.float16)), ValueError),
    (dict(vals=torch.zeros((4, 3), dtype=torch.complex128)), ValueError),
    (dict(x=torch.zeros(6, dtype=torch.float32)), ValueError),
    (dict(cols=torch.zeros((4, 3), dtype=torch.int32)), ValueError),
    (dict(cols=torch.zeros((4, 2), dtype=torch.int64)), ValueError),
    (dict(x=torch.zeros((6, 1), dtype=torch.float64)), ValueError),
    (dict(vals=torch.zeros((3, 4), dtype=torch.float64).T), ValueError),
])
def test_malformed_cuda_calls_raise_before_any_launch(change, exc,
                                                      monkeypatch):
    args = dict(cols=torch.zeros((4, 3), dtype=torch.int64),
                vals=torch.zeros((4, 3), dtype=torch.float64),
                x=torch.zeros(6, dtype=torch.float64))
    args.update(change)
    monkeypatch.setattr(ell, "_launcher", lambda: pytest.fail("launched"))
    with pytest.raises(exc):
        ell.ell_spmv(*(args[k].as_subclass(_OnCard)
                       for k in ("cols", "vals", "x")))
