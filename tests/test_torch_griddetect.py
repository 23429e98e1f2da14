"""Structured-grid recovery (petsctpu_torch/mat/griddetect.py) and
`-mat_type auto` (mat/factory.auto_format) against petsctpu
(tests/test_griddetect.py, tests/test_sell.py:70).

* grid_recover_ordering: petsctpu's `perm` byte for byte and its `dims`
  on every scrambled grid of tests/test_griddetect.py, None where
  petsctpu gives None.
* auto with accel=False (the CPU): petsctpu's off-TPU type and `perm`.
* auto with accel=True (the card's tree, run here on the CPU, so K2 and
  K1 take their plain versions): petsctpu's type and `perm` with its
  backend reported as "tpu", on every case where petsctpu picks no
  band; no BandMat on any case.
* M.mult within rounding of (A x)[perm]: 1e-5 of the largest entry in
  fp32, 1e-12 in fp64.
"""

import jax
import numpy as np
import pytest
import scipy.sparse as sp
import torch

from test_griddetect import _grid, _scramble

from petsctpu.mat.factory import mat_from_options as r_mat_from_options
from petsctpu.mat.griddetect import grid_recover_ordering as r_recover

from petsctpu_torch.mat.factory import auto_format, mat_from_options
from petsctpu_torch.mat.griddetect import grid_recover_ordering
from petsctpu_torch.models import ex45_system, laplacian_2d

# one intra-op thread: the suite runs in parallel workers (pytest -n), and
# PyTorch's default of a thread a core oversubscribes the host's cores
torch.set_num_threads(1)

GRIDS = [((18, 19, 20), "box", 27), ((17, 18, 23), "star", 7),
         ((80, 90), "box", 9), ((96, 70), "star", 5)]


@pytest.mark.parametrize("dims,kind,maxoffs", GRIDS)
def test_recovers_scrambled_grids_as_reference(dims, kind, maxoffs):
    A = _scramble(_grid(dims, kind))
    perm, gd = grid_recover_ordering(A, return_dims=True)
    rperm, rgd = r_recover(A, return_dims=True)
    assert perm.dtype == rperm.dtype == np.int64
    assert perm.tobytes() == rperm.tobytes()
    assert gd == rgd
    assert np.array_equal(grid_recover_ordering(A), perm)
    n = A.shape[0]
    inv = np.empty(n, np.int64)
    inv[perm] = np.arange(n)
    co = A.tocoo()
    offs = np.unique(inv[co.col] - inv[co.row])
    assert len(offs) <= maxoffs
    assert np.abs(offs).max() < n


def test_rejects_non_grids_as_reference():
    R = sp.random(8192, 8192, density=0.002, format="csr", random_state=3)
    R = ((R + R.T) != 0).astype(np.float64).tocsr()
    assert grid_recover_ordering(R) is None and r_recover(R) is None
    assert grid_recover_ordering(R, return_dims=True) == (None, None)
    A = _grid((20, 20, 20), "star").tolil()     # unsymmetric pattern
    A[5, 17] = 1.0
    assert grid_recover_ordering(A.tocsr()) is None
    assert r_recover(A.tocsr()) is None


def test_small_matrices_skipped_as_reference():
    A = _grid((10, 10), "star")
    assert grid_recover_ordering(A) is None and r_recover(A) is None


def _valued(A, seed=0, dtype=np.float64):
    A = sp.csr_matrix(A, dtype=np.float64)
    A.sum_duplicates()
    A.data = np.random.default_rng(seed).standard_normal(A.nnz)
    return A.astype(dtype)


def _tridiag_scrambled(n=5000):
    e = np.ones(n)
    T = sp.diags([-e[:-1], 2.5 * e, -e[:-1]], [-1, 0, 1]).tocsr()
    return _scramble(T, seed=11)


def _random_sym(n=8192):
    R = sp.random(n, n, density=0.002, format="csr", random_state=5)
    return (R + R.T + 4.0 * sp.eye(n)).tocsr()


# name -> (matrix factory, dtype); the reference's own two cases first
AUTO_CASES = {
    "test_griddetect_82": (lambda: _valued(_scramble(_grid((18, 18, 18),
                                                           "box"))),
                           np.float32),
    "test_sell_70": (lambda: laplacian_2d(24, 24).tocsr(), np.float64),
    "ex45_16_natural": (lambda: ex45_system(16, 16, 16)[0].tocsr(),
                        np.float64),
    "ex45_16_scrambled": (lambda: _scramble(ex45_system(16, 16, 16)[0]
                                            .tocsr()), np.float64),
    "ex45_16_scrambled_fp32": (lambda: _scramble(ex45_system(
        16, 16, 16)[0].tocsr()), np.float32),
    "ex45_32_natural_fp32": (lambda: ex45_system(32, 32, 32)[0].tocsr(),
                             np.float32),
    "box_80x90_scrambled": (lambda: _valued(_scramble(_grid((80, 90),
                                                            "box")), 1),
                            np.float64),
    "tridiag_scrambled": (_tridiag_scrambled, np.float64),
    "tridiag_scrambled_fp32": (_tridiag_scrambled, np.float32),
    "random_sym": (_random_sym, np.float64),
    "random_sym_fp32": (_random_sym, np.float32),
}


def _reference(A, dtype, tpu: bool):
    with pytest.MonkeyPatch.context() as mp:
        if tpu:
            mp.setattr(jax, "default_backend", lambda: "tpu")
        return r_mat_from_options(A, mat_type="auto", dtype=dtype)


def _check_mult(M, perm, A, dtype):
    n = A.shape[0]
    x = np.random.default_rng(2).standard_normal(n).astype(dtype)
    xp = x if perm is None else x[perm]
    y = M.mult(torch.from_numpy(np.ascontiguousarray(xp))).numpy()
    ref = np.asarray(A.astype(np.float64) @ x.astype(np.float64))
    ref = ref if perm is None else ref[perm]
    tol = 1e-5 if dtype == np.float32 else 1e-12
    assert np.abs(y - ref).max() <= tol * np.abs(ref).max()


def _same_perm(perm, rperm):
    if rperm is None:
        assert perm is None
    else:
        assert perm is not None and np.array_equal(perm, np.asarray(rperm))


@pytest.mark.parametrize("name", sorted(AUTO_CASES))
def test_auto_on_the_cpu_takes_reference_off_tpu_choice(name):
    make, dtype = AUTO_CASES[name]
    A = make()
    M, perm = auto_format(A, dtype=dtype, accel=False, device="cpu")
    R, rperm = _reference(A, dtype, tpu=False)
    assert type(M).__name__ == type(R).__name__, (type(M), type(R))
    _same_perm(perm, rperm)
    _check_mult(M, perm, A, dtype)
    if name == "test_griddetect_82":
        assert type(M).__name__ == "StencilMat"
    if name == "test_sell_70":
        assert type(M).__name__ == "BandMat"


@pytest.mark.parametrize("name", sorted(AUTO_CASES))
def test_auto_on_the_card_takes_reference_tpu_choice_but_band(name):
    make, dtype = AUTO_CASES[name]
    A = make()
    M, perm = auto_format(A, dtype=dtype, accel=True, device="cpu")
    assert type(M).__name__ != "BandMat"
    R, rperm = _reference(A, dtype, tpu=True)
    if type(R).__name__ != "BandMat":
        assert type(M).__name__ == type(R).__name__, (type(M), type(R))
        _same_perm(perm, rperm)
    _check_mult(M, perm, A, dtype)


def test_auto_card_tree_routes():
    """The card's tree on the inputs the issue names: an fp64 grid
    operator in natural order goes to the grid recovery and a StencilMat
    (K1), in fp32 it meets the SELL gates first (K2); where petsctpu's
    TPU tree returns a band (the natural 16³ fp64 operator, the RCM'd
    tridiagonal) it goes on to its next candidate."""
    A64 = ex45_system(16, 16, 16)[0].tocsr()
    M, perm = auto_format(A64, accel=True, device="cpu")
    assert type(M).__name__ == "StencilMat" and perm is not None
    assert type(_reference(A64, None, tpu=True)[0]).__name__ == "BandMat"
    A32 = ex45_system(32, 32, 32)[0].tocsr()
    M, perm = auto_format(A32, dtype=np.float32, accel=True, device="cpu")
    assert type(M).__name__ == "SellMat"
    T = _tridiag_scrambled()
    assert type(_reference(T, np.float32, tpu=True)[0]).__name__ == \
        "BandMat"
    M, perm = auto_format(T, dtype=np.float32, accel=True, device="cpu")
    assert type(M).__name__ == "SellMat" and perm is not None


def test_mat_from_options_auto_and_info(capsys):
    """-mat_type auto through mat_from_options on the CPU (the accel=False
    tree) with -info's decision line, as test_logging.py's
    test_info_channel reads it from petsctpu."""
    from petsctpu_torch.core.logging import info_on
    from petsctpu_torch.core.options import Options

    info_on(False)
    try:
        A = laplacian_2d(70, 70, dtype=np.float32).tocsr()
        M, perm = mat_from_options(A, Options({"mat_type": "auto",
                                               "info": "true"}),
                                   device="cpu")
        assert type(M).__name__ == "BandMat" and perm is None
        err = capsys.readouterr().err
        assert "[0] MatFromOptions(): -mat_type auto: n=4900" in err
        assert "-> BandMat" in err
    finally:
        info_on(False)


@pytest.mark.parametrize("case", ("tridiag_scrambled", "random_sym"))
def test_rcm_fast_equals_reference(case):
    """mat/order.py's "rcm_fast" (csrc/host_graph.cpp's copy of
    petsctpu's native rcm) gives petsctpu's permutation, byte for byte:
    the RCM candidate of `auto` depends on it."""
    from petsctpu.mat.order import get_ordering as r_get_ordering

    from petsctpu_torch.mat.order import get_ordering

    A = AUTO_CASES[case][0]()
    perm = get_ordering(A, "rcm_fast")
    rperm = r_get_ordering(A, "rcm_fast")
    assert perm.dtype == rperm.dtype == np.int64
    assert perm.tobytes() == rperm.tobytes()
