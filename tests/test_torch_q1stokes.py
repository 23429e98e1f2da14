"""The saddle-point models through the port, against petsctpu's.

ksp ex43's Q1-Q1 Stokes assembly (petsctpu_torch/models/q1stokes.py)
gives A, B and f byte for byte equal to petsctpu's (indptr, indices and
data, dtypes included) at 20×20 and at the uneven 13×9, for each
coefficient structure c_str 0–3: its one stable argsort of row·n + col
orders the duplicates as petsctpu's three-key lexsort does, and each
sum adds them from 0.0 in that order. The SolCx nodal solution, the
DMDAIntegrateErrors line and the MAC Stokes system (models/stokes.py)
are equal too.
"""

import numpy as np
import pytest
import torch

from petsctpu.models import q1stokes as jq1
from petsctpu.models.stokes import stokes_mac as jstokes_mac

from petsctpu_torch.models import q1stokes
from petsctpu_torch.models.stokes import stokes_mac

# one intra-op thread: the suite runs in parallel workers (pytest -n), and
# PyTorch's default of a thread a core oversubscribes the host's cores
torch.set_num_threads(1)

PARAMS = {0: dict(eta0=1.0, eta1=1.0e6, xc=0.5, nz=2), 1: dict(eta1=1e3),
          2: dict(eta1=1e2, r=0.3), 3: {}}


def same_csr(a, b):
    assert a.shape == b.shape
    for f in ("indptr", "indices", "data"):
        x, y = getattr(a, f), getattr(b, f)
        assert x.dtype == y.dtype and x.tobytes() == y.tobytes(), f


@pytest.mark.parametrize("c_str", [0, 1, 2, 3])
@pytest.mark.parametrize("mx,my", [(20, 20), (13, 9)])
def test_system_byte_equal(mx, my, c_str):
    ref = jq1.q1q1_stokes_system(mx, my, c_str=c_str, **PARAMS[c_str])
    out = q1stokes.q1q1_stokes_system(mx, my, c_str=c_str, **PARAMS[c_str])
    same_csr(out[0], ref[0])
    same_csr(out[1], ref[1])
    assert out[2].tobytes() == ref[2].tobytes()


@pytest.mark.parametrize("c_str", [0, 1, 2, 3])
def test_element_coefficients_equal(c_str):
    for gp in (False, True):
        ref = jq1.element_coefficients(13, 9, c_str, gp, **PARAMS[c_str])
        out = q1stokes.element_coefficients(13, 9, c_str, gp,
                                            **PARAMS[c_str])
        for a, b in zip(out, ref):
            assert a.tobytes() == b.tobytes()


def test_chronological_sum_adds_in_insertion_order():
    """Duplicates summed left to right from 0.0, -0.0 entries included,
    against petsctpu's lexsort + np.add.at."""
    rng = np.random.default_rng(0)
    rows = rng.integers(0, 7, 400)
    cols = rng.integers(0, 7, 400)
    vals = rng.standard_normal(400) * 10.0 ** rng.integers(-8, 8, 400)
    vals[::37] = -0.0
    same_csr(q1stokes._coo_sum_chronological(rows, cols, vals, 7),
             jq1._coo_sum_chronological(rows, cols, vals, 7))


def test_solcx_and_errors_equal():
    mx = 13
    kw = PARAMS[0]
    ref = jq1.solcx_nodal_solution(mx, mx, **kw)
    out = q1stokes.solcx_nodal_solution(mx, mx, **kw)
    assert out.tobytes() == ref.tobytes()
    X = ref + np.random.default_rng(1).standard_normal(ref.size) * 1e-3
    assert q1stokes.integrate_errors(mx, mx, X, out) == \
        jq1.integrate_errors(mx, mx, X, ref)


def test_stokes_mac_equal():
    K, b, fields, blk = stokes_mac(8)
    jK, jb, jfields, jblk = jstokes_mac(8)
    same_csr(K, jK)
    assert b.tobytes() == jb.tobytes()
    for f, g in zip(fields, jfields):
        np.testing.assert_array_equal(f, g)
    for k in ("A", "G", "D"):
        same_csr(blk[k], jblk[k])
