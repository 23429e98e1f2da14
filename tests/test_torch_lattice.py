"""The lattice gauge model (petsctpu_torch/models/lattice.py) and the
port's PETSCRAND48 block draws against petsctpu (tests/test_complex.py).

H byte-equal to petsctpu's per-site loop (indptr, indices and complex
values compared as bytes) at n = 2, 3, 6 and 17 and other β, ρ; equal
to the complex oracle's assembled matrix (tests/data/ex39_H.bin, read
through the port's reader); HtH and Htb byte-equal; the ex39 solve of
tests/test_complex.py:49 (CG on HᴴH, rtol 1e-6) at petsctpu's
iteration count and reason, both true residuals within the solve's
tolerance, 1e-6 of ‖Htb‖.
"""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from petsctpu.core.random import Rand48 as RRand48
from petsctpu.models import lattice as rlattice

from petsctpu_torch.core.random import Rand48
from petsctpu_torch.io.viewer import petsc_binary_read_mat
from petsctpu_torch.models import lattice as tlattice

# one intra-op thread: the suite runs in parallel workers (pytest -n), and
# PyTorch's default of a thread a core oversubscribes the host's cores
torch.set_num_threads(1)

DATA = os.path.join(os.path.dirname(__file__), "data", "ex39_H.bin")


def same_csr(A, B):
    assert A.shape == B.shape
    for k in ("indptr", "indices", "data"):
        a, b = getattr(A, k), getattr(B, k)
        assert a.dtype == b.dtype and a.tobytes() == b.tobytes(), k


@pytest.mark.parametrize("n", (1000, 4096, 4097, 9001))
@pytest.mark.parametrize("lo,hi", ((0.0, 1.0), (-2.0, 3.0)))
def test_rand48_block_draws_equal_the_stream(n, lo, hi):
    r, t = RRand48(lo=lo, hi=hi), Rand48(lo=lo, hi=hi)
    ref = np.array([r.get_value() for _ in range(n)])
    assert t.get_values(n).tobytes() == ref.tobytes()
    assert t.get_value() == r.get_value()      # the state advanced alike


@pytest.mark.parametrize("n,beta,rho", [(2, 1.0, 1.0), (3, 1.0, 1.0),
                                        (6, 1.0, 1.0), (17, 1.0, 1.0),
                                        (6, 0.5, 2.0), (17, 3.0, 0.1)])
def test_operator_byte_equal_to_reference(n, beta, rho):
    same_csr(tlattice.lattice_gauge_2d(n, beta, rho),
             rlattice.lattice_gauge_2d(n, beta, rho))


def test_operator_equals_oracle():
    """The complex oracle's assembled H (tests/test_complex.py::
    test_operator_entry_exact), entry for entry."""
    H = tlattice.lattice_gauge_2d(6)
    O = petsc_binary_read_mat(DATA, complex_scalars=True)
    assert H.shape == O.shape
    assert abs(H - O).max() == 0.0


@pytest.mark.parametrize("n", (6, 17))
def test_system_byte_equal_to_reference(n):
    HtH, Htb, H = tlattice.lattice_gauge_system(n)
    RHtH, RHtb, RH = rlattice.lattice_gauge_system(n)
    same_csr(H, RH)
    same_csr(HtH, RHtH)
    assert Htb.tobytes() == RHtb.tobytes()
    assert np.abs(H - H.getH()).max() == 0.0


def test_ex39_solve_as_reference():
    from petsctpu.ksp import ksp_solve as r_ksp_solve
    from petsctpu.mat import aij_from_scipy as r_aij

    from petsctpu_torch.ksp import ksp_solve
    from petsctpu_torch.mat import aij_from_scipy

    HtH, Htb, H = tlattice.lattice_gauge_system(6)
    rr = r_ksp_solve(r_aij(HtH, dtype=np.complex128), jnp.asarray(Htb),
                     ksp_type="cg", rtol=1e-6, maxits=500)
    rt = ksp_solve(aij_from_scipy(HtH, dtype=np.complex128, device="cpu"),
                   torch.from_numpy(Htb), ksp_type="cg", rtol=1e-6,
                   maxits=500)
    assert int(rt.its) == int(rr.its) and int(rt.reason) == int(rr.reason)
    assert int(rt.reason) > 0
    bound = 1e-6 * np.linalg.norm(Htb)
    for x in (rt.x.numpy(), np.asarray(rr.x)):
        assert np.linalg.norm(HtH @ x - Htb) <= bound
