"""The slice as a whole: ksp ex55 (2-D Q1 elasticity, bs 2) at ne = 15
(n = 512) through the port's -mat_type baij and sbaij, against petsctpu.

CG to rtol 1e-5 with pbjacobi and jacobi on BAIJ, jacobi and icc on
SBAIJ, in fp64 on the CPU: the same iteration count and reason, and
the residual history (relative to its first entry) and x (relative to
max |x|) within 2e-9 (the products' sums round in another order than
XLA's: 5e-11 at most; the port's own solve moves by at most 30 times
less under a one-ulp change of b, test_the_bound_is_over_the_noise).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from petsctpu.core.options import Options as JOptions
from petsctpu.ksp import ksp_solve as jksp_solve
from petsctpu.mat.factory import mat_from_options as jmat_from_options
from petsctpu.pc import make_pc as jmake_pc
from petsctpu_torch.core.options import Options
from petsctpu_torch.ksp import ksp_solve
from petsctpu_torch.mat.factory import mat_from_options
from petsctpu_torch.models.elasticity import ex55_system
from petsctpu_torch.pc import make_pc

# one intra-op thread: the suite runs in parallel workers (pytest -n), and
# PyTorch's default of a thread a core oversubscribes the host's cores
torch.set_num_threads(1)

NE = 15
BOUND = 2e-9
CASES = [("baij", "pbjacobi"), ("baij", "jacobi"), ("sbaij", "jacobi"),
         ("sbaij", "icc")]


def port_solve(A, b, mat_type, pc_type):
    o = Options({"mat_type": mat_type, "mat_block_size": "2"})
    M, _ = mat_from_options(A, o, device="cpu")
    pc = make_pc(pc_type, A=M, A_host=A)
    return M, ksp_solve(M, torch.from_numpy(b), pc=pc, ksp_type="cg",
                        rtol=1e-5, maxits=2000)


@pytest.mark.parametrize("mat_type,pc_type", CASES)
def test_ex55_through_port(mat_type, pc_type):
    A, b, _ = ex55_system(NE, 1e-3)
    M, r = port_solve(A, b, mat_type, pc_type)
    assert type(M).__name__ == mat_type.upper()
    o = JOptions({"mat_type": mat_type, "mat_block_size": "2"})
    Mj, _ = jmat_from_options(A, o)
    rj = jksp_solve(Mj, jnp.asarray(b), pc=jmake_pc(pc_type, A=Mj, A_host=A),
                    ksp_type="cg", rtol=1e-5, maxits=2000)
    its = int(r.its)
    assert its == int(rj.its) and int(r.reason) == int(rj.reason) > 0
    h, hj = r.history[:its + 1].numpy(), np.asarray(rj.history[:its + 1])
    assert np.abs(h - hj).max() <= BOUND * hj[0]
    xj = np.asarray(rj.x)
    assert np.abs(r.x.numpy() - xj).max() <= BOUND * np.abs(xj).max()


def test_the_bound_is_over_the_noise():
    """The port's own history and x under a one-ulp change of b move by
    at most BOUND / 30: the comparison above is not chaotic."""
    A, b, _ = ex55_system(NE, 1e-3)
    b2 = np.nextafter(b, np.inf)
    for mat_type, pc_type in CASES:
        _, r = port_solve(A, b, mat_type, pc_type)
        _, r2 = port_solve(A, b2, mat_type, pc_type)
        its = int(r.its)
        assert int(r2.its) == its
        d = np.abs(r.history[:its + 1].numpy()
                   - r2.history[:its + 1].numpy()).max() / float(r.history[0])
        dx = np.abs(r.x.numpy() - r2.x.numpy()).max() / np.abs(
            r.x.numpy()).max()
        assert 30 * max(d, dx) <= BOUND, (mat_type, pc_type, d, dx)
