"""Worlds built, run and closed in a row (parallel.comm.World.close),
on the CPU and, where there is one, on the card.

Imports nothing of petsctpu, so that the card's case runs where JAX is
not installed: `python -m pytest tests/test_torch_world.py`.
"""

import os

import numpy as np
import pytest
import scipy.sparse as sp
import torch

from petsctpu_torch.models import ex2_system
from petsctpu_torch.parallel import World, par_ksp_solve, \
    sharded_aij_from_scipy
from petsctpu_torch.pc.parallel import make_par_pc

NPS = (2, 4, 8)


def _tids() -> set:
    """The native ids of this process's OS threads (gloo's groups run
    their own)."""
    return set(os.listdir("/proc/self/task"))


@pytest.mark.parametrize("dev", ("cpu", pytest.param(
    "cuda", marks=pytest.mark.cuda)))
def test_worlds_in_a_row_close_their_groups(dev):
    """Worlds of 2, 4 and 8 ranks built, run and closed in a row, each
    on a small solve (the shape of chip_smoke.py's phase 46, which once
    dropped its Worlds unclosed and crashed on the card): every solve
    converges, and close() ends every OS thread the world started (its
    rank threads, and gloo's) while the World is still referenced. Only
    the world's own threads are counted: those alive after its solve
    that were not before it was built (other tests of the same worker
    may start threads of their own meanwhile)."""
    if dev == "cuda" and not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (rank threads on the card)")
    A, b, _ = ex2_system(12, 12)
    A = sp.csr_matrix(A)
    for k in range(24 if dev == "cuda" else 9):
        P = NPS[k % 3]
        before = _tids()
        w = World(P, dev, timeout=60.0)
        A_sh, part = sharded_aij_from_scipy(A, P, device=dev)
        res = par_ksp_solve(w, A_sh, np.asarray(b),
                            pc=make_par_pc("jacobi", A_sh, part),
                            ksp_type="cg", rtol=1e-8)
        assert int(res.reason) > 0 and w.comms[0].counts["psum"][0] > 0
        mine = _tids() - before
        assert len(mine) >= P, (k, P, mine)
        w.close()
        assert w.closed and all(c.pg is None for c in w.comms)
        with pytest.raises(RuntimeError, match="closed"):
            w.run(lambda comm: None)
        assert not mine & _tids(), (k, P, sorted(mine & _tids()))
