"""The ex10 datafile goldens of tests/test_golden_ex10.py, through the
port.

Each of its 18 configs (15 on AIJ, one on SBAIJ, two on BAIJ with bs 3)
reads its system with petsctpu's binary reader into scipy, builds the
port's operator and PC on the CPU in fp64 and holds the solve to the
reference oracle stream in tests/data/oracle_ex10/ with that test's
bounds: the exact iteration count, the monitor stream within 2e-5
relative, and the true residual within 2e-4 relative (stream-checked)
or 2× (the transient-spike family).
"""

import os

import numpy as np
import pytest
import torch

from test_golden_ex10 import CASES, DATA, load_oracle

from petsctpu.io.viewer import petsc_binary_read_system
from petsctpu_torch.core.options import Options
from petsctpu_torch.ksp import ksp_solve
from petsctpu_torch.mat import (aij_from_scipy, baij_from_scipy_bsr,
                                sbaij_from_scipy)
from petsctpu_torch.pc import make_pc

# one intra-op thread: the suite runs in parallel workers (pytest -n), and
# PyTorch's default of a thread a core oversubscribes the host's cores
torch.set_num_threads(1)


def test_every_config_is_here():
    assert len(CASES) == 18
    assert sum(c[1] != "aij" for c in CASES.values()) == 3


@pytest.mark.parametrize("tag", sorted(CASES))
def test_ex10_config_through_port(tag):
    fname, mat_type, bs, ksp_t, pc_t, pc_opts, stream = CASES[tag]
    A, b = petsc_binary_read_system(os.path.join(DATA, fname))
    b = np.asarray(b, np.float64)
    monit, its_ref, rnorm_ref = load_oracle(tag)
    if mat_type == "baij":
        Ad = baij_from_scipy_bsr(A, bs=bs, dtype=np.float64, device="cpu")
    elif mat_type == "sbaij":
        Ad = sbaij_from_scipy(A, bs=bs, dtype=np.float64, device="cpu")
    else:
        Ad = aij_from_scipy(A, device="cpu")
    pc = make_pc(pc_t, A=Ad, A_host=A, options=Options(pc_opts))
    r = ksp_solve(Ad, torch.from_numpy(b), pc=pc, ksp_type=ksp_t,
                  rtol=1e-5, maxits=400)
    assert int(r.its) == its_ref, (int(r.its), its_ref)
    if stream:
        np.testing.assert_allclose(r.history[:len(monit)].numpy(), monit,
                                   rtol=2e-5)
    if rnorm_ref is not None:
        tr = float(np.linalg.norm(b - A @ r.x.numpy()))
        if stream:
            assert abs(tr - rnorm_ref) <= 2e-4 * max(rnorm_ref, 1e-12) \
                + 1e-9, (tr, rnorm_ref)
        else:
            assert tr <= 2.0 * rnorm_ref + 1e-9, (tr, rnorm_ref)
