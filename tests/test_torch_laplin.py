"""snes ex35's goldens through the port (tests/test_laplin.py:54-213, CPU,
fp64): the linear Laplacian as a nonlinear problem, each nonlinear solver
beside its linear twin, the right-hand side PETSc's drand48 stream
(core/random.Rand48). runex35 (nrichardson) is held in
tests/test_torch_snes_variants.py and runex35_7 (MG) in
tests/test_torch_mg_ref.py; here runex35_2-6, the one-step Newton and
runex35_8 (FAS), each with the reference test's assertions and
tolerances, and each solve's history against petsctpu's own.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_laplin import EX35_HISTORY

from petsctpu.ksp.api import ksp_solve as jksp_solve
from petsctpu.mat.ell import aij_from_scipy as jaij

from petsctpu_torch.dm import DA
from petsctpu_torch.ksp import ksp_solve
from petsctpu_torch.ksp.common import KSPConfig
from petsctpu_torch.mat import aij_from_scipy
from petsctpu_torch.models.laplin import ex35_matrix, ex35_rhs
from petsctpu_torch.snes import fas_levels_from_da, snes_fas, snes_solve
from petsctpu_torch.snes.api import SNESConfig

# one intra-op thread: the suite runs in parallel workers (pytest -n), and
# PyTorch's default of a thread a core oversubscribes the host's cores
torch.set_num_threads(1)

CPU = "cpu"
GMRES_3 = [2.17647, 0.339505, 0.138169]     # ex35_3.out, ex35_4.out
CG_3 = [2.17647, 0.343713, 0.151262]        # ex35_5.out, ex35_6.out


def system():
    A, b = ex35_matrix(4), ex35_rhs(4)
    return A, aij_from_scipy(A, device=CPU), torch.from_numpy(b), b


def residual():
    _, Ad, bt, _ = system()
    return lambda x: Ad.mult(x) - bt


@pytest.mark.parametrize("case,kw,golden", [
    ("ex35_2", dict(ksp_type="richardson", richardson_self_scale=True),
     EX35_HISTORY),
    ("ex35_4", dict(ksp_type="gmres"), GMRES_3),
    ("ex35_6", dict(ksp_type="cg"), CG_3)])
def test_linear_twins(case, kw, golden):
    """runex35_2 (self-scaled Richardson, pc none: nrichardson's stream),
    runex35_4 (GMRES) and runex35_6 (CG), rtol 1e-12; each history within
    1e-10 of petsctpu's."""
    A, Ad, bt, b = system()
    r = ksp_solve(Ad, bt, rtol=1e-12, atol=1e-50, maxits=10000, **kw)
    np.testing.assert_allclose(r.history[:len(golden)].numpy(), golden,
                               rtol=2e-5)
    if case != "ex35_2":
        assert float(r.history[3]) < 1e-11
    jr = jksp_solve(jaij(A), jnp.asarray(b), rtol=1e-12, atol=1e-50,
                    maxits=10000, **kw)
    k = int(jr.its)
    assert (int(r.its), int(r.reason)) == (k, int(jr.reason))
    h, jh = r.history[:k + 1].numpy(), np.asarray(jr.history[:k + 1])
    np.testing.assert_allclose(h, jh, rtol=1e-10, atol=1e-13 * jh[0])


def test_ex35_3_ngmres():
    """runex35_3: -snes_type ngmres (output/ex35_3.out)."""
    from petsctpu_torch.snes.variants import snes_ngmres

    r = snes_ngmres(residual(), torch.zeros(16, dtype=torch.float64),
                    rtol=1e-12, maxits=10)
    np.testing.assert_allclose(r.history[:3].numpy(), GMRES_3, rtol=2e-5)
    assert float(r.history[3]) < 1e-11


def test_ex35_5_ncg():
    """runex35_5: -snes_type ncg, PRP beta (output/ex35_5.out)."""
    from petsctpu_torch.snes.fas import snes_ncg

    r = snes_ncg(residual(), torch.zeros(16, dtype=torch.float64),
                 rtol=1e-12, maxits=10)
    np.testing.assert_allclose(r.history[:3].numpy(), CG_3, rtol=2e-5)
    assert float(r.history[3]) < 1e-11


def test_newton_one_iteration():
    """The outer Newton of runex35_2/4/6 converges in one iteration."""
    _, Ad, bt, _ = system()
    r = snes_solve(lambda x: Ad.mult(x) - bt, torch.zeros_like(bt),
                   jac=lambda x, Fx: Ad, rtol=1e-12, maxits=5)
    assert int(r.its) == 1
    assert float(r.history[1]) < 1e-11


def test_ex35_8_fas():
    """runex35_8: 3-level FAS with nrichardson smoothers on 13 → 7 → 4 and
    a Newton coarse solve (output/ex35_8.out): all 10 outer values."""
    b13 = torch.from_numpy(ex35_rhs(13))

    def make_residual(d):
        Ad = aij_from_scipy(ex35_matrix(d.grid[0]), device=CPU)
        if d.grid[0] == 13:
            return lambda x: Ad.mult(x) - b13
        return lambda x: Ad.mult(x)

    levels = fas_levels_from_da(DA((13, 13)), make_residual, 3)
    r = snes_fas(levels, torch.zeros_like(b13), maxits=9, rtol=1e-8,
                 npre=1, npost=1, smoother="nrichardson",
                 coarse_cfg=SNESConfig(maxits=1, rtol=1e-12,
                                       linesearch="bt"),
                 coarse_ksp=KSPConfig(ksp_type="gmres", rtol=1e-12,
                                      maxits=300))
    golden = [7.46324, 1.00512, 0.142486, 0.0247617, 0.00523225,
              0.00128121, 0.000341666, 9.46065e-05, 2.65147e-05,
              7.45245e-06]
    np.testing.assert_allclose(r.history[:10].numpy(), golden, rtol=2e-5)
