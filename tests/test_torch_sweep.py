"""The oracle sweep's serial cases that the port covers, through the port.

Replays, on the CPU in fp64, each case of tests/sweep_cases.py whose
ksp type (cg, gmres, fgmres by mapping), pc type (none, jacobi; lu and
redundant since slice 2) and matrix type (aij) the port has, and holds
it to its oracle stream in
tests/data/oracle_sweep/ exactly as tests/test_sweep.py::run_serial
does: the exact iteration count, and the stream within the case's own
rtol (atol 1e-11·max for entries at fp noise).
"""

import numpy as np
import pytest
import scipy.sparse as sp
import torch

from sweep_cases import CASES
from test_sweep import oracle_stream, parse_args

from petsctpu_torch.core.options import Options
from petsctpu_torch.ksp import ksp_solve
from petsctpu_torch.ksp.api import config_from_options
from petsctpu_torch.ksp.common import KSPConfig
from petsctpu_torch.mat import aij_from_scipy
from petsctpu_torch.models import ex2_system
from petsctpu_torch.pc import make_pc

SLICE1 = ("sw_ex2_cg_none", "sw_ex2_gmres_restart10", "sw_ex2_gmres_mgs",
          "sw_ex2_gmres_unpre", "sw_ex2_gmres_right", "sw_ex1_cg_jacobi",
          "sw_ex2_cg_natural", "sw_ex2_gmres_jacobi_rowmax",
          "sw_ex23b_gmres_jacobi", "sw2_ex2_cg_natural",
          "sw6_ex2_gmres_restart45", "sw10_ex2_cg_sr_natural")
SLICE2 = ("sw_ex2_cg_lu", "sw7_ex2_cg_redundant")
BY_TAG = {c.tag: c for c in CASES}


def build_system(spec):
    """(A csr fp64, b fp64) of the oracle example (u* = 1, b = A u*)."""
    ex, _, params = spec.partition(":")
    p = dict(kv.split("=") for kv in params.split(",") if kv)
    if ex in ("ex1", "ex23"):
        n = int(p["n"])
        e = np.ones(n)
        A = sp.diags([-e[:-1], 2 * e, -e[:-1]], [-1, 0, 1]).tocsr()
        return A, A @ np.ones(n)
    if ex == "ex2":
        A, b, _ = ex2_system(int(p["m"]), int(p["n"]))
        return sp.csr_matrix(A), np.asarray(b)
    raise ValueError(spec)


def test_slice1_cases_exist():
    assert all(tag in BY_TAG and BY_TAG[tag].np == 1
               for tag in SLICE1 + SLICE2)


@pytest.mark.parametrize("tag", SLICE1 + SLICE2)
def test_sweep_case_through_port(tag):
    case = BY_TAG[tag]
    flags = parse_args(case.args)
    monit = oracle_stream(case.tag)
    if case.sys.startswith("ex2:") and "ksp_rtol" not in flags:
        # ex2.c hardcodes rtol = 1.e-2/((m+1)*(n+1)) (ex2.c:89)
        p = dict(kv.split("=") for kv in case.sys[4:].split(","))
        flags = {**flags, "ksp_rtol":
                 repr(1e-2 / ((int(p["m"]) + 1) * (int(p["n"]) + 1)))}
    A, b = build_system(case.sys)
    opts = Options(dict(flags))
    cfg = config_from_options(opts, KSPConfig(maxits=2000))
    Ad = aij_from_scipy(A, device="cpu")
    pc = make_pc(flags.get("pc_type", "ilu"), A=Ad, A_host=A, options=opts)
    r = ksp_solve(Ad, torch.from_numpy(b), pc=pc, cfg=cfg)
    assert case.check == "stream"
    assert int(r.its) == len(monit) - 1, (int(r.its), len(monit) - 1)
    hist = r.history[: len(monit)].numpy()
    idx = [i for i, v in enumerate(monit) if v is not None]
    vals = np.array([monit[i] for i in idx])
    np.testing.assert_allclose(hist[idx], vals, rtol=case.rtol,
                               atol=1e-11 * vals.max())
