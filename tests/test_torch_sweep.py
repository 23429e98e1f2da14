"""The oracle sweep's serial cases that the port covers, through the port.

Replays, on the CPU in fp64, each case of tests/sweep_cases.py whose
ksp type (cg, groppcg, gmres, fgmres by mapping), pc type (none,
jacobi; lu and redundant since slice 2; ilu, icc, sor, bjacobi and asm
since slice 5) and matrix type (aij) the port has, and holds it to its
oracle stream in tests/data/oracle_sweep/ exactly as
tests/test_sweep.py::run_serial does: the exact iteration count, and
the stream within the case's own rtol (atol 1e-11·max for entries at fp
noise); a case checked by "its" on its iteration count alone.

A case in PETSC_DOT_ORDER has a chaotic stream: a one-ulp difference in
an early inner product grows past the case's rtol by its last
iterations. It is replayed with its inner products summed in the order
of PETSc's VecDot (a BLAS dot: left to right), the order the oracle was
recorded with (ROADMAP queue 3); every other case runs the port's own
dot and norm.
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
from petsctpu_torch.vec import ops

SLICE1 = ("sw_ex2_cg_none", "sw_ex2_gmres_restart10", "sw_ex2_gmres_mgs",
          "sw_ex2_gmres_unpre", "sw_ex2_gmres_right", "sw_ex1_cg_jacobi",
          "sw_ex2_cg_natural", "sw_ex2_gmres_jacobi_rowmax",
          "sw_ex23b_gmres_jacobi", "sw2_ex2_cg_natural",
          "sw6_ex2_gmres_restart45", "sw10_ex2_cg_sr_natural")
SLICE2 = ("sw_ex2_cg_lu", "sw7_ex2_cg_redundant")
# every serial case with pc ilu, icc, sor, bjacobi or asm (ilu the
# default) on a system build_system makes, with a ksp type the port has
SLICE5 = ("sw_ex2_cg_sor15", "sw_ex2_cg_icc", "sw_ex2_cg_bjacobi4",
          "sw_ex2_gmres_cgs_always", "sw_ex2_gmres_rcm_ilu",
          "sw_ex2_cg_asm4", "sw_ex1_gmres_ilu", "sw_ex23_cg_icc",
          "sw_ex2_cg_unpre_icc", "sw_ex2_gmres_icc", "sw_ex2_cg_ilu2",
          "sw_ex2_gmres_asm4", "sw_ex2_fgmres_sor",
          "sw_ex2_gmres_restart5_ilu", "sw_ex2b_cg_icc28",
          "sw_ex2b_gmres_ilu28", "sw_ex1b_cg_icc", "sw2_ex2_gmres_asm2_basic",
          "sw2_ex2_gmres_asm4_ov2", "sw2_ex1_gmres_ilu200",
          "sw2_ex23_cg_sor120", "sw6_ex2_cg_icc1", "sw6_ex2_cg_icc2",
          "sw6_ex2_groppcg_sor", "sw7_ex2_gmres_ilu_nd",
          "sw7_ex2_gmres_ilu_qmd", "sw7_ex2_gmres_ilu_1wd",
          "sw7_ex2_cg_icc_rcm", "sw7_ex2_gmres_ilu3", "sw10_ex2_cg_sr_icc")
BY_TAG = {c.tag: c for c in CASES}
# CG+SSOR on the 1-D 120-row operator, 51 its to rtol 1e-7
PETSC_DOT_ORDER = {"sw2_ex23_cg_sor120"}


def petsc_order_dot(a, b, axis=None):
    """aᴴb of serial vectors summed left to right, PETSc's VecDot order
    (np.add.accumulate's documented order: r[i] = r[i-1] + p[i])."""
    assert axis is None
    p = (a.conj() * b).reshape(-1).numpy()
    return torch.tensor(np.add.accumulate(p)[-1] if p.size else 0.0,
                        dtype=a.dtype)


def petsc_order_norm(a, axis=None):
    return torch.sqrt(petsc_order_dot(a, a, axis).real)


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
               for tag in SLICE1 + SLICE2 + SLICE5)


def test_slice5_is_every_case_of_its_pcs_the_port_runs():
    """SLICE5 is the whole rule: serial, pc ilu/icc/sor/bjacobi/asm,
    an ex1/ex2/ex23 system and a ksp type in the port's registry."""
    from petsctpu_torch.ksp.api import KSP_REGISTRY

    rule = [c.tag for c in CASES
            if c.np == 1 and c.sys.split(":")[0] in ("ex1", "ex2", "ex23")
            and parse_args(c.args).get("pc_type", "ilu") in (
                "ilu", "icc", "sor", "bjacobi", "asm")
            and parse_args(c.args).get("ksp_type", "gmres") in KSP_REGISTRY]
    assert sorted(rule) == sorted(SLICE5)


def test_petsc_order_dot_sums_left_to_right():
    rng = np.random.default_rng(3)
    a, b = rng.standard_normal((2, 1000))
    seq = 0.0
    for u, v in zip(a, b):
        seq = seq + u * v
    assert float(petsc_order_dot(torch.from_numpy(a),
                                 torch.from_numpy(b))) == seq
    assert float(petsc_order_norm(torch.from_numpy(a))) == \
        float(np.sqrt(np.add.accumulate(a * a)[-1]))
    assert float(petsc_order_dot(torch.zeros(0, dtype=torch.float64),
                                 torch.zeros(0, dtype=torch.float64))) == 0.0
    assert PETSC_DOT_ORDER <= set(SLICE5)


@pytest.mark.parametrize("tag", SLICE1 + SLICE2 + SLICE5)
def test_sweep_case_through_port(tag, monkeypatch):
    case = BY_TAG[tag]
    if tag in PETSC_DOT_ORDER:
        monkeypatch.setattr(ops, "dot", petsc_order_dot)
        monkeypatch.setattr(ops, "norm", petsc_order_norm)
    flags = parse_args(case.args)
    if flags.get("pc_type") == "asm" and flags.get("pc_asm_type") == "basic":
        # as run_serial: serial multiblock ASM is restricted whatever
        # -pc_asm_type says (asm.c:248,:310)
        flags = {**flags, "pc_asm_type": "restrict"}
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
    if case.check == "its":
        assert int(r.its) == max(len(monit) - 1, 1), (int(r.its), len(monit))
        return
    assert case.check == "stream"
    assert int(r.its) == len(monit) - 1, (int(r.its), len(monit) - 1)
    hist = r.history[: len(monit)].numpy()
    idx = [i for i, v in enumerate(monit) if v is not None]
    vals = np.array([monit[i] for i in idx])
    np.testing.assert_allclose(hist[idx], vals, rtol=case.rtol,
                               atol=1e-11 * vals.max())
