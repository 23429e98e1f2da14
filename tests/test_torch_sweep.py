"""The oracle sweep's serial cases that the port covers, through the port.

Replays, on the CPU in fp64, each case of tests/sweep_cases.py whose
ksp type (cg, groppcg, gmres, fgmres by mapping; every other type since
slice 6), pc type (none, jacobi; lu and redundant since slice 2; ilu,
icc, sor, bjacobi and asm since slice 5; ROADMAP queue 1 item 10's
eisenstat, composite, ksp and svd since slice 8) and matrix type (aij;
baij and sbaij since slice 12) the port has, -ksp_diagonal_scale solving the scaled system as
tests/test_sweep.py does, and -pc_type eisenstat solving the
transformed system of make_eisenstat_system as run_serial does, and
holds it to its oracle stream in tests/data/oracle_sweep/
exactly as tests/test_sweep.py::run_serial does: the exact iteration
count (TFQMR's stream has two entries an iteration, Chebyshev's first
comes after its first correction), and the stream within the case's
own rtol (atol 1e-11·max for entries at fp noise); a case checked by
"its" on its iteration count alone, by "its_approx" within
max(1, its/33). The ex10 datafile cases read their system with
tests/test_sweep.py::build_system (petsctpu's binary reader) into a
scipy matrix for the port.

A case in PETSC_DOT_ORDER has a chaotic stream: a one-ulp difference in
an early inner product grows past the case's rtol by its last
iterations. It is replayed with its inner products summed in the order
of PETSc's VecDot (a BLAS dot: left to right), the order the oracle was
recorded with (ROADMAP queue 3); every other case runs the port's own
dot and norm. Every AIJ product sums each row over its slots left to
right, as PETSc's MatMult_SeqAIJ does: the port's AIJ.mult (the ELL
kernel's plain version) folds in that order, which the one case that
needed it (PETSC_ROW_ORDER) once took from a monkeypatch.

SNES holds the 13 serial snes ex5 and ex14 cases (ROADMAP queue 1 item
11) to their oracle -snes_monitor streams with the bounds of
tests/test_sweep.py::run_snes_ex5 and ::run_snes_ex14: ex5 through the
stencil-colored FD Jacobian and tight FGMRES steps (the head of the
stream within 6e-4, the quadratic tail within 3.5×); ex14 through the
SNES object with the 27-color 'ds' FD Jacobian and GMRES(30) + ILU(0)
rebuilt on each Jacobian (every entry within 3e-5, the last within
5e-3, "< 1.e-11" entries below 1e-11), the path chip_smoke.py drives
at 128³.

TS holds the 8 serial ts ex4 cases (ROADMAP queue 1 item 12) to their
oracle Timestep streams with tests/test_sweep.py::run_ts_ex4's bounds
(each step's time within 1e-5, its h-scaled 2-norm and max errors
against the analytic solution within 2e-5 + 1e-12), in one integration
whose state is read after each step (ts_solve's post_step), where
run_ts_ex4 integrates again from t = 0 for every step.

NP holds the 25 np > 1 cases (slice 14) over np CPU rank threads with
gloo groups (parallel.comm.World), as tests/test_sweep.py::
run_distributed and ::run_snes_ex5_np hold petsctpu's distributed path;
with them the port replays all 200 cases. test_ex2_2_bjacobi_two_ranks
is tests/test_golden.py's two-rank golden run truly over two ranks.
"""

import os
import re

import numpy as np
import pytest
import scipy.sparse as sp
import torch

from sweep_cases import CASES
from test_sweep import build_system as build_file_system
from test_sweep import ORACLE, oracle_stream, parse_args

from petsctpu_torch.core.options import Options
from petsctpu_torch.ksp import ksp_solve
from petsctpu_torch.ksp.api import config_from_options, diagonal_scale_system
from petsctpu_torch.ksp.common import KSPConfig
from petsctpu_torch.mat import (aij_from_scipy, baij_from_scipy_bsr,
                                sbaij_from_scipy)
from petsctpu_torch.models import ex2_system
from petsctpu_torch.pc import make_pc
from petsctpu_torch.pc.extra import make_eisenstat_system
from petsctpu_torch.vec import ops

# one intra-op thread: the suite runs in parallel workers (pytest -n), and
# PyTorch's default of a thread a core oversubscribes the host's cores
torch.set_num_threads(1)

SLICE1 = ("sw_ex2_cg_none", "sw_ex2_gmres_restart10", "sw_ex2_gmres_mgs",
          "sw_ex2_gmres_unpre", "sw_ex2_gmres_right", "sw_ex1_cg_jacobi",
          "sw_ex2_cg_natural", "sw_ex2_gmres_jacobi_rowmax",
          "sw_ex23b_gmres_jacobi", "sw2_ex2_cg_natural",
          "sw6_ex2_gmres_restart45", "sw10_ex2_cg_sr_natural")
SLICE2 = ("sw_ex2_cg_lu", "sw7_ex2_cg_redundant")
# every serial AIJ case with pc ilu, icc, sor, bjacobi or asm (ilu the
# default), or with -ksp_diagonal_scale and a pc the port has, on a
# system build_system makes (ex1/ex2/ex23 or an ex10 datafile), with a
# slice-1 ksp type
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
          "sw7_ex2_cg_icc_rcm", "sw7_ex2_gmres_ilu3", "sw10_ex2_cg_sr_icc",
          # the ex10 datafiles of tests/data
          "sw_ex10p_groppcg_icc", "sw_ex10p_cg_ilu_rcm", "sw_ex10n_gmres_sor",
          "sw_ex10b_gmres_icc", "sw_ex10p_cg_sor12", "sw_ex10p_gmres_icc1",
          "sw_ex10n_fgmres_ilu1", "sw7_ex10p_cg_icc3",
          "sw2_ex10b_gmres_inodesor", "sw6_ex10b_gmres_inodesor2",
          # -ksp_diagonal_scale: the symmetrically scaled system
          "sw10_ex2_gmres_dscale", "sw10_ex10n_gmres_dscale_ilu")
# every serial case whose ksp type is one of ROADMAP queue 1 item 7's,
# on an ex1/ex2/ex23 system (70) or an ex10 datafile (14)
SLICE6 = (
    "sw_ex2_bcgs_ilu1", "sw_ex2_bicg_jacobi20", "sw_ex2_tfqmr_jacobi",
    "sw_ex2_cgs_ilu", "sw_ex2_cr_icc", "sw_ex2_minres_ssor",
    "sw_ex2_symmlq_icc", "sw_ex2_lsqr_none", "sw_ex2_gcr_jacobi",
    "sw_ex2_lcd_jacobi", "sw_ex2_cheby_jacobi", "sw_ex2_rich_jacobi_s05",
    "sw_ex2_ibcgs_ilu", "sw_ex2_fbcgs_jacobi", "sw_ex2_bcgsl_ell3",
    "sw_ex2_cgne_jacobi", "sw_ex2_preonly_lu", "sw_ex1_bcgs_sor",
    "sw_ex23_minres_jacobi", "sw_ex23_cr_none", "sw_ex2_rich_selfscale",
    "sw_ex2_preonly_cholesky", "sw_ex2b_bcgs_jacobi28",
    "sw_ex2b_minres_jacobi28", "sw_ex1b_cr_jacobi",
    "sw_ex23b_symmlq_jacobi", "sw2_ex2_tfqmr_ilu30", "sw2_ex2_tfqmr_sor",
    "sw2_ex2_cgne_jacobi24", "sw2_ex2_lgmres_jacobi",
    "sw2_ex2_lgmres_ilu_aug4", "sw2_ex2_ibcgs_ilu24",
    "sw2_ex2_fbcgs_sor24", "sw2_ex2_lcd_ilu24", "sw2_ex2_pipecr_jacobi24",
    "sw2_ex2_cheby_jacobi_ev", "sw2_ex2_gcr_ilu24", "sw2_ex2_cgs_icc24",
    "sw2_ex2_bcgsl_ell4", "sw2_ex2_minres_sor24", "sw2_ex2_symmlq_icc24",
    "sw2_ex2_rich_omega08", "sw2_ex2_preonly_ilu", "sw6_ex2_rich_sor_fwd",
    "sw6_ex2_rich_sor_bwd", "sw6_ex2_cgs_ilu1", "sw6_ex2_bicg_icc",
    "sw6_ex2_minres_icc", "sw6_ex2_symmlq_sor", "sw6_ex2_cr_icc",
    "sw6_ex1_lsqr_jacobi200", "sw6_ex23_preonly_cholesky",
    "sw6_ex2_cheby_icc_ev", "sw7_ex2_fbcgsr_jacobi",
    "sw7_ex23_rich_sor_its3", "sw7_ex2_tcqmr_ilu", "sw8_ex2_bicg_ilu",
    "sw8_ex2_cgne_ilu", "sw9_ex2_stcg_jacobi", "sw9_ex2_nash_icc",
    "sw12_ex1_tcqmr_jacobi", "sw12_ex1_gcr_ilu", "sw12_ex23_bcgsl_jacobi",
    "sw12_ex23_fbcgs_ilu", "sw12_ex23_fbcgsr_jacobi", "sw12_ex23_ibcgs_ilu",
    "sw12_ex2_lgmres_icc_aug2", "sw12_ex2_minres_icc1",
    "sw12_ex2_symmlq_ssor14", "sw12_ex2_cr_bjacobi8",
    # the ex10 datafiles of tests/data
    "sw_ex10p_pipecr_icc", "sw_ex10p_symmlq_sor", "sw_ex10p_lsqr_jacobi",
    "sw_ex10n_tfqmr_jacobi", "sw_ex10n_gcr_ilu1", "sw_ex10n_lgmres_jacobi",
    "sw_ex10n_rich_sor", "sw_ex10b_bcgs_sor", "sw_ex10p_bicg_jacobi",
    "sw_ex10n_bcgsl_ilu2", "sw_ex10n_cgs_sor", "sw2_ex10b_bcgs_inodesor",
    "sw6_ex10b_rich_inodesor2", "sw8_ex10n_bicg_ilu")
# every serial case whose pc type is one of ROADMAP queue 1 item 10's:
# eisenstat 5, composite 2, ksp 3 (two with specest), svd 1
SLICE10 = ("sw_ex2_cg_eisenstat", "sw2_ex2_cg_eisenstat24",
           "sw2_ex2_gmres_eisenstat_om14", "sw10_ex10p_cg_eisen_sr",
           "sw10_ex2_cg_dscale_eisen", "sw7_ex2_cg_composite_add",
           "sw7_ex2_gmres_composite_mult", "sw7_ex2_fgmres_ksppc",
           "sw9_ex2_fgmres_ksppc_specest",
           "sw9_ex2_fgmres_ksppc_specest_cg", "sw7_ex2_gmres_svd")
# the serial cases on -mat_type baij or sbaij (ROADMAP queue 1 item 9)
SLICE12 = ("sw_ex10b_cg_pbjacobi", "sw8_ex10p_sbaij_cg_icc",
           "sw8_ex10p_sbaij_cg_jacobi")
SLICE1_TYPES = ("cg", "pipecg", "groppcg", "gmres", "pgmres", "fgmres")
ALL = SLICE1 + SLICE2 + SLICE5 + SLICE6 + SLICE10 + SLICE12
SNES = ("sw_snes5_l2_m10", "sw_snes5_l4_m10", "sw_snes5_l5_m16",
        "sw_snes5_l6_m12", "sw_snes5_l3_m16_basic", "sw_snes5_l45_m12_basic",
        "sw3_snes5_l2_m14", "sw3_snes5_l55_m20", "sw3_snes5_l1_m8",
        "sw_snes14_fdcolor_l5", "sw_snes14_fdcolor_l3",
        "sw3_snes14_fdcolor_l4", "sw3_snes14_fdcolor_l2")
TS = ("sw_ts4_beuler", "sw_ts4_beuler_m40", "sw_ts4_euler_m80",
      "sw3_ts4_beuler_m80", "sw3_ts4_euler_m40", "sw3_ts4_beuler_dt",
      "sw8_ts4_cn_m60", "sw8_ts4_cn_m40")
BY_TAG = {c.tag: c for c in CASES}
# CG+SSOR on the 1-D 120-row operator, 51 its to rtol 1e-7; BiCGStab +
# SOR on the 1-D 120-row operator, 31 its to rtol 1e-5; TFQMR + Jacobi
# on ex10_nonsym, 41 its (82 entries) to rtol 1e-5
PETSC_DOT_ORDER = {"sw2_ex23_cg_sor120", "sw_ex1_bcgs_sor",
                   "sw_ex10n_tfqmr_jacobi"}
PETSC_ROW_ORDER = {"sw_ex10n_tfqmr_jacobi"}


def petsc_order_dot(a, b, axis=None):
    """aᴴb of serial vectors summed left to right, PETSc's VecDot order
    (np.add.accumulate's documented order: r[i] = r[i-1] + p[i])."""
    assert axis is None
    p = (a.conj() * b).reshape(-1).numpy()
    return torch.tensor(np.add.accumulate(p)[-1] if p.size else 0.0,
                        dtype=a.dtype)


def petsc_order_norm(a, axis=None):
    return torch.sqrt(petsc_order_dot(a, a, axis).real)


def petsc_order_mult(self, x):
    """An AIJ product with each row summed over its slots left to right
    (MatMult_SeqAIJ's order; a padding slot adds an exact zero)."""
    y = self.vals[:, 0] * x[self.cols[:, 0]]
    for k in range(1, self.vals.shape[1]):
        y = y + self.vals[:, k] * x[self.cols[:, k]]
    return y


def build_system(spec):
    """(A csr fp64, b fp64) of the oracle example (u* = 1, b = A u*)."""
    if spec.startswith("file:"):
        return build_file_system(spec)
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
    assert all(tag in BY_TAG and BY_TAG[tag].np == 1 for tag in ALL)


def test_slice6_is_every_serial_case_of_its_ksp_types():
    """SLICE6 is the whole rule: serial, a ksp type of ROADMAP queue 1
    item 7 (every registry type but slice 1's), on an ex1/ex2/ex23
    system or an ex10 datafile."""
    from petsctpu_torch.ksp.api import KSP_REGISTRY

    item7 = set(KSP_REGISTRY) - set(SLICE1_TYPES)
    rule = [c.tag for c in CASES
            if c.np == 1 and (c.sys.split(":")[0] in ("ex1", "ex2", "ex23")
                              or c.sys.startswith("file:ex10"))
            and parse_args(c.args).get("ksp_type", "gmres") in item7]
    assert sorted(rule) == sorted(SLICE6)
    assert sum(BY_TAG[t].sys.startswith("file:") for t in SLICE6) == 14


def test_slice5_is_every_case_of_its_pcs_the_port_runs():
    """SLICE5 is the whole rule: serial, AIJ, an ex1/ex2/ex23 system or
    an ex10 datafile, a slice-1 ksp type (the other types' cases are
    SLICE6), and pc ilu/icc/sor/bjacobi/asm, or -ksp_diagonal_scale
    with one of those or none/jacobi. The replay then holds 154 serial
    cases with SLICE10's and SLICE12's."""
    slice5_pcs = ("ilu", "icc", "sor", "bjacobi", "asm")

    def in_rule(c):
        f = parse_args(c.args)
        pc = f.get("pc_type", "ilu")
        return (c.np == 1 and f.get("mat_type", "aij") == "aij"
                and (c.sys.split(":")[0] in ("ex1", "ex2", "ex23")
                     or c.sys.startswith("file:ex10"))
                and f.get("ksp_type", "gmres") in SLICE1_TYPES
                and (pc in slice5_pcs or "ksp_diagonal_scale" in f
                     and pc in slice5_pcs + ("none", "jacobi")))

    rule = [c.tag for c in CASES if in_rule(c)]
    assert sorted(rule) == sorted(SLICE5)
    assert sum(BY_TAG[t].sys.startswith("file:") for t in SLICE5) == 11
    assert len(set(ALL)) == len(ALL) == 154


def test_slice10_is_every_serial_case_of_its_pcs():
    """SLICE10 is the whole rule: serial, a pc type of ROADMAP queue 1
    item 10 (the port's slice-8 types, and bddc, nn and hmpi, which
    moved to items 9 and 14: no serial case has them)."""
    from petsctpu_torch.pc.api import _SLICE8

    item10 = set(_SLICE8) | {"bddc", "nn", "hmpi"}
    rule = [c.tag for c in CASES
            if c.np == 1 and parse_args(c.args).get("pc_type") in item10]
    assert sorted(rule) == sorted(SLICE10)


def test_slice12_is_every_serial_blocked_case():
    """SLICE12 is every serial case on -mat_type baij or sbaij; with
    them the port replays all 175 serial cases (ALL, SNES and TS)."""
    rule = [c.tag for c in CASES if c.np == 1 and parse_args(c.args).get(
        "mat_type", "aij") in ("baij", "sbaij")]
    assert sorted(rule) == sorted(SLICE12)
    assert len(ALL) + len(SNES) + len(TS) == sum(c.np == 1 for c in CASES) \
        == 175


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
    assert PETSC_DOT_ORDER <= set(SLICE5 + SLICE6)


def test_petsc_order_mult_sums_rows_left_to_right():
    rng = np.random.default_rng(4)
    A = sp.random(50, 50, density=0.2, random_state=5, format="csr") \
        + sp.eye(50)
    Ad = aij_from_scipy(A.tocsr(), device="cpu")
    x = rng.standard_normal(50)
    y = petsc_order_mult(Ad, torch.from_numpy(x)).numpy()
    cols, vals = Ad.cols.numpy(), Ad.vals.numpy()
    for i in range(50):
        s = 0.0
        for k in range(cols.shape[1]):
            s = s + vals[i, k] * x[cols[i, k]]
        assert y[i] == s
    np.testing.assert_allclose(y, A @ x, rtol=1e-13)
    assert PETSC_ROW_ORDER <= PETSC_DOT_ORDER
    # the port's own product now folds in this order: the same bits
    # (up to the sign of a zero row sum, which folds from +0.0)
    np.testing.assert_array_equal(Ad.mult(torch.from_numpy(x)).numpy(), y)


def port_options(flags):
    """Options and KSPConfig of a case, with
    -ksp_chebyshev_eigenvalues a,b split into emin and emax as
    tests/test_sweep.py::build_cfg does."""
    o = dict(flags)
    ev = o.pop("ksp_chebyshev_eigenvalues", None)
    if ev is not None:
        emin, emax = (float(x) for x in ev.split(","))
        o["ksp_chebyshev_emin"] = str(emin)
        o["ksp_chebyshev_emax"] = str(emax)
    opts = Options(o)
    return opts, config_from_options(opts, KSPConfig(maxits=2000))


@pytest.mark.parametrize("tag", ALL)
def test_sweep_case_through_port(tag, monkeypatch):
    case = BY_TAG[tag]
    if tag in PETSC_DOT_ORDER:
        monkeypatch.setattr(ops, "local_dot", petsc_order_dot)
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
    if "ksp_diagonal_scale" in flags:
        # as tests/test_sweep.py::run_serial: solve the symmetrically
        # scaled system (the monitor shows the scaled norms)
        A, b, _ = diagonal_scale_system(A, b)
    opts, cfg = port_options(flags)
    if flags.get("pc_type") == "eisenstat":
        # as run_serial: the KSP runs on the transformed system's shell
        # operator (PCPreSolve/PostSolve_Eisenstat, eisen.c:55/:91)
        shell, pc, pre, _ = make_eisenstat_system(
            A, omega=float(flags.get("pc_eisenstat_omega", 1.0)),
            device="cpu")
        r = ksp_solve(shell, pre(torch.from_numpy(b)), pc=pc, cfg=cfg)
    else:
        # as run_serial: -matload_block_size is the blocked formats' bs
        bs = int(flags.get("matload_block_size", 1))
        if flags.get("mat_type") == "baij":
            Ad = baij_from_scipy_bsr(A, bs=bs, device="cpu")
        elif flags.get("mat_type") == "sbaij":
            Ad = sbaij_from_scipy(A, bs=bs, device="cpu")
        else:
            Ad = aij_from_scipy(A, device="cpu")
        pc = make_pc(flags.get("pc_type", "ilu"), A=Ad, A_host=A,
                     options=opts)
        r = ksp_solve(Ad, torch.from_numpy(b), pc=pc, cfg=cfg)
    # the reference's monitor labels: tfqmr logs two entries an
    # iteration; chebyshev's first comes after its first correction
    expected_its = {"tfqmr": len(monit) // 2, "chebyshev": len(monit)}.get(
        cfg.ksp_type, len(monit) - 1)
    if case.check == "its":
        assert int(r.its) == max(expected_its, 1), (int(r.its), len(monit))
        return
    if case.check == "its_approx":
        assert abs(int(r.its) - expected_its) <= max(1, expected_its // 33), \
            (int(r.its), expected_its)
        return
    assert case.check == "stream"
    assert int(r.its) == expected_its, (int(r.its), expected_its)
    hist = r.history[: len(monit)].numpy()
    idx = [i for i, v in enumerate(monit) if v is not None]
    vals = np.array([monit[i] for i in idx])
    np.testing.assert_allclose(hist[idx], vals, rtol=case.rtol,
                               atol=1e-11 * vals.max())


def test_snes_is_every_serial_snes_case():
    rule = [c.tag for c in CASES
            if c.np == 1 and c.check in ("snes", "snes14")]
    assert sorted(rule) == sorted(SNES) and len(SNES) == 13


def _snes_monitor(tag):
    """-snes_monitor(_short) entries; "< 1.e-11" becomes None."""
    txt = open(os.path.join(ORACLE, tag + ".txt")).read()
    return [None if "<" in m.group(1) else float(m.group(1))
            for m in re.finditer(r"SNES Function norm (\S+)", txt)]


def _snes5(case, flags, monit):
    from petsctpu_torch.dm import DA
    from petsctpu_torch.models.bratu import (bratu_initial_guess,
                                             bratu_jacobian_template,
                                             bratu_residual)
    from petsctpu_torch.snes import ColoredJacobian, snes_solve
    from petsctpu_torch.snes.api import SNESConfig

    p = dict(kv.split("=") for kv in case.sys.split(":")[1].split(","))
    m, lam = int(p["m"]), float(p["par"])
    da = DA((m, m))
    r = snes_solve(
        bratu_residual(da, lam), bratu_initial_guess(da, lam, device="cpu"),
        jac=ColoredJacobian.from_stencil(bratu_jacobian_template(
            da, device="cpu")),
        cfg=SNESConfig(rtol=float(flags.get("snes_rtol", 1e-8)), atol=1e-50,
                       linesearch="basic" if flags.get("snes_ls") == "basic"
                       else "bt"),
        ksp_cfg=KSPConfig(ksp_type="fgmres", rtol=1e-10, maxits=1000,
                          restart=200))
    monit = [v for v in monit if v is not None]
    assert int(r.its) >= len(monit) - 1, (int(r.its), len(monit) - 1)
    # the oracle's Newton is inexact (gmres + ilu, rtol 1e-5): the head
    # agrees to ~6e-4, the quadratic-limit tail is bounded, not matched
    head = max(len(monit) - 2, 1)
    np.testing.assert_allclose(r.history[:head].numpy(), monit[:head],
                               rtol=6e-4)
    for k in range(head, len(monit)):
        assert float(r.history[k]) <= 3.5 * monit[k] + 1e-11, \
            (k, float(r.history[k]), monit[k])


def _snes14(case, flags, monit):
    from petsctpu_torch.mat.ell import aij_to_scipy
    from petsctpu_torch.models.bratu import (bratu3d_fd_jacobian,
                                             bratu3d_initial_guess,
                                             bratu3d_residual)
    from petsctpu_torch.pc.factor import make_ilu
    from petsctpu_torch.snes import SNES as SNESObject

    p = dict(kv.split("=") for kv in case.sys.split(":")[1].split(","))
    m, lam = int(p["m"]), float(p["par"])
    snes = SNESObject(Options({
        "snes_rtol": flags.get("snes_rtol", "1e-8"), "ksp_type": "gmres",
        "ksp_rtol": "1e-5", "ksp_max_it": "10000"}))
    snes.set_function(bratu3d_residual(m, lam))
    snes.set_jacobian(bratu3d_fd_jacobian(m, device="cpu"))
    snes.set_pc_builder(lambda J: make_ilu(aij_to_scipy(J), levels=0,
                                           device="cpu"))
    r = snes.solve(bratu3d_initial_guess(m, lam, device="cpu"))
    hist = r.history[:int(r.its) + 1].numpy()
    assert len(hist) == len(monit), (len(hist), len(monit))
    for i, (hv, mv) in enumerate(zip(hist, monit)):
        if mv is None:                      # printed as "< 1.e-11"
            assert hv < 1e-11, (i, hv)
        elif i == len(hist) - 1:
            # the last entry sits at the quadratic limit, where the FD
            # Jacobian's own O(√eps) error dominates
            np.testing.assert_allclose(hv, mv, rtol=5e-3)
        else:
            np.testing.assert_allclose(hv, mv, rtol=3e-5)


@pytest.mark.parametrize("tag", SNES)
def test_snes_sweep_case_through_port(tag):
    case = BY_TAG[tag]
    flags = parse_args(case.args)
    monit = _snes_monitor(tag)
    (_snes5 if case.check == "snes" else _snes14)(case, flags, monit)


def test_ts_is_every_serial_ts_ex4_case():
    rule = [c.tag for c in CASES if c.np == 1 and c.sys.startswith("ts_ex4:")]
    assert sorted(rule) == sorted(TS) and len(TS) == 8
    assert all(BY_TAG[tag].check == "ts" for tag in TS)


@pytest.mark.parametrize("tag", TS)
def test_ts_sweep_case_through_port(tag):
    """ts ex4's 1-D heat equation (RHS matrix with unit boundary rows,
    u0 = sin(6πx) + 3 sin(2πx), dt = h²/2) replayed as
    tests/test_sweep.py::run_ts_ex4 does, in one integration."""
    from petsctpu_torch.ts import ts_solve
    from petsctpu_torch.ts.steppers import TSConfig

    case = BY_TAG[tag]
    flags = parse_args(case.args)
    m = int(dict(kv.split("=") for kv in
                 case.sys.split(":")[1].split(","))["m"])
    txt = open(os.path.join(ORACLE, tag + ".txt")).read()
    rows = [(float(mm.group(1)), float(mm.group(2)), float(mm.group(3)))
            for mm in re.finditer(
                r"Timestep \d+: time = (\S+) 2-norm error = (\S+) "
                r"max norm error = (\S+)", txt)]
    assert rows, "no oracle Timestep stream"
    h = 1.0 / (m - 1)
    x = np.arange(m) * h
    u0 = np.sin(6 * np.pi * x) + 3.0 * np.sin(2 * np.pi * x)

    def exact(tt):
        return (np.exp(-36 * np.pi ** 2 * tt) * np.sin(6 * np.pi * x)
                + 3 * np.exp(-4 * np.pi ** 2 * tt) * np.sin(2 * np.pi * x))

    s1 = 1.0 / h ** 2
    A = sp.diags([s1 * np.ones(m - 1), -2 * s1 * np.ones(m),
                  s1 * np.ones(m - 1)], [-1, 0, 1]).tolil()
    A[0, :] = 0.0
    A[0, 0] = 1.0
    A[m - 1, :] = 0.0
    A[m - 1, m - 1] = 1.0
    Ad = torch.from_numpy(sp.csr_matrix(A).toarray())
    dt = h * h / 2.0
    states = [(0.0, u0)]
    ts_solve(lambda t_, u: Ad @ u, torch.from_numpy(u0),
             cfg=TSConfig(ts_type=flags.get("ts_type", "euler"), dt=dt,
                          max_steps=len(rows) - 1, max_time=1.0),
             post_step=lambda k, tt, u: states.append((float(tt),
                                                       u.numpy().copy())))
    assert len(states) == len(rows)
    for k, ((t_ref, e2_ref, emax_ref), (tk, u)) in enumerate(zip(rows,
                                                                 states)):
        err = u - exact(k * dt)
        e2 = np.sqrt(h) * np.linalg.norm(err)
        emax = np.abs(err).max()
        assert abs(k * dt - t_ref) <= 1e-5 * max(t_ref, 1e-9)
        assert abs(tk - t_ref) <= 1e-5 * max(t_ref, 1e-9)
        assert abs(e2 - e2_ref) <= 2e-5 * max(e2_ref, 1e-12) + 1e-12, \
            (k, e2, e2_ref)
        assert abs(emax - emax_ref) <= 2e-5 * max(emax_ref, 1e-12) \
            + 1e-12, (k, emax, emax_ref)


# ---------------------------------------------------------------------------
# np > 1: the port's distributed path (slice 14)
# ---------------------------------------------------------------------------
NP = tuple(c.tag for c in CASES if c.np > 1)
_WORLDS = {}


@pytest.fixture(autouse=True, scope="module")
def _close_worlds():
    yield
    for w in _WORLDS.values():
        w.close()
    _WORLDS.clear()


def world(nranks: int):
    """One World of CPU rank threads (gloo groups) of each size, closed
    when the module's tests end."""
    from petsctpu_torch.parallel import World

    w = _WORLDS.get(nranks)
    if w is None or w.closed:
        w = _WORLDS[nranks] = World(nranks, "cpu", timeout=60.0)
    return w


def test_np_is_every_distributed_case():
    """With the 25 np > 1 cases the port replays all 200."""
    assert len(NP) == 25 and len(NP) + 175 == len(CASES) == 200
    assert {BY_TAG[t].np for t in NP} == {2, 4, 8}


@pytest.mark.parametrize("tag", NP)
def test_np_sweep_case_through_port(tag):
    """An np > 1 case over np CPU rank threads, as
    tests/test_sweep.py::run_distributed (the default halo style, the
    ELL product, -pc_type jacobi or per-rank block Jacobi ILU(0)/LU)
    and ::run_snes_ex5_np (the sharded Bratu residual, the sharded
    colored-FD Jacobian, FGMRES steps) hold petsctpu: the oracle is the
    serial equivalent of the np-rank default (-pc_bjacobi_blocks np),
    its iterations exact and the stream within the case's rtol."""
    from petsctpu_torch.parallel import par_ksp_solve, sharded_aij_from_scipy
    from petsctpu_torch.pc.parallel import make_par_pc

    case = BY_TAG[tag]
    flags = parse_args(case.args)
    w = world(case.np)
    if case.check == "snes_np":
        _snes5_np(case, flags, w)
        return
    monit = oracle_stream(case.tag)
    A, b = build_system(case.sys)
    opts, cfg = port_options(flags)
    Ash, part = sharded_aij_from_scipy(A, case.np, device="cpu")
    pc = make_par_pc(flags.get("pc_type", "jacobi"), Ash, part,
                     options=opts)
    r = par_ksp_solve(w, Ash, b, pc=pc, cfg=cfg)
    expected_its = {"tfqmr": len(monit) // 2}.get(cfg.ksp_type,
                                                  len(monit) - 1)
    if case.check == "its":
        assert int(r.its) == max(expected_its, 1), (int(r.its), len(monit))
        return
    assert case.check == "stream"
    assert int(r.its) == expected_its, (int(r.its), expected_its)
    hist = r.history[: len(monit)].numpy()
    idx = [i for i, v in enumerate(monit) if v is not None]
    vals = np.array([monit[i] for i in idx])
    np.testing.assert_allclose(hist[idx], vals, rtol=case.rtol,
                               atol=1e-11 * vals.max())


def _snes5_np(case, flags, w):
    from petsctpu_torch.dm import DA
    from petsctpu_torch.models.bratu import (bratu_initial_guess,
                                             bratu_residual_sharded)
    from petsctpu_torch.parallel import ShardedFDJac, par_snes_solve
    from petsctpu_torch.snes.api import SNESConfig

    p = dict(kv.split("=") for kv in case.sys.split(":")[1].split(","))
    m, lam = int(p["m"]), float(p["par"])
    monit = [v for v in _snes_monitor(case.tag) if v is not None]
    da = DA((m, m))
    Fp, _ = bratu_residual_sharded(da, case.np, lam=lam)
    star5 = ((0, 0), (-1, 0), (1, 0), (0, -1), (0, 1))
    r = par_snes_solve(
        w, Fp, bratu_initial_guess(da, lam, device="cpu").numpy(),
        jac=ShardedFDJac.plan((m, m), star5, case.np, device="cpu"),
        cfg=SNESConfig(rtol=float(flags.get("snes_rtol", 1e-8)), atol=1e-50),
        ksp_cfg=KSPConfig(ksp_type="fgmres", rtol=1e-10, maxits=1000,
                          restart=200))
    assert int(r.its) >= len(monit) - 1, (int(r.its), len(monit) - 1)
    head = max(len(monit) - 2, 1)
    np.testing.assert_allclose(r.history[:head].numpy(), monit[:head],
                               rtol=6e-4)
    for k in range(head, len(monit)):
        assert float(r.history[k]) <= 3.5 * monit[k] + 1e-11, \
            (k, float(r.history[k]), monit[k])


def test_ex2_2_bjacobi_two_ranks():
    """tests/test_golden.py::test_ex2_2_bjacobi_two_ranks run truly over
    two ranks: output/ex2_2.out (makefile:322: mpiexec -n 2), GMRES +
    per-rank ILU(0) block Jacobi on the 13/12-row PETSC_DECIDE split of
    -m 5 -n 5, against the same golden digits."""
    from petsctpu_torch.parallel import (par_ksp_solve,
                                         sharded_aij_from_scipy,
                                         unshard_vector)
    from petsctpu_torch.pc.parallel import make_par_pc

    A, b, u = ex2_system(5, 5)
    Ash, part = sharded_aij_from_scipy(sp.csr_matrix(A), 2, device="cpu")
    assert [D.shape[0] - (part.layout.n_padded - part.layout.n) * (p == 1)
            for p, D in enumerate(part.diag_blocks)] == [13, 12]
    r = par_ksp_solve(world(2), Ash, np.asarray(b),
                      pc=make_par_pc("bjacobi", Ash, part), ksp_type="gmres",
                      rtol=1e-2 / 36, atol=1e-50, cgs_refine="always")
    golden = [2.73499, 0.795482, 0.261984, 0.0752998, 0.0230031,
              0.00521255, 0.00145783, 0.000277319]
    assert int(r.its) == 7
    np.testing.assert_allclose(r.history[:8].numpy(), golden, rtol=2e-5)
    np.testing.assert_allclose(
        np.linalg.norm(unshard_vector(r.x, part.layout) - u), 0.000292349,
        rtol=1e-3)
