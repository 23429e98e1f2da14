"""The 13 example CLIs of the port (petsctpu_torch/examples) against the
reference's (examples/*.py, loaded by path), on the same argv.

Each port CLI runs as main(argv, device="cpu") and each reference CLI as
its main(argv) (ex_elasticity and ex_stokes read sys.argv). Their
printed lines are compared token by token: words and integers
(iteration counts, reasons, sizes) exactly, every other number within
the bound that the case states (`rtol` of the larger, or `atol`):

* 1e-5 relative by default: %g and %.3e print 4-6 digits, so a
  difference in the last ulps of a residual can move the last digit;
* ex39: its CG's true residual ‖HᴴH x − Hᵀb‖ is rounding noise below the
  solve's tolerance, so it is held within that tolerance, 1e-6·‖Hᵀb‖
  (1.44e-6 at -size 6), not digit for digit.

ex10 runs on all four tests/data/*.bin and on a scrambled 18³ 7-point
grid written by the port's writer with -mat_type auto (the grid
recovery and a StencilMat on both sides).
"""

import contextlib
import importlib
import importlib.util
import io
import os
import re
import sys

import numpy as np
import pytest
import scipy.sparse as sp
import torch

# one intra-op thread: the suite runs in parallel workers (pytest -n), and
# PyTorch's default of a thread a core oversubscribes the host's cores
torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DATA = os.path.join(ROOT, "tests", "data")
RTOL = 1e-5

# name -> (argv, {number position: atol}); the reference CLIs' golden runs
CASES = {
    "ex2": ["-ksp_monitor_short", "-m", "5", "-n", "5",
            "-ksp_gmres_cgs_refinement_type", "refine_always"],
    "ex45": ["-da_grid", "9", "-ksp_type", "cg", "-pc_type", "mg"],
    "ex9": ["-t", "2", "-pc_type", "jacobi", "-ksp_monitor_short",
            "-ksp_type", "gmres", "-ksp_gmres_cgs_refinement_type",
            "refine_always", "-s2_ksp_type", "bcgs", "-s2_pc_type",
            "jacobi", "-s2_ksp_monitor_short"],
    "ex11_complex": ["-n", "6", "-norandom", "-pc_type", "none",
                     "-ksp_monitor_short", "-ksp_gmres_cgs_refinement_type",
                     "refine_always"],
    "ex39_lattice": ["-size", "6"],
    "ex5": ["-da_grid_x", "9", "-da_grid_y", "9", "-snes_monitor"],
    "ex5_fas": ["-da_grid_x", "17", "-da_grid_y", "17", "-fas_levels", "3"],
    "ex19": ["-da_grid", "8", "-snes_monitor_short"],
    "ex12_plex": ["-cells", "8", "-ksp_type", "cg", "-pc_type", "gamg"],
    "ex22_imex": ["-da_grid_x", "20"],
    "ex_elasticity": ["-mx", "8", "-my", "4"],
    "ex_stokes": ["-m", "6"],
    "ex10": ["-f", os.path.join(DATA, "ex10_poisson.bin"), "-ksp_type", "cg",
             "-pc_type", "jacobi", "-ksp_rtol", "1e-8"],
}
# the absolute bound of ex39's printed residual (the last number of its
# last line): the solve's tolerance
ATOL = {"ex39_lattice": 1e-6 * 1.436141}

EX10_FILES = {
    "ex10_poisson": ["-ksp_type", "cg", "-pc_type", "jacobi"],
    "ex10_nonsym": ["-ksp_type", "gmres", "-pc_type", "ilu"],
    "ex10_baij3": ["-mat_type", "baij", "-mat_block_size", "3",
                   "-ksp_type", "gmres", "-pc_type", "jacobi"],
    "ex39_H": ["-ksp_type", "gmres", "-pc_type", "none"],
}

_NUM = re.compile(r"[-+]?(\d+\.\d*|\.\d+|\d+)([eE][-+]?\d+)?")


def reference(name):
    spec = importlib.util.spec_from_file_location(
        f"reference_examples_{name}", os.path.join(ROOT, "examples",
                                                   f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def run(fn, argv):
    """stdout of fn(), with sys.argv set as a CLI would see it."""
    buf = io.StringIO()
    old = sys.argv
    sys.argv = ["cli"] + list(argv)
    try:
        with contextlib.redirect_stdout(buf):
            out = fn()
    finally:
        sys.argv = old
    return buf.getvalue(), out


def both(name, argv):
    ref = reference(name)
    port = importlib.import_module(f"petsctpu_torch.examples.{name}")
    rtext, _ = run((lambda: ref.main()) if name in ("ex_elasticity",
                                                    "ex_stokes")
                   else (lambda: ref.main(argv)), argv)
    ttext, res = run(lambda: port.main(argv, device="cpu"), argv)
    return rtext, ttext, res


def assert_same_output(rtext, ttext, atol_last=None):
    """Token by token: words and integers exactly, other numbers within
    RTOL of the larger (the last number within atol_last if given)."""
    rl, tl = rtext.splitlines(), ttext.splitlines()
    assert len(rl) == len(tl) and rl, (rtext, ttext)
    for k, (r, t) in enumerate(zip(rl, tl)):
        rn, tn = _NUM.findall(r), _NUM.findall(t)
        assert _NUM.sub("#", r) == _NUM.sub("#", t), (r, t)
        assert len(rn) == len(tn)
        for j, (a, b) in enumerate(zip(rn, tn)):
            a, b = "".join(a), "".join(b)
            if a.lstrip("+-").isdigit() or b.lstrip("+-").isdigit():
                assert a == b, (r, t)
                continue
            x, y = float(a), float(b)
            last = k == len(rl) - 1 and j == len(rn) - 1
            if last and atol_last is not None:
                assert abs(x) <= atol_last and abs(y) <= atol_last, (r, t)
            else:
                assert abs(x - y) <= RTOL * max(abs(x), abs(y)), (r, t)


@pytest.mark.parametrize("name", sorted(CASES))
def test_cli_prints_what_the_reference_prints(name):
    rtext, ttext, res = both(name, CASES[name])
    assert_same_output(rtext, ttext, ATOL.get(name))
    assert res is not None


def test_cli_iteration_counts_and_reasons():
    """The solve results behind the printed lines: ex2's GMRES 4 its
    (output/ex2_1.out), ex11's 6 its, ex39's converged CG."""
    _, _, r = both("ex2", CASES["ex2"])
    assert int(r.its) == 4 and int(r.reason) > 0
    _, _, r = both("ex11_complex", CASES["ex11_complex"])
    assert int(r.its) == 6
    rtext, _, r = both("ex39_lattice", CASES["ex39_lattice"])
    assert f"reason {int(r.reason)}, its {int(r.its)}," in rtext


@pytest.mark.parametrize("name", sorted(EX10_FILES))
def test_ex10_on_every_data_file(name):
    argv = ["-f", os.path.join(DATA, f"{name}.bin")] + EX10_FILES[name]
    rtext, ttext, run10 = both("ex10", argv)
    assert_same_output(rtext, ttext)
    assert int(run10.res.reason) > 0


def test_ex10_auto_on_a_scrambled_grid(tmp_path):
    """A scrambled 18³ 7-point operator written by the port's writer:
    -mat_type auto recovers the grid on both sides (petsctpu off the
    TPU; the port's CPU tree) and solves in the recovered order."""
    from petsctpu_torch.io import petsc_binary_write_mat
    from petsctpu_torch.models import ex45_system

    A = ex45_system(18, 18, 18)[0].tocsr()
    p = np.random.default_rng(5).permutation(A.shape[0])
    As = sp.csr_matrix(A[p][:, p])
    path = str(tmp_path / "grid18.bin")
    petsc_binary_write_mat(path, As)
    argv = ["-f", path, "-mat_type", "auto", "-ksp_type", "cg",
            "-pc_type", "jacobi", "-ksp_rtol", "1e-8"]
    rtext, ttext, r = both("ex10", argv)
    assert_same_output(rtext, ttext)
    assert type(r.M).__name__ == "StencilMat" and r.perm is not None
    assert r.rnorm <= 1e-7 * np.linalg.norm(r.b)


def test_ex10_usage_without_a_file():
    rtext, ttext, r = both("ex10", [])
    assert rtext == ttext and "usage" in ttext and r is None
