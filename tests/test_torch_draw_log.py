"""The port's draw (petsctpu_torch/core/draw.py) and the rest of its
logging (core/logging.py) against petsctpu's (tests/test_vecnest_draw.py's
draw part, tests/test_logging.py).

* ascii_lg and ascii_contour: the reference's strings, character for
  character, on the same history and grid;
* -ksp_monitor_draw through KSP prints ascii_lg of the solve's history;
* log_view: the reference's table on the same events (stages, names,
  counts, GFlop, Mess, MessMB), apart from the times and what is
  computed from them;
* the flop models equal; log_trace, stages and info_enabled as there;
* log_comm: the collectives a distributed CG books (counted at run time
  on a 2-rank World) against petsctpu's compile-time audit of the same
  program at 2 ranks: per iteration equal, the once part as the run
  made it.
"""

import re

import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse as sp
import torch

from petsctpu.core import draw as rdraw
from petsctpu.core import logging as rlog

from petsctpu_torch.core import draw as tdraw
from petsctpu_torch.core import logging as tlog
from petsctpu_torch.core.options import Options
from petsctpu_torch.ksp import KSP, ksp_solve
from petsctpu_torch.mat import aij_from_scipy
from petsctpu_torch.models import ex2_system

# one intra-op thread: the suite runs in parallel workers (pytest -n), and
# PyTorch's default of a thread a core oversubscribes the host's cores
torch.set_num_threads(1)


def _history():
    h = np.full(20, np.nan)
    h[:11] = 10.0 ** (-np.arange(11, dtype=float))
    return h


HISTORIES = {
    "decade": _history(),
    "flat": np.full(5, 3.0),
    "empty": np.full(4, np.nan),
    "long": np.geomspace(1.0, 1e-9, 300) * (1 + 0.3 * np.sin(np.arange(300))),
}


@pytest.mark.parametrize("name", sorted(HISTORIES))
@pytest.mark.parametrize("width,height", ((60, 16), (30, 8)))
def test_ascii_lg_equals_reference(name, width, height):
    h = HISTORIES[name]
    txt = tdraw.ascii_lg(h, width=width, height=height)
    assert txt == rdraw.ascii_lg(h, width=width, height=height)
    assert tdraw.ascii_lg(torch.from_numpy(h), width=width,
                          height=height) == txt
    if name == "decade":
        assert "its=10" in txt and "*" in txt and "1.000e-10" in txt


def test_ascii_contour_equals_reference():
    x = np.linspace(-2, 2, 40)
    G = np.exp(-(x[:, None] ** 2 + x[None, :] ** 2))
    s = tdraw.ascii_contour(G, width=30, height=12)
    assert s == rdraw.ascii_contour(G, width=30, height=12)
    lines = s.splitlines()
    assert len(lines) == 13 and "@" in lines[6] and "@" not in lines[0]
    assert tdraw.ascii_contour(np.ones(64), width=10, height=4) == \
        rdraw.ascii_contour(np.ones(64), width=10, height=4)
    rng = np.random.default_rng(0)
    R = rng.standard_normal((17, 23))
    assert tdraw.ascii_contour(torch.from_numpy(R)) == rdraw.ascii_contour(R)


def test_png_save(tmp_path):
    p = str(tmp_path / "lg.png")
    ok = tdraw.save_lg_png(_history(), p)
    assert ok == rdraw.save_lg_png(_history(), str(tmp_path / "r.png"))
    if ok:                                    # matplotlib gated
        assert (tmp_path / "lg.png").stat().st_size > 1000
    assert tdraw.save_lg_png(np.full(3, np.nan), p) is False


def test_monitor_draw_through_ksp(capsys):
    """-ksp_monitor_draw (ksp/api.py): after the solve, the ASCII graph
    of its history, the reference's string for that history; the
    reference's own KSP prints its graph the same way."""
    from petsctpu.core.options import Options as ROptions
    from petsctpu.ksp import KSP as RKSP
    from petsctpu.mat import aij_from_scipy as r_aij

    A, b, _ = ex2_system(6, 6)
    opts = {"ksp_type": "cg", "pc_type": "jacobi", "ksp_rtol": "1e-8",
            "ksp_monitor_draw": None}
    ksp = KSP(options=Options(dict(opts)))
    ksp.set_operators(aij_from_scipy(A, device="cpu"), A_host=A)
    res = ksp.solve(torch.from_numpy(b))
    out = capsys.readouterr().out
    txt = rdraw.ascii_lg(res.history.numpy())
    assert out == txt + "\n"
    assert f"its={int(res.its)}" in out
    rk = RKSP(options=ROptions(dict(opts)))
    rk.set_operators(r_aij(A), A_host=A)
    rres = rk.solve(jnp.asarray(b))
    rout = capsys.readouterr().out
    assert int(rres.its) == int(res.its)
    assert rout.splitlines()[0] == out.splitlines()[0]
    assert tdraw.monitor_draw(res, echo=False) == txt


def _solve_logged(mod, solve):
    """Run `solve` with mod's logger on and a stage pushed around part
    of it; return mod's table."""
    mod.log_begin()
    try:
        mod.stage_push("Assembly")
        with mod.log_event("MatSetValues", flops=12.0, bytes=96.0):
            pass
        mod.log_flops("MatSetValues", 4.0)
        mod.stage_pop()
        solve()
        mod.log_comm("Halo", 3, 4096.0)
        return mod.log_view()
    finally:
        mod._state.enabled = False


def _rows(table):
    """{(stage, name): (count, GFlop, Mess, MessMB)} of a log_view
    table; the time columns (Time, %T, GF/s, GB/s) dropped."""
    rows, stage = {}, None
    for line in table.splitlines():
        m = re.match(r"--- stage: (.*)$", line)
        if m:
            stage = m.group(1)
            continue
        parts = line.split()
        if stage is None or len(parts) < 9 or not parts[1].isdigit():
            continue
        name = " ".join(parts[:-8])
        c, _, _, gf, _, _, mess, mb = parts[-8:]
        rows[(stage, name)] = (int(c), gf, mess, mb)
    return rows


def test_log_view_equals_reference_apart_from_times():
    from petsctpu.ksp import ksp_solve as r_ksp_solve
    from petsctpu.mat import aij_from_scipy as r_aij
    from petsctpu.pc import make_pc as r_make_pc

    from petsctpu_torch.pc import make_pc

    A, b, _ = ex2_system(6, 6)
    Ar = r_aij(A)
    At = aij_from_scipy(A, device="cpu")
    rt = _solve_logged(rlog, lambda: r_ksp_solve(
        Ar, jnp.asarray(b), pc=r_make_pc("jacobi", A=Ar), ksp_type="cg",
        rtol=1e-8))
    tt = _solve_logged(tlog, lambda: ksp_solve(
        At, torch.from_numpy(b), pc=make_pc("jacobi", A=At), ksp_type="cg",
        rtol=1e-8))
    assert tt.splitlines()[1] == rt.splitlines()[1]
    assert tt.splitlines()[4] == rt.splitlines()[4]     # the header
    assert _rows(tt) == _rows(rt)
    rows = _rows(tt)
    assert ("Main", "KSPSolve[cg]") in rows and ("Main", "MatMult") in rows
    assert rows[("Assembly", "MatSetValues")][0] == 1
    assert rows[("Main", "Halo")][2:] == ("3", "0.004")
    assert tlog.log_events() is tlog._state.events


def test_flop_models_trace_and_info(capsys):
    for args in ((100,), (100, 7), (0,)):
        assert tlog.spmv_flops(*args) == rlog.spmv_flops(*args)
    for n in (0, 5, 1000):
        assert tlog.dot_flops(n) == rlog.dot_flops(n)
        assert tlog.axpy_flops(n) == rlog.axpy_flops(n)
    tlog._state.enabled = False
    try:
        tlog.log_trace(True)
        assert tlog.log_enabled()
        with tlog.log_event("Traced"):
            pass
        out = capsys.readouterr().out
        assert "Event begin: Traced [Main]" in out
        assert "Event end:   Traced [Main]" in out
    finally:
        tlog.log_trace(False)
        tlog._state.enabled = False
    tlog.info_on(True)
    assert tlog.info_enabled()
    tlog.info_on(False)
    assert not tlog.info_enabled()


def test_log_comm_of_a_distributed_cg_equals_reference_audit():
    """par_ksp_solve with logging on books, under KSPSolve_cg, the
    collectives rank 0 made in the solve (count and bytes, counted at
    run time); petsctpu books once + its × per_iteration of its jaxpr
    audit of the same program (parallel/api.py:108). On a 2-rank CG +
    Jacobi: equal its, the port's ledger equal to what rank 0 made, and
    the per-iteration part equal to petsctpu's audit; the two ledgers
    differ only by their once part (the jaxpr counts collectives of both
    branches of a cond, the run those of the branch it takes)."""
    import jax
    from jax.sharding import Mesh

    from petsctpu.core import commaudit as rcommaudit
    from petsctpu.parallel import par_ksp_solve as r_par_ksp_solve
    from petsctpu.parallel import sharded_aij_from_scipy as r_sharded
    from petsctpu.pc.parallel import make_par_pc as r_make_par_pc

    from petsctpu_torch.parallel import (World, par_ksp_solve,
                                         sharded_aij_from_scipy)
    from petsctpu_torch.parallel.api import audit_par_ksp
    from petsctpu_torch.pc.parallel import make_par_pc

    P = 2
    A, b, _ = ex2_system(10, 8)
    A = sp.csr_matrix(A)
    R, rpart = r_sharded(A, P)
    mesh = Mesh(np.array(jax.devices()[:P]), ("rows",))
    rcommaudit.COMM_AUDITS.clear()
    rlog.log_begin()
    try:
        rr = r_par_ksp_solve(mesh, R, b, pc=r_make_par_pc(
            "jacobi", R, rpart), ksp_type="cg", rtol=1e-8)
        rev = rlog._state.events[("Main", "KSPSolve_cg")]
    finally:
        rlog._state.enabled = False
    (ra,) = [a for a in rcommaudit.COMM_AUDITS.values() if a is not None]
    with World(P, "cpu") as w:
        T, part = sharded_aij_from_scipy(A, P, device="cpu")
        pc = make_par_pc("jacobi", T, part)
        w.reset_counts()
        tlog.log_begin()
        try:
            rt = par_ksp_solve(w, T, b, pc=pc, ksp_type="cg", rtol=1e-8)
            tev = tlog.log_events()["KSPSolve_cg"]
        finally:
            tlog._state.enabled = False
        made = {k: list(v) for k, v in w.comms[0].counts.items()}
        ta = audit_par_ksp(w, T, b, pc=pc, ksp_type="cg")
    its = int(rt.its)
    assert its == int(rr.its)
    assert tev.msgs == sum(c[0] for c in made.values())
    assert tev.msg_bytes == sum(c[1] for c in made.values())
    assert ta.per_iteration.counts == ra.per_iteration.counts
    assert ta.per_iteration.bytes == ra.per_iteration.bytes
    assert rev.msgs == ra.once.total_count + its * ra.per_iteration.total_count
    assert tev.msgs == ta.once.total_count + its * ta.per_iteration.total_count
    assert tev.msg_bytes == ta.once.total_bytes \
        + its * ta.per_iteration.total_bytes
    assert rev.msgs - tev.msgs == ra.once.total_count - ta.once.total_count
