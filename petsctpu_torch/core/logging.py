"""Event logging, flop accounting, the -log_summary table and the -info
channel.

Counterpart of petsctpu/core/logging.py: the reference's
PetscLogEventBegin/End (include/petsclog.h:294; src/sys/logging/plog.c)
as `log_event`, the analytic flop ledger `log_flops` (SpMV counts
2*nnz - nrows, aij.c:1219) with its flop models, the collective ledger
`log_comm` (the Mess/MessLen columns), stages (`stage_push/pop`),
-log_trace, the PetscLogView table `log_view`, and PetscInfo
(src/sys/info/verboseinfo.c) as `petsc_info`.

Kernels run asynchronously on the card, so a timed event synchronises
the current CUDA device on entry and exit. The logger is process-global,
mirroring the reference's global state, except on the rank threads of a
parallel.comm.World: there each rank's events go to the RankCounters
bound to its thread (core/rankctx).
"""

from __future__ import annotations

import sys
import time
from contextlib import contextmanager
from dataclasses import dataclass, field

import torch

from petsctpu_torch.core import rankctx


@dataclass
class EventStats:
    count: int = 0
    time: float = 0.0
    flops: float = 0.0
    bytes: float = 0.0
    msgs: float = 0.0        # collective-op count
    msg_bytes: float = 0.0   # collective payload bytes a rank


@dataclass
class _LogState:
    enabled: bool = False
    trace: bool = False
    # stage -> (name -> EventStats), stages in the order first logged
    staged: dict = field(default_factory=lambda: {"Main": {}})
    stages: list = field(default_factory=lambda: ["Main"])
    t0: float = 0.0

    @property
    def events(self) -> dict:
        """The Main stage's table (name -> EventStats)."""
        return self.staged["Main"]


_state = _LogState()


def log_begin() -> None:
    """Enable logging (reference: PetscLogBegin plog.c:286)."""
    _state.enabled = True
    _state.staged = {"Main": {}}
    _state.t0 = time.perf_counter()


def log_enabled() -> bool:
    return _state.enabled


def log_trace(flag: bool = True) -> None:
    """-log_trace analog (plog.c:368): stream every event begin/end for
    hang diagnosis. Implies logging enabled."""
    if flag and not _state.enabled:
        log_begin()
    _state.trace = flag


def stage_push(name: str) -> None:
    _state.stages.append(name)


def stage_pop() -> None:
    if len(_state.stages) > 1:
        _state.stages.pop()


def log_events() -> dict:
    """The event table this thread writes: its rank's on a World's
    rank thread, else the process's table of the current stage."""
    mine = rankctx.current()
    if mine is not None:
        return mine.events
    return _state.staged.setdefault(_state.stages[-1], {})


def _sync():
    if torch.cuda.is_available() and torch.cuda.is_initialized():
        torch.cuda.synchronize()


@contextmanager
def log_event(name: str, flops: float = 0.0, bytes: float = 0.0):
    """Time a region and accrue flops/bytes under `name`."""
    if not _state.enabled:
        yield
        return
    _sync()
    t = time.perf_counter()
    if _state.trace:
        print(f"Event begin: {name} [{_state.stages[-1]}] "
              f"t={t - _state.t0:.6f}", flush=True)
    yield
    _sync()
    dt = time.perf_counter() - t
    if _state.trace:
        print(f"Event end:   {name} [{_state.stages[-1]}] dt={dt:.6f}",
              flush=True)
    ev = log_events().setdefault(name, EventStats())
    ev.count += 1
    ev.time += dt
    ev.flops += flops
    ev.bytes += bytes


def log_flops(name: str, flops: float, bytes: float = 0.0) -> None:
    """Accrue flops without timing (for fused regions)."""
    if not _state.enabled:
        return
    ev = log_events().setdefault(name, EventStats())
    ev.flops += flops
    ev.bytes += bytes


def log_comm(name: str, msgs: float, msg_bytes: float = 0.0) -> None:
    """Accrue collective counts/volume under an event — the
    reference's Mess/MessLen/Reductions ledger (petsclog.h:294; the
    columns PetscLogView prints at plog.c:1264). The distributed solve
    books the collectives its rank 0 made, counted at run time
    (parallel/api.py)."""
    if not _state.enabled:
        return
    ev = log_events().setdefault(name, EventStats())
    ev.msgs += msgs
    ev.msg_bytes += msg_bytes


def log_view() -> str:
    """Format a -log_summary-style table (reference: PetscLogView
    plog.c:1264) of the process's events, stage by stage."""
    total = time.perf_counter() - _state.t0
    lines = []
    lines.append("-" * 105)
    lines.append("petsctpu performance summary (-log_summary analog)")
    lines.append(f"Total wall time: {total:.4e} s")
    lines.append("-" * 105)
    lines.append(f"{'Stage/Event':34s} {'Count':>7s} {'Time (s)':>11s} "
                 f"{'%T':>5s} {'GFlop':>9s} {'GF/s':>8s} {'GB/s':>8s} "
                 f"{'Mess':>7s} {'MessMB':>8s}")
    lines.append("-" * 105)
    for stage, table in _state.staged.items():
        if not table:
            continue
        lines.append(f"--- stage: {stage}")
        for name, ev in sorted(table.items(), key=lambda r: -r[1].time):
            gf = ev.flops / 1e9
            gfs = gf / ev.time if ev.time > 0 else 0.0
            gbs = ev.bytes / 1e9 / ev.time if ev.time > 0 else 0.0
            pct = 100.0 * ev.time / total if total > 0 else 0.0
            lines.append(f"{name:34s} {ev.count:7d} {ev.time:11.4e} "
                         f"{pct:5.1f} {gf:9.3f} {gfs:8.2f} {gbs:8.2f} "
                         f"{ev.msgs:7.0f} {ev.msg_bytes/1e6:8.3f}")
    lines.append("-" * 105)
    return "\n".join(lines)


# ---- analytic flop models (static nnz known at plan time) -------------------
def spmv_flops(nnz: int, nrows_nonzero: int = None) -> float:
    """Reference convention: 2*nnz - nonzero_rows (aij.c:1219)."""
    if nrows_nonzero is None:
        return 2.0 * nnz
    return 2.0 * nnz - nrows_nonzero


def dot_flops(n: int) -> float:
    return 2.0 * n


def axpy_flops(n: int) -> float:
    return 2.0 * n


# ---------------------------------------------------------------------------
# -info verbose channel (PetscInfo, src/sys/info/verboseinfo.c)
# ---------------------------------------------------------------------------
_INFO = False


def info_on(flag: bool = True) -> None:
    """PetscInfoAllow analog: enable the -info verbose stream."""
    global _INFO
    _INFO = bool(flag)


def info_enabled() -> bool:
    return _INFO


def petsc_info(func: str, msg: str) -> None:
    """PetscInfo analog: '[0] Func(): message' lines on stderr
    documenting setup-time decisions."""
    if _INFO:
        print(f"[0] {func}(): {msg}", file=sys.stderr, flush=True)
