"""Event logging, flop accounting and the -info channel.

The part of petsctpu/core/logging.py that the solve path calls: the
reference's PetscLogEventBegin/End (include/petsclog.h:294;
src/sys/logging/plog.c) as `log_event`, the analytic flop ledger
`log_flops` (SpMV counts 2*nnz - nrows, aij.c:1219), and PetscInfo
(src/sys/info/verboseinfo.c) as `petsc_info`.

Kernels run asynchronously on the card, so a timed event synchronises
the current CUDA device on entry and exit. The logger is
process-global, mirroring the reference's global state.
"""

from __future__ import annotations

import sys
import time
from contextlib import contextmanager
from dataclasses import dataclass, field

import torch


@dataclass
class EventStats:
    count: int = 0
    time: float = 0.0
    flops: float = 0.0
    bytes: float = 0.0


@dataclass
class _LogState:
    enabled: bool = False
    events: dict = field(default_factory=dict)     # name -> EventStats


_state = _LogState()


def log_begin() -> None:
    """Enable logging (reference: PetscLogBegin plog.c:286)."""
    _state.enabled = True
    _state.events.clear()


def log_enabled() -> bool:
    return _state.enabled


def log_events() -> dict:
    return _state.events


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
    yield
    _sync()
    ev = _state.events.setdefault(name, EventStats())
    ev.count += 1
    ev.time += time.perf_counter() - t
    ev.flops += flops
    ev.bytes += bytes


def log_flops(name: str, flops: float, bytes: float = 0.0) -> None:
    """Accrue flops without timing (for fused regions)."""
    if not _state.enabled:
        return
    ev = _state.events.setdefault(name, EventStats())
    ev.flops += flops
    ev.bytes += bytes


# ---------------------------------------------------------------------------
# -info verbose channel (PetscInfo, src/sys/info/verboseinfo.c)
# ---------------------------------------------------------------------------
_INFO = False


def info_on(flag: bool = True) -> None:
    """PetscInfoAllow analog: enable the -info verbose stream."""
    global _INFO
    _INFO = bool(flag)


def petsc_info(func: str, msg: str) -> None:
    """PetscInfo analog: '[0] Func(): message' lines on stderr
    documenting setup-time decisions."""
    if _INFO:
        print(f"[0] {func}(): {msg}", file=sys.stderr, flush=True)
