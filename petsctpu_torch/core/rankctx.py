"""Per-rank counters of the thread a rank runs on.

The rank threads of a parallel.comm.World launch kernels and log events
at once. Each rank owns one `RankCounters`; World.run binds it to the
rank's thread, where the kernel wrappers' launch counter
(ops/_build.counted) and the event log (core/logging) write into it.
Outside a run nothing is bound and they write only their process-wide
tables. The distributed layer reads and resets these counters; this
module knows nothing of it.
"""

from __future__ import annotations

import threading

_TLS = threading.local()


class RankCounters:
    """One rank's kernel launches (wrapper name -> launches) and log
    events (name -> EventStats)."""

    def __init__(self):
        self.reset()

    def reset(self) -> None:
        self.launches: dict = {}
        self.events: dict = {}


def current():
    """The RankCounters bound to this thread, or None outside a run."""
    return getattr(_TLS, "counters", None)


def bind(counters) -> None:
    """Bind `counters` (or None) to this thread."""
    _TLS.counters = counters
