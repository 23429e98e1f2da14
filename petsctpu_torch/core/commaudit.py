"""Communication-volume observability: the -log_summary message columns.

Counterpart of petsctpu/core/commaudit.py (reference: the Mess/MessLen/
Reductions columns that PetscLogView prints, src/sys/logging/plog.c:1264,
fed by counters at the MPI_Allreduce and VecScatter sites,
include/petsclog.h:294). petsctpu counts collectives at compile time by
walking the jaxpr, separating one-time work from while-loop bodies. The
port counts at run time: every parallel.comm.Comm call adds itself and
its operand's bytes (per rank, the jaxpr's aval bytes), and
`audit_runs` splits two runs of one program that differ only in their
iteration counts into a per-iteration part (the difference over the
extra iterations) and a one-time part (the rest). A two-axis World's row
and column Comms count into their rank's flat Comm, so the audit of a
program over both axes (the hierarchical halo, make_dist_mg_hier's
re-sharded stage) counts every collective of it, as the jaxpr does.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np


@dataclass
class CommCounts:
    """counts[label] = calls, bytes[label] = payload bytes (per rank)."""

    counts: dict = field(default_factory=dict)
    bytes: dict = field(default_factory=dict)

    def add(self, label: str, n: int, nbytes: float) -> None:
        self.counts[label] = self.counts.get(label, 0) + n
        self.bytes[label] = self.bytes.get(label, 0.0) + nbytes

    def merge(self, other: "CommCounts", times: int = 1) -> None:
        for k, n in other.counts.items():
            self.add(k, n * times, other.bytes[k] * times)

    @property
    def total_count(self) -> int:
        return sum(self.counts.values())

    @property
    def total_bytes(self) -> float:
        return sum(self.bytes.values())

    def summary(self) -> dict:
        return {"collectives": int(self.total_count),
                "bytes": float(self.total_bytes),
                "by_op": {k: [int(self.counts[k]), float(self.bytes[k])]
                          for k in sorted(self.counts)}}

    @classmethod
    def of(cls, comm_counts: dict) -> "CommCounts":
        """From a Comm's {label: [calls, bytes]} (barriers left out)."""
        c = cls()
        for k, (n, b) in comm_counts.items():
            if k != "barrier":
                c.add(k, n, b)
        return c


@dataclass
class CommAudit:
    """once: outside the iteration loop; per_iteration: one iteration."""

    once: CommCounts = field(default_factory=CommCounts)
    per_iteration: CommCounts = field(default_factory=CommCounts)

    def summary(self) -> dict:
        return {"once": self.once.summary(),
                "per_iteration": self.per_iteration.summary()}


def audit_runs(short: dict, its_short: int, long: dict,
               its_long: int) -> CommAudit:
    """The audit of a program from one rank's counts of two runs that
    took its_short < its_long iterations (Comm.counts dicts)."""
    a, b = CommCounts.of(short), CommCounts.of(long)
    k = its_long - its_short
    audit = CommAudit()
    for lab in sorted(set(a.counts) | set(b.counts)):
        dn = b.counts.get(lab, 0) - a.counts.get(lab, 0)
        db = b.bytes.get(lab, 0.0) - a.bytes.get(lab, 0.0)
        if dn % k or dn < 0:
            raise ValueError(f"{lab}: {dn} calls over {k} iterations is not "
                             "a whole number an iteration")
        if dn:
            audit.per_iteration.add(lab, dn // k, db / k)
        n0 = a.counts.get(lab, 0) - its_short * (dn // k)
        if n0:
            audit.once.add(lab, n0, a.bytes.get(lab, 0.0)
                           - its_short * db / k)
    return audit


# process-global registry: audit_par_ksp deposits its audits here;
# comm_table prints them
COMM_AUDITS: dict = {}


def comm_table(audits: dict = None) -> str:
    """PetscLogView-style per-solver message table (plog.c:1264
    Mess/MessLen/Reductions columns, per rank)."""
    audits = COMM_AUDITS if audits is None else audits
    lines = ["-" * 78,
             "collective-traffic audit (per rank; counted at run time)",
             f"{'Program':30s} {'coll/iter':>9s} {'KB/iter':>9s} "
             f"{'setup coll':>10s} {'breakdown (per iter)':>16s}",
             "-" * 78]
    for key in sorted(audits, key=str):
        a = audits[key]
        per = a.per_iteration
        brk = ",".join(f"{k}:{per.counts[k]}" for k in sorted(per.counts))
        lines.append(
            f"{str(key):30s} {per.total_count:9d} "
            f"{per.total_bytes/1024:9.2f} {a.once.total_count:10d} "
            f"{brk:>16s}")
    lines.append("-" * 78)
    return "\n".join(lines)


def halo_audit(halo, dtype=np.float32) -> dict:
    """Static halo-plan volume (the VecScatter message-length ledger,
    vpscat.c): per-rank send slots, ghosts, and bytes moved per
    exchange for the alltoall route."""
    item = np.dtype(dtype).itemsize
    P, _, smax = halo.send_idx.shape
    return {
        "shards": int(P),
        "ghosts_per_shard_max": int(halo.gmax),
        "send_slots_per_shard": int(P * smax),
        "halo_bytes_per_exchange_per_shard": int(P * smax * item),
        "alltoall_payload_bytes_total": int(P * P * smax * item),
    }
