"""Communicators over torch.distributed: the port's mesh axis.

petsctpu runs each solver unchanged inside `shard_map` over a 1-D
device mesh; collectives appear in it only through `vec.ops` (psum)
and the sharded operators' halos (all_to_all, all_gather, ppermute),
each naming the mesh axis. The port keeps that shape in PyTorch's SPMD
idiom: every rank runs the same Python solver on its own shard, and
`axis` is a `Comm` (or None for serial).

`Comm` wraps one torch.distributed ProcessGroup. Every call counts
itself, with the bytes of its operand on this rank (the jaxpr audit's
convention, core/commaudit.py), in `counts`.

* `psum` all-gathers the ranks' partials and sums them in rank order,
  for short and long operands alike, so every rank gets the same bits
  whatever the transport's reduction order: the Krylov loops test
  convergence on the host on every rank, and ranks that differ by one
  bit take different branches and deadlock.
* `all_to_all` is `alltoall_base` with equal splits: x [P, ...] with
  x[d] going to rank d; the result's [s] came from rank s.
* `ppermute(x, pairs)` sends x to the partner of each (src, dst) pair
  this rank is the source of and returns what its own source sent, or
  zeros where it has none (lax.ppermute's semantics); `ppermutes` posts
  several at once and waits for all (each counts as one).
* Between rank threads a gloo message costs about a millisecond
  (thread wake-ups; scripts/bench_comm.py), which the halo's shifts
  pay once a product by going out together. `seconds` keeps each kind's
  wall time in its calls (waiting for the others included).

Over gloo, a CUDA operand is copied to pinned host memory and back by
the Comm itself, explicitly, counted and timed in `staging` (copies,
bytes, seconds); gloo's own CUDA paths stage through the host as well,
so nothing is lost by doing it here, where it is seen. NCCL takes
device tensors directly.

`World(nranks, device)` is the counterpart of a Mesh: its ranks are
threads of this process, each with its own gloo group over one
in-process HashStore (sub-groups over a PrefixStore of it), all on one
device. `world.run(fn, per_rank_args)` is the counterpart of
shard_map: fn(comm, *args) runs on every rank concurrently, and an
exception in any rank is re-raised by run (the others fail at the
groups' timeout, and the world is then closed). `world.close()` (or
leaving a `with World(...)` block) shuts every group down and drops it,
and returns once every OS thread the world started (its rank threads,
the helpers that build its groups, and gloo's threads) has ended:
Python's `Thread.join` returns before its OS thread is gone, so close()
waits on the threads' native ids in /proc/self/task. The
multi-card route is `world_from_env()`: one process per card started
by torchrun, the same Comm over an NCCL group.
"""

from __future__ import annotations

import contextlib
import datetime
import os
import threading
import time
from typing import Callable, Sequence

import torch
import torch.distributed as dist

from petsctpu_torch.core.rankctx import RankCounters, bind
from petsctpu_torch.device import resolve_device


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


class Comm:
    """One rank's handle on a ProcessGroup (see the module docstring)."""

    def __init__(self, pg, rank: int, size: int, device: torch.device,
                 backend: str):
        self.pg = pg
        self.rank = rank
        self.size = size
        self.device = torch.device(device)
        self.backend = backend
        self.stage = backend == "gloo" and self.device.type == "cuda"
        self.counts: dict = {}        # label -> [calls, bytes]
        self.staging = [0, 0, 0.0]    # host copies, bytes, seconds
        self.seconds: dict = {}       # label -> wall seconds in its calls
        # this rank's kernel launches and log events, bound to its thread
        # while a World runs it (core/rankctx)
        self.counters = RankCounters()
        self._tag = 0
        self.axes: dict = {}          # mesh axis name -> Comm (two-axis World)
        self._halo_record = self._halo_replay = None

    @property
    def launches(self) -> dict:
        return self.counters.launches

    @property
    def events(self) -> dict:
        return self.counters.events

    # -- bookkeeping ------------------------------------------------------
    def _count(self, label: str, nbytes: int) -> None:
        c = self.counts.setdefault(label, [0, 0])
        c[0] += 1
        c[1] += nbytes

    @contextlib.contextmanager
    def _timed(self, label: str):
        """Add the wall time of the block (waiting for the other ranks,
        staging and transport) to seconds[label]."""
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.seconds[label] = self.seconds.get(label, 0.0) \
                + time.perf_counter() - t0

    def reset_counts(self) -> None:
        # in place: a mesh axis's Comm shares these with its rank's flat one
        self.counts.clear()
        self.seconds.clear()
        self.staging[:] = [0, 0, 0.0]
        self.counters.reset()

    def sub(self, axis) -> "Comm":
        """The Comm of a mesh axis of this rank ("ici": its row, "dcn":
        its column of a two-axis World); any other axis (None, "rows", the
        pair of both) is the flat Comm itself."""
        return self.axes.get(axis, self) if isinstance(axis, str) else self

    def close(self) -> None:
        """Shut the group down and drop it (World.close)."""
        if self.pg is not None:
            self.pg.shutdown()
            self.pg = None

    def _wire(self, t: torch.Tensor) -> torch.Tensor:
        """t as the transport takes it: contiguous, real, and on the
        host (pinned) where the backend stages."""
        t = t.contiguous()
        if t.is_complex():
            t = torch.view_as_real(t)
        if not self.stage or t.device.type != "cuda":
            return t
        torch.cuda.current_stream(t.device).synchronize()
        t0 = time.perf_counter()
        h = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
        h.copy_(t)
        self._staged(_nbytes(t), t0)
        return h

    def _unwire(self, h: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
        if h.device != like.device:
            t0 = time.perf_counter()
            h = h.to(like.device)
            torch.cuda.current_stream(like.device).synchronize()
            self._staged(_nbytes(h), t0)
        if like.is_complex():
            h = torch.view_as_complex(h)
        return h

    def _staged(self, nbytes: int, t0: float) -> None:
        self.staging[0] += 1
        self.staging[1] += nbytes
        self.staging[2] += time.perf_counter() - t0

    def _empty(self, w: torch.Tensor, *lead) -> torch.Tensor:
        return torch.empty((*lead, *w.shape), dtype=w.dtype, device=w.device,
                           pin_memory=w.is_pinned())

    def _gather(self, x: torch.Tensor) -> torch.Tensor:
        """[P, *x.shape]: every rank's x, in rank order (allgather)."""
        flat = x.reshape(-1)
        w = self._wire(flat)
        out = self._empty(w, self.size)
        self.pg.allgather([list(out.unbind(0))], [w]).wait()
        return self._unwire(out, flat).reshape(self.size, *x.shape)

    # -- collectives ------------------------------------------------------
    def psum(self, x):
        """Σ over ranks of x, summed in rank order on every rank."""
        x = torch.as_tensor(x)
        self._count("psum", _nbytes(x))
        with self._timed("psum"):
            parts = self._gather(x)
        out = parts[0]
        for k in range(1, self.size):
            out = out + parts[k]
        return out

    def pmax(self, x):
        x = torch.as_tensor(x)
        self._count("pmax", _nbytes(x))
        with self._timed("pmax"):
            return self._gather(x).amax(0)

    def all_gather(self, x: torch.Tensor) -> torch.Tensor:
        """Every rank's x concatenated along dim 0 (tiled)."""
        self._count("all_gather", _nbytes(x))
        with self._timed("all_gather"):
            return self._gather(x).reshape(-1, *x.shape[1:])

    def all_to_all(self, x: torch.Tensor) -> torch.Tensor:
        """x [P, ...] with x[d] for rank d -> out [P, ...] with out[s]
        from rank s."""
        assert x.shape[0] == self.size, (x.shape, self.size)
        self._count("all_to_all", _nbytes(x))
        with self._timed("all_to_all"):
            w = self._wire(x)
            out = self._empty(w)
            self.pg.alltoall_base(out, w, [], []).wait()
            return self._unwire(out, x)

    def ppermute(self, x: torch.Tensor, pairs: Sequence) -> torch.Tensor:
        """Send x along (src, dst) pairs; receive from my source or 0."""
        return self.ppermutes([(x, pairs)])[0]

    def ppermutes(self, shifts: Sequence) -> list:
        """Several ppermutes [(x, pairs), ...] at once: every send and
        receive posted, then all waited for (each counts as one)."""
        if self._halo_replay is not None:
            return self._replayed(shifts)
        with self._timed("ppermute"):
            return self._ppermutes(shifts)

    def _ppermutes(self, shifts: Sequence) -> list:
        out, works, recvs = [], [], []
        for x, pairs in shifts:
            self._count("ppermute", _nbytes(x))
            self._tag += 1
            dst = [d for s, d in pairs if s == self.rank]
            src = [s for s, d in pairs if d == self.rank]
            if self.size == 1:          # a rank's pair with itself
                out.append(x.clone() if src else torch.zeros_like(x))
                continue
            w = self._wire(x)
            works += [self.pg.send([w], d, self._tag) for d in dst]
            if src:
                buf = self._empty(w)
                works.append(self.pg.recv([buf], src[0], self._tag))
                recvs.append((len(out), buf, x))
            out.append(None if src else torch.zeros_like(x))
        for wk in works:
            wk.wait()
        for k, buf, x in recvs:
            out[k] = self._unwire(buf, x)
        if self._halo_record is not None:
            self._halo_record += [o.detach().clone() for o in out]
        return out

    # -- frozen halos -----------------------------------------------------
    @contextlib.contextmanager
    def recording_halos(self):
        """Keep what this rank's ppermutes receive inside the block (a
        list, in call order) for replaying_halos."""
        rec = []
        self._halo_record = rec
        try:
            yield rec
        finally:
            self._halo_record = None

    @contextlib.contextmanager
    def replaying_halos(self, rec: list):
        """Inside the block a ppermute sends nothing: it returns, in call
        order (cycling through `rec`), what recording_halos kept,
        broadcast over the operand's leading batch dimensions. A residual
        evaluated there sees its neighbours' rows as they were when
        recorded: the subdomain problems of nonlinear additive Schwarz,
        solved on each rank with no message (and so with as many inner
        iterations as each rank needs)."""
        self._halo_replay, self._halo_k = rec, 0
        try:
            yield
        finally:
            self._halo_replay = None

    def _replayed(self, shifts) -> list:
        out = []
        for x, _ in shifts:
            r = self._halo_replay[self._halo_k % len(self._halo_replay)]
            self._halo_k += 1
            out.append(r.to(x.dtype).expand(x.shape))
        return out

    def barrier(self) -> None:
        self._count("barrier", 0)
        if self.backend == "nccl":
            self.pg.allreduce([torch.zeros(1, device=self.device)]).wait()
        else:
            self.pg.barrier().wait()


def _live_tids() -> set:
    """The native ids of this process's live OS threads (empty where
    /proc is not mounted)."""
    try:
        return set(map(int, os.listdir("/proc/self/task")))
    except OSError:
        return set()


def _wait_gone(tids: set, timeout: float) -> set:
    """Wait up to `timeout` seconds until none of the OS threads `tids`
    is alive; returns those still alive."""
    end = time.perf_counter() + timeout
    left = tids & _live_tids()
    while left and time.perf_counter() < end:
        time.sleep(1e-3)
        left &= _live_tids()
    return left


def _gloo_group(store, rank: int, size: int, timeout: float):
    opts = dist.ProcessGroupGloo._Options()
    opts._devices = [dist.ProcessGroupGloo.create_device(interface="lo")]
    opts._timeout = datetime.timedelta(seconds=timeout)
    return dist.ProcessGroupGloo(store, rank, size, opts)


class World:
    """P rank threads of this process, each with its own gloo group, all
    on one device: the counterpart of a 1-D Mesh (see the module
    docstring), or with mesh=(H, C) of petsctpu's two-axis ("dcn",
    "ici") Mesh (`_mesh_axes`). `timeout` bounds how long a rank waits
    in a collective.

    The groups are gloo's: NCCL refuses two ranks on one card ("Duplicate
    GPU detected"), so the NCCL route is world_from_env(), a process per
    card."""

    backend = "gloo"

    def __init__(self, nranks: int, device=None, timeout: float = 120.0,
                 mesh: tuple = None):
        self.size = int(nranks)
        self.device = resolve_device(device)
        self.timeout = float(timeout)
        self._store = dist.HashStore()
        self._nsplit = 0
        self.closed = False
        self._failure = None
        self._all: list = []          # every Comm made, splits' too
        self.tids: set = set()        # native ids of the threads it started
        self.comms = self._groups("world", self.size, range(self.size))
        self.mesh = None
        if mesh is not None:
            self._mesh_axes(*mesh)

    def _mesh_axes(self, H: int, C: int) -> None:
        """The two-axis (dcn, ici) mesh of H x C ranks, rank p = h*C + c
        (petsctpu's Mesh(devices.reshape(H, C), ("dcn", "ici"))): each
        rank's Comm gets axes["ici"], a group over its row (the same h;
        rank c in it), and axes["dcn"], a group over its column (the same
        c; rank h). The axes' Comms count into their rank's flat Comm
        (counts, stagings, launches), as petsctpu's audit counts every
        collective of a program whatever its axis; a reduction over both
        axes is the flat Comm's, in global rank order."""
        H, C = int(H), int(C)
        if H * C != self.size:
            raise ValueError(f"mesh {H}x{C} for a World of {self.size} "
                             "ranks")
        self.mesh = (H, C)
        ici, dcn = [], [None] * self.size
        for h in range(H):
            ici += self._groups(f"ici{h}", C, range(C))
        for c in range(C):
            for h, cm in enumerate(self._groups(f"dcn{c}", H, range(H))):
                dcn[h * C + c] = cm
        for p, comm in enumerate(self.comms):
            for name, sub in (("ici", ici[p]), ("dcn", dcn[p])):
                sub.counts, sub.staging = comm.counts, comm.staging
                sub.seconds = comm.seconds
                sub.counters = comm.counters
                comm.axes[name] = sub

    def _groups(self, prefix: str, size: int, ranks) -> list:
        """One Comm per rank in `ranks` (ranks 0..size-1 of a group over
        PrefixStore(prefix)), built concurrently: a group's constructor
        meets all of its ranks."""
        ranks = list(ranks)
        store = dist.PrefixStore(prefix, self._store)
        before = _live_tids()
        out, errs = [None] * len(ranks), []

        def make(i, r):
            try:
                out[i] = Comm(_gloo_group(store, r, size, self.timeout), r,
                              size, self.device, self.backend)
            except BaseException as e:            # re-raised below
                errs.append(e)

        threads = [threading.Thread(target=make, args=(i, r))
                   for i, r in enumerate(ranks)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        # gloo's threads, started by the groups' constructors, and the
        # helpers that ran them
        self.tids |= (_live_tids() - before) | {t.native_id for t in threads}
        if errs:
            raise errs[0]
        self._all += out
        return out

    def split(self, nsub: int) -> list:
        """PetscSubcommCreate: nsub contiguous groups of size/nsub ranks;
        returns each world rank's sub-group Comm."""
        if self.size % nsub:
            raise ValueError(f"{self.size} ranks not divisible by "
                             f"nsub={nsub}")
        k = self.size // nsub
        self._nsplit += 1
        subs = []
        for g in range(nsub):
            subs += self._groups(f"split{self._nsplit}.{g}", k, range(k))
        return subs

    def reset_counts(self) -> None:
        for c in self.comms:
            c.reset_counts()

    def close(self) -> None:
        """Shut down and drop every group of the world and its splits,
        and wait (at most the world's timeout, and 10 s) until every OS
        thread the world started has ended. The world refuses runs after
        it; closing twice does nothing."""
        if self.closed:
            return
        self.closed = True
        for c in self._all:
            c.close()
        self._all = []
        _wait_gone(self.tids, min(self.timeout, 10.0))

    def __enter__(self) -> "World":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    def run(self, fn: Callable, per_rank_args: Sequence = None,
            comms: Sequence = None) -> list:
        """[fn(comm_r, *per_rank_args[r]) for every rank r], run on the
        ranks' threads at once; re-raises a rank's exception."""
        if self.closed:
            raise RuntimeError("World is closed" + (
                f" after a failed run: {self._failure!r}"
                if self._failure is not None else ""))
        comms = self.comms if comms is None else list(comms)
        args = per_rank_args or [()] * self.size
        out = [None] * self.size
        errs = {}

        def body(r):
            comm = comms[r]
            bind(comm.counters)
            try:
                out[r] = fn(comm, *args[r])
            except BaseException as e:            # re-raised below
                errs[r] = e
            finally:
                bind(None)
                if self.device.type == "cuda":
                    torch.cuda.synchronize(self.device)

        threads = [threading.Thread(target=body, args=(r,), daemon=True)
                   for r in range(self.size)]
        for t in threads:
            t.start()
        self.tids |= {t.native_id for t in threads}
        for t in threads:
            t.join()
        if errs:
            # the rank that failed first (errs fills in the order the
            # ranks failed): the others failed in a collective after it,
            # at a timeout or on a closed connection
            r = next(iter(errs))
            self._failure = errs[r]
            self.close()
            raise RuntimeError(f"rank {r} of {self.size} failed") \
                from errs[r]
        return out


class EnvWorld:
    """This process's rank of a torchrun job: a World of one local rank
    over the default (NCCL on CUDA) group. run() calls fn for this rank
    only and returns its result in a list of one."""

    def __init__(self, comm: Comm):
        self.comm = comm
        self.comms = [comm]
        self.size = comm.size
        self.rank = comm.rank
        self.device = comm.device
        self.backend = comm.backend

    def reset_counts(self) -> None:
        self.comm.reset_counts()

    def run(self, fn: Callable, per_rank_args: Sequence = None,
            comms: Sequence = None) -> list:
        comm = self.comm if comms is None else comms[0]
        args = (per_rank_args or [()] * self.size)[self.rank]
        bind(comm.counters)
        try:
            return [fn(comm, *args)]
        finally:
            bind(None)


def world_from_env(device=None, backend: str = None) -> EnvWorld:
    """Join the torchrun job in the environment (RANK, WORLD_SIZE,
    MASTER_ADDR, MASTER_PORT): one process per card, NCCL on CUDA."""
    rank = int(os.environ["RANK"])
    size = int(os.environ["WORLD_SIZE"])
    local = int(os.environ.get("LOCAL_RANK", rank))
    dev = resolve_device(device if device is not None else
                         (f"cuda:{local}" if torch.cuda.is_available()
                          else None))
    backend = backend or ("nccl" if dev.type == "cuda" else "gloo")
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    if not dist.is_initialized():
        dist.init_process_group(
            backend, init_method=f"tcp://{os.environ['MASTER_ADDR']}:"
            f"{os.environ['MASTER_PORT']}", rank=rank, world_size=size,
            device_id=dev if dev.type == "cuda" else None)
    pg = dist.distributed_c10d._get_default_group()
    return EnvWorld(Comm(pg, rank, size, dev, backend))
