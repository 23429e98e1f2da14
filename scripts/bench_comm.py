"""Latency of the distributed layer's collectives between rank threads.

    python3 scripts/bench_comm.py [--device cuda|cpu] [--ranks 4]
        [--switch S ...] [--reps N]

For each Python thread switch interval S (sys.setswitchinterval, the
longest a thread that wakes from a blocking call waits for another
thread holding the GIL), over a parallel.comm.World of rank threads on
the device: a raw gloo allgather of one float in a loop on every rank
(the transport alone), Comm.psum of a scalar, Comm.ppermute of a 64 KiB
slab (the 128³ halo's size; staged through pinned host memory on CUDA)
and one mult of the fp64 ELL operator of ksp ex45 at 64³ split over the
ranks. Prints µs a call, the median of the ranks' means.
"""

from __future__ import annotations

import argparse
import os
import statistics
import sys
import time

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

from petsctpu_torch.core.layout import Layout  # noqa: E402
from petsctpu_torch.models import ex45_system  # noqa: E402
from petsctpu_torch.parallel import (World, shard_vector,  # noqa: E402
                                     sharded_aij_from_scipy)


def per_call_us(world, fn, reps):
    """Median over the ranks of the mean µs of fn(comm) over reps calls."""
    def body(comm):
        fn(comm)
        if world.device.type == "cuda":
            torch.cuda.synchronize()
        t = time.perf_counter()
        for _ in range(reps):
            fn(comm)
        if world.device.type == "cuda":
            torch.cuda.synchronize()
        return 1e6 * (time.perf_counter() - t) / reps
    return statistics.median(world.run(body))


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--ranks", type=int, default=4)
    ap.add_argument("--switch", type=float, nargs="+",
                    default=[0.005, 0.001, 0.0001])
    ap.add_argument("--reps", type=int, default=200)
    a = ap.parse_args(argv)
    world = World(a.ranks, a.device)
    P = a.ranks
    A, _, _ = ex45_system(64, 64, 64)
    E, _ = sharded_aij_from_scipy(A, P, device=world.device)
    xs = shard_vector(world, np.random.default_rng(0).standard_normal(
        A.shape[0]), Layout(A.shape[0], P))
    slab = torch.ones(16384, device=world.device)
    ring = [(p, (p + 1) % P) for p in range(P)]
    one = torch.ones(1)
    card = (torch.cuda.get_device_name(0) if world.device.type == "cuda"
            else "cpu")
    print(f"{P} rank threads on {world.device} ({card})")
    for s in a.switch:
        sys.setswitchinterval(s)
        raw = per_call_us(world, lambda c: c.pg.allgather(
            [[torch.empty(1) for _ in range(P)]], [one]).wait(), a.reps)
        ps = per_call_us(world, lambda c: c.psum(torch.ones(
            (), device=world.device)), a.reps)
        pp = per_call_us(world, lambda c: c.ppermute(slab, ring), a.reps)
        mult_ms = 1e-3 * per_call_us(
            world, lambda c: E.rank(c).mult(xs[c.rank]), max(a.reps // 10, 5))
        print(f"switch {s:g} s: gloo allgather {raw:.1f} us, psum {ps:.1f} "
              f"us, ppermute 64 KiB {pp:.1f} us, ELL mult 64^3 over {P} "
              f"ranks {mult_ms:.3f} ms")
    sys.setswitchinterval(0.005)
    world.close()


if __name__ == "__main__":
    main()
