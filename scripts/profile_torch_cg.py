"""Where the time of one CG iteration goes, on one NVIDIA card.

Runs the port's options-driven ex45 solve at GRID³ for a fixed number
of iterations under torch.profiler and prints: the wall time per
iteration, the device time per iteration by kernel, and the device's
busy and idle shares of the wall time. PC picks the path:

  jacobi  -mat_type sell, natural order, CG+Jacobi in fp32 (slice 1);
  mg      a StencilMat in fp64, CG with -pc_type mg on DA((GRID,)*3),
          device setup (slice 2);
  gamg    -mat_type sell, natural order, CG with -pc_type gamg in fp32
          (slice 3); it also prints the setup seconds split into
          hierarchy, packing and transfer.
For mg and gamg it also prints the host-clock time of one MG apply, of
the coarse solve alone, and per level of the operator's product, a
smooth, a restriction and a prolongation.

Setup runs once, before the timed solves. Needs CUDA; run from the
repository root:

    python3 scripts/profile_torch_cg.py [GRID] [ITERATIONS] [PC]
"""

from __future__ import annotations

import os
import subprocess
import sys
import time

import numpy as np
import torch
from torch.profiler import ProfilerActivity, profile

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from petsctpu_torch.core.logging import log_begin, log_events  # noqa: E402
from petsctpu_torch.core.options import Options  # noqa: E402
from petsctpu_torch.dm import DA  # noqa: E402
from petsctpu_torch.ksp import KSP  # noqa: E402
from petsctpu_torch.mat import mat_from_options, stencil_from_scipy  # noqa: E402
from petsctpu_torch.models import ex45_system  # noqa: E402
from petsctpu_torch.pc.mg import op_format  # noqa: E402


def _fixed_its(its):
    return {"ksp_type": "cg", "ksp_rtol": "1e-30", "ksp_atol": "0",
            "ksp_max_it": str(its)}


def _jacobi_path(grid, its):
    A, b, _ = ex45_system(grid, grid, grid)
    M, _ = mat_from_options(A, Options({"mat_type": "sell",
                                        "mat_ordering_type": "natural"}))
    ksp = KSP(Options({**_fixed_its(its), "pc_type": "jacobi"}))
    ksp.set_operators(M).set_from_options().setup()
    return ksp, torch.from_numpy(b.astype(np.float32)).cuda()


def _mg_path(grid, its):
    A, b, _ = ex45_system(grid, grid, grid)
    S = stencil_from_scipy(A, (grid, grid, grid))
    ksp = KSP(Options({**_fixed_its(its), "pc_type": "mg",
                       "pc_mg_da": DA((grid, grid, grid))}))
    ksp.set_operators(S).set_from_options().setup()
    return ksp, torch.from_numpy(b).cuda()


def _gamg_path(grid, its):
    A, b, _ = ex45_system(grid, grid, grid)
    M, _ = mat_from_options(A, Options({"mat_type": "sell",
                                        "mat_ordering_type": "natural"}))
    ksp = KSP(Options({**_fixed_its(its), "pc_type": "gamg"}))
    log_begin()
    t = time.perf_counter()
    ksp.set_operators(M, A).set_from_options().setup()
    torch.cuda.synchronize()
    ev = log_events()
    print(f"GAMG setup {time.perf_counter() - t:.2f} s = hierarchy "
          f"{ev['PCGAMGHierarchy'].time:.2f} + packing "
          f"{ev['PCMGPack'].time:.2f} + transfer "
          f"{ev['PCMGTransfer'].time:.2f} s")
    return ksp, torch.from_numpy(b.astype(np.float32)).cuda()


def _wall_ms(fn, runs=20):
    """Median host-clock ms of fn() followed by a synchronise."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(runs):
        t = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append(1e3 * (time.perf_counter() - t))
    return float(np.median(times))


def _mg_parts(pc, b):
    """Host-clock ms of one MG apply, of its coarse solve, and per level
    of the operator's product, a smooth, a restriction and a
    prolongation."""
    rc = torch.ones(pc.coarse_A.shape[0], dtype=b.dtype, device=b.device)
    print(f"MG apply {_wall_ms(lambda: pc.apply(b)):.4f} ms; coarse solve "
          f"({type(pc.coarse).__name__}, {pc.coarse_A.shape[0]} rows) "
          f"{_wall_ms(lambda: pc.coarse.apply(rc)):.4f} ms")
    for l, lev in enumerate(pc.levels):
        x = torch.ones(lev.A.shape[0], dtype=b.dtype, device=b.device)
        xc = torch.ones(lev.P.shape[1], dtype=b.dtype, device=b.device)
        print(f"  level {l} n={lev.A.shape[0]} {op_format(lev.A)}: mult "
              f"{_wall_ms(lambda: lev.A.mult(x)):.4f} ms, smooth "
              f"{_wall_ms(lambda: lev.smoother.smooth(lev.A, x, x)):.4f} ms,"
              f" restrict {_wall_ms(lambda: lev.restrict(x)):.4f} ms, "
              f"prolong {_wall_ms(lambda: lev.P.mult(xc)):.4f} ms")


def main(grid=128, its=100, pc="jacobi"):
    if not torch.cuda.is_available():
        raise SystemExit("profile_torch_cg: CUDA is not available")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip()
    print(f"card: {smi}")
    paths = {"jacobi": _jacobi_path, "mg": _mg_path, "gamg": _gamg_path}
    ksp, bt = paths[pc](grid, its)

    def run():
        res = ksp.solve(bt)
        torch.cuda.synchronize()
        return res

    run()                                       # warm-up
    t = time.perf_counter()
    res = run()
    wall = time.perf_counter() - t
    n = int(res.its)
    print(f"ex45 {grid}^3 CG+{pc}: {n} its, wall {1e3 * wall / n:.4f} "
          "ms/it (no profiler)")
    if pc in ("mg", "gamg"):
        _mg_parts(ksp.pc, bt)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t = time.perf_counter()
        res = run()
        pwall = time.perf_counter() - t
    events = [e for e in prof.events() if e.device_type.name == "CUDA"]
    busy_us = _union_us([(e.time_range.start, e.time_range.end)
                         for e in events])
    per_kernel = {}
    for e in events:
        k = per_kernel.setdefault(e.name, [0, 0.0])
        k[0] += 1
        k[1] += e.time_range.end - e.time_range.start
    print(f"profiled: wall {1e3 * pwall / n:.4f} ms/it; device busy "
          f"{busy_us / n / 1e3:.4f} ms/it = {busy_us / (pwall * 1e6):.3f} "
          f"of wall; idle share {1 - busy_us / (pwall * 1e6):.3f}")
    print("device time by kernel (per iteration):")
    for name, (count, us) in sorted(per_kernel.items(),
                                    key=lambda kv: -kv[1][1])[:20]:
        print(f"  {us / n / 1e3:9.5f} ms  {count / n:5.1f}/it  {name[:90]}")


def _union_us(ranges):
    total, end = 0.0, -1.0
    for s, e in sorted(ranges):
        if s > end:
            total += e - s
            end = e
        elif e > end:
            total += e - end
            end = e
    return total


if __name__ == "__main__":
    main(*(int(a) for a in sys.argv[1:3]), *sys.argv[3:4])
