"""Where the time of one CG+Jacobi iteration goes, on one NVIDIA card.

Runs the port's options-driven solve (ex45 at GRID³, -mat_type sell,
natural order, CG+Jacobi) for a fixed number of iterations under
torch.profiler and prints: the wall time per iteration, the device time
per iteration by kernel, and the device's busy and idle shares of the
wall time. Needs CUDA; run from the repository root:

    python3 scripts/profile_torch_cg.py [GRID] [ITERATIONS]
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

from petsctpu_torch.core.options import Options  # noqa: E402
from petsctpu_torch.ksp import KSP  # noqa: E402
from petsctpu_torch.mat import mat_from_options  # noqa: E402
from petsctpu_torch.models import ex45_system  # noqa: E402


def main(grid=128, its=100):
    if not torch.cuda.is_available():
        raise SystemExit("profile_torch_cg: CUDA is not available")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip()
    print(f"card: {smi}")
    A, b, _ = ex45_system(grid, grid, grid)
    M, _ = mat_from_options(A, Options({"mat_type": "sell",
                                        "mat_ordering_type": "natural"}))
    bt = torch.from_numpy(b.astype(np.float32)).cuda()
    opts = {"ksp_type": "cg", "pc_type": "jacobi", "ksp_rtol": "1e-30",
            "ksp_atol": "0", "ksp_max_it": str(its)}

    def run():
        ksp = KSP(Options(dict(opts)))
        ksp.set_operators(M)
        res = ksp.solve(bt)
        torch.cuda.synchronize()
        return res

    run()                                       # warm-up
    t = time.perf_counter()
    res = run()
    wall = time.perf_counter() - t
    n = int(res.its)
    print(f"ex45 {grid}^3 CG+jacobi: {n} its, wall {1e3 * wall / n:.4f} "
          "ms/it (no profiler)")
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
                                    key=lambda kv: -kv[1][1])[:15]:
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
    main(*(int(a) for a in sys.argv[1:3]))
