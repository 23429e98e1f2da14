"""Time the GAMG setup of this checkout against other checkouts on one
NVIDIA card.

For each checkout, this one ("this") and each `--other NAME=DIR` (e.g.
the parent, unpacked with `git archive` under a git-ignored directory),
a fresh Python process imports that checkout's petsctpu_torch, builds
KSP ex45's operator at GRID³ on SELL in natural order
(mat_from_options) and sets up CG + `-pc_type gamg`
(`-pc_gamg_coarse_eq_limit 64`), and prints the seconds of
mat_from_options and of the setup, with the setup's log events
(PCGAMGHierarchy, PCMGPack, PCMGTransfer, PCMGTransposePlan). The
checkouts run in turns, forwards and then backwards, `--rounds` times;
the medians print last, under the card's name and power limit. Needs
CUDA (the setup transfers to the card); run from the repository root:

    python3 -m petsctpu_torch.bench_gamg_setup [--grid G] [--rounds R]
        [--other NAME=DIR ...]
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

CHILD = """
import json, sys, time
sys.path.insert(0, {root!r})
import torch
from petsctpu_torch.core.logging import log_begin, log_events
from petsctpu_torch.core.options import Options
from petsctpu_torch.ksp import KSP
from petsctpu_torch.mat import mat_from_options
from petsctpu_torch.models import ex45_system

try:                                   # a native library, built before
    from petsctpu_torch.mat import host_graph   # the clock starts
    host_graph._lib()
except ImportError:                    # a checkout without one
    pass
g = {grid}
A, b, _ = ex45_system(g, g, g)
torch.zeros(1, device="cuda")
torch.cuda.synchronize()
log_begin()
t = time.perf_counter()
M, _ = mat_from_options(A, Options({{"mat_type": "sell",
                                    "mat_ordering_type": "natural"}}),
                        dtype=torch.float32)
torch.cuda.synchronize()
op = time.perf_counter() - t
ksp = KSP(Options({{"ksp_type": "cg", "pc_type": "gamg",
                   "pc_gamg_coarse_eq_limit": "64"}})).set_operators(M, A)
t = time.perf_counter()
ksp.set_from_options().setup()
torch.cuda.synchronize()
setup = time.perf_counter() - t
print(json.dumps(dict(mat_from_options=op, setup=setup,
                      **{{k: v.time for k, v in log_events().items()}})))
"""


def run(root: str, grid: int) -> dict:
    out = subprocess.run([sys.executable, "-c",
                          CHILD.format(root=root, grid=grid)], cwd=root,
                         capture_output=True, text=True, check=True)
    return json.loads(out.stdout.strip().splitlines()[-1])


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--grid", type=int, default=128)
    ap.add_argument("--rounds", type=int, default=1)
    ap.add_argument("--other", action="append", default=[],
                    metavar="NAME=DIR")
    args = ap.parse_args(argv)
    roots = {"this": ROOT}
    for spec in args.other:
        name, _, path = spec.partition("=")
        roots[name] = os.path.abspath(path)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    results = {name: [] for name in roots}
    order = list(roots)
    for _ in range(args.rounds):
        for name in order + order[::-1]:
            res = run(roots[name], args.grid)
            results[name].append(res)
            print(name, json.dumps({k: round(v, 3) for k, v in res.items()}),
                  flush=True)
    print(f"GAMG setup at ex45 {args.grid}^3, medians ({smi}):")
    for name, runs in results.items():
        keys = sorted(set().union(*runs))
        med = {k: statistics.median(r.get(k, 0.0) for r in runs)
               for k in keys}
        print(f"  {name}: " + ", ".join(f"{k} {v:.2f} s"
                                         for k, v in med.items()))


if __name__ == "__main__":
    main()
