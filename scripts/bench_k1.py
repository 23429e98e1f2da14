"""Time kernel K1 (the stencil SpMV) on one NVIDIA card at the shapes the
slice-2 path runs it at, against other checkouts' K1.

The shapes: every level operator of KSP ex45's CG + `-pc_type mg`
hierarchy at GRID³ (the fp64 GRID³ 7-point operator, then the 27-point
Galerkin operators of the coarser levels; 129³ gives 129³, 65³, 33³,
17³, 9³ and 5³), built by the port's device MG setup; bench.py's 4096²
5-point layout in fp32 (random coefficients in [1, 1.1) times its
values); and, for K1's other instantiations, a 65³ 19-point stencil in
fp64 (the generic D) and a 128³ 7-point one in fp32, with random
coefficients. On each, every launcher must equal K1's plain version bit
for bit; then each is timed with CUDA events (a call back to back, the
wrapper's host cost included) and in a CUDA graph (device time), in
turns (the order forwards, then backwards, ROUNDS times; the median is
printed, and the device readings), beside the byte bound ((D + 2)·N·
sizeof(T) at 3.35 TB/s) and one torch.sparse CSR `mv` of the assembled
operator:

  this        this checkout's wrapper `stencil_mult`;
  NAME        with --other NAME=DIR (repeatable), the wrapper of another
              checkout (bench_calls.other_wrapper: its kernel built from
              DIR's csrc into DIR's _build and called through its own C
              interface).

The others run first, so with one of them the order is other, this,
this, other. Needs CUDA and nvcc; run from the repository root:

    python3 scripts/bench_k1.py [--grid GRID] [--rounds R] [--other NAME=DIR ...]

`bench_stencil`, `csr_tensor` and `k1_bound` are also what
`chip_smoke.py` builds and bounds its K1 cases with.
"""

from __future__ import annotations

import argparse
import os
import statistics
import subprocess
import sys

import numpy as np
import scipy.sparse as sp
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

from bench_calls import build_together, other_wrapper  # noqa: E402

from petsctpu_torch.core.options import Options  # noqa: E402
from petsctpu_torch.dm import DA  # noqa: E402
from petsctpu_torch.ksp import KSP  # noqa: E402
from petsctpu_torch.mat import (StencilMat, stencil_from_scipy,  # noqa: E402
                                stencil_to_scipy)
from petsctpu_torch.models import ex45_system  # noqa: E402
from petsctpu_torch.ops import stencil_mult as k1  # noqa: E402
from petsctpu_torch.timing import (FP32_FLOPS_PER_S,  # noqa: E402
                                   FP64_FLOPS_PER_S, HBM_BYTES_PER_S,
                                   graph_ms, time_ms)

BENCH_M = 4096
STAR5 = ((0, 0), (-1, 0), (1, 0), (0, -1), (0, 1))
STAR7 = ((0, 0, 0), (-1, 0, 0), (1, 0, 0), (0, -1, 0), (0, 1, 0),
         (0, 0, -1), (0, 0, 1))
STAR19 = STAR7 + tuple((i, j, k) for i in (-1, 0, 1) for j in (-1, 0, 1)
                       for k in (-1, 0, 1) if abs(i) + abs(j) + abs(k) == 2)


def level_operators(g):
    """The slice-2 hierarchy's level operators at g³, finest first."""
    A, _, _ = ex45_system(g, g, g)
    S = stencil_from_scipy(A, (g, g, g))
    ksp = KSP(Options({"ksp_type": "cg", "pc_type": "mg", "ksp_rtol": "1e-5",
                       "pc_mg_da": DA((g, g, g))}))
    ksp.set_operators(S).set_from_options().setup()
    return [lv.A for lv in ksp.pc.levels]


def bench_stencil(rng, m):
    """bench.py's 4096² 5-point layout (bench.py:42-55) in fp32, each
    coefficient scaled by a random factor in [1, 1.1)."""
    C = np.zeros((5, m, m), np.float32)
    C[0] = 4.0
    C[1, 1:, :] = -1.0
    C[2, :-1, :] = -1.0
    C[3, :, 1:] = -1.0
    C[4, :, :-1] = -1.0
    C *= 1.0 + 0.1 * rng.random((5, m, m), dtype=np.float32)
    return StencilMat(torch.from_numpy(C).cuda(), STAR5, (m, m))


def random_stencil(rng, offsets, grid, dtype):
    C = rng.standard_normal((len(offsets),) + grid).astype(dtype)
    return StencilMat(torch.from_numpy(C).cuda(), offsets, grid)


def csr_tensor(A, dtype):
    """A scipy matrix as a torch.sparse CSR tensor on the card."""
    A = sp.csr_matrix(A, dtype=dtype)
    return torch.sparse_csr_tensor(
        torch.from_numpy(A.indptr.astype(np.int64)),
        torch.from_numpy(A.indices.astype(np.int64)),
        torch.from_numpy(A.data), size=A.shape, check_invariants=True).cuda()


def k1_bound(S):
    """(compulsory bytes, their ms at HBM_BYTES_PER_S, the ms of the
    2·D flops a point at the dtype's peak) of one K1 product on S."""
    n, D = S.shape[0], len(S.offsets)
    nbytes = (D + 2) * S.coeffs.element_size() * n
    peak = FP32_FLOPS_PER_S if S.dtype == torch.float32 else FP64_FLOPS_PER_S
    return nbytes, nbytes / HBM_BYTES_PER_S * 1e3, 2.0 * D * n / peak * 1e3


def time_case(label, S, wrappers, rng, rounds):
    x = torch.from_numpy(rng.standard_normal(S.shape[0])).to("cuda", S.dtype)
    args = (S.coeffs, x, S.offsets, S.grid, S.boundary)
    ref = k1.stencil_mult_plain(*args)
    calls = {name: (lambda m=mod: m.stencil_mult(*args))
             for name, mod in wrappers.items()}
    for name, call in calls.items():
        if not torch.equal(call(), ref):
            raise AssertionError(f"{label}: {name} differs from K1's plain "
                                 "version")
    nbytes, bound_ms, _ = k1_bound(S)
    csr = csr_tensor(stencil_to_scipy(S), np.float32
                     if S.dtype == torch.float32 else np.float64)
    library_ms = time_ms(lambda: torch.mv(csr, x))
    print(f"{label}: N={S.shape[0]} D={len(S.offsets)} {S.dtype}; bound "
          f"{bound_ms:.6f} ms ({nbytes} B at 3.35 TB/s); torch.sparse CSR mv "
          f"{library_ms:.4f} ms a call; each launcher equals the plain "
          "version bit for bit", flush=True)
    got = {name: ([], []) for name in calls}
    order = list(calls)
    for name in (order + order[::-1]) * rounds:
        got[name][0].append(time_ms(calls[name]))
        got[name][1].append(graph_ms(calls[name]))
    for name in order:
        call = statistics.median(got[name][0])
        dev = statistics.median(got[name][1])
        print(f"  {name:10s} a call {call:.4f} ms, device {dev:.5f} ms "
              f"({100 * bound_ms / dev:.1f} % of the bound; device runs "
              f"{', '.join(f'{v:.5f}' for v in got[name][1])})", flush=True)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--grid", type=int, default=129)
    ap.add_argument("--rounds", type=int, default=1)
    ap.add_argument("--other", action="append", default=[],
                    metavar="NAME=DIR")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("bench_k1: CUDA is not available")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip()
    print(f"card: {smi}")
    wrappers = {}
    for spec in args.other:
        name, root = spec.split("=", 1)
        wrappers[name] = other_wrapper(name, root, "stencil_mult")
    wrappers["this"] = k1
    build_together(list(wrappers.values()), "stencil_mult")
    rng = np.random.default_rng(0)
    r = args.rounds
    for S in level_operators(args.grid):
        time_case(f"{S.grid[0]}^3 {len(S.offsets)}-point fp64", S, wrappers,
                  rng, r)
    time_case(f"{BENCH_M}^2 5-point fp32", bench_stencil(rng, BENCH_M),
              wrappers, rng, r)
    time_case("65^3 19-point fp64", random_stencil(rng, STAR19, (65,) * 3,
                                                   np.float64),
              wrappers, rng, r)
    time_case("128^3 7-point fp32", random_stencil(rng, STAR7, (128,) * 3,
                                                   np.float32),
              wrappers, rng, r)


if __name__ == "__main__":
    main()
