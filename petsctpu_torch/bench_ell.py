"""Time the ELL kernel under AIJ.mult on one NVIDIA card against other
checkouts' in turns, beside torch.mv on CSR and the byte bound.

Operators (fp64): ksp ex43's SolCx operator A at mx = my = MX (K 27;
3,145,728 rows at 1023) and snes ex14's 7-point Jacobian pattern at M³
(K 7; 2,097,152 rows at 128) with values from the seed. On each, every
variant is first held bit for bit to the plain version (CSR within
1e-12 relative), then timed as 20 calls in a CUDA graph, the variants in
turns, forwards and backwards, `--rounds` times:

- "kernel": this checkout's kernel at its launch plan;
- NAME: another checkout's kernel (`--other NAME=DIR`: the parent, or a
  variant of the kernel, unpacked with `git archive` into a git-ignored
  directory of this checkout such as `_archive/`), through that
  checkout's own wrapper and build, with int64 columns where that
  wrapper takes them;
- "csr64", "csr32": torch.mv on a CSR tensor with int64 or int32
  indices (cuSPARSE: the library's call for the same product).

The medians print last with the share of the byte bound (the pack read
once, x and y once, at 3.35 TB/s), under the card's name and power
limit; `--json PATH` writes them too. Needs CUDA; run from the
repository root:

    python3 -m petsctpu_torch.bench_ell [--mx MX] [--m M] [--rounds R]
        [--other NAME=DIR ...] [--json PATH]
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import os
import statistics
import subprocess
import sys
import time

import numpy as np
import scipy.sparse as sp
import torch

from petsctpu_torch.mat.ell import aij_from_scipy
from petsctpu_torch.ops import ell_spmv as ell
from petsctpu_torch.timing import HBM_BYTES_PER_S, graph_ms


def _module(name, path):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def other_ell(name, root):
    """Another checkout's ops/ell_spmv.py, bound to its own _build (its
    kernel built from root's csrc into root's _build); root must lie
    inside this checkout."""
    root = os.path.realpath(root)
    if os.path.commonpath([root, HERE]) != HERE or root == HERE:
        raise SystemExit(f"bench_ell: --other {name}={root}: not a "
                         f"directory inside this checkout ({HERE})")
    ops = os.path.join(root, "petsctpu_torch", "ops")
    build = _module(f"ell_{name}_build", os.path.join(ops, "_build.py"))
    mod = _module(f"ell_{name}", os.path.join(ops, "ell_spmv.py"))
    mod._build = build
    build.build_all(["ell_spmv"])
    return mod


def operators(mx, m, rng):
    """[(label, scipy A)]: ex43's A at mx and ex14's pattern at m³."""
    from petsctpu_torch.models.bratu import bratu3d_pattern
    from petsctpu_torch.models.q1stokes import q1q1_stokes_system
    t = time.perf_counter()
    A = q1q1_stokes_system(mx, mx, c_str=0, eta0=1.0, eta1=1.0e6, xc=0.5,
                           nz=2)[0]
    print(f"ex43 mx={mx}: n={A.shape[0]} nnz={A.nnz} assembled in "
          f"{time.perf_counter() - t:.1f} s", flush=True)
    J = bratu3d_pattern(m).astype(np.float64)
    J.data = rng.standard_normal(J.nnz)
    return [(f"ex43 mx={mx}", A), (f"ex14 {m}^3 pattern", J)]


def csr(A, index_dtype):
    A = sp.csr_matrix(A)
    return torch.sparse_csr_tensor(
        torch.from_numpy(A.indptr.astype(index_dtype)),
        torch.from_numpy(A.indices.astype(index_dtype)),
        torch.from_numpy(A.data), size=A.shape).cuda()


def variants(A, Ad, x, others):
    """{label: () -> y} of every variant on one operator."""
    out = {"kernel": lambda: ell.ell_spmv(Ad.cols, Ad.vals, x)}
    for name, mod in others.items():
        cols = Ad.cols if hasattr(mod, "COL_BYTES") else Ad.cols.long()
        out[name] = (lambda mod=mod, cols=cols:
                     mod.ell_spmv(cols, Ad.vals, x))
    for label, dt in (("csr64", np.int64), ("csr32", np.int32)):
        M = csr(A, dt)
        out[label] = (lambda M=M: torch.mv(M, x))
    return out


def check(label, fns, Ad, x):
    """Every kernel variant bit for bit against the plain version, CSR
    within 1e-12 relative."""
    plain = ell.ell_spmv_plain(Ad.cols, Ad.vals, x)
    for name, fn in fns.items():
        y = fn()
        torch.cuda.synchronize()
        if name.startswith("csr"):
            rel = float((y - plain).abs().max() / plain.abs().max())
            if not rel <= 1e-12:
                raise AssertionError(f"{label} {name}: rel diff {rel}")
        elif not torch.equal(y, plain):
            raise AssertionError(f"{label} {name}: differs from the plain "
                                 f"version by {float((y - plain).abs().max())}")


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--mx", type=int, default=1023)
    ap.add_argument("--m", type=int, default=128)
    ap.add_argument("--rounds", type=int, default=3)
    ap.add_argument("--other", action="append", default=[])
    ap.add_argument("--json", default=None)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("bench_ell: CUDA is not available")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True).stdout.strip()
    others = {}
    for spec in args.other:
        name, root = spec.split("=", 1)
        others[name] = other_ell(name, root)
    rng = np.random.default_rng(0)
    results = {}
    for label, A in operators(args.mx, args.m, rng):
        Ad = aij_from_scipy(A)
        x = torch.from_numpy(rng.standard_normal(A.shape[1])).cuda()
        m, K = Ad.cols.shape
        es = Ad.vals.element_size()
        nbytes = m * K * (ell.COL_BYTES + es) + (A.shape[1] + m) * es
        bound = nbytes / HBM_BYTES_PER_S * 1e3
        fns = variants(A, Ad, x, others)
        check(label, fns, Ad, x)
        p = ell.launch_plan(m, K, es, ell._num_sms(x.get_device()))
        print(f"{label}: m={m} K={K} launch plan {p}; bound {bound:.4f} ms "
              f"({nbytes} B at 3.35 TB/s)", flush=True)
        times = {name: [] for name in fns}
        order = list(fns)
        for r in range(args.rounds):
            for name in (order if r % 2 == 0 else order[::-1]):
                times[name].append(graph_ms(fns[name]))
        med = {name: statistics.median(v) for name, v in times.items()}
        for name in order:
            print(f"  {name:>10}: {med[name]:.4f} ms device "
                  f"({', '.join(f'{t:.4f}' for t in times[name])}); "
                  f"{100 * bound / med[name]:.1f} % of the byte bound",
                  flush=True)
        results[label] = dict(m=m, K=K, bound_ms=bound, plan=p._asdict(),
                              ms=med, runs=times)
        del Ad, fns
        torch.cuda.empty_cache()
    print(smi)
    if args.json:
        with open(args.json, "w") as f:
            json.dump(dict(card=smi, results=results), f, indent=1)


if __name__ == "__main__":
    main(sys.argv[1:])
