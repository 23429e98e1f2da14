"""Time kernel K2 (the SELL SpMV) on one NVIDIA card: against other
builds of K2, against H1, and the host's cost of a call by part.

On two packs, the ex45 operator at GRID³ (diag mode, G = 16, 7 passes)
and the gather7 base probe case (scripts/probe_gather7.py's data, 96
passes a tile, K2 on the padded layout as petsctpu_torch.probes runs
it), it checks each launcher bit for bit against K2's plain version and
times it with CUDA events (back to back) and in a CUDA graph, in turns
(the order is run forwards and then backwards, and each one's median of
the two is printed):

  k2          the wrapper `sell_spmv`, as the port calls it;
  k2 raw      the same kernel through its C entry point alone (the
              wrapper's host cost left out);
  NAME        with --other NAME=DIR (repeatable), the K2 of another
              checkout, built from DIR's csrc into DIR's _build and called
              through its C entry point (bench_calls.other_wrapper);
  H1 tile     on gather7 base only, H1 (sell_pass) in tile mode on the
              compacted stream.

Then the host's microseconds a call of each part of the wrapper
(`host_parts` of scripts/bench_calls.py: the median of five rounds of
perf_counter, the card idle before each). Needs
CUDA and nvcc; run from the repository root:

    python3 scripts/bench_k2.py [--grid GRID] [--other NAME=DIR ...]
"""

from __future__ import annotations

import argparse
import os
import statistics
import subprocess
import sys

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

from bench_calls import build_together, host_parts, other_wrapper  # noqa: E402

from petsctpu_torch.mat.sell import sell_from_scipy  # noqa: E402
from petsctpu_torch.models import ex45_system  # noqa: E402
from petsctpu_torch.ops import _build  # noqa: E402
from petsctpu_torch.ops import sell_spmv as k2  # noqa: E402
from petsctpu_torch.probes.sell import (_gather7_inputs,  # noqa: E402
                                        probe_gather7_base)
from petsctpu_torch.timing import HBM_BYTES_PER_S, graph_ms, time_ms  # noqa: E402

def runner(fn, pack):
    """A call of C entry point fn on a pack, writing into one output."""
    vals, idx, qs, ws, xp, G, S = pack
    nt, P = vals.shape[:2]
    y = torch.empty((nt, G, 128), device="cuda")
    args = tuple(t.data_ptr() for t in (vals, idx, qs, ws, xp, y)) \
        + (nt, P, G, 1)
    index = xp.get_device()

    def run():
        rc = _build.launch(fn, index, args)
        if rc != 0:
            raise RuntimeError(f"launch failed with CUDA error {rc}")
        return y
    return run


def gather7_pack():
    """The gather7 base case's padded layout for K2 (one chunk a tile, so
    the pack is the case's own arrays), and H1's call on the case."""
    case = probe_gather7_base("cuda")
    vals, idx, qs, _, _, _, xp = _gather7_inputs()
    t = [torch.from_numpy(a).cuda() for a in (vals, idx, qs, xp)]
    ws = torch.zeros(vals.shape[0], dtype=torch.int32, device="cuda")
    return (t[0], t[1], t[2], ws, t[3], vals.shape[2], xp.shape[0]), case.run


def time_pack(label, pack, calls):
    """Each call checked against the plain version, then timed in turns."""
    vals, idx, qs, ws, xp, G, S = pack
    ref = k2.sell_spmv_plain(vals, idx, qs, ws, xp, G=G, S=S, mode="diag")
    for name, call in calls.items():
        if name != "H1 tile" and not torch.equal(call(), ref):
            raise AssertionError(f"{label}: {name} differs from K2's plain "
                                 "version")
    nbytes = sum(t.numel() * t.element_size() for t in pack[:5]) \
        + ref.numel() * 4
    bound_ms = nbytes / HBM_BYTES_PER_S * 1e3
    print(f"{label}: nt={vals.shape[0]} P={vals.shape[1]} G={G} S={S}; K2 "
          f"bound {bound_ms:.4f} ms ({nbytes} B at 3.35 TB/s); each K2 "
          "launcher equals the plain version bit for bit")
    times = {name: ([], []) for name in calls}
    order = list(calls)
    for name in order + order[::-1]:
        times[name][0].append(time_ms(calls[name]))
        times[name][1].append(graph_ms(calls[name]))
    for name in order:
        ms = statistics.median(times[name][0])
        gms = statistics.median(times[name][1])
        print(f"  {name:10s} {ms:.4f} ms back to back, {gms:.4f} ms in a "
              f"CUDA graph ({100 * bound_ms / gms:.1f} % of K2's bound)")


def k2_parts(pack, entry):
    """The wrapper's host cost a call, by part (bench_calls.host_parts)."""
    vals, idx, qs, ws, xp, G, S = pack
    nt, P = vals.shape[:2]
    y = torch.empty((nt, G, 128), device=xp.device)
    cargs = tuple(t.data_ptr() for t in (vals, idx, qs, ws, xp, y)) \
        + (nt, P, G, 1, torch._C._cuda_getCurrentRawStream(xp.get_device()))
    got = host_parts(lambda: k2.sell_spmv(*pack[:5], G=G, S=S),
                     lambda: k2._check(*pack[:5], G, S, "diag"), xp,
                     (nt, G, 128), entry, cargs)
    for name, us in got.items():
        print(f"  host {name}: {us:.2f} us a call")


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--grid", type=int, default=128)
    ap.add_argument("--other", action="append", default=[],
                    metavar="NAME=DIR")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("bench_k2: CUDA is not available")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip()
    print(f"card: {smi}")
    _build.build_all(["sell_spmv", "sell_pass"])
    others = {}
    for spec in args.other:
        name, root = spec.split("=", 1)
        others[name] = other_wrapper(name, root, "sell_spmv")
    build_together(list(others.values()), "sell_spmv")
    entries = {"k2 raw": k2._launcher()}
    entries |= {name: mod._launcher() for name, mod in others.items()}
    g = args.grid
    A, _, _ = ex45_system(g, g, g)
    M = sell_from_scipy(A, G=16)
    x = np.random.default_rng(0).standard_normal(A.shape[1])
    xp = M.pad_operand(torch.from_numpy(x.astype(np.float32)).cuda())
    assert M.mode == "diag"
    ex45 = (M.vals, M.idx, M.qs, M.winstart, xp, M.G, M.S)
    g7, h1 = gather7_pack()
    for label, pack, extra in ((f"ex45 {g}^3", ex45, {}),
                               ("gather7 base", g7, {"H1 tile": h1})):
        calls = {"k2": (lambda p=pack: k2.sell_spmv(*p[:5], G=p[5],
                                                    S=p[6]))}
        calls |= {name: runner(fn, pack) for name, fn in entries.items()}
        time_pack(label, pack, calls | extra)
    print(f"host cost of a K2 call on ex45 {g}^3, by part:")
    k2_parts(ex45, entries["k2 raw"])


if __name__ == "__main__":
    main()
