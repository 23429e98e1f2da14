"""Time the host's cost of a kernel wrapper call, by part, on one NVIDIA
card, for probe cases of H1 (`sell_pass`), H2 (`window_spmv`, case
probe_pallas_gather2_window) and H3 (`gather_forms`).

For each case named (by default probe_pallas_gather5_A, H3's slowest
call against its library call, and probe_sell_bisect_d, H1's), it prints
the host microseconds a call of the whole wrapper and of each part a
call goes through (`host_parts` says which).

Then each case's call back to back (CUDA events), its device time in a
CUDA graph and its library call, in turns. `--pairs A B` times two cases
alternately (A B B A, four rounds) to tell a difference between them
from the run's spread. `--root DIR` imports petsctpu_torch from another
checkout (e.g. the parent, unpacked with `git archive`), so that two
trees are measured by one script. Needs CUDA and nvcc; run from the
repository root:

    python3 scripts/bench_calls.py [--root DIR] [--n N] [--pairs A B] [case ...]

`host_us` and `host_parts` are also what `scripts/bench_k2.py` (K2's
parts) and `chip_smoke.py` (phase 13) time a call's parts with, and
`other_wrapper` is how `scripts/bench_k1.py` and `bench_k2.py` load
another checkout's kernel wrapper; they import this file with the
repository already on sys.path.
"""

from __future__ import annotations

import argparse
import importlib.util
import os
import statistics
import subprocess
import sys
import threading
import time


def _root(argv):
    """The checkout whose petsctpu_torch is imported (--root, else this
    one), put first on sys.path before the import."""
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    if "--root" in argv:
        root = os.path.abspath(argv[argv.index("--root") + 1])
    sys.path.insert(0, root)
    return root


ROOT = _root(sys.argv) if __name__ == "__main__" else None

import torch  # noqa: E402

from petsctpu_torch import probes  # noqa: E402
from petsctpu_torch.ops import _build  # noqa: E402
from petsctpu_torch.ops import gather_forms as h3  # noqa: E402
from petsctpu_torch.ops import sell_pass as h1  # noqa: E402
from petsctpu_torch.ops import window_spmv as h2  # noqa: E402
from petsctpu_torch.probes import gather as pg, sell as ps  # noqa: E402
from petsctpu_torch.timing import graph_ms, time_ms  # noqa: E402

DEFAULT = ("probe_pallas_gather5_A", "probe_sell_bisect_d")
# kernel: (wrapper module, the probe module that calls it, the position
# of the size argument of its C entry point)
KERNELS = {"gather_forms": (h3, pg, 6), "sell_pass": (h1, ps, 14),
           "window_spmv": (h2, ps, 6)}


def _module(name, path):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def other_wrapper(name, root, kernel):
    """Another checkout's wrapper module of `kernel` (e.g. "stencil_mult"),
    bound to that checkout's own _build: its kernel is built from
    root's csrc into root's _build and called through its own C
    interface (`_launcher()`, ARGTYPES), so a changed interface still
    works."""
    ops = os.path.join(os.path.abspath(root), "petsctpu_torch", "ops")
    build = _module(f"{kernel}_{name}_build", os.path.join(ops, "_build.py"))
    mod = _module(f"{kernel}_{name}", os.path.join(ops, f"{kernel}.py"))
    mod._build = build
    return mod


def build_together(wrappers, kernel):
    """`kernel` of each wrapper module's checkout, built at once (one nvcc
    each)."""
    errors = []

    def one(mod):
        try:
            mod._build.build_all([kernel])
        except Exception as e:                   # raised below
            errors.append(e)
    threads = [threading.Thread(target=one, args=(m,)) for m in wrappers]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    if errors:
        raise errors[0]


def host_us(fn, n=2000, rounds=5):
    """Host microseconds a call of fn: the median over `rounds` rounds of
    n // rounds calls each, after a warm-up, the card idle before each."""
    for _ in range(3):
        fn()
    per = []
    for _ in range(rounds):
        torch.cuda.synchronize()
        t = time.perf_counter()
        for _ in range(n // rounds):
            fn()
        per.append(1e6 * (time.perf_counter() - t) / (n // rounds))
    torch.cuda.synchronize()
    return statistics.median(per)


def host_parts(call, check, like, shape, entry, cargs, zero=None,
               n=2000) -> dict:
    """{part: host µs a call} of one wrapper call: `call` the whole
    wrapper, `check` its checks, `like` a tensor of its device (the
    output is allocated `shape` beside it), `entry` its C entry point
    and `cargs` the arguments the wrapper gave it (the stream last);
    `zero`, those arguments with the size 0, for which the entry point
    returns before any CUDA call (ctypes alone: the route's floor)."""
    dev, index = like.device, like.get_device()

    def ctx():
        with torch.cuda.device(index):
            pass
    parts = {
        "the whole wrapper": call,
        "checks (_check)": check,
        "torch.empty(shape, dtype, device)":
            lambda: torch.empty(shape, dtype=torch.float32, device=dev),
        "x.new_empty(shape)": lambda: like.new_empty(shape),
        "torch.cuda.current_device()": torch.cuda.current_device,
        "raw device query": torch._C._cuda_getDevice,
        "torch.cuda.device context": ctx,
        "current_stream().cuda_stream":
            lambda: torch.cuda.current_stream(dev).cuda_stream,
        "raw current stream":
            lambda: torch._C._cuda_getCurrentRawStream(index),
        "C entry point (marshalling + launch)": lambda: entry(*cargs),
        "_build.launch (raw stream, device test, C entry point)":
            lambda: _build.launch(entry, index, cargs[:-1]),
        "is_current_stream_capturing (counter)":
            torch._C._cuda_isCurrentStreamCapturing,
        "one data_ptr()": like.data_ptr,
    }
    if zero is not None:
        parts["C entry point, size 0 (marshalling alone)"] = \
            lambda: entry(*zero)
    return {name: host_us(fn, n) for name, fn in parts.items()}


class _Spy:
    """Stands in for a callable, records the arguments of each call and
    passes them on."""

    def __init__(self, fn):
        self.fn, self.calls = fn, []

    def __call__(self, *args, **kw):
        self.calls.append((args, kw))
        return self.fn(*args, **kw)


def _wrapper_args(case):
    """(kernel module, the wrapper's args and kwargs, the C entry point's
    args, the real entry point, the call's output) of one run of case,
    read by standing spies in for the wrapper and its entry point."""
    mod, caller, _ = KERNELS[case.kernel]
    wrapper = getattr(caller, case.kernel)
    spy = _Spy(wrapper)
    setattr(caller, case.kernel, spy)
    launcher = mod._launcher
    entry = _Spy(launcher())
    mod._launcher = lambda: entry
    try:
        out = case.run()
    finally:
        setattr(caller, case.kernel, wrapper)
        mod._launcher = launcher
    torch.cuda.synchronize()
    (args, kw), = spy.calls
    (cargs, _), = entry.calls
    return mod, args, kw, cargs, entry.fn, out


def case_parts(case, n=2000) -> dict:
    """host_parts of one call of a probe case's H1, H2 or H3 wrapper."""
    mod, args, kw, cargs, entry, out = _wrapper_args(case)
    like = args[2]
    if mod is h3:
        form, x, idx, idx2 = (list(args) + [None] * 4)[:4]
        ca = (form, x, idx, idx2, kw.get("t", 0), kw.get("size"),
              kw.get("blocks", 1))
        like = x
    elif mod is h2:
        ca = (*args, kw["Rb"])
        like = args[4]
    else:
        ca = (*args, kw.get("mode", "tile"),
              *(kw.get(k) for k in ("qs", "qbase", "qoff", "hh", "i1")))
    zero = list(cargs)
    zero[KERNELS[case.kernel][2]] = 0
    wrapper = getattr(mod, case.kernel)
    return host_parts(lambda: wrapper(*args, **kw), lambda: mod._check(*ca),
                      like, tuple(out.shape), entry, cargs, zero, n)


def parts(name, n):
    case = probes.CASES[name]("cuda")
    got = case_parts(case, n)
    print(f"host cost of a call, {name} ({case.kernel}):")
    for part, us in got.items():
        print(f"  host {part}: {us:.2f} us a call")


def times(names, rounds):
    """A call back to back, the device time in a CUDA graph and the
    library call of each case, the cases in turns (forwards, then
    backwards, `rounds` times); medians."""
    cases = {name: probes.CASES[name]("cuda") for name in names}
    libs = {name: (c.library() if c.library else None)
            for name, c in cases.items()}
    got = {name: ([], [], []) for name in names}
    for _ in range(rounds):
        for name in list(names) + list(names)[::-1]:
            c, lib = cases[name], libs[name]
            got[name][0].append(time_ms(c.run))
            got[name][1].append(graph_ms(c.run))
            if lib is not None:
                got[name][2].append(time_ms(lib))
    for name in names:
        call, dev, lib = (statistics.median(v) if v else None
                          for v in got[name])
        spread = (min(got[name][0]), max(got[name][0]))
        print(f"  {name}: a call {call:.4f} ms (runs {spread[0]:.4f}-"
              f"{spread[1]:.4f}), device {dev:.4f} ms in a CUDA graph, "
              f"library {'none' if lib is None else f'{lib:.4f} ms'}")


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("cases", nargs="*", default=list(DEFAULT))
    ap.add_argument("--root", default=None)
    ap.add_argument("--n", type=int, default=2000)
    ap.add_argument("--pairs", nargs=2, default=None, metavar="CASE")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("bench_calls: CUDA is not available")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip()
    print(f"card: {smi}; petsctpu_torch from {ROOT}")
    names = args.cases or list(DEFAULT)
    for name in names:
        parts(name, args.n)
    print("calls, in turns:")
    times(names, 2)
    if args.pairs:
        print(f"pair {args.pairs[0]} / {args.pairs[1]}, in turns:")
        for name in args.pairs:
            parts(name, args.n)
        times(args.pairs, 4)


if __name__ == "__main__":
    main()
