"""The round-4 TPU probes of scripts/probe_*.py as Hopper kernels.

Every Pallas kernel of those scripts is a case here, run through one of
three hand-written CUDA kernels: H1 `ops/sell_pass.py` (the SELL pass
probes), H2 `ops/window_spmv.py` (the windowed SpMV) and H3
`ops/gather_forms.py` (the gather forms). A case rebuilds its script's
inputs from the script's seed, runs the kernel, and holds it to its
plain version (bit for bit) and to the script's numpy emulation; on the
card it also times the kernel, the plain version, one PyTorch call
computing the same function and, for the tile-mode SELL cases at bench
scale, K2 on the same data.

    python -m petsctpu_torch.probes [case ...] [--device cpu]
"""

from __future__ import annotations

import torch

from petsctpu_torch.device import resolve_device
from petsctpu_torch.probes import gather, sell
from petsctpu_torch.probes.common import bound, check, line, measure

CASES = {**gather.CASES, **sell.CASES}


def check_cases(names=None, device=None) -> list:
    """Build the named cases (all by default) on `device` (CUDA unless
    told otherwise), launch each case's kernel once and hold it to its
    plain version and the script's emulation; returns [(case, result)].
    These are the only kernel launches of the path: timing comes after.
    Raises on the first case that disagrees."""
    dev = resolve_device(device)
    names = list(CASES) if not names else list(names)
    unknown = sorted(set(names) - set(CASES))
    if unknown:
        raise ValueError(f"unknown probe cases {unknown}; the cases are "
                         f"{sorted(CASES)}")
    checked = []
    for name in names:
        case = CASES[name](dev)
        out = case.run()
        if dev.type == "cuda":
            torch.cuda.synchronize()
        res = check(case, out)
        res.update(bound(case))
        checked.append((case, res))
    return checked


def run(names=None, device=None) -> list:
    """check_cases, then on the card time every case; prints a line a
    case and returns their results."""
    results = []
    for case, res in check_cases(names, device):
        if res["out"].device.type == "cuda":
            res.update(measure(case, res["out"]))
        print(line(res), flush=True)
        results.append(res)
    return results
