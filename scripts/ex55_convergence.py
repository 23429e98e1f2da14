"""How CG converges on ksp ex55 (2-D Q1 elasticity, bs 2, soft
inclusion 1e-3) as the mesh is refined, through the port's blocked
formats in fp64: CG + ICC(0) on SBAIJ and CG + pbjacobi on BAIJ.

For each ne it runs the fixed 300 iterations of chip_smoke.py's phases
36-37 and then the same solve to rtol 1e-8, and prints: the history's
first entry, its largest (and where), its entry at 300, the energy
½xᵀAx − bᵀx (which CG lowers at every step) and the true relative
residual after 300 its and at convergence, and the iterations to
converge. It shows whether a history that rises over the first 300
iterations is CG's transient or a solve that does not converge:

  python3 scripts/ex55_convergence.py [--device cpu] [--ne 127 255 ...]
      [--maxits 20000]

On the card it also prints the card's name and power limit.
"""

from __future__ import annotations

import argparse
import os
import subprocess
import sys
import time

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

from petsctpu_torch.core.options import Options  # noqa: E402
from petsctpu_torch.ksp import ksp_solve  # noqa: E402
from petsctpu_torch.mat.factory import mat_from_options  # noqa: E402
from petsctpu_torch.models.elasticity import ex55_system  # noqa: E402
from petsctpu_torch.pc import make_pc  # noqa: E402

FIXED = 300
CASES = (("sbaij", "icc"), ("baij", "pbjacobi"))


def run(A, b, mat_type, pc_type, dev, maxits):
    M, _ = mat_from_options(A, Options({"mat_type": mat_type,
                                        "mat_block_size": "2"}),
                            dtype=torch.float64, device=dev)
    pc = make_pc(pc_type, A=M, A_host=A)
    bt = torch.from_numpy(b).to(dev)
    nb = np.linalg.norm(b)
    out = []
    for rtol, its in ((1e-30, FIXED), (1e-8, maxits)):
        t = time.perf_counter()
        r = ksp_solve(M, bt, pc=pc, ksp_type="cg", rtol=rtol, maxits=its)
        secs = time.perf_counter() - t
        x = r.x.double().cpu().numpy()
        h = r.history[:int(r.its) + 1].numpy()
        out.append(dict(its=int(r.its), reason=int(r.reason), h=h, secs=secs,
                        energy=float(0.5 * x @ (A @ x) - b @ x),
                        resid=float(np.linalg.norm(b - A @ x) / nb)))
    return out


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--ne", type=int, nargs="+",
                    default=[127, 255, 511, 1023])
    ap.add_argument("--maxits", type=int, default=20000)
    a = ap.parse_args()
    for ne in a.ne:
        A, b, _ = ex55_system(ne, 1e-3)
        for mat_type, pc_type in CASES:
            fixed, conv = run(A, b, mat_type, pc_type, a.device, a.maxits)
            h = conv["h"]
            at = h[FIXED] if len(h) > FIXED else float("nan")
            print(f"ne={ne} n={A.shape[0]} {mat_type} CG+{pc_type}: history "
                  f"{h[0]:.6e} first, largest {h.max():.6e} at it "
                  f"{int(h.argmax())}, {at:.6e} at it {FIXED}; after "
                  f"{fixed['its']} its energy {fixed['energy']:.9e}, true rel "
                  f"residual {fixed['resid']:.4e}; to rtol 1e-8: its "
                  f"{conv['its']} reason {conv['reason']} "
                  f"({conv['secs']:.2f} s), energy {conv['energy']:.9e}, "
                  f"true rel residual {conv['resid']:.4e}", flush=True)
    if a.device != "cpu":
        print(subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True,
            text=True).stdout.strip())


if __name__ == "__main__":
    main()
