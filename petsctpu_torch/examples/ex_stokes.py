"""Lid-driven Stokes cavity — saddle-point solve demo.

Counterpart of petsctpu's examples/ex_stokes.py. Analog of the
reference's Stokes tutorials (ksp ex42/ex43-style): MAC-grid Stokes
solved by FGMRES + PCFieldSplit(Schur) with the pressure-constant null
space projected.

    python -m petsctpu_torch.examples.ex_stokes -m 12 -ksp_monitor_short
"""

from __future__ import annotations

import sys

import numpy as np
import torch

from petsctpu_torch.core.options import Options
from petsctpu_torch.device import resolve_device
from petsctpu_torch.ksp import ksp_solve
from petsctpu_torch.mat import aij_from_scipy
from petsctpu_torch.mat.nullspace import make_nullspace
from petsctpu_torch.models.stokes import stokes_mac
from petsctpu_torch.pc import make_pc
from petsctpu_torch.vec.indexset import IS


def main(argv, device=None):
    dev = resolve_device(device)
    opts = Options.from_args(argv)
    m = opts.get_int("m", 12)
    K, b, (vi, pi), blk = stokes_mac(m)
    Kd = aij_from_scipy(K, device=dev)
    pc = make_pc("fieldsplit", A=Kd, A_host=K, options=Options({
        "pc_fieldsplit_fields": [IS.general(vi), IS.general(pi)],
        "pc_fieldsplit_type": opts.get_str("pc_fieldsplit_type", "schur")}))
    v = np.zeros(K.shape[0])
    v[pi] = 1.0
    nsp = make_nullspace(K.shape[0], has_constant=False, vecs=[v],
                         device=dev)
    res = ksp_solve(Kd, torch.from_numpy(b).to(dev), pc=pc,
                    ksp_type="fgmres",
                    rtol=opts.get_real("ksp_rtol", 1e-8), maxits=200,
                    nullspace=nsp,
                    monitor=opts.get_bool("ksp_monitor_short", False))
    x = res.x.cpu().numpy()
    div = np.abs(blk["D"] @ x[vi]).max()
    print(f"Stokes {m}x{m}: {int(res.its)} its, max|div u| = {div:.3e}, "
          f"max|u| = {np.abs(x[vi]).max():.4f}")
    left = [k for k in opts.unused() if k != "m"]
    if left:
        print("WARNING: unused options:", left)
    return res


if __name__ == "__main__":
    main(sys.argv[1:])
