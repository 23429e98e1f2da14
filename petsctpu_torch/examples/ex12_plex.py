"""SNES ex12 analog: P1 FEM Poisson on an UNSTRUCTURED triangle mesh.

Counterpart of petsctpu's examples/ex12_plex.py. Reference:
src/snes/examples/tutorials/ex12.c (Poisson with FEM on a
DMPlex/DMMesh unstructured mesh). Here: Plex box triangulation, the
element stiffness computed on the device for all cells at once, CG +
(ILU | GAMG).
    python -m petsctpu_torch.examples.ex12_plex -cells 16 -pc_type gamg \\
        -ksp_monitor
"""

from __future__ import annotations

import sys

import numpy as np

from petsctpu_torch.core.options import Options
from petsctpu_torch.device import resolve_device
from petsctpu_torch.dm.plex import Plex, p1_assemble_poisson
from petsctpu_torch.ksp import KSP


def main(argv, device=None):
    dev = resolve_device(device)
    opts = Options.from_args(argv)
    nc = opts.get_int("cells", 16)
    refine = opts.get_int("refine", 0)

    px = Plex.create_box_mesh(nc, nc)
    for _ in range(refine):
        px = px.refine()

    def f(c):
        return 2 * np.pi ** 2 * np.sin(np.pi * c[0]) * np.sin(np.pi * c[1])

    Ad, Ah, b = p1_assemble_poisson(px, f, device=dev)
    ksp = KSP(options=opts)
    ksp.set_operators(Ad, Ah)
    res = ksp.solve(b)
    exact = np.sin(np.pi * px.coords[:, 0]) * np.sin(np.pi * px.coords[:, 1])
    err = np.abs(res.x.cpu().numpy() - exact).max()
    print(f"Plex mesh: {px.num_cells} cells, {px.num_vertices} vertices; "
          f"{'converged' if res.converged else 'FAILED'} in {int(res.its)} "
          f"iterations, max error vs exact = {err:.3e}")
    return res


if __name__ == "__main__":
    main(sys.argv[1:])
