"""VTK viewer sink (legacy ASCII .vtk).

Counterpart of petsctpu/io/vtk.py (reference: src/sys/classes/viewer/
impls/vtk, the PETSC_VIEWER_VTK_* sink DMDA and DMPlex fields go
through for ParaView/VisIt):

  * vtk_write_structured: STRUCTURED_POINTS for DMDA fields
    (DMDAVTKWriteAll);
  * vtk_write_plex: UNSTRUCTURED_GRID for a Plex mesh and its vertex and
    cell fields (DMPlexVTKWriteAll).

Fields may be tensors on any device or numpy arrays: each comes down to
float64 numpy before formatting, so a file equals petsctpu's for the
same values, byte for byte.
"""

from __future__ import annotations

import numpy as np
import torch

_VTK_CELL = {  # nodes per cell, spatial dim -> VTK cell type
    (3, 2): 5,    # triangle
    (4, 2): 9,    # quad
    (4, 3): 10,   # tetra
    (8, 3): 12,   # hexahedron
}


def _host(a, dtype=np.float64) -> np.ndarray:
    if isinstance(a, torch.Tensor):
        a = a.detach().cpu().numpy()
    return np.asarray(a, dtype)


def _write_fields(f, n: int, fields: dict, kind: str) -> None:
    f.write(f"{kind} {n}\n")
    for name, data in fields.items():
        data = _host(data)
        # grid-shaped arrays of exactly n values are scalar fields; a
        # trailing component axis (size n*ncomp) makes a vector
        if data.size == n or data.shape[-1] == 1:
            f.write(f"SCALARS {name} double 1\nLOOKUP_TABLE default\n")
            for v in data.reshape(-1):
                f.write(f"{v:.10g}\n")
        else:
            ncomp = data.shape[-1]
            f.write(f"VECTORS {name} double\n")
            for row in data.reshape(-1, ncomp):
                vals = list(row) + [0.0] * (3 - ncomp)
                f.write(f"{vals[0]:.10g} {vals[1]:.10g} {vals[2]:.10g}\n")


def vtk_write_structured(path: str, fields: dict, grid: tuple,
                         spacing: tuple = None,
                         origin: tuple = (0.0, 0.0, 0.0)) -> None:
    """Write DMDA-style fields on a structured grid. fields: name ->
    array of shape grid (scalars) or grid + (dof,) (vectors); grid:
    (nx,), (ny, nx) or (nz, ny, nx), numpy index order."""
    grid = tuple(grid)
    nd = len(grid)
    dims = list(reversed(grid)) + [1] * (3 - nd)      # VTK is x, y, z
    if spacing is None:
        spacing = tuple(1.0 / max(g - 1, 1) for g in dims)
    n = int(np.prod(grid))
    with open(path, "w") as f:
        f.write("# vtk DataFile Version 2.0\n")
        f.write("petsctpu field output\nASCII\n")
        f.write("DATASET STRUCTURED_POINTS\n")
        f.write(f"DIMENSIONS {dims[0]} {dims[1]} {dims[2]}\n")
        f.write(f"ORIGIN {origin[0]} {origin[1]} {origin[2]}\n")
        sp3 = list(spacing) + [1.0] * (3 - len(spacing))
        f.write(f"SPACING {sp3[0]} {sp3[1]} {sp3[2]}\n")
        _write_fields(f, n, fields, "POINT_DATA")


def vtk_write_plex(path: str, plex, point_data: dict = None,
                   cell_data: dict = None) -> None:
    """Write a Plex mesh (and its vertex and cell fields) as an
    UNSTRUCTURED_GRID."""
    coords = _host(plex.coords)
    cells = _host(plex.cells, None)
    nv, dim = coords.shape
    nc, npc = cells.shape
    ctype = _VTK_CELL[(npc, dim)]
    with open(path, "w") as f:
        f.write("# vtk DataFile Version 2.0\n")
        f.write("petsctpu plex output\nASCII\n")
        f.write("DATASET UNSTRUCTURED_GRID\n")
        f.write(f"POINTS {nv} double\n")
        for p in coords:
            xyz = list(p) + [0.0] * (3 - dim)
            f.write(f"{xyz[0]:.10g} {xyz[1]:.10g} {xyz[2]:.10g}\n")
        f.write(f"CELLS {nc} {nc * (npc + 1)}\n")
        for c in cells:
            f.write(str(npc) + " " + " ".join(map(str, c)) + "\n")
        f.write(f"CELL_TYPES {nc}\n")
        for _ in range(nc):
            f.write(f"{ctype}\n")
        if point_data:
            _write_fields(f, nv, point_data, "POINT_DATA")
        if cell_data:
            _write_fields(f, nc, cell_data, "CELL_DATA")
