"""Section — per-point DOF layout for unstructured meshes.

Counterpart of petsctpu/dm/section.py (reference: PetscSection as DMPlex
uses it in src/dm/impls/plex/plex.c — DMPlexGetDepthStratum +
PetscSectionGetDof/GetOffset drive every closure/assembly loop).

A Section maps mesh "points" (vertices/edges/faces/cells in a single
numbering) to dof counts and offsets into a flat storage vector:

    sec = Section(npoints)
    sec.set_dof(points, ndof)          # vectorized SetDof
    sec.set_field(name, points, ndof)  # multi-field layouts
    sec.set_constrained(points_or_dofs)  # Dirichlet rows
    sec.setup()                        # computes offsets (SetUp)

The layout is a host plan of numpy arrays; the device only sees the
index arrays it yields (closure_indices) in the assembly's gathers and
folds.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, Optional

import numpy as np


@dataclass
class Section:
    """DOF layout over a point range [0, npoints)."""

    npoints: int
    ndof: np.ndarray = None              # [npoints] dofs per point
    offsets: np.ndarray = None           # [npoints+1] after setup()
    fields: Dict[str, np.ndarray] = field(default_factory=dict)
    constrained: np.ndarray = None       # bool [total_dofs] after setup()
    _constrained_points: list = field(default_factory=list)

    def __post_init__(self):
        if self.ndof is None:
            self.ndof = np.zeros(self.npoints, np.int64)
        else:
            self.ndof = np.asarray(self.ndof, np.int64)

    # ---- layout construction (PetscSectionSetDof / SetFieldDof) ----
    def set_dof(self, points, ndof) -> "Section":
        self.ndof[np.asarray(points)] = ndof
        self.offsets = None
        return self

    def add_dof(self, points, ndof) -> "Section":
        self.ndof[np.asarray(points)] += ndof
        self.offsets = None
        return self

    def set_field(self, name: str, points, ndof) -> "Section":
        """Field layouts: per-field dof counts; total = sum of fields
        (PetscSectionSetFieldDof)."""
        fd = self.fields.setdefault(name,
                                    np.zeros(self.npoints, np.int64))
        fd[np.asarray(points)] = ndof
        self.ndof = sum(self.fields.values())
        self.offsets = None
        return self

    def set_constrained(self, points) -> "Section":
        """Mark every dof of these points constrained
        (PetscSectionSetConstraintDof — Dirichlet rows)."""
        self._constrained_points.append(np.asarray(points))
        return self

    def setup(self) -> "Section":
        """Compute offsets (PetscSectionSetUp)."""
        self.offsets = np.zeros(self.npoints + 1, np.int64)
        np.cumsum(self.ndof, out=self.offsets[1:])
        self.constrained = np.zeros(self.total_dofs, bool)
        for pts in self._constrained_points:
            p = np.atleast_1d(pts).astype(np.int64)
            nd = self.ndof[p]
            # every dof of every point: offsets[p] + 0 .. ndof[p]-1
            first = np.repeat(self.offsets[p], nd)
            self.constrained[first + np.arange(len(first))
                             - np.repeat(np.cumsum(nd) - nd, nd)] = True
        return self

    # ---- queries (GetDof / GetOffset / GetStorageSize) ----
    @property
    def total_dofs(self) -> int:
        if self.offsets is None:
            self.setup()
        return int(self.offsets[-1])

    def dof(self, point) -> np.ndarray:
        return self.ndof[point]

    def offset(self, point) -> np.ndarray:
        if self.offsets is None:
            self.setup()
        return self.offsets[point]

    def field_offset_within(self, name: str, point) -> np.ndarray:
        """Offset of field `name` within point's dof block (fields are
        stored point-major, field-minor — the reference's layout)."""
        off = np.zeros_like(self.ndof[point])
        for fname, fd in self.fields.items():
            if fname == name:
                break
            off = off + fd[point]
        return off

    def point_dofs(self, points) -> np.ndarray:
        """Flat dof indices of `points`, concatenated in point order
        (the closure→indices step of DMPlexMatSetClosure). Requires a
        uniform dof count across the given points."""
        points = np.asarray(points)
        if self.offsets is None:
            self.setup()
        nd = self.ndof[points]
        k = int(nd[0]) if len(nd) else 0
        if len(nd) and not (nd == k).all():
            raise ValueError("point_dofs needs uniform dofs per point")
        return (self.offsets[points][:, None]
                + np.arange(k)[None, :]).reshape(-1)

    def closure_indices(self, cells: np.ndarray) -> np.ndarray:
        """[nc, npc*k] dof indices for each cell's vertex closure —
        the vectorized DMPlexGetClosureIndices. cells: [nc, npc]
        point ids with uniform dofs k."""
        if self.offsets is None:
            self.setup()
        nd = self.ndof[cells]
        k = int(nd.flat[0]) if nd.size else 0
        if nd.size and not (nd == k).all():
            raise ValueError("closure_indices needs uniform dofs")
        base = self.offsets[cells]                       # [nc, npc]
        idx = base[:, :, None] + np.arange(k)[None, None, :]
        return idx.reshape(cells.shape[0], -1)


def vertex_section(nvertices: int, dof: int = 1,
                   constrained: Optional[np.ndarray] = None) -> Section:
    """The common P1/Q1 layout: `dof` dofs on every vertex."""
    s = Section(nvertices).set_dof(np.arange(nvertices), dof)
    if constrained is not None:
        s.set_constrained(constrained)
    return s.setup()
