"""DMLabel — named point sets for boundary/material markers.

Counterpart of petsctpu/dm/label.py: host numpy as there.

Reference: the label list every DMPlex carries
(src/dm/impls/plex/plex.c:115 `next->name` label walk; labels are
(name, value) -> stratum-of-points maps used for boundary conditions,
material regions, and mesh-generator physical groups). Here a label
is a plain value->sorted-point-array map attached to a Plex; the
point CHART follows the reference's convention of one unified
numbering: [0, nc) cells, [nc, nc+nv) vertices (Plex-lite has no
interpolated edge/face points; edge/face markers are expressed on
their vertex closures, which is what the assembly consumes).
"""

from __future__ import annotations

import numpy as np


class DMLabel:
    """value -> sorted np.int64 array of points (DMLabelSetValue /
    DMLabelGetStratumIS analog)."""

    def __init__(self, name: str):
        self.name = name
        self._strata: dict = {}

    def set_value(self, points, value: int) -> None:
        pts = np.atleast_1d(np.asarray(points, np.int64))
        cur = self._strata.get(int(value))
        self._strata[int(value)] = (
            np.unique(pts) if cur is None
            else np.unique(np.concatenate([cur, pts])))

    def stratum(self, value: int) -> np.ndarray:
        """DMLabelGetStratumIS: the points with this value."""
        return self._strata.get(int(value), np.zeros(0, np.int64))

    def values(self) -> list:
        """DMLabelGetValueIS: sorted list of present values."""
        return sorted(self._strata)

    def get_value(self, point: int) -> int:
        """DMLabelGetValue: -1 when the point is unlabeled."""
        for v, pts in self._strata.items():
            i = np.searchsorted(pts, point)
            if i < len(pts) and pts[i] == point:
                return v
        return -1

    def has_point(self, point: int) -> bool:
        return self.get_value(point) >= 0

    @property
    def num_strata(self) -> int:
        return len(self._strata)

    def stratum_size(self, value: int) -> int:
        return len(self.stratum(value))


def get_labels(plex) -> dict:
    """The label dict of a Plex (created lazily — the reference hangs
    labels off the DM object, plex.c:344)."""
    if not hasattr(plex, "_labels"):
        object.__setattr__(plex, "_labels", {})
    return plex._labels


def create_label(plex, name: str) -> DMLabel:
    """DMCreateLabel analog."""
    labels = get_labels(plex)
    if name not in labels:
        labels[name] = DMLabel(name)
    return labels[name]


def get_label(plex, name: str):
    """DMGetLabel: None when absent."""
    return get_labels(plex).get(name)


def vertex_point(plex, v) -> np.ndarray:
    """Chart point id(s) of vertex id(s) v."""
    return np.asarray(v, np.int64) + plex.num_cells


def point_vertex(plex, p) -> np.ndarray:
    """Vertex id(s) of chart point(s) in the vertex stratum."""
    return np.asarray(p, np.int64) - plex.num_cells


def label_vertices(plex, label: DMLabel, values) -> np.ndarray:
    """Vertex ids carried by the given label values: cell and FACE
    points in the strata are expanded to their vertex closures
    (DMPlexGetTransitiveClosure semantics for the consumers that need
    vertex dofs, e.g. P1 Dirichlet rows)."""
    nc = plex.num_cells
    nv = plex.num_vertices
    out = []
    for val in np.atleast_1d(values):
        pts = label.stratum(int(val))
        cpts = pts[pts < nc]
        vpts = pts[(pts >= nc) & (pts < nc + nv)] - nc
        hpts = pts[pts >= nc + nv]              # faces (and 3-D edges)
        out.append(vpts)
        if len(cpts):
            out.append(np.unique(plex.cells[cpts].reshape(-1)))
        if len(hpts):
            from petsctpu_torch.dm.interp import interpolate
            it = interpolate(plex)
            fids = hpts - nc - nv
            fmask = fids < it.num_faces
            if fmask.any():
                out.append(np.unique(
                    it.faces[fids[fmask]].reshape(-1)))
            emask = ~fmask
            if emask.any():
                out.append(np.unique(
                    it.edges[fids[emask] - it.num_faces].reshape(-1)))
    return (np.unique(np.concatenate(out)) if out
            else np.zeros(0, np.int64))


def mark_boundary(plex, name: str = "marker", value: int = 1) -> DMLabel:
    """DMPlexMarkBoundaryFaces analog: label the boundary vertices
    (faces' closures) with `value`."""
    lab = create_label(plex, name)
    lab.set_value(vertex_point(plex, plex.boundary_vertices()), value)
    return lab
