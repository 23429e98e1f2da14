"""DMPlexInterpolate analog: first-class facet (and 3-D edge) strata.

Counterpart of petsctpu/dm/interp.py: the same host plan, its per-cell
and per-face Python loops (support, match_faces, label_faces) written as
numpy array operations with the same results.

Reference: DMPlexInterpolate_2D/3D (src/dm/impls/plex/plex.c:3893,
:4031) — builds the intermediate mesh points (faces, edges) of the
Hasse diagram so labels can live on facets and facet-integral
(Neumann/Robin) boundary conditions are expressible. Plex-lite keeps
its base cell-vertex storage and attaches the interpolated strata as
a host-side plan:

  chart = [cells 0..nc) [vertices nc..nc+nv) [faces ..+nf) [edges ..+ne)

(the existing cell/vertex point ids — and every label built on them —
are unchanged). Face points carry cone (vertices), support (cells),
measures and outward-normal data for boundary integrals.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from petsctpu_torch.dm.plex import row_keys, unique_rows

# local facet vertex tuples per cell type (by nodes-per-cell, dim)
_FACETS = {
    (3, 2): [(0, 1), (1, 2), (2, 0)],                        # tri
    (4, 2): [(0, 1), (1, 2), (2, 3), (3, 0)],                # quad
    (4, 3): [(0, 1, 2), (0, 1, 3), (0, 2, 3), (1, 2, 3)],    # tet
    (8, 3): [(0, 1, 2, 3), (4, 5, 6, 7), (0, 1, 5, 4),       # hex
             (1, 2, 6, 5), (2, 3, 7, 6), (3, 0, 4, 7)],
}
_EDGES3D = {
    (4, 3): [(0, 1), (0, 2), (0, 3), (1, 2), (1, 3), (2, 3)],
    (8, 3): [(0, 1), (1, 2), (2, 3), (3, 0), (4, 5), (5, 6),
             (6, 7), (7, 4), (0, 4), (1, 5), (2, 6), (3, 7)],
}


@dataclass(frozen=True)
class PlexInterp:
    """Interpolated strata of a base Plex (host plan)."""

    faces: np.ndarray          # [nf, fnodes] vertex ids (first-seen order)
    cell_faces: np.ndarray     # [nc, fpc] face index per local facet
    face_support: np.ndarray   # [nf, 2] cell ids, -1 = none (boundary)
    edges: np.ndarray          # [ne, 2] vertex ids ([0,2] empty in 2-D)

    @property
    def num_faces(self) -> int:
        return self.faces.shape[0]

    @property
    def num_edges(self) -> int:
        return self.edges.shape[0]


def interpolate(plex) -> PlexInterp:
    """Build (and cache on the plex) the interpolated strata."""
    if hasattr(plex, "_interp"):
        return plex._interp
    cells = np.asarray(plex.cells)
    nc, npc = cells.shape
    dim = plex.coords.shape[1]
    locf = np.asarray(_FACETS[(npc, dim)])
    fpc = locf.shape[0]
    allf = cells[:, locf.reshape(-1)].reshape(nc * fpc, -1)
    keys = np.sort(allf, axis=1)
    _, first, inv = unique_rows(keys, return_index=True,
                                return_inverse=True)
    faces = allf[first]                    # first-seen orientation
    cell_faces = inv.reshape(nc, fpc)
    nf = faces.shape[0]
    # support: the first cell to list a face, and the last of the others
    flat = cell_faces.reshape(-1)
    order = np.argsort(flat, kind="stable")
    cell = order // fpc
    start = np.searchsorted(flat[order], np.arange(nf))
    end = np.searchsorted(flat[order], np.arange(nf), side="right")
    support = np.full((nf, 2), -1, np.int64)
    support[:, 0] = cell[start]
    two = end - start >= 2
    support[two, 1] = cell[end[two] - 1]
    if dim == 3:
        loce = np.asarray(_EDGES3D[(npc, dim)])
        alle = cells[:, loce.reshape(-1)].reshape(-1, 2)
        edges = unique_rows(np.sort(alle, axis=1))
    else:
        edges = np.zeros((0, 2), np.int64)
    it = PlexInterp(faces, cell_faces, support, edges)
    object.__setattr__(plex, "_interp", it)
    return it


# ---- chart helpers ---------------------------------------------------------
def face_point(plex, f) -> np.ndarray:
    """Chart point id(s) of face id(s)."""
    return (np.asarray(f, np.int64) + plex.num_cells
            + plex.num_vertices)


def point_face(plex, p) -> np.ndarray:
    return np.asarray(p, np.int64) - plex.num_cells - plex.num_vertices


def edge_point(plex, e) -> np.ndarray:
    it = interpolate(plex)
    return (np.asarray(e, np.int64) + plex.num_cells
            + plex.num_vertices + it.num_faces)


def chart_size(plex) -> int:
    it = interpolate(plex)
    return (plex.num_cells + plex.num_vertices + it.num_faces
            + it.num_edges)


def cone_of_point(plex, p: int) -> np.ndarray:
    """Unified DMPlexGetCone over the interpolated chart: cells ->
    face points, faces -> vertex points, vertices -> []."""
    from petsctpu_torch.dm.label import vertex_point
    it = interpolate(plex)
    nc, nv = plex.num_cells, plex.num_vertices
    if p < nc:
        return face_point(plex, it.cell_faces[p])
    if p < nc + nv:
        return np.zeros(0, np.int64)
    f = p - nc - nv
    if f < it.num_faces:
        return vertex_point(plex, it.faces[f])
    e = f - it.num_faces
    return vertex_point(plex, it.edges[e])


def support_of_point(plex, p: int) -> np.ndarray:
    """Unified DMPlexGetSupport: faces -> cells, vertices -> faces."""
    it = interpolate(plex)
    nc, nv = plex.num_cells, plex.num_vertices
    if p < nc:
        return np.zeros(0, np.int64)
    if p < nc + nv:
        v = p - nc
        return face_point(plex,
                          np.flatnonzero((it.faces == v).any(axis=1)))
    f = p - nc - nv
    s = it.face_support[f]
    return s[s >= 0]


def boundary_faces(plex) -> np.ndarray:
    """Face ids with exactly one supporting cell
    (DMPlexMarkBoundaryFaces on the interpolated mesh)."""
    it = interpolate(plex)
    return np.flatnonzero(it.face_support[:, 1] < 0)


def face_measures(plex, faces=None) -> np.ndarray:
    """Length (2-D) / area (3-D) of each (or the given) faces."""
    it = interpolate(plex)
    f = it.faces if faces is None else it.faces[faces]
    x = np.asarray(plex.coords, float)[f]             # [nf, fnodes, dim]
    if x.shape[2] == 2:                               # edges
        return np.linalg.norm(x[:, 1] - x[:, 0], axis=1)
    if x.shape[1] == 3:                               # triangles
        return 0.5 * np.linalg.norm(
            np.cross(x[:, 1] - x[:, 0], x[:, 2] - x[:, 0]), axis=1)
    # planar quads: split into two triangles
    a1 = 0.5 * np.linalg.norm(
        np.cross(x[:, 1] - x[:, 0], x[:, 2] - x[:, 0]), axis=1)
    a2 = 0.5 * np.linalg.norm(
        np.cross(x[:, 2] - x[:, 0], x[:, 3] - x[:, 0]), axis=1)
    return a1 + a2


def face_centroids(plex, faces=None) -> np.ndarray:
    it = interpolate(plex)
    f = it.faces if faces is None else it.faces[faces]
    return np.asarray(plex.coords, float)[f].mean(axis=1)


def match_faces(plex, facet_nodes: np.ndarray) -> np.ndarray:
    """Face ids of the given facet vertex tuples (order-insensitive);
    -1 when a tuple is not a face of the mesh. The Gmsh reader uses
    this to put $PhysicalNames facet groups onto FACE points."""
    it = interpolate(plex)
    table = np.sort(it.faces, axis=1).astype(np.int64)
    fn = np.sort(np.atleast_2d(np.asarray(facet_nodes, np.int64)),
                 axis=1)
    out = np.full(fn.shape[0], -1, np.int64)
    if fn.shape[1] != table.shape[1] or not len(table):
        return out
    ok = (fn >= 0).all(axis=1)
    base = int(max(table.max(), fn.max(initial=0))) + 1
    if float(base) ** table.shape[1] >= 2.0 ** 62:
        keys = {tuple(k): i for i, k in enumerate(table.tolist())}
        return np.asarray([keys.get(tuple(row), -1) for row in fn.tolist()],
                          np.int64)
    tk, qk = row_keys(table, base), row_keys(fn[ok], base)
    order = np.argsort(tk)
    pos = np.minimum(np.searchsorted(tk[order], qk), len(tk) - 1)
    found = tk[order][pos] == qk
    out[np.flatnonzero(ok)[found]] = order[pos[found]]
    return out


def label_faces(plex, label, values) -> np.ndarray:
    """Face ids carried by the given label values. Face points map
    directly; a legacy vertex-set stratum falls back to the boundary
    faces whose closures lie inside the set."""
    it = interpolate(plex)
    nc, nv = plex.num_cells, plex.num_vertices
    out = []
    for val in np.atleast_1d(values):
        pts = label.stratum(int(val))
        fpts = pts[(pts >= nc + nv) & (pts < nc + nv + it.num_faces)]
        if len(fpts):
            out.append(fpts - nc - nv)
        vpts = pts[(pts >= nc) & (pts < nc + nv)] - nc
        if len(vpts):
            bf = boundary_faces(plex)
            keep = bf[np.isin(it.faces[bf], vpts).all(axis=1)]
            if len(keep):
                out.append(keep.astype(np.int64))
    return (np.unique(np.concatenate(out)) if out
            else np.zeros(0, np.int64))
