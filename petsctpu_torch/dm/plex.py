"""Plex — minimal unstructured mesh (DMPlex-lite), and FEM assembly on it.

Counterpart of petsctpu/dm/plex.py (reference: src/dm/impls/plex/plex.c
— DMPlex's cells/faces/edges/vertices as points of a Hasse DAG with
cone/support, PetscSection dof layouts, DMPlexMatSetClosure). Meshes are
host plans of numpy arrays, equal byte for byte to petsctpu's:

  * triangles, tetrahedra, quadrilaterals and hexahedra with cone/
    support, edges, faces and boundary detection;
  * box meshes and regular refinement, built by array operations (the
    reference appends one cell at a time and keeps a dict of edges;
    the arrays here come out the same, in the same order);
  * FEM assembly: the element matrices of all cells at once, as batched
    PyTorch operations on the assembly's device (where petsctpu vmaps
    one cell's kernel); the structural pattern and each entry's slot on
    the host, as in the reference; the numeric sum on the device through
    a fold plan (mat/fold.py), which adds each slot's contributions in
    their order of appearance from +0.0, np.add.at's order, so the sum
    has the host's bits.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable

import numpy as np
import scipy.sparse as sp
import torch

from petsctpu_torch.core.logging import log_event
from petsctpu_torch.device import np_dtype, resolve_device
from petsctpu_torch.mat.fold import fold_plan


# ---------------------------------------------------------------------------
# rows of vertex ids as int64 keys
# ---------------------------------------------------------------------------

def row_keys(rows: np.ndarray, base: int) -> np.ndarray:
    """One int64 key a row of ids below `base`, in lexicographic order."""
    k = np.zeros(rows.shape[0], np.int64)
    for j in range(rows.shape[1]):
        k = k * base + rows[:, j]
    return k


def unique_rows(a, return_index=False, return_inverse=False,
                return_counts=False):
    """np.unique(a, axis=0, ...) for rows of non-negative integer ids,
    through one int64 key a row where the rows fit in one: the same
    arrays in the same order (return_index gives first occurrences in
    both, numpy's stable sort), several times faster. The inverse is
    1-D."""
    a = np.asarray(a)
    flags = dict(return_index=return_index, return_inverse=return_inverse,
                 return_counts=return_counts)
    if (a.ndim != 2 or a.size == 0 or a.dtype.kind not in "iu"
            or a.min() < 0
            or float(a.max()) + 1 >= 2.0 ** (62 / a.shape[1])):
        res = np.unique(a, axis=0, **flags)
        if return_inverse:
            res = list(res)
            res[1 + return_index] = res[1 + return_index].reshape(-1)
            res = tuple(res)
        return res
    base = int(a.max()) + 1
    res = np.unique(row_keys(a.astype(np.int64), base), **flags)
    if not any(flags.values()):
        res = (res,)
    uk = res[0]
    rows = np.empty((len(uk), a.shape[1]), a.dtype)
    for j in reversed(range(a.shape[1])):
        rows[:, j] = uk % base
        uk = uk // base
    return (rows, *res[1:]) if any(flags.values()) else rows


def _pair_indexer(edges: np.ndarray):
    """index(a, b): the index in the sorted unique `edges` [ne, 2] of each
    pair (a, b), either way round (every pair is an edge)."""
    base = int(edges.max()) + 1 if edges.size else 1
    keys = row_keys(edges.astype(np.int64), base)

    def index(a, b):
        a, b = np.asarray(a, np.int64), np.asarray(b, np.int64)
        return np.searchsorted(keys, np.minimum(a, b) * base
                               + np.maximum(a, b))
    return index


def _boundary_vertices(cells: np.ndarray, local) -> np.ndarray:
    """Vertices of the facets (local vertex tuples) owned by one cell."""
    f = np.concatenate([cells[:, list(t)] for t in local])
    uniq, counts = unique_rows(np.sort(f, axis=1), return_counts=True)
    return np.unique(uniq[counts == 1].reshape(-1))


def _unique_local(cells: np.ndarray, local) -> np.ndarray:
    """The unique sorted vertex tuples of the local tuples (edges or
    faces) of every cell."""
    e = np.concatenate([cells[:, list(t)] for t in local])
    return unique_rows(np.sort(e, axis=1))


class _PlexBase:
    """Sizes and the cone/support of vertices, shared by every cell type."""

    @property
    def num_cells(self) -> int:
        return self.cells.shape[0]

    @property
    def num_vertices(self) -> int:
        return self.coords.shape[0]

    def cone(self, c: int) -> np.ndarray:
        """DMPlexGetCone: vertices of cell c."""
        return self.cells[c]

    def support(self, v: int) -> np.ndarray:
        """DMPlexGetSupport: cells touching vertex v."""
        return np.where((self.cells == v).any(axis=1))[0]

    def edges(self) -> np.ndarray:
        """Unique edges [ne, 2] (DMPlexInterpolate's edge construction)."""
        return _unique_local(self.cells, self._EDGE_PAIRS)


def _grid_coords(*n) -> np.ndarray:
    xs = [np.linspace(0.0, 1.0, k + 1) for k in n]
    return np.stack([g.ravel() for g in np.meshgrid(*xs, indexing="ij")],
                    axis=1)


def _grid_index(*n):
    """Lower-corner indices (i, j[, k]) of every box, C order."""
    return [g.ravel() for g in np.meshgrid(*[np.arange(k) for k in n],
                                           indexing="ij")]


@dataclass(frozen=True)
class Plex(_PlexBase):
    """cells: [nc, 3] vertex ids; coords: [nv, 2]."""

    cells: np.ndarray
    coords: np.ndarray

    _EDGE_PAIRS = ((0, 1), (1, 2), (2, 0))

    def boundary_vertices(self) -> np.ndarray:
        """Vertices on edges owned by exactly one cell
        (DMPlexMarkBoundaryFaces analog)."""
        return _boundary_vertices(self.cells, self._EDGE_PAIRS)

    def refine(self) -> "Plex":
        """Regular refinement: each triangle into 4 via edge midpoints."""
        edges = self.edges()
        nv = self.num_vertices
        mid_coords = 0.5 * (self.coords[edges[:, 0]]
                            + self.coords[edges[:, 1]])
        coords = np.concatenate([self.coords, mid_coords])
        index = _pair_indexer(edges)
        a, b, c = self.cells.T
        ab, bc, ca = nv + index(a, b), nv + index(b, c), nv + index(c, a)
        new = np.stack([a, ab, ca, ab, b, bc, ca, bc, c, ab, bc, ca],
                       axis=1).reshape(-1, 3)
        return Plex(new.astype(self.cells.dtype), coords)

    @classmethod
    def create_box_mesh(cls, nx: int, ny: int) -> "Plex":
        """Structured triangulation of the unit square (2 triangles per
        quad; DMPlexCreateBoxMesh analog)."""
        i, j = _grid_index(nx, ny)
        v00, v10 = i * (ny + 1) + j, (i + 1) * (ny + 1) + j
        v01, v11 = v00 + 1, v10 + 1
        cells = np.stack([v00, v10, v11, v00, v11, v01], axis=1)
        return cls(cells.reshape(-1, 3).astype(np.int32),
                   _grid_coords(nx, ny))


@dataclass(frozen=True)
class Plex3D(_PlexBase):
    """3-D tetrahedral Plex: cells [nc, 4] vertex ids; coords [nv, 3]."""

    cells: np.ndarray
    coords: np.ndarray

    _EDGE_PAIRS = ((0, 1), (0, 2), (0, 3), (1, 2), (1, 3), (2, 3))
    _FACE_TRIPLES = ((0, 1, 2), (0, 1, 3), (0, 2, 3), (1, 2, 3))

    def faces(self) -> np.ndarray:
        """Unique triangular faces [nf, 3] (the height-1 stratum)."""
        return _unique_local(self.cells, self._FACE_TRIPLES)

    def boundary_vertices(self) -> np.ndarray:
        """Vertices of faces owned by exactly one tet."""
        return _boundary_vertices(self.cells, self._FACE_TRIPLES)

    def refine(self) -> "Plex3D":
        """Regular 1:8 refinement: 4 corner tets + octahedron split
        along the (m01, m23) diagonal (Bey's red refinement)."""
        edges = self.edges()
        nv = self.num_vertices
        coords = np.concatenate([self.coords,
                                 0.5 * (self.coords[edges[:, 0]]
                                        + self.coords[edges[:, 1]])])
        a, b, c, d = self.cells.T
        index = _pair_indexer(edges)

        def m(p, q):
            return nv + index(p, q)

        ab, ac, ad = m(a, b), m(a, c), m(a, d)
        bc, bd, cd = m(b, c), m(b, d), m(c, d)
        out = np.stack([a, ab, ac, ad, ab, b, bc, bd,
                        ac, bc, c, cd, ad, bd, cd, d,
                        # octahedron {ab,ac,ad,bc,bd,cd} split on (ab, cd)
                        ab, ac, ad, cd, ab, ac, bc, cd,
                        ab, ad, bd, cd, ab, bc, bd, cd], axis=1)
        return Plex3D(out.reshape(-1, 4).astype(self.cells.dtype), coords)

    @classmethod
    def create_box_mesh(cls, nx: int, ny: int, nz: int) -> "Plex3D":
        """Kuhn triangulation of the unit cube grid: 6 tets per cube
        (DMPlexCreateBoxMesh dim=3 analog)."""
        i, j, k = _grid_index(nx, ny, nz)
        v = np.stack([((i + (s & 1)) * (ny + 1) + j + ((s >> 1) & 1))
                      * (nz + 1) + k + ((s >> 2) & 1) for s in range(8)],
                     axis=1)
        # Kuhn: tets follow the 6 permutations of the unit-cube path
        paths = np.array([(0, 1, 3, 7), (0, 1, 5, 7), (0, 2, 3, 7),
                          (0, 2, 6, 7), (0, 4, 5, 7), (0, 4, 6, 7)])
        cells = v[:, paths].reshape(-1, 4)
        return cls(cells.astype(np.int32), _grid_coords(nx, ny, nz))


@dataclass(frozen=True)
class PlexQuad(_PlexBase):
    """2-D quadrilateral Plex: cells [nc, 4] CCW vertex ids; coords
    [nv, 2] (the tensor-cell instantiation, with Q1)."""

    cells: np.ndarray
    coords: np.ndarray

    _EDGE_PAIRS = ((0, 1), (1, 2), (2, 3), (3, 0))

    def boundary_vertices(self) -> np.ndarray:
        return _boundary_vertices(self.cells, self._EDGE_PAIRS)

    def refine(self) -> "PlexQuad":
        """1:4 refinement: edge midpoints + a center point per quad."""
        edges = self.edges()
        nv = self.num_vertices
        nc = self.num_cells
        centers = self.coords[self.cells].mean(axis=1)
        coords = np.concatenate([
            self.coords,
            0.5 * (self.coords[edges[:, 0]] + self.coords[edges[:, 1]]),
            centers])
        c0 = nv + edges.shape[0]
        a, b, c, d = self.cells.T
        index = _pair_indexer(edges)

        def m(p, q):
            return nv + index(p, q)

        ab, bc, cd, da = m(a, b), m(b, c), m(c, d), m(d, a)
        ce = c0 + np.arange(nc)
        out = np.stack([a, ab, ce, da, ab, b, bc, ce,
                        ce, bc, c, cd, da, ce, cd, d], axis=1)
        return PlexQuad(out.reshape(-1, 4).astype(self.cells.dtype), coords)

    @classmethod
    def create_box_mesh(cls, nx: int, ny: int) -> "PlexQuad":
        i, j = _grid_index(nx, ny)
        v00, v10 = i * (ny + 1) + j, (i + 1) * (ny + 1) + j
        cells = np.stack([v00, v10, v10 + 1, v00 + 1], axis=1)
        return cls(cells.astype(np.int32), _grid_coords(nx, ny))


@dataclass(frozen=True)
class PlexHex(_PlexBase):
    """3-D hexahedral Plex: cells [nc, 8] vertex ids in VTK order
    (bottom quad CCW then top quad CCW); coords [nv, 3]."""

    cells: np.ndarray
    coords: np.ndarray

    _EDGE_PAIRS = ((0, 1), (1, 2), (2, 3), (3, 0),
                   (4, 5), (5, 6), (6, 7), (7, 4),
                   (0, 4), (1, 5), (2, 6), (3, 7))
    _FACE_QUADS = ((0, 1, 2, 3), (4, 5, 6, 7), (0, 1, 5, 4),
                   (1, 2, 6, 5), (2, 3, 7, 6), (3, 0, 4, 7))

    def faces(self) -> np.ndarray:
        return _unique_local(self.cells, self._FACE_QUADS)

    def boundary_vertices(self) -> np.ndarray:
        return _boundary_vertices(self.cells, self._FACE_QUADS)

    @classmethod
    def create_box_mesh(cls, nx: int, ny: int, nz: int) -> "PlexHex":
        i, j, k = _grid_index(nx, ny, nz)

        def vid(a, b, c):
            return (a * (ny + 1) + b) * (nz + 1) + c

        cells = np.stack([vid(i, j, k), vid(i + 1, j, k),
                          vid(i + 1, j + 1, k), vid(i, j + 1, k),
                          vid(i, j, k + 1), vid(i + 1, j, k + 1),
                          vid(i + 1, j + 1, k + 1), vid(i, j + 1, k + 1)],
                         axis=1)
        return cls(cells.astype(np.int32), _grid_coords(nx, ny, nz))


# ---------------------------------------------------------------------------
# element kernels: batched over leading dimensions, on the input's device
# ---------------------------------------------------------------------------

def _tri_gradients(X: torch.Tensor):
    """(area, g) of straight triangles X [..., 3, 2]: g [..., 3, 2] the
    physical gradients of the P1 basis, petsctpu's gref @ Jinv with its
    products by 0 and ±1 (exact) left out."""
    p0, p1, p2 = X[..., 0, :], X[..., 1, :], X[..., 2, :]
    a, c = p1 - p0, p2 - p0                  # J's columns
    j00, j10, j01, j11 = a[..., 0], a[..., 1], c[..., 0], c[..., 1]
    det = j00 * j11 - j01 * j10
    area = 0.5 * det.abs()
    inv = ((j11 / det, -j01 / det), (-j10 / det, j00 / det))
    g = torch.stack([torch.stack([-(inv[0][k] + inv[1][k]), inv[0][k],
                                  inv[1][k]], dim=-1) for k in (0, 1)],
                    dim=-1)                  # [..., 3, 2]
    return area, g


def _gram2(G: torch.Tensor) -> torch.Tensor:
    """G Gᵀ for G [..., n, 2], each entry one product plus the other."""
    return (G[..., :, None, 0] * G[..., None, :, 0]
            + G[..., :, None, 1] * G[..., None, :, 1])


def p1_element_stiffness(X: torch.Tensor) -> torch.Tensor:
    """3×3 P1 stiffness of triangles X [..., 3, 2]."""
    area, g = _tri_gradients(X)
    return area[..., None, None] * _gram2(g)


_GREF_TET = ((-1.0, -1.0, -1.0), (1.0, 0.0, 0.0), (0.0, 1.0, 0.0),
             (0.0, 0.0, 1.0))


def p1_element_stiffness_3d(X: torch.Tensor) -> torch.Tensor:
    """4×4 P1 stiffness of tetrahedra X [..., 4, 3] (torch.linalg's
    det and inv where petsctpu uses jnp.linalg's)."""
    J = (X[..., 1:, :] - X[..., :1, :]).transpose(-1, -2)   # [..., 3, 3]
    vol = torch.linalg.det(J).abs() / 6.0
    gref = torch.tensor(_GREF_TET, dtype=X.dtype, device=X.device)
    g = gref @ torch.linalg.inv(J)                           # [..., 4, 3]
    return vol[..., None, None] * (g @ g.transpose(-1, -2))


# Q1 tensor-product elements (2x2 / 2x2x2 Gauss). Corner signs follow
# the cell vertex order (CCW quad; VTK hex).
_Q1_SIGNS_2D = np.array([[-1, -1], [1, -1], [1, 1], [-1, 1]], np.float64)
_Q1_SIGNS_3D = np.array([[-1, -1, -1], [1, -1, -1], [1, 1, -1],
                         [-1, 1, -1], [-1, -1, 1], [1, -1, 1],
                         [1, 1, 1], [-1, 1, 1]], np.float64)


def _q1_gauss(dim: int):
    g = 1.0 / np.sqrt(3.0)
    if dim == 2:
        pts = np.array([(sx * g, sy * g)
                        for sx in (-1, 1) for sy in (-1, 1)])
    else:
        pts = np.array([(sx * g, sy * g, sz * g)
                        for sx in (-1, 1) for sy in (-1, 1)
                        for sz in (-1, 1)])
    return pts, np.ones(len(pts))


def _q1_grad_ref(signs: np.ndarray, xi: np.ndarray) -> np.ndarray:
    """[npc, dim] reference gradients of the Q1 basis at point xi."""
    npc, dim = signs.shape
    G = np.empty((npc, dim))
    for i in range(npc):
        for d in range(dim):
            v = signs[i, d]
            for e in range(dim):
                if e != d:
                    v = v * (1.0 + signs[i, e] * xi[e])
            G[i, d] = v / (2.0 ** dim)
    return G


def q1_element_stiffness(X: torch.Tensor) -> torch.Tensor:
    """4x4 Q1 stiffness of quads X [..., 4, 2] (CCW)."""
    return _q1_stiffness(X, _Q1_SIGNS_2D)


def q1_element_stiffness_3d(X: torch.Tensor) -> torch.Tensor:
    """8x8 Q1 stiffness of hexes X [..., 8, 3] (VTK order)."""
    return _q1_stiffness(X, _Q1_SIGNS_3D)


def _q1_stiffness(X: torch.Tensor, signs: np.ndarray) -> torch.Tensor:
    dim = signs.shape[1]
    pts, wts = _q1_gauss(dim)
    n = signs.shape[0]
    K = torch.zeros((*X.shape[:-2], n, n), dtype=X.dtype, device=X.device)
    for q, w in zip(pts, wts):
        Gref = torch.from_numpy(_q1_grad_ref(signs, q)).to(X.device,
                                                           X.dtype)
        J = X.transpose(-1, -2) @ Gref                     # [..., dim, dim]
        detJ = torch.linalg.det(J)
        g = Gref @ torch.linalg.inv(J)                     # physical grads
        K = K + (w * detJ.abs())[..., None, None] * (g @ g.transpose(-1, -2))
    return K


def _q1_measures(coords: np.ndarray, cells: np.ndarray) -> np.ndarray:
    """Per-cell area/volume by the same Gauss rule."""
    dim = coords.shape[1]
    signs = _Q1_SIGNS_2D if dim == 2 else _Q1_SIGNS_3D
    pts, wts = _q1_gauss(dim)
    out = np.zeros(cells.shape[0])
    xc = coords[cells]                                 # [nc, npc, dim]
    for q, w in zip(pts, wts):
        Gref = _q1_grad_ref(signs, q)                  # [npc, dim]
        J = np.einsum("cpd,pe->cde", xc, Gref)
        out += w * np.abs(np.linalg.det(J))
    return out


def element_kernel_for(plex):
    """The batched stiffness kernel for this Plex's cell type."""
    npc = plex.cells.shape[1]
    dim = plex.coords.shape[1]
    if (npc, dim) == (3, 2):
        return p1_element_stiffness
    if (npc, dim) == (4, 3):
        return p1_element_stiffness_3d
    if (npc, dim) == (4, 2):
        return q1_element_stiffness
    if (npc, dim) == (8, 3):
        return q1_element_stiffness_3d
    raise ValueError(f"no element for npc={npc}, dim={dim}")


def cell_measures(plex) -> np.ndarray:
    npc = plex.cells.shape[1]
    dim = plex.coords.shape[1]
    if (npc, dim) in ((3, 2), (4, 3)):
        return _simplex_measures(plex.coords, plex.cells)
    return _q1_measures(plex.coords, plex.cells)


def _simplex_measures(coords: np.ndarray, cells: np.ndarray) -> np.ndarray:
    """Per-cell area (tri) / volume (tet)."""
    p0 = coords[cells[:, 0]]
    E = np.stack([coords[cells[:, k]] - p0
                  for k in range(1, cells.shape[1])], axis=2)
    if cells.shape[1] == 3:
        return 0.5 * np.abs(E[:, 0, 0] * E[:, 1, 1]
                            - E[:, 0, 1] * E[:, 1, 0])
    return np.abs(np.linalg.det(E)) / 6.0


def element_matrices(plex, kernel, dtype, device) -> torch.Tensor:
    """[nc, npc', npc'] element matrices of every cell on `device`: the
    cells' coordinates gathered there and `kernel` applied to all."""
    coords = torch.from_numpy(np.asarray(plex.coords)).to(device, dtype)
    cells = torch.from_numpy(np.asarray(plex.cells)).to(device).long()
    return kernel(coords[cells])


# ---------------------------------------------------------------------------
# assembly
# ---------------------------------------------------------------------------

def closure_pattern(ci: np.ndarray, ndof: int):
    """The structural pattern of the closure pairs of ci [nc, k] (every
    pair, those whose sums will cancel to 0 too: a plain COO→CSR would
    prune them and break frozen-pattern plans downstream) and each
    entry's slot in it: (indices int32, indptr, slot [nc·k·k])."""
    k = ci.shape[1]
    rows = np.repeat(ci, k, axis=1).reshape(-1)
    cols = np.tile(ci, (1, k)).reshape(-1)
    keys = rows.astype(np.int64) * ndof + cols
    ukeys, slot = np.unique(keys, return_inverse=True)
    indptr = np.searchsorted(ukeys // ndof, np.arange(ndof + 1))
    return (ukeys % ndof).astype(np.int32), indptr, slot.reshape(-1)


def closure_sum(slot: np.ndarray, nslots: int, Ke: torch.Tensor):
    """Each slot's element contributions summed on Ke's device, in their
    order of appearance from +0.0 (np.add.at(zeros, slot, Ke)'s bits)."""
    plan = fold_plan(torch.from_numpy(slot).to(Ke.device))
    start = torch.zeros(nslots, dtype=Ke.dtype, device=Ke.device)
    return plan.fold(start, Ke.reshape(-1))


def _assemble(plex, kernel, ci, ndof, dtype, dev):
    """Host CSR of the element matrices of `kernel` scattered by the
    closure indices ci, under the log events DMPlexElementKernel
    (device), DMPlexPattern (host), DMPlexSum (device, and the copy of
    the sums to the host)."""
    tdt = torch.float64 if np.dtype(dtype) == np.float64 else torch.float32
    with log_event("DMPlexElementKernel"):
        Ke = element_matrices(plex, kernel, tdt, dev)
    with log_event("DMPlexPattern"):
        indices, indptr, slot = closure_pattern(ci, ndof)
    with log_event("DMPlexSum"):
        data = closure_sum(slot, len(indices), Ke).cpu().numpy()
    return sp.csr_matrix((data, indices, indptr), shape=(ndof, ndof))


def _dirichlet(A: sp.csr_matrix, b: np.ndarray, con: np.ndarray) -> None:
    """Zero the constrained rows and columns IN the pattern (MatZeroRows
    keeps it), a unit diagonal, a zero right-hand side."""
    ndof = A.shape[0]
    rr = np.repeat(np.arange(ndof), np.diff(A.indptr))
    A.data[con[rr] | con[A.indices]] = 0.0
    A.data[(A.indices == rr) & con[rr]] = 1.0
    b[con] = 0.0


def _resolve(plex, spec):
    from petsctpu_torch.dm.label import DMLabel, get_label
    lab_or_name, vals, gfun = spec
    if isinstance(lab_or_name, DMLabel):
        lab = lab_or_name
    else:
        lab = get_label(plex, lab_or_name)
        if lab is None:
            raise ValueError(f"no label {lab_or_name!r}")
    return lab, vals, gfun


def _facet_values(plex, spec):
    """(facet vertex ids [nf, fnodes], measure × value a facet) of a
    neumann/robin spec, or None when its label selects no facet."""
    from petsctpu_torch.dm.interp import (face_centroids, face_measures,
                                          interpolate, label_faces)
    lab, vals, g = _resolve(plex, spec)
    fids = label_faces(plex, lab, vals)
    if not len(fids):
        return None
    meas = face_measures(plex, fids)
    cen = face_centroids(plex, fids)
    gv = (np.asarray([g(c) for c in cen], float) if callable(g)
          else float(g) * np.ones(len(fids)))
    return interpolate(plex).faces[fids], gv, meas


def fem_assemble_poisson(plex, f: Callable = None, dtype=np.float64,
                         section=None, bc_label=None, neumann=None,
                         robin=None, device=None):
    """Assemble A, b for −Δu = f with homogeneous Dirichlet boundary,
    on any Plex cell type (tri/quad P1/Q1 in 2-D, tet/hex in 3-D).

    Returns (A AIJ on `device`, A_host scipy CSR, b on `device`). The
    element matrices of all cells are computed at once on the device;
    the dof scatter goes through a Section (closure_indices — the
    vectorized DMPlexMatSetClosure); the pattern is built on the host
    and the sums folded on the device (module docstring), then
    identity boundary rows on the host (the ex12-style path).

    bc_label: optional (label_name, values) pair or DMLabel — Dirichlet
    dofs from the named point sets instead of the whole topological
    boundary (DMAddBoundary over a DMLabel).

    neumann: optional (label|name, values, g) — adds int_Gamma g v ds
    over the label's facet points (one-point facet rule); g a callable
    of the facet centroid or a constant.

    robin: optional (label|name, values, alpha) — adds the lumped facet
    mass alpha int_Gamma u v ds to the operator's diagonal."""
    from petsctpu_torch.dm.section import vertex_section
    from petsctpu_torch.mat.ell import aij_from_scipy

    dev = resolve_device(device)
    dtype = np_dtype(dtype).type
    npc = plex.cells.shape[1]                          # nodes per cell
    nc = plex.num_cells
    nv = plex.num_vertices
    if bc_label is not None:
        from petsctpu_torch.dm.label import DMLabel, get_label, \
            label_vertices
        if isinstance(bc_label, DMLabel):
            lab, vals = bc_label, bc_label.values()
        else:
            name, vals = bc_label
            lab = get_label(plex, name)
            if lab is None:
                raise ValueError(f"no label {name!r} on this Plex")
        bnd = label_vertices(plex, lab, vals)
    else:
        bnd = plex.boundary_vertices()
    if section is None:
        section = vertex_section(nv, dof=1, constrained=bnd)
    ndof = section.total_dofs
    ci = section.closure_indices(plex.cells)           # [nc, npc]
    A = _assemble(plex, element_kernel_for(plex), ci, ndof, dtype, dev)

    with log_event("DMPlexLoad"):
        # load vector: one-point rule (measure/npc per vertex)
        centroids = plex.coords[plex.cells].mean(axis=1)
        measures = cell_measures(plex)
        fc = (np.ones(nc) if f is None
              else np.asarray([f(c) for c in centroids], float))
        b = np.zeros(ndof)
        np.add.at(b, ci.reshape(-1), np.repeat(measures * fc / npc, npc))
        if neumann is not None:
            fv = _facet_values(plex, neumann)
            if fv is not None:
                fverts, gv, meas = fv
                fnodes = fverts.shape[1]
                np.add.at(b, section.closure_indices(fverts).reshape(-1),
                          np.repeat(meas * gv / fnodes, fnodes))
    with log_event("DMPlexBC"):
        if robin is not None:
            fv = _facet_values(plex, robin)
            if fv is not None:
                fverts, av, meas = fv
                fnodes = fverts.shape[1]
                # lumped facet mass onto the diagonal (pattern has it)
                Ad_ = A.diagonal()
                np.add.at(Ad_, section.closure_indices(fverts).reshape(-1),
                          np.repeat(av * meas / fnodes, fnodes))
                A.setdiag(Ad_)
        _dirichlet(A, b, section.constrained)
    with log_event("DMPlexUpload"):
        Ad = aij_from_scipy(A, dtype=dtype, device=dev)
        bd = torch.from_numpy(b).to(dev, Ad.dtype)
    return Ad, A, bd


def p1_assemble_poisson(plex, f: Callable = None, dtype=np.float64,
                        device=None):
    """Back-compat alias (rounds 1-2 name)."""
    return fem_assemble_poisson(plex, f=f, dtype=dtype, device=device)


# ---------------------------------------------------------------------------
# P2 (quadratic) triangles through the Section — dofs on vertices AND
# edge midpoints (the multi-stratum PetscSection layout)
# ---------------------------------------------------------------------------

_P2_QPTS = ((0.5, 0.5, 0.0), (0.0, 0.5, 0.5), (0.5, 0.0, 0.5))
_P2_EDGES = ((0, 1), (1, 2), (2, 0))


def p2_element_stiffness(X: torch.Tensor) -> torch.Tensor:
    """6×6 P2 stiffness of straight triangles X [..., 3, 2].

    Local ordering: vertices 0,1,2 then midpoints of edges (0,1),
    (1,2), (2,0). Barycentric shapes N_i = λ_i(2λ_i−1),
    N_{3+k} = 4λ_aλ_b; the 3-midpoint rule integrates the quadratic
    gradient products exactly."""
    area, glam = _tri_gradients(X)           # ∇λ, constant on a cell
    gl = [glam[..., i, :] for i in range(3)]
    K = torch.zeros((*X.shape[:-2], 6, 6), dtype=X.dtype, device=X.device)
    w = (area / 3.0)[..., None, None]
    for lam in _P2_QPTS:
        G = [(4.0 * lam[i] - 1.0) * gl[i] for i in range(3)]
        G += [4.0 * (lam[a] * gl[b] + lam[b] * gl[a]) for a, b in _P2_EDGES]
        K = K + w * _gram2(torch.stack(G, dim=-2))
    return K


def p2_closure(plex):
    """[nc, 6] closure point ids (vertices then edge points offset by
    nv) and the edge table used for the numbering."""
    edges = plex.edges()
    nv = plex.num_vertices
    index = _pair_indexer(edges)
    a, b, d = plex.cells.T
    cl = np.empty((plex.num_cells, 6), np.int64)
    cl[:, :3] = plex.cells
    cl[:, 3], cl[:, 4], cl[:, 5] = (nv + index(a, b), nv + index(b, d),
                                    nv + index(d, a))
    return cl, edges


def p2_assemble_poisson(plex, f: Callable = None, dtype=np.float64,
                        device=None):
    """Assemble −Δu = f with P2 triangles, homogeneous Dirichlet.

    Returns (A on `device`, A_host, b on `device`, node_coords) where
    node_coords [nv+ne, 2] includes the edge midpoints (for evaluating
    exact solutions at every dof)."""
    from petsctpu_torch.dm.section import Section
    from petsctpu_torch.mat.ell import aij_from_scipy

    dev = resolve_device(device)
    dtype = np_dtype(dtype).type
    cl, edges = p2_closure(plex)
    nv = plex.num_vertices
    npts = nv + edges.shape[0]
    mids = 0.5 * (plex.coords[edges[:, 0]] + plex.coords[edges[:, 1]])
    node_coords = np.concatenate([plex.coords, mids])

    # boundary: vertices on boundary + midpoints of boundary edges (the
    # unique sorted edges are plex.edges() itself)
    e_all = np.concatenate([plex.cells[:, [0, 1]], plex.cells[:, [1, 2]],
                            plex.cells[:, [2, 0]]])
    uniq, counts = unique_rows(np.sort(e_all, axis=1), return_counts=True)
    bnd_v = np.unique(uniq[counts == 1].reshape(-1))
    bnd_e = nv + np.flatnonzero(counts == 1).astype(np.int64)
    con_pts = np.concatenate([bnd_v, bnd_e])

    sec = Section(npts).set_dof(np.arange(npts), 1)
    sec.set_constrained(con_pts)
    sec.setup()

    ci = sec.closure_indices(cl)                      # [nc, 6]
    ndof = sec.total_dofs
    A = _assemble(plex, p2_element_stiffness, ci, ndof, dtype, dev)

    # load: midpoint rule — only edge dofs receive load (vertex P2
    # shapes vanish at midpoints); ∫ N_edge = area/3
    measures = _simplex_measures(plex.coords, plex.cells)
    b = np.zeros(ndof)
    for k in range(3, 6):
        pts = node_coords[cl[:, k]]
        fv = (np.ones(len(pts)) if f is None
              else np.asarray([f(p) for p in pts], float))
        np.add.at(b, ci[:, k], measures / 3.0 * fv)

    _dirichlet(A, b, sec.constrained)
    Ad = aij_from_scipy(A, dtype=dtype, device=dev)
    return Ad, A, torch.from_numpy(b).to(dev, Ad.dtype), node_coords
