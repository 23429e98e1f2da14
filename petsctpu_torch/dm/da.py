"""DA — structured-grid manager (DMDA analog).

Counterpart of petsctpu/dm/da.py (reference: src/dm/impls/da —
DMDACreate2d da2.c:870, DMDACreate3d da3.c:1480; Q1 interpolation
dainterp.c:53; stencil preallocation fdda.c):

  * vectors are grid-shaped tensors; the "ghost update" of a stencil
    op is a padded read, not a scatter plan;
  * DMCreateMatrix returns an empty StencilMat — assembly writes
    coefficient planes, never (row, col) triples;
  * refinement follows the vertex-centred rule m_fine = 2·m_coarse − 1
    (periodic axes: ratio 2), and interpolation is matrix-free Q1
    (tensor-product linear), with a scipy twin for Galerkin setup.
"""

from __future__ import annotations

import itertools
from dataclasses import dataclass
from typing import Tuple

import numpy as np
import scipy.sparse as sp
import torch
import torch.nn.functional as F

from petsctpu_torch.device import resolve_device
from petsctpu_torch.ops.stencil_mult import mirror_index


@dataclass(frozen=True)
class DA:
    """Host-side descriptor of a structured grid (1/2/3-D, dof=1)."""

    grid: Tuple[int, ...]           # global dims, natural ordering
    stencil_width: int = 1
    stencil_type: str = "star"      # star | box
    # per-axis DMDABoundaryType (petscdmda.h:51):
    # "none" | "ghosted" | "mirror" | "periodic"; a bare string
    # applies to every axis. GHOSTED = ghost slots exist and carry a
    # USER value (the `fill` argument of local_with_ghosts); MIRROR
    # reflects about the boundary node.
    boundary: Tuple[str, ...] = ()

    def boundary_types(self) -> Tuple[str, ...]:
        b = self.boundary
        if not b:
            return ("none",) * self.ndim
        if isinstance(b, str):
            return (b,) * self.ndim
        return tuple(b)

    @property
    def ndim(self):
        return len(self.grid)

    @property
    def n(self):
        return int(np.prod(self.grid))

    # ---- vectors ------------------------------------------------------
    def create_global_vector(self, dtype=torch.float64, device=None):
        return torch.zeros(self.n, dtype=dtype, device=resolve_device(device))

    def to_grid(self, x):
        return x.reshape(self.grid)

    def from_grid(self, xg):
        return xg.reshape(-1)

    def local_with_ghosts(self, x, fill=0.0):
        """Ghosted view: the grid tensor padded by stencil_width (the
        DMGlobalToLocal analog for one process). Periodic axes wrap,
        mirror axes reflect about the boundary node, "none"/"ghosted"
        axes take `fill` (the user-set ghost value)."""
        xg = self.to_grid(x)
        w = self.stencil_width
        bts = self.boundary_types()
        if all(b in ("none", "ghosted") for b in bts):
            return F.pad(xg, (w, w) * xg.dim(), value=fill)
        for ax, b in enumerate(bts):
            m = xg.shape[ax]
            j = torch.arange(-w, m + w, device=xg.device)
            if b == "periodic":
                xg = xg.index_select(ax, torch.remainder(j, m))
            elif b == "mirror":
                xg = xg.index_select(ax, mirror_index(j, m))
            else:
                pad = [0, 0] * xg.dim()
                pad[2 * (xg.dim() - 1 - ax):2 * (xg.dim() - ax)] = [w, w]
                xg = F.pad(xg, pad, value=fill)
        return xg

    # ---- stencil offsets ----------------------------------------------
    def stencil_offsets(self):
        w = self.stencil_width
        offs = []
        for off in itertools.product(range(-w, w + 1), repeat=self.ndim):
            if self.stencil_type == "star" and \
                    sum(1 for o in off if o != 0) > 1:
                continue
            offs.append(off)
        # diagonal first (conventional)
        offs.sort(key=lambda o: (sum(abs(v) for v in o), o))
        return tuple(offs)

    def create_matrix(self, dtype=torch.float64, device=None):
        """Empty StencilMat with this grid's stencil pattern (and this
        grid's boundary types: periodic axes wrap in the operator)."""
        from petsctpu_torch.mat.stencil import StencilMat
        offs = self.stencil_offsets()
        coeffs = torch.zeros((len(offs),) + tuple(self.grid), dtype=dtype,
                             device=resolve_device(device))
        bts = self.boundary_types()
        return StencilMat(coeffs, offs, self.grid,
                          () if all(b == "none" for b in bts) else bts)

    # ---- hierarchy -----------------------------------------------------
    def coarsen(self) -> "DA":
        """Vertex-centred axes: m_c = (m_f + 1)/2 (inverse of the
        reference's 2x−1 refine); periodic axes: m_c = m_f/2 (ratio-2
        wrap rule, dainterp.c:67-69)."""
        cg = tuple(g // 2 if b == "periodic" else (g + 1) // 2
                   for g, b in zip(self.grid, self.boundary_types()))
        if any(c < 2 for c in cg):
            raise ValueError(f"cannot coarsen grid {self.grid}")
        return DA(cg, self.stencil_width, self.stencil_type,
                  self.boundary)

    def refine(self) -> "DA":
        return DA(tuple(2 * g if b == "periodic" else 2 * g - 1
                        for g, b in zip(self.grid,
                                        self.boundary_types())),
                  self.stencil_width, self.stencil_type, self.boundary)

    def can_coarsen(self) -> bool:
        def ok(g, b):
            if b == "periodic":
                return g % 2 == 0 and g // 2 >= 2
            return (g + 1) // 2 >= 2 and (g % 2 == 1)
        return all(ok(g, b)
                   for g, b in zip(self.grid, self.boundary_types()))

    def interpolation_scipy(self, coarse: "DA") -> sp.csr_matrix:
        return q1_interp_scipy(self.grid, coarse.grid,
                               self.boundary_types())

    def interpolation(self, coarse: "DA") -> "Q1Interp":
        if coarse.grid != tuple((g + 1) // 2 for g in self.grid):
            raise ValueError(f"{coarse.grid} is not the coarsening of "
                             f"{self.grid}")
        return Q1Interp(self.grid, coarse.grid)

    def coordinates(self, lo=0.0, hi=1.0):
        """Uniform vertex coordinates per axis (host arrays)."""
        return [np.linspace(lo, hi, g) for g in self.grid]


# ---------------------------------------------------------------------------
# Q1 (multilinear) interpolation, matrix-free
# ---------------------------------------------------------------------------
def _interp_axis(X, axis, nf):
    """1-D linear interpolation along `axis`: nc → nf = 2·nc − 1."""
    X = torch.movedim(X, axis, 0)
    out = torch.zeros((nf,) + tuple(X.shape[1:]), dtype=X.dtype,
                      device=X.device)
    out[::2] = X
    out[1::2] = 0.5 * (X[:-1] + X[1:])
    return torch.movedim(out, 0, axis)


def _restrict_axis(X, axis, nc):
    """Adjoint of _interp_axis (Pᵀ, unscaled — full weighting × 2)."""
    X = torch.movedim(X, axis, 0)
    even = X[::2]
    half_odd = 0.5 * X[1::2]
    z = torch.zeros_like(even[:1])
    left = torch.cat([z, half_odd], dim=0)
    right = torch.cat([half_odd, z], dim=0)
    out = even + left + right
    return torch.movedim(out, 0, axis)


class Q1Interp:
    """Matrix-free prolongation P: coarse → fine (dainterp.c analog).

    mult  = P  (coarse→fine Q1 interpolation)
    multT = Pᵀ (restriction; PCMG applies MatRestrict = Pᵀ)
    """

    def __init__(self, fine: tuple, coarse: tuple):
        self.fine = tuple(fine)
        self.coarse = tuple(coarse)

    @property
    def shape(self):
        return (int(np.prod(self.fine)), int(np.prod(self.coarse)))

    def mult(self, xc):
        X = xc.reshape(self.coarse)
        for ax in range(len(self.fine)):
            X = _interp_axis(X, ax, self.fine[ax])
        return X.reshape(-1)

    def multT(self, xf):
        X = xf.reshape(self.fine)
        for ax in range(len(self.fine)):
            X = _restrict_axis(X, ax, self.coarse[ax])
        return X.reshape(-1)


def q0_interp_scipy(fine: tuple, coarse: tuple) -> sp.csr_matrix:
    """Piecewise-constant (cell-centred) interpolation — the DMDA_Q0
    path (DMCreateInterpolation_DA_3D_Q0, dainterp.c:588): fine cell
    (i,j,k) takes coarse cell (i//r, j//r, k//r)'s value, ratio
    r = mf/mc per axis ∈ {1,2}. Restriction (Pᵀ) sums the children."""
    if len(fine) != len(coarse):
        raise ValueError(f"grids {fine} and {coarse} differ in dimension")
    nf = int(np.prod(fine))
    idx = np.arange(nf)
    coords = np.unravel_index(idx, fine)      # C-order, last axis fastest
    ccoords = []
    for ax in range(len(fine)):
        r = fine[ax] // coarse[ax]
        if r * coarse[ax] != fine[ax] or r not in (1, 2):
            raise ValueError(f"Q0 needs ratio 1 or 2 per axis: {fine} "
                             f"over {coarse}")
        ccoords.append(coords[ax] // r)
    col = np.ravel_multi_index(tuple(ccoords), coarse)
    return sp.csr_matrix((np.ones(nf), (idx, col)),
                         shape=(nf, int(np.prod(coarse))))


def q1_interp_scipy(fine: tuple, coarse: tuple,
                    boundary: tuple = ()) -> sp.csr_matrix:
    """scipy twin of Q1Interp (for Galerkin PᵀAP setup and tests).

    boundary: per-axis "none"|"periodic" (DMCreateInterpolation_DA_*_Q1
    dainterp.c:67-73 — periodic axes use ratio mx/Mx with a wrapping
    right neighbour; the others use the vertex-centred 2x−1 rule)."""
    def p1d(nc, nf):
        i = np.arange(nc)
        h = np.arange(nc - 1)
        rows = np.concatenate([2 * i, 2 * h + 1, 2 * h + 1])
        cols = np.concatenate([i, h, h + 1])
        vals = np.concatenate([np.ones(nc), np.full(2 * (nc - 1), 0.5)])
        return sp.coo_matrix((vals, (rows, cols)), shape=(nf, nc)).tocsr()

    def p1d_periodic(nc, nf):
        # dainterp.c:93-118 with bx periodic: i_c = i//ratio, weights
        # (1−x, x) at (i_c, i_c+1 mod Mx), x = (i − i_c·ratio)/ratio
        ratio = nf // nc
        if ratio * nc != nf:
            raise ValueError(f"periodic axis {nf} is not a multiple of {nc}")
        rows, cols, vals = [], [], []
        for i in range(nf):
            ic = i // ratio
            x = (i - ic * ratio) / ratio
            rows.append(i)
            cols.append(ic)
            vals.append(1.0 - x)
            if ic * ratio != i:
                rows.append(i)
                cols.append((ic + 1) % nc)
                vals.append(x)
        return sp.coo_matrix((vals, (rows, cols)), shape=(nf, nc)).tocsr()

    bts = (boundary if boundary else ("none",) * len(fine))
    if isinstance(bts, str):
        bts = (bts,) * len(fine)

    def axis(k):
        return (p1d_periodic(coarse[k], fine[k]) if bts[k] == "periodic"
                else p1d(coarse[k], fine[k]))

    P = axis(0)
    for k in range(1, len(fine)):
        P = sp.kron(P, axis(k), format="csr")
    return P


def interp_dof_scipy(P: sp.csr_matrix, dof: int) -> sp.csr_matrix:
    """MAIJ expansion P ⊗ I_dof for interleaved multi-component grids
    (DMCreateInterpolation_DA wraps DMDA interpolation in MATMAIJ when
    dof > 1)."""
    if dof == 1:
        return P
    return sp.kron(P, sp.identity(dof, format="csr"), format="csr")
