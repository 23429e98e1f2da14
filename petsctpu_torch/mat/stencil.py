"""StencilMat — grid-structured (DIA-style) matrices.

Counterpart of petsctpu/mat/stencil.py. A structured-grid operator (a
DMDA-built matrix, the ex45 and lap2d families) is stored as one
coefficient plane per grid offset, with no index arrays:

Layout: coeffs[d, *grid] for offsets[d] (grid-coordinate tuples).
Row (i,j,..) of A has entry coeffs[d, i,j,..] at column (i,j,..)+off_d.
Out-of-grid neighbours carry coefficient 0 on "none" axes, wrap on
periodic axes and reflect about the boundary node on mirror axes.

  mult :  y = Σ_d coeff_d ⊙ shift(x, +off_d)   (kernel K1 on the card)
  multT:  y = Σ_d shift(coeff_d ⊙ x, −off_d)   (plain tensor code)

`galerkin_coarsen` builds the Galerkin coarse operator PᵀAP of a Q1
transfer by comb probing, on the operator's device.
"""

from __future__ import annotations

import functools
import itertools

import numpy as np
import scipy.sparse as sp
import torch

from petsctpu_torch.device import np_dtype, resolve_device
from petsctpu_torch.ops.stencil_mult import shift, stencil_mult


def _is_diag(off) -> bool:
    return all(o == 0 for o in off)


class StencilMat:
    """coeffs [D, *grid] on the device; offsets, grid and boundary
    (per-axis "none" | "periodic" | "mirror"; () means all "none") are
    static host tuples."""

    def __init__(self, coeffs: torch.Tensor, offsets, grid, boundary=()):
        self.coeffs = coeffs
        self.offsets = tuple(tuple(int(o) for o in off) for off in offsets)
        self.grid = tuple(int(g) for g in grid)
        self.boundary = tuple(boundary)

    @property
    def shape(self):
        n = int(np.prod(self.grid))
        return (n, n)

    @property
    def dtype(self):
        return self.coeffs.dtype

    @property
    def device(self):
        return self.coeffs.device

    @property
    def nnz(self):
        # the dense-stencil count, for flop accounting
        return int(np.prod(self.grid)) * len(self.offsets)

    def mult(self, x: torch.Tensor) -> torch.Tensor:
        """Shape-preserving: flat x gives flat y, grid x gives grid y."""
        return stencil_mult(self.coeffs, x.contiguous(), self.offsets,
                            self.grid, self.boundary)

    def mult_add(self, x, y):
        return y + self.mult(x)

    def multT(self, x: torch.Tensor) -> torch.Tensor:
        if any(b == "mirror" for b in self.boundary):
            # the adjoint of a reflect-read is a fold-back scatter;
            # use the assembled form for transpose solves
            raise NotImplementedError("StencilMat.multT: mirror "
                                      "boundary (assemble to AIJ)")
        xg = x.reshape(self.grid)
        y = torch.zeros_like(xg)
        for d, off in enumerate(self.offsets):
            y = y + shift(self.coeffs[d] * xg, tuple(-o for o in off),
                          self.boundary)
        return y.reshape(x.shape)

    def diagonal(self) -> torch.Tensor:
        for d, off in enumerate(self.offsets):
            if _is_diag(off):
                return self.coeffs[d].reshape(-1)
        return torch.zeros(self.shape[0], dtype=self.dtype,
                           device=self.device)

    def rows_sum(self) -> torch.Tensor:
        return torch.sum(self.coeffs, dim=0).reshape(-1)

    def scale(self, a) -> "StencilMat":
        return StencilMat(self.coeffs * a, self.offsets, self.grid,
                          self.boundary)

    def shift_diag(self, a) -> "StencilMat":
        for d, off in enumerate(self.offsets):
            if _is_diag(off):
                coeffs = self.coeffs.clone()
                coeffs[d] += a
                return StencilMat(coeffs, self.offsets, self.grid,
                                  self.boundary)
        raise ValueError("stencil has no diagonal offset")

    def flops_per_mult(self) -> float:
        return 2.0 * self.nnz - self.shape[0]


# ---- host converters --------------------------------------------------------
def _strides(grid) -> np.ndarray:
    return np.array([int(np.prod(grid[k + 1:])) for k in range(len(grid))],
                    dtype=np.int64)


def stencil_from_scipy(A, grid: tuple, offsets=None, dtype=None,
                       device=None) -> StencilMat:
    """Extract a StencilMat from a scipy matrix known to be grid-banded.

    offsets: iterable of grid-coordinate offsets; if None, inferred from
    the set of flat band offsets present (each must map to an in-grid
    offset with |o_k| < grid[k]). Entry (r, c) lands in plane d when
    c's grid coordinates are r's plus offsets[d]; other entries are
    dropped. One pass over the nonzeros per offset."""
    dev = resolve_device(device)
    grid = tuple(int(g) for g in grid)
    A = sp.csr_matrix(A, copy=True)
    n = int(np.prod(grid))
    if A.shape != (n, n):
        raise ValueError(f"matrix {A.shape} vs grid {grid}")
    A.sum_duplicates()
    strides = _strides(grid)
    coo = A.tocoo()
    rows = coo.row.astype(np.int64)
    cols = coo.col.astype(np.int64)
    if offsets is None:
        offsets = [_unflatten_offset(f, grid, strides)
                   for f in np.unique(cols - rows)]
    offsets = [tuple(int(o) for o in off) for off in offsets]

    # key of each entry's grid offset, in a mixed radix of 2·g_k − 1
    key = np.zeros(len(rows), np.int64)
    for k, (g, s) in enumerate(zip(grid, strides)):
        delta = (cols // s) % g - (rows // s) % g
        key = key * (2 * g - 1) + (delta + g - 1)

    dtype = np_dtype(dtype) or A.dtype
    coeffs = np.zeros((len(offsets), n), dtype=dtype)
    for d, off in enumerate(offsets):
        if any(abs(o) >= g for o, g in zip(off, grid)):
            continue
        kd = 0
        for o, g in zip(off, grid):
            kd = kd * (2 * g - 1) + (o + g - 1)
        hit = key == kd
        coeffs[d, rows[hit]] = coo.data[hit]
    return StencilMat(torch.from_numpy(coeffs.reshape((-1,) + grid)).to(dev),
                      tuple(offsets), grid)


def _unflatten_offset(f: int, grid, strides):
    """Flat column offset → grid offset (choose minimal per-axis moves)."""
    off = []
    rem = int(f)
    for k, s in enumerate(strides):
        lim = grid[k]
        o = int(np.round(rem / s)) if s > 0 else 0
        # clamp to sane stencil range
        o = max(min(o, lim - 1), -(lim - 1))
        off.append(o)
        rem -= o * s
    if rem != 0:
        raise ValueError(f"flat offset {f} not representable on grid {grid}")
    return tuple(off)


def stencil_to_scipy(S: StencilMat):
    """Assemble to scipy CSR (drops zero coefficients)."""
    n = S.shape[0]
    grid = S.grid
    strides = _strides(grid)
    rows_idx = np.arange(n)
    multi = np.stack(np.unravel_index(rows_idx, grid), axis=1)
    rows, cols, vals = [], [], []
    C = S.coeffs.cpu().numpy()
    bnd = S.boundary or ("none",) * len(grid)
    periodic = np.array([b == "periodic" for b in bnd])
    for d, off in enumerate(S.offsets):
        tgt = multi + np.array(off)
        for k in np.where(periodic)[0]:
            tgt[:, k] %= grid[k]
        ok = np.all((tgt >= 0) & (tgt < np.array(grid)), axis=1)
        v = C[d].reshape(-1)
        keep = ok & (v != 0)
        rows.append(rows_idx[keep])
        cols.append((tgt @ strides)[keep])
        vals.append(v[keep])
    return sp.coo_matrix((np.concatenate(vals),
                          (np.concatenate(rows), np.concatenate(cols))),
                         shape=(n, n)).tocsr()


# ---- Galerkin coarsening by comb probing --------------------------------------
def coarse_reach(A: StencilMat) -> tuple:
    """Per-axis stencil reach of Pᵀ A P for Q1 (vertex 2:1) transfers.

    R[q,i] couples |i − 2q| ≤ 1, A couples |j − i| ≤ r, P[j,p] couples
    |j − 2p| ≤ 1, so |q − p| ≤ (r + 2) / 2 per axis."""
    nd = len(A.grid)
    return tuple((max(abs(int(off[ax])) for off in A.offsets) + 2) // 2
                 for ax in range(nd))


def galerkin_coarsen(A: StencilMat, P, coarse_grid: tuple) -> StencilMat:
    """Exact Galerkin coarse operator Ac = Pᵀ A P on A's device.

    The coarse operator is again a stencil with per-axis reach rc (see
    coarse_reach), so probing with combs of coarse unit vectors spaced
    s = 2·rc+1 apart resolves every coarse entry exactly: within any
    s-wide window there is one comb point per class, so y = Pᵀ(A(P·comb
    _class))[q] is the single coefficient A_c[q, p(q, class)]. Π s_ax
    probes (9 for 2-D 5/9-point, 27 for 3-D), one RAP apply each, no
    host copy.

    Returns the full ±rc box stencil (planes that are identically zero
    are kept — they are the DMDA structural zeros)."""
    nd = len(A.grid)
    bnd = A.boundary or ("none",) * nd
    if any(b == "periodic" for b in bnd):
        # comb classes would alias across the wrap unless s | grid;
        # periodic hierarchies keep the host PtAP path
        raise NotImplementedError("galerkin_coarsen: periodic boundary")
    coarse_grid = tuple(coarse_grid)
    rc = coarse_reach(A)
    s = tuple(2 * r + 1 for r in rc)
    classes = list(itertools.product(*[range(si) for si in s]))
    offs_c = list(itertools.product(*[range(-ri, ri + 1) for ri in rc]))

    dev = A.device
    iotas = []
    for ax, g in enumerate(coarse_grid):
        view = [1] * nd
        view[ax] = g
        iotas.append(torch.arange(g, device=dev).reshape(view)
                     .expand(coarse_grid))

    ys = []
    for cls in classes:
        mask = functools.reduce(
            torch.logical_and,
            [(iotas[ax] % s[ax]) == cls[ax] for ax in range(nd)])
        xc = mask.to(A.dtype).reshape(-1)
        ys.append(P.multT(A.mult(P.mult(xc))).reshape(coarse_grid))
    ys = torch.stack(ys)                      # [Πs, *coarse_grid]

    planes = []
    for off in offs_c:
        cls_idx = torch.zeros(coarse_grid, dtype=torch.int64, device=dev)
        for ax in range(nd):
            cls_idx = cls_idx * s[ax] + (iotas[ax] + off[ax]) % s[ax]
        planes.append(torch.gather(ys, 0, cls_idx[None])[0])
    return StencilMat(torch.stack(planes), tuple(offs_c), coarse_grid,
                      A.boundary)
