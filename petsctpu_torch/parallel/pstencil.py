"""Sharded stencil matrices: structured-grid SPMD with ppermute halos.

Counterpart of petsctpu/parallel/pstencil.py (the reference's DMDA
ghost exchange, src/dm/impls/da/da2.c:664 — ghost scatters sized by
the stencil width): the grid's slowest axis is split over the ranks;
each product exchanges `w` boundary rows with the two neighbour ranks
through two Comm.ppermute calls, then sums the stencil's shifted
copies of the extended slab, as PyTorch ops, in petsctpu's order (it
does not call the stencil kernel here either). A rank without a
neighbour receives zeros, the out-of-grid value.

ShardedQ1Interp is the sharded twin of dm.da.Q1Interp between two
levels whose leading axes are split with aligned boundaries.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as TF

from petsctpu_torch.device import resolve_device


def shift(xg: torch.Tensor, off: tuple) -> torch.Tensor:
    """s with s[idx] = xg[idx + off] over the trailing len(off) axes,
    zero outside the grid."""
    nd = len(off)
    lead = xg.dim() - nd
    pads = []
    for o in reversed(off):
        o = int(o)
        pads += [max(-o, 0), max(o, 0)]
    xp = TF.pad(xg, pads)
    sl = [slice(None)] * lead
    for ax, o in enumerate(off):
        o = int(o)
        dim = xg.shape[lead + ax]
        sl.append(slice(o, o + dim) if o >= 0 else slice(0, dim))
    return xp[tuple(sl)]


def exchange_rows(xg: torch.Tensor, comm, w: int, axis: int = 0):
    """xg extended along `axis` by w rows from each neighbour rank (the
    previous rank's last rows before, the next rank's first after)."""
    P = comm.size
    fwd = [(i, i + 1) for i in range(P - 1)]
    bwd = [(i + 1, i) for i in range(P - 1)]
    n = xg.shape[axis]
    above, below = comm.ppermutes([
        (xg.narrow(axis, n - w, w).contiguous(), fwd),
        (xg.narrow(axis, 0, w).contiguous(), bwd)])
    return torch.cat([above, xg, below], dim=axis)


class ShardedStencil:
    """Per-rank coefficient slabs coeffs[p] [D, mloc, *rest] of a
    StencilMat split along its leading grid axis (padded to P·mloc with
    identity rows); rank(comm) gives the rank's operator."""

    def __init__(self, coeffs, offsets, grid, nshards: int, halo: int = 1):
        self.coeffs = coeffs
        self.offsets = tuple(tuple(int(o) for o in off) for off in offsets)
        self.grid = tuple(grid)
        self.nshards = nshards
        self.halo = halo

    @property
    def shape(self):
        n = int(np.prod(self.grid))
        return (n, n)

    @property
    def mloc(self) -> int:
        return self.grid[0] // self.nshards

    @property
    def dtype(self):
        return self.coeffs[0].dtype

    def rank(self, comm) -> "RankStencil":
        return RankStencil(self.coeffs[comm.rank], self.offsets, self.grid,
                           comm, self.halo)


class RankStencil:
    """One rank's slab of a sharded stencil, bound to its Comm."""

    def __init__(self, coeffs, offsets, grid, comm, halo: int = 1):
        self.coeffs = coeffs
        self.offsets = offsets
        self.grid = grid
        self.comm = comm
        self.halo = halo
        self.mloc = coeffs.shape[1]
        n = int(np.prod(coeffs.shape[1:]))
        self.shape = (n, n)

    @property
    def dtype(self):
        return self.coeffs.dtype

    @property
    def device(self):
        return self.coeffs.device

    def mult(self, x: torch.Tensor) -> torch.Tensor:
        w = self.halo
        rest = tuple(self.grid[1:])
        xg = x.reshape((self.mloc,) + rest)
        if self.comm.size > 1:
            xs = exchange_rows(xg, self.comm, w)
        else:
            xs = TF.pad(xg, [0, 0] * len(rest) + [w, w])
        y = torch.zeros_like(xg)
        for d, off in enumerate(self.offsets):
            # the row offset on the extended slab, the others by shifting
            sl = xs[w + off[0]: w + off[0] + self.mloc]
            if any(off[1:]):
                sl = shift(sl, (0,) + off[1:])
            y = y + self.coeffs[d] * sl
        return y.reshape(-1)

    def diagonal(self) -> torch.Tensor:
        for d, off in enumerate(self.offsets):
            if not any(off):
                return self.coeffs[d].reshape(-1)
        return torch.zeros(self.shape[0], dtype=self.dtype,
                           device=self.device)

    def flops_per_mult(self) -> float:
        n = self.shape[0]
        return 2.0 * n * len(self.offsets) - n


def sharded_stencil_from(S, nshards: int, mloc: int = None,
                         device=None) -> ShardedStencil:
    """Split a StencilMat over the leading grid axis, padded to a
    multiple of nshards with identity rows (diag 1). mloc: an explicit
    per-rank leading size (>= ceil(m/nshards)), which keeps multigrid
    levels' rank boundaries aligned 2:1."""
    dev = resolve_device(device if device is not None else S.device)
    m = S.grid[0]
    rest = tuple(S.grid[1:])
    if mloc is None:
        mloc = -(-m // nshards)
    assert mloc * nshards >= m, (mloc, nshards, m)
    m_pad = mloc * nshards
    C = S.coeffs.detach().cpu().numpy()
    D = C.shape[0]
    halo = max(abs(int(o[0])) for o in S.offsets) or 1
    if m_pad != m:
        Cp = np.zeros((D, m_pad) + rest, C.dtype)
        Cp[:, :m] = C
        diag_d = next(d for d, off in enumerate(S.offsets)
                      if all(o == 0 for o in off))
        Cp[diag_d, m:] = 1.0
        C = Cp
    C = C.reshape((D, nshards, mloc) + rest).swapaxes(0, 1)
    return ShardedStencil([torch.from_numpy(np.ascontiguousarray(C[p]))
                           .to(dev) for p in range(nshards)],
                          S.offsets, (m_pad,) + rest, nshards, halo)


class ShardedQ1Interp:
    """Q1 prolongation/restriction between two leading-axis-split grid
    levels (mloc_fine = 2·mloc_coarse, so fine row 2i lives on the rank
    of coarse row i): each transfer needs ONE halo row from one
    neighbour (a ppermute); fmask zeroes the fine pad rows. mult = P
    (coarse -> fine), multT = Pᵀ. rank(comm) gives the rank's view."""

    def __init__(self, fmask, fine: tuple, coarse: tuple, nshards: int):
        self.fmask = fmask
        self.fine = tuple(fine)
        self.coarse = tuple(coarse)
        self.nshards = nshards

    @property
    def shape(self):
        return (int(np.prod(self.fine)), int(np.prod(self.coarse)))

    def rank(self, comm) -> "RankQ1Interp":
        return RankQ1Interp(self, comm)


class RankQ1Interp:
    def __init__(self, Q: ShardedQ1Interp, comm):
        self.Q, self.comm = Q, comm
        self.fmask = Q.fmask[comm.rank]

    def mult(self, xc: torch.Tensor) -> torch.Tensor:
        """Prolongate the local coarse vector to the local fine vector."""
        from petsctpu_torch.dm.da import _interp_axis
        Q, comm = self.Q, self.comm
        rest_c, rest_f = Q.coarse[1:], Q.fine[1:]
        mc = Q.coarse[0] // Q.nshards
        Xc = xc.reshape((mc,) + rest_c)
        P = comm.size
        if P > 1:
            # the next rank's first coarse row (the boundary odd fine
            # row); the last rank's unmatched receive is zero
            nxt = comm.ppermute(Xc[:1].contiguous(),
                                [(i + 1, i) for i in range(P - 1)])
        else:
            nxt = torch.zeros_like(Xc[:1])
        Xe = torch.cat([Xc, nxt], 0)
        odd = 0.5 * (Xe[:-1] + Xe[1:])
        Xf = torch.stack([Xc, odd], 1).reshape((2 * mc,) + rest_c)
        for ax in range(1, len(Q.fine)):
            Xf = _interp_axis(Xf, ax, rest_f[ax - 1])
        Xf = Xf * self.fmask.reshape((-1,) + (1,) * len(rest_f))
        return Xf.reshape(-1)

    def multT(self, xf: torch.Tensor) -> torch.Tensor:
        """Restrict the local fine vector to the local coarse vector."""
        from petsctpu_torch.dm.da import _restrict_axis
        Q, comm = self.Q, self.comm
        rest_f, rest_c = Q.fine[1:], Q.coarse[1:]
        mf = Q.fine[0] // Q.nshards
        Xf = xf.reshape((mf,) + rest_f)
        Xf = Xf * self.fmask.reshape((-1,) + (1,) * len(rest_f))
        even, odd = Xf[0::2], Xf[1::2]
        P = comm.size
        if P > 1:
            # the previous rank's last odd row feeds my coarse row 0
            prev = comm.ppermute(odd[-1:].contiguous(),
                                 [(i, i + 1) for i in range(P - 1)])
        else:
            prev = torch.zeros_like(odd[:1])
        odd_ext = torch.cat([prev, odd], 0)
        Xc = even + 0.5 * (odd_ext[:-1] + odd_ext[1:])
        for ax in range(1, len(Q.coarse)):
            Xc = _restrict_axis(Xc, ax, rest_c[ax - 1])
        return Xc.reshape(-1)


def sharded_q1_interp(fine_true: tuple, coarse_true: tuple, nshards: int,
                      mloc_f: int, dtype=np.float64,
                      device=None) -> ShardedQ1Interp:
    """The transfer between padded split levels. fine_true/coarse_true:
    the TRUE grids (leading 2x-1 relation); mloc_f: the fine per-rank
    leading size (even; the coarse level takes mloc_f // 2)."""
    assert mloc_f % 2 == 0 and fine_true[0] == 2 * coarse_true[0] - 1
    assert tuple(fine_true[1:]) == tuple(2 * c - 1 for c in coarse_true[1:])
    assert nshards * mloc_f >= fine_true[0]
    dev = resolve_device(device)
    rows = np.arange(nshards * mloc_f).reshape(nshards, mloc_f)
    fmask = (rows < fine_true[0]).astype(dtype)
    fine = (nshards * mloc_f,) + tuple(fine_true[1:])
    coarse = (nshards * (mloc_f // 2),) + tuple(coarse_true[1:])
    return ShardedQ1Interp([torch.from_numpy(fmask[p]).to(dev)
                            for p in range(nshards)], fine, coarse, nshards)
