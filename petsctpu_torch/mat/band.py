"""BandMat — tiled banded matrices.

Counterpart of petsctpu/mat/band.py. The band of an (RCM-ordered) A is
tiled into dense [T, T+2B] row blocks, and the product is one batched
matrix-vector product of the tiles with x's sliding windows, built from
reshaped chunks of the padded x (no gather):

    y[tT:(t+1)T] = tiles[t] @ x_padded[tT : tT + T + 2B]

petsctpu computes it as an XLA einsum; here it is torch.bmm (TF32 off,
device.py). Storage and traffic are n·(T+2B) values.
"""

from __future__ import annotations

import numpy as np
import scipy.sparse as sp
import torch

from petsctpu_torch.device import np_dtype, resolve_device


class BandMat:
    def __init__(self, tiles: torch.Tensor, bandwidth: int = 0,
                 tile: int = 128, shape=(0, 0), nnz: int = 0):
        self.tiles = tiles                              # [nt, T, T+2B]
        self.bandwidth = int(bandwidth)
        self.tile = int(tile)
        self.shape = tuple(shape)
        self.nnz = int(nnz)

    @property
    def dtype(self):
        return self.tiles.dtype

    @property
    def device(self):
        return self.tiles.device

    def _nchunks(self) -> int:
        W = self.tile + 2 * self.bandwidth
        return -(-W // self.tile) + 1

    def _windows(self, x):
        """xw[t] = xp[tT : tT + W], W = T + 2B, from reshaped chunks."""
        T, B = self.tile, self.bandwidth
        nt = self.tiles.shape[0]
        nch = self._nchunks()
        xp = torch.zeros((nt + nch) * T, dtype=x.dtype, device=x.device)
        xp[B:B + x.shape[0]] = x
        Xe = xp.reshape(nt + nch, T)
        xw = torch.cat([Xe[k:k + nt] for k in range(nch)], dim=1)
        return xw[:, :T + 2 * B]

    def mult(self, x: torch.Tensor) -> torch.Tensor:
        n = self.shape[0]
        xw = self._windows(x.reshape(-1))
        y = torch.bmm(self.tiles, xw[:, :, None])
        return y.reshape(-1)[:n].reshape(x.shape)

    def mult_add(self, x, y):
        return y + self.mult(x)

    def multT(self, x: torch.Tensor) -> torch.Tensor:
        """The adjoint of the windows: each tile's transposed product is
        added back as nchunks shifted chunks, in petsctpu's order."""
        T, B = self.tile, self.bandwidth
        nt, _, W = self.tiles.shape
        n = self.shape[0]
        xf = torch.zeros(nt * T, dtype=x.dtype, device=x.device)
        xf[:n] = x.reshape(-1)
        contrib = torch.bmm(xf.reshape(nt, 1, T), self.tiles)[:, 0]
        nch = self._nchunks()
        contrib = torch.nn.functional.pad(contrib, (0, nch * T - W))
        acc = torch.zeros((nt + nch) * T, dtype=x.dtype, device=x.device)
        for k in range(nch):
            acc[k * T:(k + nt) * T] += contrib[:, k * T:(k + 1) * T] \
                .reshape(-1)
        return acc[B:B + n].reshape(x.shape)

    def diagonal(self) -> torch.Tensor:
        d = torch.diagonal(self.tiles, offset=self.bandwidth, dim1=1, dim2=2)
        return d.reshape(-1)[:self.shape[0]]

    def flops_per_mult(self) -> float:
        return 2.0 * self.nnz - self.shape[0]

    def traffic_per_mult(self) -> float:
        return float(self.tiles.numel() + 2 * self.shape[0]) \
            * self.tiles.element_size()


def band_pack(A, dtype=None, perm=None, tile: int = None):
    """Host tiles of (optionally permuted) A: (tiles [nt, T, T+2B], B,
    T, n, nnz). tile defaults to the smallest 128-multiple ≥ max(128,
    B/2), petsctpu's rule."""
    A = sp.csr_matrix(A)
    if perm is not None:
        perm = np.asarray(perm)
        A = A[perm][:, perm]
    n = A.shape[0]
    coo = A.tocoo()
    B = int(np.abs(coo.col - coo.row).max()) if A.nnz else 0
    if tile is None:
        tile = max(128, -(-max(B, 1) // 256) * 128)
    T = tile
    nt = -(-n // T)
    tiles = np.zeros((nt, T, T + 2 * B), np_dtype(dtype) or A.dtype)
    tiles[coo.row // T, coo.row % T, coo.col - (coo.row // T) * T + B] = \
        coo.data
    return tiles, B, T, n, int(A.nnz)


def band_from_scipy(A, dtype=None, perm=None, tile: int = None,
                    device=None) -> BandMat:
    dev = resolve_device(device)
    tiles, B, T, n, nnz = band_pack(A, dtype, perm, tile)
    return BandMat(torch.from_numpy(tiles).to(dev), B, T, (n, n), nnz)
