"""MATFFT analog and an FFT-based fast Poisson solver.

Counterpart of petsctpu/mat/fft.py (reference: src/mat/impls/fft, a Mat
whose MatMult is the multi-dimensional DFT, through FFTW or CUFFT).
petsctpu's transforms are jnp.fft (XLA); here they are torch.fft. A
DST-I spectral solver gives an exact O(N log N) solve of the
constant-coefficient Dirichlet Laplacian, standalone or as a PC.
"""

from __future__ import annotations

import numpy as np
import torch

from petsctpu_torch.device import np_dtype, resolve_device


class FFTMat:
    """y = DFT_nd(x) over `dims` (MatCreateFFT, fft.c). The DFT matrix
    F is symmetric, so multT == mult; Fᴴ = N·F⁻¹ gives mult_hermitian;
    solve() is the inverse transform."""

    def __init__(self, dims):
        self.dims = tuple(int(d) for d in dims)

    @property
    def shape(self):
        n = int(np.prod(self.dims))
        return (n, n)

    def mult(self, x):
        # a real x is taken to complex64, as petsctpu does
        xc = x if x.is_complex() else x.to(torch.complex64)
        return torch.fft.fftn(xc.reshape(self.dims)).reshape(-1)

    multT = mult

    def mult_hermitian(self, x):
        n = int(np.prod(self.dims))
        return n * torch.fft.ifftn(x.reshape(self.dims)).reshape(-1)

    def solve(self, b):
        return torch.fft.ifftn(b.reshape(self.dims)).reshape(-1)


def dst1(x, axis=-1):
    """DST-I along `axis` through the odd-extension FFT:
    y_k = Σ_{j=1..n} x_j sin(π j k / (n+1)), k = 1..n; self-inverse up
    to the factor (n+1)/2."""
    n = x.shape[axis]
    x = torch.movedim(x, axis, -1)
    z = torch.zeros(x.shape[:-1] + (1,), dtype=x.dtype, device=x.device)
    ext = torch.cat([z, x, z, -x.flip(-1)], dim=-1)          # 2n + 2
    y = -0.5 * torch.fft.rfft(ext)[..., 1:n + 1].imag
    return torch.movedim(y.to(x.dtype), -1, axis)


class PoissonFFTPC:
    """Exact solver of the 5/7-point Dirichlet Laplacian with uniform
    coefficients: DST-I along every axis, a divide by the eigenvalue
    sum, and back; λ_k = 2 − 2cos(kπ/(n+1)) per axis."""

    def __init__(self, inv_eig: torch.Tensor, dims):
        self.inv_eig = inv_eig                  # dims, 1/Σλ precomputed
        self.dims = tuple(int(d) for d in dims)

    def apply(self, b):
        v = b.reshape(self.dims)
        for ax in range(len(self.dims)):
            v = dst1(v, axis=ax)
        v = v * self.inv_eig
        for ax in range(len(self.dims)):
            v = dst1(v, axis=ax)
        norm = float(np.prod([(n + 1) / 2.0 for n in self.dims]))
        return (v / norm).reshape(b.shape)


def make_poisson_fft(dims, dtype=None, scale: float = 1.0,
                     shift: float = 0.0, device=None) -> PoissonFFTPC:
    """Fast solver of scale·(−Δ_h) + shift·I on a Dirichlet grid of
    `dims` (the ex2/ex45 operator with scale = 1)."""
    dt = np_dtype(dtype) or np.dtype(np.float32)
    eig = np.zeros(dims, np.float64)
    for ax, n in enumerate(dims):
        k = np.arange(1, n + 1)
        shape = [1] * len(dims)
        shape[ax] = n
        eig = eig + (2.0 - 2.0 * np.cos(k * np.pi / (n + 1))).reshape(shape)
    inv = 1.0 / (scale * eig + shift)
    return PoissonFFTPC(torch.from_numpy(inv.astype(dt))
                        .to(resolve_device(device)), tuple(dims))
