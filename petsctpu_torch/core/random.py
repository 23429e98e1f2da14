"""PETSCRAND48: PETSc's default random stream, bit for bit.

Counterpart of petsctpu/core/random.py::Rand48 (reference:
src/sys/classes/random/impls/rand48 — srand48/drand48 with PETSc's
default seed 0x12345678, set at PetscRandomSetType, randomc.c:376 and
randreg.c:50). It reproduces VecSetRandom-driven goldens (snes ex35's
random right-hand side): drand48 is the POSIX 48-bit LCG
X' = (0x5DEECE66D·X + 0xB) mod 2^48, seeded X = (seed<<16)|0x330E.
The stream is a host computation in Python integers.

`Random` is the counterpart of petsctpu's PetscRandom analog, which
draws from jax.random: here a stream of an explicit torch.Generator
(CPU, seeded once), so it is deterministic for a seed and the same on
every device, but its bits are not jax.random's.
"""

from __future__ import annotations

import numpy as np
import torch

from petsctpu_torch.device import resolve_device


class Random:
    """PetscRandom: uniform values in [lo, hi) (drawn in fp32, as
    petsctpu's), normal values, each call the stream's next draw; the
    values are put on `device` (None: CUDA)."""

    def __init__(self, seed: int = 0x12345678, lo=0.0, hi=1.0,
                 device=None):
        self._gen = torch.Generator().manual_seed(int(seed))
        self.lo, self.hi = lo, hi
        self.device = resolve_device(device)

    def set_interval(self, lo, hi) -> "Random":
        self.lo, self.hi = lo, hi
        return self

    def get_values(self, shape, dtype=torch.float64) -> torch.Tensor:
        u = torch.rand(shape, generator=self._gen, dtype=torch.float32)
        return (self.lo + (self.hi - self.lo) * u).to(self.device, dtype)

    def get_value(self, dtype=torch.float64) -> torch.Tensor:
        return self.get_values((), dtype)

    def get_normal(self, shape, dtype=torch.float64) -> torch.Tensor:
        return torch.randn(shape, generator=self._gen,
                           dtype=torch.float32).to(self.device, dtype)


_MUL, _ADD, _MASK = 0x5DEECE66D, 0xB, (1 << 48) - 1
_BLOCK = 4096


class Rand48:
    def __init__(self, seed: int = 0x12345678, lo=0.0, hi=1.0):
        self._x = ((seed & 0xFFFFFFFF) << 16) | 0x330E
        self.lo, self.hi = lo, hi

    def get_value(self) -> float:
        self._x = (_MUL * self._x + _ADD) & _MASK
        u = self._x / float(1 << 48)
        return self.lo + (self.hi - self.lo) * u

    def get_values(self, n: int) -> np.ndarray:
        """The next n values of get_value(), computed in blocks: state
        X_{t+j} = a_j·X_t + c_j (mod 2^48) with a_j = a^j and
        c_j = c·(a^j − 1)/(a − 1), in uint64 arithmetic (it wraps mod
        2^64, which 2^48 divides), the same bits as n calls."""
        if n <= 0:
            return np.zeros(0)
        B = min(n, _BLOCK)
        aj = np.empty(B, np.uint64)
        cj = np.empty(B, np.uint64)
        a, c = 1, 0
        for j in range(B):
            a, c = (a * _MUL) & _MASK, (c * _MUL + _ADD) & _MASK
            aj[j], cj[j] = a, c
        starts = np.empty(-(-n // B), np.uint64)
        x = self._x
        for i in range(len(starts)):
            starts[i] = x
            x = (a * x + c) & _MASK
        X = ((starts[:, None] * aj[None, :] + cj[None, :])
             & np.uint64(_MASK)).reshape(-1)[:n]
        self._x = int(X[-1])
        u = X.astype(np.float64) / float(1 << 48)
        return self.lo + (self.hi - self.lo) * u
