"""PETSCRAND48: PETSc's default random stream, bit for bit.

Counterpart of petsctpu/core/random.py::Rand48 (reference:
src/sys/classes/random/impls/rand48 — srand48/drand48 with PETSc's
default seed 0x12345678, set at PetscRandomSetType, randomc.c:376 and
randreg.c:50). It reproduces VecSetRandom-driven goldens (snes ex35's
random right-hand side): drand48 is the POSIX 48-bit LCG
X' = (0x5DEECE66D·X + 0xB) mod 2^48, seeded X = (seed<<16)|0x330E.
The stream is a host computation in Python integers. petsctpu's
jax.random-based `Random` has no bit-compatible counterpart here
(ROADMAP queue 1 item 3).
"""

from __future__ import annotations

import numpy as np


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
