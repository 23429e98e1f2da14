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


class Rand48:
    def __init__(self, seed: int = 0x12345678, lo=0.0, hi=1.0):
        self._x = ((seed & 0xFFFFFFFF) << 16) | 0x330E
        self.lo, self.hi = lo, hi

    def get_value(self) -> float:
        self._x = (0x5DEECE66D * self._x + 0xB) & ((1 << 48) - 1)
        u = self._x / float(1 << 48)
        return self.lo + (self.hi - self.lo) * u

    def get_values(self, n: int) -> np.ndarray:
        return np.array([self.get_value() for _ in range(n)])
