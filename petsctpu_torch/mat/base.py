"""Matrix wrappers (the part of petsctpu/mat/base.py on the solve path).

Only `Transpose` (MATTRANSPOSE, used by ksp_solve_transpose) is ported
so far; the other wrappers are ROADMAP queue 1 item 3.
"""

from __future__ import annotations


class Transpose:
    """Implicit Aᵀ (MatCreateTranspose): mult ↔ multT."""

    def __init__(self, A):
        self.A = A

    @property
    def shape(self):
        return self.A.shape[::-1]

    @property
    def dtype(self):
        return self.A.dtype

    @property
    def device(self):
        return self.A.device

    def mult(self, x):
        return self.A.multT(x)

    def multT(self, x):
        return self.A.mult(x)
