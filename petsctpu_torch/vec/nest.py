"""VecNest: a vector of sub-vectors (block systems).

Counterpart of petsctpu/vec/nest.py (reference: src/vec/vec/impls/nest,
VecCreateNest, VecNestGetSubVec; the vector-side partner of MATNEST). A
tuple of tensors treated as one logical vector: the arithmetic is
blockwise, and the reductions sum the blocks' partials in block order
(`dot` conjugates its first argument, as petsctpu's jnp.vdot does).
`flatten`/`from_flat` bridge to the monolithic layout (DMComposite's
packing).
"""

from __future__ import annotations

import numpy as np
import torch


def _vdot(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """jnp.vdot: Σ conj(a)·b over the flattened tensors."""
    a, b = a.reshape(-1), b.reshape(-1)
    return torch.vdot(a, b) if a.is_complex() else torch.dot(a, b)


class VecNest:
    def __init__(self, blocks):
        self.blocks = tuple(blocks)

    @property
    def nb(self) -> int:
        return len(self.blocks)

    @property
    def n(self) -> int:
        return sum(int(b.shape[0]) for b in self.blocks)

    @property
    def dtype(self):
        return self.blocks[0].dtype

    # ---- blockwise arithmetic (VecAXPY/VecScale/... on nests) ----
    def __add__(self, other):
        return VecNest(a + b for a, b in zip(self.blocks, other.blocks))

    def __sub__(self, other):
        return VecNest(a - b for a, b in zip(self.blocks, other.blocks))

    def __mul__(self, s):
        return VecNest(s * a for a in self.blocks)

    __rmul__ = __mul__

    def axpy(self, alpha, x: "VecNest") -> "VecNest":
        return VecNest(a + alpha * b for a, b in zip(self.blocks, x.blocks))

    # ---- reductions across the blocks, summed in block order ----
    def dot(self, other: "VecNest"):
        return sum(_vdot(a, b) for a, b in zip(self.blocks, other.blocks))

    def norm(self):
        return torch.sqrt(sum(_vdot(a, a).real for a in self.blocks))

    def norm_inf(self):
        return torch.max(torch.stack([torch.max(torch.abs(a))
                                      for a in self.blocks]))

    # ---- sub-vector access (VecNestGetSubVec) ----
    def sub(self, i: int):
        return self.blocks[i]

    def with_sub(self, i: int, v) -> "VecNest":
        bl = list(self.blocks)
        bl[i] = v
        return VecNest(bl)

    # ---- flat interop ----
    def flatten(self):
        return torch.cat([b.reshape(-1) for b in self.blocks])

    @classmethod
    def from_flat(cls, x, sizes) -> "VecNest":
        off = np.cumsum([0] + list(sizes))
        return cls(x[off[i]:off[i + 1]] for i in range(len(sizes)))

    @classmethod
    def zeros_like(cls, other: "VecNest") -> "VecNest":
        return cls(torch.zeros_like(b) for b in other.blocks)
