"""MAIJ — multi-DOF wrapper A ⊗ I_dof over a scalar operator.

Counterpart of petsctpu/mat/maij.py (reference: src/mat/impls/maij,
MATMAIJ: a scalar matrix applied to each of `dof` interleaved
components, as DMDA interpolation with dof > 1 stores only the scalar
stencil). The forward product is the scalar operator's product with a
dense [n, dof] right-hand side (AIJ.mult_dense); the transpose applies
the scalar multT to each component, as petsctpu's vmap does.
"""

from __future__ import annotations

import torch


class MAIJ:
    """y = (A ⊗ I_dof) x on interleaved storage x[node*dof + c]."""

    def __init__(self, A, dof: int = 1):
        self.A = A                  # scalar operator with mult_dense/multT
        self.dof = int(dof)

    @property
    def shape(self):
        m, n = self.A.shape
        return (m * self.dof, n * self.dof)

    @property
    def dtype(self):
        return self.A.dtype

    @property
    def device(self):
        return self.A.device

    def mult(self, x: torch.Tensor) -> torch.Tensor:
        return self.A.mult_dense(x.reshape(-1, self.dof)).reshape(-1)

    def multT(self, x: torch.Tensor) -> torch.Tensor:
        X = x.reshape(-1, self.dof)
        return torch.stack([self.A.multT(X[:, c]) for c in range(self.dof)],
                           dim=1).reshape(-1)

    def flops_per_mult(self) -> float:
        return getattr(self.A, "flops_per_mult", lambda: 0.0)() * self.dof
