"""Pointwise preconditioners: none, Jacobi, point-block Jacobi.

Reference: src/ksp/pc/impls/{none,jacobi,pbjacobi}. Jacobi supports the
reference's rowmax/rowsum variants; PBJacobi inverts the dense bs×bs
diagonal blocks at setup (a batched inverse on the operator's device).
"""

from __future__ import annotations

import torch


class NonePC:
    def apply(self, x):
        return x


class JacobiPC:
    def __init__(self, dinv: torch.Tensor):
        self.dinv = dinv

    def apply(self, x):
        return self.dinv * x


def make_jacobi(A, variant: str = "diag", A_host=None) -> JacobiPC:
    """variant: diag | rowmax | rowsum (jacobi.c options)."""
    if variant == "diag":
        d = A.diagonal()
    elif variant == "rowmax":
        d = torch.amax(torch.abs(A.vals), dim=1)
    elif variant == "rowsum":
        d = A.rows_sum()
    else:
        raise ValueError(f"unknown jacobi variant {variant}")
    # zero diagonal → identity on that row (same guard as jacobi.c)
    one = torch.ones((), dtype=d.dtype, device=d.device)
    nz = d != 0
    return JacobiPC(torch.where(nz, 1.0 / torch.where(nz, d, one), one))


class PBJacobiPC:
    """Point-block Jacobi: x ← blockdiag(A)⁻¹ x, blocks bs×bs."""

    def __init__(self, binv: torch.Tensor, bs: int = 1):
        self.binv = binv            # [nb, bs, bs]
        self.bs = bs

    def apply(self, x):
        xb = x.reshape(-1, self.bs)
        return torch.einsum("bij,bj->bi", self.binv, xb).reshape(-1)


def make_pbjacobi(A, bs: int = None) -> PBJacobiPC:
    """Extract the dense bs×bs diagonal blocks of an AIJ's ELL layout
    and invert them."""
    if not bs:
        raise ValueError("pbjacobi on AIJ needs explicit bs")
    n = A.shape[0]
    dev = A.cols.device
    rows = torch.arange(n, device=dev)
    lo = ((rows // bs) * bs)[:, None]
    in_block = (A.cols >= lo) & (A.cols < lo + bs)
    nb = n // bs
    flat_b = (rows[:, None] // bs) * (bs * bs) \
        + (rows[:, None] % bs) * bs + (A.cols - lo)
    flat_b = torch.where(in_block, flat_b, nb * bs * bs)
    zero = torch.zeros((), dtype=A.vals.dtype, device=dev)
    blocks = torch.zeros(nb * bs * bs + 1, dtype=A.vals.dtype, device=dev)
    blocks = blocks.index_add_(0, flat_b.reshape(-1),
                               torch.where(in_block, A.vals, zero)
                               .reshape(-1))[:-1]
    return PBJacobiPC(torch.linalg.inv(blocks.reshape(nb, bs, bs)), int(bs))
