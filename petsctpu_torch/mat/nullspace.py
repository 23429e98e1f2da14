"""MatNullSpace — null-space removal for singular operators.

Reference: src/mat/interface/matnull.c (MatNullSpaceCreate/Remove/Test)
and KSP_RemoveNullSpace in itfunc.c — Krylov methods on singular but
consistent systems (e.g. pure-Neumann Poisson) stay in range(A) by
projecting the null space out of the RHS and of every preconditioned
residual.

remove() runs on the vectors' device (a mean and two small products);
construction orthonormalizes on the host, as petsctpu's does.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from petsctpu_torch.device import resolve_device
from petsctpu_torch.vec import ops


class NullSpace:
    """Orthonormal basis of null(A): optional constant vector plus
    explicit vectors (MatNullSpaceCreate matnull.c:107 signature)."""

    def __init__(self, vecs: Optional[torch.Tensor], has_constant=False):
        self.vecs = vecs               # (k, n) orthonormal rows, or None
        self.has_constant = has_constant

    def remove(self, x):
        """x ← x − Proj_null x (MatNullSpaceRemove analog)."""
        if self.has_constant:
            x = x - torch.mean(x)
        if self.vecs is not None:
            x = x - self.vecs.T @ (self.vecs @ x)
        return x

    def test(self, A, atol=1e-10) -> bool:
        """MatNullSpaceTest: ‖A v‖ ≈ 0 for every basis vector."""
        n = A.shape[0]
        vs = [] if self.vecs is None else list(self.vecs)
        if self.has_constant:
            dt = self.vecs.dtype if self.vecs is not None else torch.float64
            vs.insert(0, torch.ones(n, dtype=dt, device=A.device) / np.sqrt(n))
        return all(float(ops.norm(A.mult(v))) < atol * np.sqrt(n) for v in vs)


def make_nullspace(n: int, has_constant: bool = True, vecs=None,
                   dtype=None, device=None) -> NullSpace:
    """Orthonormalize user vectors (against the constant too) on the
    host, then put them on `device` (CUDA unless told otherwise)."""
    if vecs is None:
        return NullSpace(None, has_constant)
    V = np.atleast_2d(np.asarray(vecs, np.float64))
    if has_constant:
        V = V - V.mean(axis=1, keepdims=True)
    Q, R = np.linalg.qr(V.T)
    keep = np.abs(np.diag(R)) > 1e-12 * max(np.abs(np.diag(R)).max(), 1e-300)
    Q = Q[:, keep]
    basis = np.ascontiguousarray(Q.T.astype(dtype or np.float64))
    return NullSpace(torch.from_numpy(basis).to(resolve_device(device)),
                     has_constant)


class _NullSpacePC:
    """Wraps a PC so every application is followed by null-space
    removal (the KSP_PCApply → KSP_RemoveNullSpace composition)."""

    def __init__(self, pc, nsp: NullSpace):
        self.pc = pc
        self.nsp = nsp

    def apply(self, x):
        return self.nsp.remove(self.pc.apply(x))
