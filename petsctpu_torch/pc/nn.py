"""PCNN — (balanced) Neumann-Neumann domain decomposition over MATIS.

Counterpart of petsctpu/pc/nn.py (reference: src/ksp/pc/impls/is/nn.c,
one-level Neumann-Neumann with the balancing coarse step). Apply:

  M⁻¹r = Z C⁻¹ Zᵀ r  +  Σᵢ Dᵢ Rᵢᵀ Aᵢ⁺ Rᵢ Dᵢ (r − A Z C⁻¹ Zᵀ r)

with Dᵢ the multiplicity weights, Aᵢ⁺ the local pseudo-inverse (a
floating subdomain's Neumann matrix is singular), Z the weighted
subdomain constants and C = Zᵀ A Z. Setup is host numpy, as in
petsctpu; the apply is dense products on the device, and each
subdomain's add writes its unique indices once (deterministic).
"""

from __future__ import annotations

import numpy as np
import torch

from petsctpu_torch.mat.matis import MatIS


class NNPC:
    def __init__(self, A: MatIS, weights, local_pinv, Z, Cinv,
                 balanced: bool = True):
        self.A = A
        self.weights = tuple(weights)       # per-subdomain D_i
        self.local_pinv = tuple(local_pinv)  # per-subdomain A_i^+
        self.Z = Z                          # [n, nsub]
        self.Cinv = Cinv                    # [nsub, nsub]
        self.balanced = balanced

    def _coarse(self, r):
        return self.Z @ (self.Cinv @ (self.Z.T @ r))

    def _local(self, r):
        y = torch.zeros_like(r)
        for Wi, Pi, gi in zip(self.weights, self.local_pinv, self.A.l2g):
            y.index_add_(0, gi, Wi * (Pi @ (Wi * r[gi])))
        return y

    def apply(self, r):
        if not self.balanced:
            return self._local(r)
        xc = self._coarse(r)
        return xc + self._local(r - self.A.mult(xc))


def make_nn(A: MatIS, dtype=None, balanced: bool = True,
            rtol: float = 1e-10) -> NNPC:
    from petsctpu_torch.device import np_dtype
    from petsctpu_torch.mat.ell import aij_to_scipy

    dt = np_dtype(dtype) or np.dtype(np.float64)
    dev = A.device

    def dev_t(a):
        return torch.from_numpy(np.asarray(a, dt)).to(dev)

    n = A.shape[0]
    l2g = [g.cpu().numpy() for g in A.l2g]
    mult = np.zeros(n)
    for g in l2g:
        mult[g] += 1.0
    weights = [dev_t(1.0 / mult[g]) for g in l2g]
    pinvs = [dev_t(np.linalg.pinv(aij_to_scipy(Ai).toarray(), rcond=rtol))
             for Ai in A.locals_]
    Z = np.zeros((n, len(l2g)))
    for i, g in enumerate(l2g):
        Z[g, i] += 1.0 / mult[g]
    C = Z.T @ (A.assemble_host() @ Z)
    # the constant may be in A's null space (pure Neumann): regularize C
    # as the local solves are
    Cinv = np.linalg.pinv(C, rcond=rtol)
    return NNPC(A, weights, pinvs, dev_t(Z), dev_t(Cinv), balanced)
