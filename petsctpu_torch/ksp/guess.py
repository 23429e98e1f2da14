"""KSPFischerGuess — initial guesses for sequences of related solves.

Reference: src/ksp/ksp/interface/iguess.c (KSPFischerGuessCreate
models 1 and 2, used via KSPSetUseFischerGuess; itfunc.c:371 forms
the guess before each solve and updates the model after). For a
sequence A x_k = b_k with slowly varying b_k, the guess is the
Galerkin projection of the new RHS onto the span of the last m
solutions:

  model 1: x0 = X c,  c = argmin ‖b − (A X) c‖₂  (normal equations on
           the stored pairs (x_i, A x_i); Fischer's eq. (2))
  model 2: same, with the stored pair scaled by ‖A x‖ (Fischer's
           A-norm variant for SPD A). Both models solve the small
           normal equations at form time, which subsumes the
           reference's incremental orthonormalization.

The stored pairs are a ring buffer of fixed-shape tensors on the
operator's device; the count and the ring's head are host integers.
The m×m normal equations are solved on the host with LAPACK's
getrf/getrs (scipy), as ksp/gmres.py solves its small triangle: G's
condition reaches 1e12 (the regularization), where torch.linalg.solve
moves c by up to 1e-4 relative against the reference's CPU solve
(LAPACK getrf/getrs) on the same G; scipy's getrf/getrs agrees with
it to 1e-16 relative.
"""

from __future__ import annotations

import scipy.linalg
import torch

from petsctpu_torch.device import resolve_device
from petsctpu_torch.vec import ops


class FischerGuess:
    def __init__(self, X, AX, used: int = 0, head: int = 0, model: int = 1):
        self.X = X                   # (m, n) stored solutions
        self.AX = AX                 # (m, n) stored A·solutions
        self.used = used             # valid entries
        self.head = head             # next ring slot
        self.model = model

    @property
    def size(self) -> int:
        return self.X.shape[0]

    def form(self, b):
        """Galerkin initial guess for a new RHS (KSPFischerGuessFormGuess)."""
        m = self.size
        mask = (torch.arange(m, device=b.device) < self.used).to(b.dtype)
        G = (self.AX * mask[:, None]) @ self.AX.T * (mask[:, None] * mask)
        rhs = mask * (self.AX @ b)
        # regularized normal equations: empty slots get identity rows
        G = G + torch.diag(1.0 - mask) \
            + 1e-12 * torch.eye(m, dtype=b.dtype, device=b.device)
        lu = scipy.linalg.lu_factor(G.cpu().numpy(), check_finite=False)
        c = scipy.linalg.lu_solve(lu, rhs.cpu().numpy(), check_finite=False)
        return (mask * torch.from_numpy(c).to(b.device)) @ self.X

    def update(self, x, Ax):
        """Insert a converged solution into the ring (FischerGuessUpdate)."""
        nrm = ops.norm(Ax if self.model == 2 else x)
        scale = torch.where(nrm > 0, 1.0 / torch.clamp(nrm, min=1e-300),
                            torch.zeros_like(nrm))
        self.X[self.head] = x * scale
        self.AX[self.head] = Ax * scale
        self.used = min(self.used + 1, self.size)
        self.head = (self.head + 1) % self.size
        return self


def make_fischer_guess(n: int, size: int = 10, model: int = 1,
                       dtype=None, device=None) -> FischerGuess:
    dev = resolve_device(device)
    dt = dtype or torch.float64
    return FischerGuess(torch.zeros((size, n), dtype=dt, device=dev),
                        torch.zeros((size, n), dtype=dt, device=dev),
                        model=model)
