"""Factorization preconditioners: the exact LU (lu, cholesky, redundant).

Counterpart of the LU part of petsctpu/pc/factor.py (reference:
src/ksp/pc/impls/factor/{lu,cholesky}). The numeric factorization
happens on the host at setup, as in the reference; the apply is two
level-scheduled triangular solves on the device (mat/factor.py).
PermutedPC applies an inner PC in a symmetric permutation. ILU and ICC
are ROADMAP queue 1 item 5.
"""

from __future__ import annotations

import scipy.sparse as sp
import torch

from petsctpu_torch.device import resolve_device
from petsctpu_torch.mat.factor import SpTRSVPlan, lu_factor, make_sptrsv_plan


class LUPC:
    """Exact sparse LU (SuperLU factors, device triangular solves):
    x = Pc U⁻¹ L⁻¹ Pr b."""

    def __init__(self, Lplan: SpTRSVPlan, Uplan: SpTRSVPlan,
                 perm_r: torch.Tensor, perm_c: torch.Tensor):
        self.Lplan = Lplan
        self.Uplan = Uplan
        self.perm_r = perm_r
        self.perm_c = perm_c

    def apply(self, b):
        # scipy splu convention: x = Pc U⁻¹ L⁻¹ Pr b with
        # (Pr b)[perm_r[i]] = b[i] (scatter) and (Pc z)[i] = z[perm_c[i]]
        # (gather), as in scipy.sparse.linalg.SuperLU's documentation
        pb = torch.zeros_like(b)
        pb[self.perm_r] = b
        z = self.Uplan.solve(self.Lplan.solve(pb))
        return z[self.perm_c]


class PermutedPC:
    """Apply an inner PC in a symmetric permutation: M⁻¹ = Pᵀ M̃⁻¹ P
    (-pc_factor_mat_ordering_type rcm analog). perm maps new → old."""

    def __init__(self, inner, perm: torch.Tensor):
        self.inner = inner
        self.perm = perm

    def apply(self, b):
        z = self.inner.apply(b[self.perm])
        out = torch.zeros_like(b)
        out[self.perm] = z
        return out


def lupc_from_factors(L, U, perm_r, perm_c, dtype=None, transpose=False,
                      device=None) -> LUPC:
    """An LUPC from SuperLU's factors. transpose=True gives the
    PCApplyTranspose operator of the same factors: apply(b) = A⁻ᵀ b =
    Prᵀ L⁻ᵀ U⁻ᵀ Pcᵀ b — the permutations swap scatter and gather roles
    and the triangular factors swap order."""
    dev = resolve_device(device)
    if transpose:
        L, U = sp.csr_matrix(U.T), sp.csr_matrix(L.T)
        perm_r, perm_c = perm_c, perm_r

    def perm(p):
        return torch.as_tensor(p, dtype=torch.int64).to(dev)

    return LUPC(make_sptrsv_plan(L, lower=True, unit_diag=False,
                                 dtype=dtype, device=dev),
                make_sptrsv_plan(U, lower=False, unit_diag=False,
                                 dtype=dtype, device=dev),
                perm(perm_r), perm(perm_c))


def make_lu(A_host, dtype=None, transpose: bool = False,
            device=None) -> LUPC:
    """LU of a scipy matrix; transpose=True builds the PCApplyTranspose
    operator from the same factorization (precon.c PCApplyTranspose →
    MatSolveTranspose)."""
    return lupc_from_factors(*lu_factor(A_host), dtype=dtype,
                             transpose=transpose, device=device)
