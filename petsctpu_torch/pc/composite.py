"""Composite preconditioners: PCComposite, PCKSP, PCShell, PCMat.

Counterpart of petsctpu/pc/composite.py (reference: src/ksp/pc/impls/
composite, impls/ksp, PCShell, PCMat). Each composes other PCs'
`apply` or an operator's `mult`; they launch nothing of their own. An
inner solve (KSPPC) runs the port's KSP loop, which reads the host once
an iteration, so a PC apply that holds one costs a host read for every
inner iteration.
"""

from __future__ import annotations

import torch

from petsctpu_torch.ksp.common import KSPConfig


class CompositePC:
    """additive: y = Σ Mᵢ⁻¹x; multiplicative: a sweep with residual
    updates through A."""

    def __init__(self, pcs, A=None, mode: str = "additive"):
        self.pcs = tuple(pcs)
        self.A = A
        self.mode = mode

    def apply(self, x):
        y = self.pcs[0].apply(x)
        for p in self.pcs[1:]:
            if self.mode == "additive":
                y = y + p.apply(x)
            else:
                y = y + p.apply(x - self.A.mult(y))
        return y


class KSPPC:
    """An inner KSP solve as the preconditioner (PCKSP): y ≈ A⁻¹x by a
    full Krylov solve with its own config and inner PC, from zero."""

    def __init__(self, A, inner_pc=None, cfg: KSPConfig = None, axis=None):
        self.A = A
        self.inner_pc = inner_pc
        self.cfg = cfg or KSPConfig(ksp_type="gmres", rtol=1e-2, maxits=20)
        self.axis = axis

    def apply(self, x):
        from petsctpu_torch.ksp.api import KSP_REGISTRY

        return KSP_REGISTRY[self.cfg.ksp_type](
            self.A, x, torch.zeros_like(x), self.inner_pc, self.cfg,
            self.axis).x


class ShellPC:
    """User-callback PC (PCShell): apply_fn(ctx, x)."""

    def __init__(self, ctx, apply_fn):
        self.ctx = ctx
        self.apply_fn = apply_fn

    def apply(self, x):
        return self.apply_fn(self.ctx, x)


class MatPC:
    """An operator applied as the PC (PCMat): y = M·x."""

    def __init__(self, M):
        self.M = M

    def apply(self, x):
        return self.M.mult(x)
