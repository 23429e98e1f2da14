"""Structured convergence-reason codes and errors.

Mirrors the semantics of the reference's KSPConvergedReason /
SNESConvergedReason enums (reference: include/petscksp.h,
include/petscsnes.h; checked in e.g. src/ksp/ksp/impls/cg/cg.c:152
NaN/Inf guard, cg.c:188 indefinite-PC). Positive = converged,
negative = diverged, 0 = still iterating. The solvers run their
convergence test on the host after each iteration and return the
reason as an int32 tensor.
"""

from __future__ import annotations

import enum


class ConvergedReason(enum.IntEnum):
    """KSP convergence reasons (values chosen to match reference enum)."""

    CONVERGED_RTOL_NORMAL = 1
    CONVERGED_RTOL = 2
    CONVERGED_ATOL = 3
    CONVERGED_ITS = 4            # preonly / fixed-iteration success
    CONVERGED_CG_NEG_CURVE = 5   # trust-region CG hit negative curvature
    CONVERGED_CG_CONSTRAINED = 6  # trust-region CG hit the radius
    CONVERGED_STEP_LENGTH = 7
    CONVERGED_HAPPY_BREAKDOWN = 8
    CONVERGED_ATOL_NORMAL = 9
    ITERATING = 0
    DIVERGED_NULL = -2
    DIVERGED_ITS = -3            # hit maxits without converging
    DIVERGED_DTOL = -4           # residual grew by divtol
    DIVERGED_BREAKDOWN = -5      # e.g. BiCGStab rho = 0
    DIVERGED_BREAKDOWN_BICG = -6
    DIVERGED_NONSYMMETRIC = -7
    DIVERGED_INDEFINITE_PC = -8
    DIVERGED_NANORINF = -9
    DIVERGED_INDEFINITE_MAT = -10

    @property
    def converged(self) -> bool:
        return self.value > 0


class SNESConvergedReason(enum.IntEnum):
    """SNES convergence reasons (reference: include/petscsnes.h)."""

    CONVERGED_FNORM_ABS = 2      # ||F|| < atol
    CONVERGED_FNORM_RELATIVE = 3  # ||F|| < rtol*||F0||
    CONVERGED_SNORM_RELATIVE = 4  # newton step small
    CONVERGED_ITS = 5
    CONVERGED_TR_DELTA = 7       # trust region shrank below xnorm*deltatol
    ITERATING = 0
    DIVERGED_FUNCTION_DOMAIN = -1
    DIVERGED_FUNCTION_COUNT = -2
    DIVERGED_LINEAR_SOLVE = -3
    DIVERGED_FNORM_NAN = -4
    DIVERGED_MAX_IT = -5
    DIVERGED_LINE_SEARCH = -6
    DIVERGED_INNER = -7
    DIVERGED_LOCAL_MIN = -8

    @property
    def converged(self) -> bool:
        return self.value > 0


class PetscTPUError(RuntimeError):
    """Base error for the framework (host-side failures; device-side
    numerical failure is reported through reason codes, not exceptions)."""
