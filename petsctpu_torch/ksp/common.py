"""KSP shared infrastructure: norm policy, convergence test, monitors.

Mirrors the reference's KSP interface layer (src/ksp/ksp/interface):
KSPDefaultConverged (iterativ.c:702 — rtol/atol/dtol on the selected
residual norm), norm-type policy (none/preconditioned/unpreconditioned/
natural), monitors and residual history.

The solvers are eager Python loops. Vectors stay on the device of the
operands; after each iteration the loop copies the few scalars it
branches on to the host in one transfer, and the convergence test and
the monitors run there. The host scalars keep the solve's dtype
(numpy float32 for an fp32 solve), so every threshold is rounded and
compared as in petsctpu's device-side test: an fp32 solve sees
`atol = 1e-50` as 0 and `rtol·rnorm0` rounded to fp32.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import NamedTuple, Optional

import numpy as np
import torch

from petsctpu_torch.core.errors import ConvergedReason
from petsctpu_torch.device import np_dtype

NORM_NONE = "none"
NORM_PRECONDITIONED = "preconditioned"
NORM_UNPRECONDITIONED = "unpreconditioned"
NORM_NATURAL = "natural"


@dataclass(frozen=True)
class KSPConfig:
    """Solver configuration (the same fields and defaults as petsctpu's)."""

    ksp_type: str = "gmres"
    rtol: float = 1e-5
    atol: float = 1e-50
    divtol: float = 1e5
    maxits: int = 10000
    restart: int = 30                   # GMRES restart
    norm_type: Optional[str] = None     # None -> solver default
    monitor: bool = False
    monitor_true: bool = False          # -ksp_monitor_true_residual
    orth: str = "cgs"                   # gmres orthogonalization: cgs|mgs
    cgs_refine: str = "never"           # never|ifneeded|always
    richardson_scale: float = 1.0
    # -ksp_richardson_self_scale (rich.c:16,84)
    richardson_self_scale: bool = False
    cheby_emin: float = 0.0             # 0 -> auto-estimate
    cheby_emax: float = 0.0
    guess_nonzero: bool = False
    radius: float = 0.0                 # trust-region radius (stcg/nash/gltr)
    aug_dim: int = 2                    # LGMRES augmentation dimension
    bcgsl_ell: int = 2                  # BiCGStab(l) polynomial degree
    # -ksp_lag_norm (KSPSetLagNorm itfunc.c)
    lag_norm: bool = False
    # -ksp_cg_single_reduction (KSPCGUseSingleReduction, cg.c:349)
    cg_single_reduction: bool = False


class SolveResult(NamedTuple):
    x: torch.Tensor         # on the operands' device
    its: torch.Tensor       # int32 iteration count (host)
    reason: torch.Tensor    # int32 ConvergedReason (host)
    rnorm: torch.Tensor     # final residual norm (host)
    history: torch.Tensor   # [maxits+1] residual history, NaN-padded (host)

    def reason_enum(self) -> ConvergedReason:
        return ConvergedReason(int(self.reason))

    @property
    def converged(self):
        return int(self.reason) > 0


def real_dtype(dtype):
    """numpy real dtype of a solve in `dtype` (norms are real)."""
    return np.zeros((), np_dtype(dtype)).real.dtype


def to_host(*vals) -> np.ndarray:
    """Copy device scalars to the host in one transfer, in their dtype."""
    return torch.stack([torch.as_tensor(v) for v in vals]).cpu().numpy()


def check_convergence(rnorm, rnorm0, its: int, cfg: KSPConfig) -> int:
    """KSPDefaultConverged (iterativ.c:702) on host scalars of the
    solve's real dtype → reason."""
    dt = np.asarray(rnorm).dtype.type
    rnorm, rnorm0 = dt(rnorm), dt(rnorm0)
    if np.isnan(rnorm) or np.isinf(rnorm):
        return ConvergedReason.DIVERGED_NANORINF
    atol = dt(cfg.atol)
    ttol = max(dt(cfg.rtol) * rnorm0, atol)
    if rnorm <= atol:
        return ConvergedReason.CONVERGED_ATOL
    if rnorm <= ttol:
        return ConvergedReason.CONVERGED_RTOL
    if rnorm > dt(cfg.divtol) * rnorm0:
        return ConvergedReason.DIVERGED_DTOL
    if its >= cfg.maxits:
        return ConvergedReason.DIVERGED_ITS
    return ConvergedReason.ITERATING


def _fmt_short(rnorm):
    """KSPMonitorDefaultShort formatting (iterativ.c): %g above 1e-9,
    %5.3e down to 1e-11, then the literal '< 1.e-11'."""
    r = float(rnorm)
    if r > 1e-9:
        return f"{r:g}"
    if r > 1e-11:
        return f"{r:5.3e}"
    return "< 1.e-11"


def monitor(cfg: KSPConfig, its: int, rnorm) -> None:
    """-ksp_monitor / -ksp_monitor_short line for one iteration."""
    if cfg.monitor:
        print(f"{int(its):3d} KSP Residual norm {_fmt_short(rnorm)} ")


def monitor_true(cfg: KSPConfig, its: int, rnorm, trnorm, bnorm) -> None:
    """-ksp_monitor_true_residual (KSPMonitorTrueResidualNorm,
    iterativ.c): the preconditioned estimate, the actual ‖b − Ax‖ and
    its ratio to ‖b‖."""
    if cfg.monitor_true:
        rel = trnorm / (bnorm if bnorm > 0 else bnorm.dtype.type(1.0))
        print(f"{int(its):3d} KSP preconditioned resid norm "
              f"{float(rnorm):14.12e} true resid norm {float(trnorm):14.12e} "
              f"||r(i)||/||b|| {float(rel):14.12e}")


def init_history(cfg: KSPConfig, dtype) -> np.ndarray:
    # residual norms are real even for complex solves
    return np.full((cfg.maxits + 1,), np.nan, dtype=real_dtype(dtype))


def make_result(x, its: int, reason: int, history: np.ndarray) -> SolveResult:
    hist = torch.from_numpy(history)
    return SolveResult(x, torch.tensor(its, dtype=torch.int32),
                       torch.tensor(int(reason), dtype=torch.int32),
                       hist[its], hist)


def rnorm0_reference(cfg, b, pc, nt, axis, r0norm):
    """The reference's relative-tolerance base (KSPDefaultConverged,
    iterativ.c:703-733): with a NONZERO initial guess the rtol test is
    against the RHS norm — ‖b‖ for unpreconditioned norm / right PC,
    ‖M⁻¹b‖ for preconditioned, √(bᵀM⁻¹b) for natural — falling back
    to the initial residual norm when that RHS norm is zero. With the
    (default) zero guess, the two coincide and r0norm is returned.
    r0norm and the result are host scalars."""
    from petsctpu_torch.vec import ops

    if not cfg.guess_nonzero:
        return r0norm
    if nt == NORM_UNPRECONDITIONED:
        s = ops.norm(b, axis)
    elif nt == NORM_NATURAL:
        s = torch.sqrt(torch.abs(ops.dot(b, apply_pc(pc, b), axis)))
    else:
        s = ops.norm(apply_pc(pc, b), axis)
    (s,) = to_host(s)
    return s if s > 0 else r0norm


def apply_pc(pc, r):
    return r if pc is None else pc.apply(r)
