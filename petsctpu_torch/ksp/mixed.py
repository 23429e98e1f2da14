"""Mixed-precision iterative refinement: fp64 residuals, fp32 inner
Krylov solves.

petsctpu's extra beyond the reference (which is fixed-precision per
build): the inner Krylov solve runs in fp32, where the SpMV and
reduction work is, while the outer loop computes true residuals and
accumulates the solution in fp64 — classic Wilkinson refinement with a
Krylov inner solver. ‖r_k‖ contracts by about the inner solve's
reduction each sweep, so a handful of fp32 solves reach fp64-level
accuracy.
"""

from __future__ import annotations

from dataclasses import replace
from typing import Optional

import numpy as np
import torch

from petsctpu_torch.core.errors import ConvergedReason
from petsctpu_torch.ksp.common import KSPConfig, SolveResult, to_host
from petsctpu_torch.vec import ops


def solve_ir(A64, A32, b, pc32=None, cfg: KSPConfig = None,
             inner_cfg: KSPConfig = None, max_refine: int = 10,
             axis: Optional[str] = None, **kw) -> SolveResult:
    """Iterative refinement: fp64 residuals, fp32 inner Krylov solves.

    A64 : fp64 operator (residual evaluation)
    A32 : the same operator in fp32 (inner solve)
    pc32: optional fp32 preconditioner for the inner solve
    cfg : OUTER tolerance (fp64 true-residual rtol/atol)
    inner_cfg: inner solver config (defaults: gmres, rtol 1e-5)

    Its result's `its` is the total of the inner iterations and its
    history the true residual norm after each sweep."""
    from petsctpu_torch.ksp.api import KSP_REGISTRY

    cfg = replace(cfg or KSPConfig(rtol=1e-12), **kw) if kw \
        else (cfg or KSPConfig(rtol=1e-12))
    inner_cfg = inner_cfg or KSPConfig(ksp_type="gmres", rtol=1e-5,
                                       maxits=200)
    inner = KSP_REGISTRY[inner_cfg.ksp_type]
    b64 = b.to(torch.float64)
    x = torch.zeros_like(b64)
    rnorm0 = float(to_host(ops.norm(b64, axis))[0])
    history = np.full(max_refine + 1, np.nan)
    history[0] = rnorm0
    its_total = 0
    reason = ConvergedReason.ITERATING
    rn = rnorm0
    for k in range(1, max_refine + 1):
        r32 = (b64 - A64.mult(x)).to(torch.float32)
        d = inner(A32, r32, torch.zeros_like(r32), pc32, inner_cfg, axis)
        x = x + d.x.to(torch.float64)
        rn_prev, rn = rn, float(to_host(ops.norm(b64 - A64.mult(x), axis))[0])
        its_total += int(d.its)
        history[k] = rn
        if not np.isfinite(rn):
            reason = ConvergedReason.DIVERGED_NANORINF
            break
        if rn <= max(cfg.rtol * rnorm0, cfg.atol):
            reason = ConvergedReason.CONVERGED_RTOL
            break
        if rn >= 0.9 * rn_prev:                  # fp32 floor reached
            reason = (ConvergedReason.CONVERGED_RTOL
                      if rn <= 1e-6 * rnorm0
                      else ConvergedReason.DIVERGED_DTOL)
            break
    else:
        reason = ConvergedReason.DIVERGED_ITS
    return SolveResult(x, torch.tensor(its_total, dtype=torch.int32),
                       torch.tensor(int(reason), dtype=torch.int32),
                       torch.tensor(rn, dtype=torch.float64),
                       torch.from_numpy(history))
