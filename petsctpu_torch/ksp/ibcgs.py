"""IBCGS — improved BiCGStab with ONE fused reduction per iteration.

Reference: src/ksp/ksp/impls/ibcgs/ibcgs.c (Yang & Brent's reordered
BiCGStab: all six inner products of an iteration are arranged to be
computable from the same two vectors sn/tn, merged with the LAGGED
residual norm into a single 7-term MPI_Allreduce, ibcgs.c:185-217).

The 7 contractions go through one `ops.reduce_all`. Like the
reference, the DEFAULT convergence norm is the current iteration's
‖rn‖ (a second reduction, ibcgs.c:238-243); with cfg.lag_norm
(-ksp_lag_norm) the lagged norm rides the fused reduction. Either way
the norm and the breakdown flag come to the host once per iteration.

Requires a symmetric preconditioner (or none): f0 = Aᵀ Bᵀ r0 is formed
with B applied as itself (the reference calls PCApplyTranspose). Needs
A.multT: an AIJ operator on the card.
"""

from __future__ import annotations

import torch

from petsctpu_torch.core.errors import ConvergedReason
from petsctpu_torch.ksp.common import (
    KSPConfig, SolveResult, advance, apply_pc, initial_guess, make_result,
    nonzero_or_one, preconditioned_residual, start, to_host,
)
from petsctpu_torch.vec import ops

ITERATING = ConvergedReason.ITERATING


def solve_ibcgs(A, b, x0, pc, cfg: KSPConfig, axis=None) -> SolveResult:

    def BA(v):
        return apply_pc(pc, A.mult(v))

    x = initial_guess(b, x0, cfg)
    r = preconditioned_residual(A, b, x, pc, cfg)
    history, rnorm0, reason = start(cfg, ops.norm(r, axis))
    r0 = r
    u = BA(r)                                   # un_1 = B A rn_1
    f0 = A.multT(apply_pc(pc, r0))              # f0 = A' B' r0 (B symmetric)
    zero = torch.zeros_like(b)
    one = torch.ones((), dtype=b.dtype, device=b.device)
    z0 = torch.zeros((), dtype=b.dtype, device=b.device)
    phin_1, sigman_1 = ops.reduce_all((torch.vdot(r0, r0),
                                       torch.vdot(r0, u)), axis)
    v = q = z = zero
    sigman_2 = pin_1 = taun_1 = z0
    alphan_1 = omegan_1 = one
    rnormin = z0                    # local ‖rn‖² of the last iteration
    its = 0
    while reason == ITERATING:
        its += 1
        rhon = phin_1 - omegan_1 * sigman_2 + omegan_1 * alphan_1 * pin_1
        deltan = rhon if its == 1 else rhon / nonzero_or_one(taun_1)
        betan = deltan / nonzero_or_one(omegan_1)
        taun = sigman_1 + betan * taun_1 - deltan * pin_1
        bad_tau = taun == 0
        alphan = rhon / torch.where(bad_tau, one, taun)

        # fused vector updates (ibcgs.c:149-155, incl. the alphan/alphan_1
        # correction the paper omits)
        zn = (alphan * r + (alphan / alphan_1) * betan * z
              - alphan * deltan * v)
        vn = u + betan * v - deltan * q
        sn = r - alphan * vn
        qn = BA(vn)
        tn = u - alphan * qn

        # the single fused reduction: 6 recurrence dots + lagged ‖r‖²
        phin, pin, gamman, etan, thetan, kappan, rsum = ops.reduce_all(
            (torch.vdot(r0, sn), torch.vdot(r0, qn), torch.vdot(f0, sn),
             torch.vdot(f0, tn), torch.vdot(sn, tn), torch.vdot(tn, tn),
             rnormin), axis)
        if its == 1:
            rsum = phin_1                       # the lagged ‖r0‖², global
        bad_kt = (kappan == 0) | (thetan == 0)
        omegan = thetan / nonzero_or_one(kappan)
        sigman = gamman - omegan * etan
        rn = sn - omegan * tn
        rnormin = torch.vdot(rn, rn)            # reduced NEXT iteration
        xn = x + zn + omegan * sn
        # reference DEFAULT (!ksp->lagnorm, ibcgs.c:238-243): the
        # convergence norm is ‖rn‖ of THIS iteration, a second
        # reduction; -ksp_lag_norm takes the lagged one from the fused
        # reduction
        rnorm_sq = rsum if cfg.lag_norm else \
            ops.reduce_all((rnormin,), axis)[0]
        rnorm = torch.sqrt(torch.clamp(rnorm_sq.real, min=0.0))
        un = BA(rn)
        dp, bad = to_host(rnorm, bad_tau | bad_kt)
        reason = advance(cfg, history, its, dp, rnorm0, bool(bad))
        x, r, u, v, q, z = xn, rn, un, vn, qn, zn
        sigman_2, sigman_1, pin_1, phin_1 = sigman_1, sigman, pin, phin
        taun_1, alphan_1, omegan_1 = taun, alphan, omegan
    # the loop's norm may be lagged; report the true final residual norm
    (rfinal,) = to_host(ops.norm(r, axis))
    return make_result(x, its, reason, history, rnorm=rfinal)
