"""SNES NASM (nonlinear additive Schwarz), multiblock and MS (multi-stage
smoothers).

Counterpart of petsctpu/snes/nasm.py (reference:
src/snes/impls/nasm/nasm.c — subdomain nonlinear solves combined
additively, optional damping; src/snes/impls/multiblock; and
src/snes/impls/ms/ms.c — explicit multi-stage Shu-Osher-form smoothers,
Jameson and van Leer-Tai-Powell schemes).
"""

from __future__ import annotations

from contextlib import nullcontext
from typing import Callable, Optional, Sequence

import numpy as np
import torch

from petsctpu_torch.ksp.common import KSPConfig
from petsctpu_torch.snes.api import (Monitor, SNESConfig, SNESResult,
                                     configure, snes_solve)
from petsctpu_torch.vec import ops


def _restricted(F, x, idx):
    """F with the unknowns idx free and the others held at x, on idx."""
    def Fi(xi):
        return F(x.index_put((idx,), xi))[idx]
    return Fi


def snes_nasm(F: Callable, x0: torch.Tensor, subdomains: Sequence,
              damping: float = 1.0, inner_its: int = 2,
              cfg: SNESConfig = None, axis: Optional[str] = None,
              nasm_type: str = "basic", owned: Sequence = None,
              inner_cfg: SNESConfig = None, inner_ksp: KSPConfig = None,
              **kw) -> SNESResult:
    """Nonlinear additive Schwarz (SNESNASM).

    subdomains: index arrays. An outer iteration solves each subdomain's
    restricted problem F(x with x_i replaced)[idx_i] = 0 by a few Newton
    steps (matrix-free GMRES inner), the other unknowns held at their
    current values, then combines the corrections:
      "basic"    — additive with partition-of-unity weights on the
                   overlap (and `damping`);
      "restrict" — restricted additive Schwarz: solve on the overlapping
                   subdomain, write back only its `owned` points.

    On a Comm (F the rank's residual, its halos Comm.ppermute), the
    subdomains are index arrays of the rank's piece and every rank
    solves its own: the halo rows that F(x) received at the outer
    iterate are recorded and replayed in the subdomain solves
    (Comm.recording_halos / replaying_halos), so a subdomain problem
    holds the other ranks' unknowns at their current values, as the
    serial method holds every unknown outside it, and its inner Newton
    sends no message. The outer norms are the Comm's."""
    cfg = configure(cfg, kw)
    dev = x0.device
    subs = [torch.as_tensor(np.asarray(s, np.int64), device=dev)
            for s in subdomains]
    mult = np.zeros(x0.shape[0])
    for s in subdomains:
        mult[np.asarray(s)] += 1.0
    wts = [torch.as_tensor(1.0 / mult[np.asarray(s)], dtype=x0.dtype,
                           device=dev) for s in subdomains]
    if nasm_type == "restrict":
        if owned is None:
            raise ValueError("snes_nasm: the restrict type needs the owned "
                             "index lists")
        own_pos, owned_t = [], []
        for s, o in zip(subdomains, owned):
            lookup = {int(g): k for k, g in enumerate(np.asarray(s))}
            own_pos.append(torch.as_tensor(
                [lookup[int(g)] for g in np.asarray(o)], dtype=torch.int64,
                device=dev))
            owned_t.append(torch.as_tensor(np.asarray(o, np.int64),
                                           device=dev))
    inner_cfg = inner_cfg or SNESConfig(maxits=inner_its, rtol=1e-8,
                                        linesearch="bt")
    inner_ksp = inner_ksp or KSPConfig(ksp_type="gmres", rtol=1e-6,
                                       maxits=100)

    def local_correction(x, idx):
        res = snes_solve(_restricted(F, x, idx), x[idx], jac="jvp",
                         cfg=inner_cfg, ksp_cfg=inner_ksp)
        return res.x - x[idx]

    def recorded(x):
        """F(x), and the halos its evaluation received (on a Comm)."""
        if axis is None:
            return F(x), None
        with axis.recording_halos() as halos:
            return F(x), halos

    Fx, halos = recorded(x0)
    mon = Monitor(cfg, x0, ops.norm(Fx, axis), axis)
    x = x0
    while mon.iterating:
        dx = torch.zeros_like(x)
        with (nullcontext() if axis is None
              else axis.replaying_halos(halos)):
            if nasm_type == "restrict":
                for idx, og, pos in zip(subs, owned_t, own_pos):
                    dx[og] = local_correction(x, idx)[pos]
            else:
                for idx, w in zip(subs, wts):
                    dx.index_add_(0, idx, w * local_correction(x, idx))
        xn = x + damping * dx
        Fx, halos = recorded(xn)
        mon.step_from(xn, x, ops.norm(Fx, axis))
        x = xn
    return mon.result(x, ops.norm(F(x), axis))


def snes_multiblock(F: Callable, x0: torch.Tensor, fields: Sequence,
                    mode: str = "multiplicative", inner_its: int = 3,
                    cfg: SNESConfig = None, axis: Optional[str] = None,
                    **kw) -> SNESResult:
    """SNES multiblock (src/snes/impls/multiblock): per-FIELD nonlinear
    solves combined additively or multiplicatively (the nonlinear
    counterpart of PCFieldSplit). fields: index arrays."""
    cfg = configure(cfg, kw)
    if mode == "additive":
        return snes_nasm(F, x0, fields, damping=1.0, inner_its=inner_its,
                         cfg=cfg, axis=axis)
    subs = [torch.as_tensor(np.asarray(s, np.int64), device=x0.device)
            for s in fields]
    inner_cfg = SNESConfig(maxits=inner_its, rtol=1e-8, linesearch="bt")
    inner_ksp = KSPConfig(ksp_type="gmres", rtol=1e-6, maxits=100)
    mon = Monitor(cfg, x0, ops.norm(F(x0), axis), axis)
    x = x0
    while mon.iterating:
        xn = x
        for idx in subs:                       # Gauss-Seidel over fields
            res = snes_solve(_restricted(F, xn, idx), xn[idx], jac="jvp",
                             cfg=inner_cfg, ksp_cfg=inner_ksp)
            xn = xn.index_put((idx,), res.x)
        mon.step_from(xn, x, ops.norm(F(xn), axis))
        x = xn
    return mon.result(x, ops.norm(F(x), axis))


# Multi-stage schemes: name -> (stage coefficients, damping)
# (ms.c SNESMSRegisterAll: euler, jameson83, vltp21..61)
MS_SCHEMES = {
    "euler": ([1.0], 1.0),
    "jameson83": ([0.25, 0.5, 0.55, 1.0], 1.0),
    "vltp21": ([0.3333, 1.0], 1.0),
    "vltp31": ([0.1481, 0.4000, 1.0], 1.5),
    "vltp41": ([0.0833, 0.2069, 0.4265, 1.0], 2.0),
    "vltp51": ([0.0533, 0.1263, 0.2375, 0.4414, 1.0], 2.5),
    "vltp61": ([0.0370, 0.0851, 0.1521, 0.2562, 0.4512, 1.0], 3.0),
}


def snes_ms(F: Callable, x0: torch.Tensor, scheme: str = "jameson83",
            damping: float = None, scale: Optional[torch.Tensor] = None,
            cfg: SNESConfig = None, axis: Optional[str] = None,
            **kw) -> SNESResult:
    """Explicit multi-stage smoothing iterations (SNESMS, ms.c): each
    outer iteration runs the stages x_(i) = x_0 − β_i·h·S·F(x_(i−1)),
    S an optional scaling (e.g. 1/diag(J)), h the damping."""
    cfg = configure(cfg, kw)
    betas, h_default = MS_SCHEMES[scheme]
    h = damping if damping is not None else h_default

    def S(v):
        return v if scale is None else scale * v

    mon = Monitor(cfg, x0, ops.norm(F(x0), axis), axis)
    x = x0
    while mon.iterating:
        xn = x
        for b in betas:
            xn = x - b * h * S(F(xn))
        mon.step_from(xn, x, ops.norm(F(xn), axis))
        x = xn
    return mon.result(x, ops.norm(F(x), axis))
