"""PCBDDC — balancing domain decomposition by constraints over MATIS.

Counterpart of petsctpu/pc/bddc.py (reference:
src/ksp/pc/impls/bddc/bddc.c): the interface is classified by subdomain
signature (PCBDDCAnalyzeInterface) into vertices (point constraints)
and edges (average constraints); each subdomain's saddle-point system
[A_i C_iᵀ; C_i 0] is inverted densely on the host at setup into H_i
(the constrained correction) and Ψ_i (the coarse basis), and the coarse
matrix K_c = Σ_i Ψ_iᵀ A_i Ψ_i is inverted. The apply is additive,

  M⁻¹r = Rᴰᵀ (H + Ψ K_c⁻¹ Ψᵀ) Rᴰ r,

dense products on the device; each subdomain's add (to the coarse
residual and to y) writes its unique indices once, so it is
deterministic on the card.
"""

from __future__ import annotations

import numpy as np
import torch

from petsctpu_torch.mat.matis import MatIS


class BDDCPC:
    def __init__(self, A: MatIS, weights, H, Psi, cmaps, Kc_inv,
                 nprimal: int = 0):
        self.A = A
        self.weights = tuple(weights)       # per-subdomain D_i
        self.H = tuple(H)                   # [ni, ni] corrections
        self.Psi = tuple(Psi)               # [ni, nc_i] coarse bases
        self.cmaps = tuple(cmaps)           # global primal dof ids
        self.Kc_inv = Kc_inv                # [NC, NC]
        self.nprimal = int(nprimal)

    def apply(self, r):
        y = torch.zeros_like(r)
        rc = torch.zeros(self.nprimal, dtype=r.dtype, device=r.device)
        locs = []
        for Wi, Pi, ci, gi in zip(self.weights, self.Psi, self.cmaps,
                                  self.A.l2g):
            ri = Wi * r[gi]
            locs.append(ri)
            rc.index_add_(0, ci, Pi.T @ ri)
        xc = self.Kc_inv @ rc
        for Wi, Hi, Pi, ci, gi, ri in zip(self.weights, self.H, self.Psi,
                                          self.cmaps, self.A.l2g, locs):
            y.index_add_(0, gi, Wi * (Hi @ ri + Pi @ xc[ci]))
        return y


def _interface_classes(l2g, n):
    """Dofs grouped by their subdomain signature."""
    sig = [[] for _ in range(n)]
    for i, g in enumerate(l2g):
        for k in g:
            sig[k].append(i)
    classes = {}
    for k in range(n):
        if len(sig[k]) >= 2:
            classes.setdefault(tuple(sig[k]), []).append(k)
    return classes


def _primal(classes, vertices: bool, edges: bool) -> list:
    """Global primal dofs: ("v", dof) vertices, ("e", dofs) averages."""
    primal = []
    for sg, dofs in sorted(classes.items()):
        if len(sg) >= 3 or len(dofs) == 1:
            if vertices:
                primal.extend(("v", d) for d in sorted(dofs))
            if len(sg) >= 3 and len(dofs) > 1 and edges:
                primal.append(("e", tuple(sorted(dofs))))
        elif edges:
            primal.append(("e", tuple(sorted(dofs))))
    if not primal:                       # degenerate: fall back to NN
        primal = [("e", tuple(sorted(d for ds in classes.values()
                                     for d in ds)))]
    return primal


def _constraints(primal, g2l, ni):
    """Subdomain constraint rows and their global primal ids."""
    rows, cids = [], []
    for cj, (kind, payload) in enumerate(primal):
        if kind == "v":
            if payload in g2l:
                row = np.zeros(ni)
                row[g2l[payload]] = 1.0
                rows.append(row)
                cids.append(cj)
        else:
            dofs = [g2l[d] for d in payload if d in g2l]
            if len(dofs) == len(payload):   # whole class in subdomain
                row = np.zeros(ni)
                row[dofs] = 1.0 / len(dofs)
                rows.append(row)
                cids.append(cj)
    return rows, cids


def make_bddc(A: MatIS, dtype=None, rtol: float = 1e-10,
              vertices: bool = True, edges: bool = True) -> BDDCPC:
    """The BDDC preconditioner of a MATIS operator (host setup)."""
    from petsctpu_torch.device import np_dtype
    from petsctpu_torch.mat.ell import aij_to_scipy

    dt = np_dtype(dtype) or np.dtype(np.float64)
    dev = A.device

    def dev_t(a, t=dt):
        return torch.from_numpy(np.asarray(a, t)).to(dev)

    n = A.shape[0]
    l2g = [g.cpu().numpy() for g in A.l2g]
    mult = np.zeros(n)
    for g in l2g:
        mult[g] += 1.0
    weights = [dev_t(1.0 / mult[g]) for g in l2g]
    primal = _primal(_interface_classes(l2g, n), vertices, edges)
    NC = len(primal)

    Hs, Psis, cmaps = [], [], []
    Kc = np.zeros((NC, NC))
    for i, gi in enumerate(l2g):
        ni = len(gi)
        Ai = aij_to_scipy(A.locals_[i]).toarray().astype(np.float64)
        rows, cids = _constraints(
            primal, {int(g): k for k, g in enumerate(gi)}, ni)
        if not rows:
            # no constraint touches this subdomain: a plain regularized
            # local solve, no coarse contribution
            Hs.append(dev_t(np.linalg.pinv(Ai, rcond=rtol)))
            Psis.append(dev_t(np.zeros((ni, 1))))
            cmaps.append(dev_t(np.zeros(1), np.int64))
            continue
        C = np.stack(rows)
        nc = len(rows)
        K = np.zeros((ni + nc, ni + nc))
        K[:ni, :ni] = Ai
        K[:ni, ni:] = C.T
        K[ni:, :ni] = C
        Kinv = np.linalg.pinv(K, rcond=rtol)
        Psi = Kinv[:ni, ni:]                    # [ni, nc]
        Hs.append(dev_t(Kinv[:ni, :ni]))
        Psis.append(dev_t(Psi))
        cmaps.append(dev_t(cids, np.int64))
        Kc[np.ix_(cids, cids)] += Psi.T @ Ai @ Psi
    return BDDCPC(A, weights, Hs, Psis, cmaps,
                  dev_t(np.linalg.pinv(Kc, rcond=rtol)), NC)
