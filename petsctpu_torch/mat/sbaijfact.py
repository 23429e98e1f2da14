"""SBAIJ blocked Cholesky / IC(k): the symmetric block factorization.

Counterpart of petsctpu/mat/sbaijfact.py (reference:
src/mat/impls/sbaij/seq/sbaijfact.c, MatCholeskyFactorNumeric_SeqSBAIJ_N):
A ≈ UᵀDU over the block upper triangle with bs×bs block pivots D_k,

    D_k  = A_kk − Σ_{i<k, k∈pat(i)} U_ikᵀ D_i U_ik
    U_kj = D_k⁻¹ (A_kj − Σ_{i<k, k,j∈pat(i)} U_ikᵀ D_i U_ij),

over the symbolic IC(k) pattern of the block graph (levels=None: nb
levels, the full fill of an exact blocked Cholesky).

Setup, on the host, each part under a log event (core/logging.py):
  * MatCholFctrSym  the block graph and its IC(k) pattern
                    (csrc/host_factor.cpp::icck_pattern);
  * MatCholFctrNum  the block recurrence, csrc/host_factor.cpp::
                    sbaij_block_udu (a copy of petsctpu's native C++);
  * MatSBAIJExpand  the scalar expansion: each pivot factored as D_k =
                    u_kᵀ d_k u_k (dense UDU), W = blockdiag(u_k)·U − I a
                    scalar unit-upper factor with A ≈ (I+W)ᵀ diag(d)
                    (I+W). petsctpu's `_expand_scalar` and `_dense_udu`
                    loop over every block in Python; here the same
                    arithmetic runs batched over the blocks, and the same
                    entries are dropped (exact zeros of u_k's strict part
                    and of W);
  * MatSolvePlan    the two triangles' level plans (host arrays);
  * MatUpload       the plans' level order and their copy to the device.
The apply is the port's ICCPC: two SpTRSV launches (ops/sptrsv.py)
with the 1/d scaling between them (tri="band": petsctpu's banded plans,
PyTorch products).
"""

from __future__ import annotations

import numpy as np
import scipy.sparse as sp
import torch

from petsctpu_torch.core.logging import log_event
from petsctpu_torch.device import np_dtype, resolve_device
from petsctpu_torch.mat import host_factor


def dense_udu(Ab):
    """Each block of Ab [nb, bs, bs] as uᵀ diag(d) u, u unit upper:
    (u [nb, bs, bs], d [nb, bs]). petsctpu's `_dense_udu` batched over
    the blocks, the same arithmetic; a zero scalar pivot raises
    ZeroDivisionError."""
    C = np.array(Ab, dtype=np.float64)
    nb, bs = C.shape[0], C.shape[-1]
    u = np.broadcast_to(np.eye(bs), C.shape).copy()
    d = np.zeros((nb, bs))
    for p in range(bs):
        d[:, p] = C[:, p, p]
        zero = np.flatnonzero(d[:, p] == 0.0)
        if zero.size:
            raise ZeroDivisionError(f"zero scalar pivot in block {zero[0]} "
                                    f"(dof {p})")
        u[:, p, p + 1:] = C[:, p, p + 1:] / d[:, p, None]
        C[:, p + 1:, p + 1:] -= u[:, p, p + 1:, None] * C[:, p, None, p + 1:]
    return u, d


def block_pattern(A_host, bs: int, levels=None) -> tuple:
    """The block recurrence's operands: A's upper blocks (diagonal
    included) in block CSR (ai, aj, av [nnzb, bs, bs]), in A's BSR
    order, and the strict-upper IC(levels) pattern (ui, uj) of the
    symmetrized block graph (levels None: nb)."""
    A = sp.csr_matrix(A_host).astype(np.float64)
    n = A.shape[0]
    if n % bs:
        raise ValueError(f"n = {n} is not a multiple of bs = {bs}")
    nb = n // bs
    Ab = A.tobsr(blocksize=(bs, bs))
    G = sp.csr_matrix((np.ones(len(Ab.indices)), Ab.indices, Ab.indptr),
                      shape=(nb, nb))
    G = ((G + G.T) != 0).astype(np.float64).tocsr()
    G.sort_indices()
    ui, uj = host_factor.icck_pattern(G.indptr, G.indices,
                                      nb if levels is None else levels)
    rows = np.repeat(np.arange(nb), np.diff(Ab.indptr))
    up = rows <= Ab.indices
    ai = np.zeros(nb + 1, np.int64)
    ai[1:] = np.cumsum(np.bincount(rows[up], minlength=nb))
    return (ai, Ab.indices[up].astype(np.int64), Ab.data[up],
            ui.astype(np.int64), uj.astype(np.int64))


def sbaij_block_udu_plain(ai, aj, av, ui, uj, bs: int, shift: float = 0.0):
    """host_factor.sbaij_block_udu in Python (its plain version, the same
    loops): (uv [nnzU, bs, bs], dv [nb, bs, bs])."""
    nb = len(ai) - 1
    uv = np.zeros((int(ui[-1]), bs, bs))
    D = np.zeros((nb, bs, bs))
    bucket = [[] for _ in range(nb)]

    def inverse(Mk):
        w, out = Mk.copy(), np.eye(bs)
        for c in range(bs):
            p = c
            for r in range(c + 1, bs):
                if abs(w[r, c]) > abs(w[p, c]):
                    p = r
            if w[p, c] == 0.0:
                return None
            if p != c:
                w[[p, c]], out[[p, c]] = w[[c, p]], out[[c, p]]
            dc = w[c, c]
            for j in range(bs):
                w[c, j] /= dc
                out[c, j] /= dc
            for r in range(bs):
                f = w[r, c]
                if r == c or f == 0.0:
                    continue
                for j in range(bs):
                    w[r, j] -= f * w[c, j]
                    out[r, j] -= f * out[c, j]
        return out

    def product(X, Y):
        Z = np.zeros((bs, bs))
        for r in range(bs):
            for c in range(bs):
                s = 0.0
                for q in range(bs):
                    s += X[r, q] * Y[q, c]
                Z[r, c] = s
        return Z

    for k in range(nb):
        acc = {k: np.zeros((bs, bs))}
        for t in range(bs):
            acc[k][t, t] += shift
        for t in range(ai[k], ai[k + 1]):
            if aj[t] >= k:
                a = acc.setdefault(int(aj[t]), np.zeros((bs, bs)))
                a += av[t]
        for t in range(ui[k], ui[k + 1]):
            acc.setdefault(int(uj[t]), np.zeros((bs, bs)))
        for i, tik in bucket[k]:
            M = product(uv[tik].T, D[i])
            for t in range(ui[i], ui[i + 1]):
                j = int(uj[t])
                if j >= k and j in acc:
                    acc[j] -= product(M, uv[t])
        D[k] = acc[k]
        inv = inverse(D[k])
        if inv is None:
            raise ZeroDivisionError(f"sbaij UtDU: singular block pivot {k}")
        for t in range(ui[k], ui[k + 1]):
            uv[t] = product(inv, acc[int(uj[t])])
            bucket[int(uj[t])].append((k, t))
    return uv, D


def expand_scalar(uv, dv, ui, uj, bs: int) -> tuple:
    """The scalar expansion (Wstrict, d) of the block factor: u_k, d_k of
    each pivot, W's rows k·bs + a holding u_k's strict part and the
    blocks u_k·U_kj, exact zeros dropped (petsctpu's `_expand_scalar`,
    batched over the blocks)."""
    nb = dv.shape[0]
    n = nb * bs
    u, d = dense_udu(dv)
    a, b = np.triu_indices(bs, 1)
    us = u[:, a, b]                                   # [nb, npairs]
    kk, pp = np.nonzero(us)
    rows_d, cols_d, vals_d = kk * bs + a[pp], kk * bs + b[pp], us[kk, pp]
    krow = np.repeat(np.arange(nb), np.diff(ui))
    W = np.matmul(u[krow], uv)                        # [nnzU, bs, bs]
    t, ra, cb = np.nonzero(W)
    rows = np.concatenate([rows_d, krow[t] * bs + ra])
    cols = np.concatenate([cols_d, uj[t] * bs + cb])
    vals = np.concatenate([vals_d, W[t, ra, cb]])
    Wstrict = sp.coo_matrix((vals, (rows, cols)), shape=(n, n)).tocsr()
    return Wstrict, d.reshape(-1)


def sbaij_cholesky_factor(A_host, bs: int, levels=None,
                          shift: float = 0.0) -> tuple:
    """Blocked UᵀDU of a symmetric matrix in bs-blocks (levels: IC(k) on
    the block graph; None the full fill). Returns (Wstrict, d): A ≈
    (I+Wstrict)ᵀ diag(d) (I+Wstrict), petsctpu's pattern byte for byte."""
    with log_event("MatCholFctrSym"):
        ai, aj, av, ui, uj = block_pattern(A_host, bs, levels)
    with log_event("MatCholFctrNum"):
        uv, dv = host_factor.sbaij_block_udu(ai, aj, av, ui, uj, bs, shift)
    with log_event("MatSBAIJExpand"):
        return expand_scalar(uv, dv, ui, uj, bs)


def iccpc_from_factor(Wstrict, d, dtype=None, tri: str = "level",
                      device=None):
    """The ICCPC of a scalar factor (Wstrict unit-upper strict part, d):
    level plans of Wstrictᵀ and Wstrict (tri "band": banded plans) and
    1/d on the device."""
    from petsctpu_torch.mat.factor import (SpTRSVPlan, make_band_trsv_plan,
                                           sptrsv_arrays)
    from petsctpu_torch.pc.factor import ICCPC

    dev = resolve_device(device)
    tris = ((sp.csr_matrix(Wstrict.T), True), (sp.csr_matrix(Wstrict), False))
    if tri == "band":
        with log_event("MatSolvePlan"):
            plans = [make_band_trsv_plan(T, lower=lo, unit_diag=True,
                                         dtype=dtype, device=dev)
                     for T, lo in tris]
    else:
        with log_event("MatSolvePlan"):
            arrays = [sptrsv_arrays(T, lo, True, dtype) for T, lo in tris]
        with log_event("MatUpload"):
            plans = [SpTRSVPlan(*a, device=dev) for a in arrays]
    dt = np_dtype(dtype) or np.dtype(np.float64)
    with log_event("MatUpload"):
        dinv = torch.from_numpy((1.0 / np.asarray(d)).astype(dt)).to(dev)
    return ICCPC(plans[0], plans[1], dinv)


def make_sbaij_cholesky(A_host, bs: int, levels=None, dtype=None,
                        shift: float = 0.0, tri: str = "level",
                        device=None):
    """PC factory: blocked Cholesky (levels None) or blocked IC(k) on the
    bs-block structure, applied by the port's ICCPC, x = U⁻¹ D⁻¹ U⁻ᵀ b
    (two SpTRSV launches on the card)."""
    dev = resolve_device(device)
    Wstrict, d = sbaij_cholesky_factor(A_host, bs, levels=levels, shift=shift)
    return iccpc_from_factor(Wstrict, d, dtype, tri, dev)
