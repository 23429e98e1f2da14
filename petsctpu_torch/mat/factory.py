"""Runtime matrix-format selection (-mat_type, MatSetFromOptions).

Reference: MatSetType/MatSetFromOptions + the registry in
src/mat/interface/matregis.c. Ported formats:

  aij      ELL-packed general sparse (the ELL kernel)
  baij     block ELL (-mat_block_size); on the card fp32 SELL-viable
           operators take SellBAIJ, whose forward product is K2
  sbaij    symmetric block upper-triangle storage (-mat_block_size)
  dense    dense (torch.matmul)
  band     tiled band in the -mat_ordering_type ordering (default rcm)
  dia      diagonal-offset streams, in that ordering
  sell     sliced-ELL through the hand-written CUDA kernel K2
           (mat/sell.py; fp32 only)
  auto     pick for the hardware (auto_format, below)

band, dia, sell and auto solve in the permuted space: the returned
`perm` (or None) must be applied to b and inverted on x.

`auto` follows petsctpu/mat/factory.py::_auto_format, whose decision
tree forks on `jax.default_backend() == "tpu"`. Here the fork is the
`accel` argument: True for an operator built on the card.

  * accel=False (the CPU) takes the reference's off-TPU decisions
    exactly: natural band -> BandMat; a recovered grid
    (mat/griddetect.py) -> StencilMat; RCM band -> BandMat; else AIJ.
  * accel=True takes the reference's TPU tree, SELL gates included
    (fp32 only: K2), without its three BandMat returns: where the
    reference would return a band it goes on to its next candidate.
    The gate follows the kernel table of PERF.md §6 (NVIDIA H100 80GB
    HBM3, 700.00 W): on the natural 513² 5-point Laplacian (fp64)
    BandMat.mult takes 0.96 ms on the device and DiaMat.mult 0.041 ms
    against 0.021 ms for CSR `mv`, so on the card neither is a default.
    An fp64 grid operator therefore goes to the grid recovery and a
    StencilMat (K1) in either ordering; an fp32 one meets the SELL
    gates first.
"""

from __future__ import annotations

import numpy as np
import scipy.sparse as sp
import torch

from petsctpu_torch.core.logging import log_event, petsc_info


def mat_from_options(A, opts=None, mat_type: str = None, dtype=None,
                     device=None):
    """Build a device matrix per options. Returns (mat, perm|None)."""
    from petsctpu_torch.device import np_dtype, resolve_device
    from petsctpu_torch.mat.ell import aij_from_scipy
    from petsctpu_torch.mat.order import get_ordering

    dev = resolve_device(device)
    bs = 1
    ordering = "rcm"
    if opts is not None:
        mat_type = mat_type or opts.get_str("mat_type", "aij")
        bs = opts.get_int("mat_block_size", 1)
        ordering = opts.get_str("mat_ordering_type", "rcm")
        if opts.get_bool("info", False):
            from petsctpu_torch.core.logging import info_on
            info_on()
    else:
        mat_type = mat_type or "aij"
    A = sp.csr_matrix(A)

    if mat_type == "aij":
        return aij_from_scipy(A, dtype=dtype, device=dev), None
    if mat_type == "baij":
        from petsctpu_torch.mat.bsr import baij_from_scipy_bsr
        return baij_from_scipy_bsr(A, bs=bs, dtype=dtype, device=dev), None
    if mat_type == "sbaij":
        from petsctpu_torch.mat.sbaij import sbaij_from_scipy
        return sbaij_from_scipy(A, bs=bs, dtype=dtype, device=dev), None
    if mat_type == "dense":
        import torch

        from petsctpu_torch.mat.dense import Dense
        D = A.toarray().astype(np_dtype(dtype) or A.dtype)
        return Dense(torch.from_numpy(D).to(dev)), None
    if mat_type in ("band", "dia"):
        from petsctpu_torch.mat.band import band_from_scipy
        from petsctpu_torch.mat.dia import dia_from_scipy
        perm = get_ordering(A, ordering)
        make = band_from_scipy if mat_type == "band" else dia_from_scipy
        return make(A, dtype=dtype, perm=perm, device=dev), perm
    if mat_type == "sell":
        from petsctpu_torch.mat.sell import sell_from_scipy
        perm = get_ordering(A, ordering)
        if np.array_equal(perm, np.arange(A.shape[0])):
            Ap = A if A.has_canonical_format else A.copy()
        else:
            Ap = A[perm][:, perm].tocsr()
        Ap.sum_duplicates()
        return sell_from_scipy(Ap, device=dev), perm
    if mat_type == "auto":
        M, perm = auto_format(A, ordering, dtype, accel=dev.type == "cuda",
                              device=dev)
        petsc_info("MatFromOptions",
                   f"-mat_type auto: n={A.shape[0]} nnz={A.nnz} -> "
                   f"{type(M).__name__}"
                   + ("" if perm is None else " (permuted)"))
        return M, perm
    raise ValueError(f"unknown -mat_type {mat_type!r} "
                     "(aij|baij|sbaij|dense|band|dia|sell|auto)")


def auto_format(A: sp.csr_matrix, ordering: str = "rcm", dtype=None,
                accel: bool = True, device=None):
    """-mat_type auto: (mat, perm|None), the reference's _auto_format
    with `accel` in place of its TPU test (see the module docstring).

    Ordering policy (the reference's default kernel is its fast
    kernel, aij.c:1173, and its Inode/CRL detection upgrades the
    layout silently): the NATURAL ordering is tried first — when the
    matrix is already banded or SELL-viable as given, no permutation
    is applied at all. Only when natural fails does the plan evaluate
    permutations, choosing by the SELL plan's own pass-count cost model
    (per-row q-chunk dispersion — see mat/sell.py). The grid recovery,
    the stencil pack and its upload run under the log events
    MatGridDetect, MatStencilPack and MatUpload."""
    from petsctpu_torch.device import np_dtype, resolve_device
    from petsctpu_torch.mat.band import band_from_scipy
    from petsctpu_torch.mat.ell import aij_from_scipy
    from petsctpu_torch.mat.griddetect import grid_recover_ordering
    from petsctpu_torch.mat.order import bandwidth, get_ordering
    from petsctpu_torch.mat.sell import (sell_from_scipy, sell_plan_stats,
                                         sell_viable)
    from petsctpu_torch.mat.stencil import StencilMat

    dev = resolve_device(device)
    A = sp.csr_matrix(A)
    n = A.shape[0]
    band_thresh = max(512, n // 64)
    f32 = (np_dtype(dtype) or A.dtype) == np.float32

    # 1) natural band (identity perm) — off the card only
    if not accel and bandwidth(A) <= band_thresh:
        return band_from_scipy(A, dtype=dtype, device=dev), None

    # 2) natural SELL — near-ideal slop short-circuits with NO perm
    avg = A.nnz / max(n, 1)
    An = A.copy()
    An.sum_duplicates()
    best = None                     # (P, perm|None, matrix)
    if f32 and accel and sell_viable(An):
        Pn = sell_plan_stats(An)[0]
        if Pn <= 2.0 * avg:
            return sell_from_scipy(An, device=dev), None
        best = (Pn, None, An)

    # 3) structured-grid recovery first: a recovered grid is a
    #    <= 3^d-offset stencil with no band fill, so its coefficient
    #    planes (mat/stencil.py, K1) need no index arrays, and the RCM
    #    candidates below are skipped
    grid_won = False
    if best is None or best[0] > 2.0 * avg:
        with log_event("MatGridDetect"):
            gperm, gdims = grid_recover_ordering(A, return_dims=True)
        if gperm is not None:
            with log_event("MatStencilPack"):
                Ag = A[gperm][:, gperm].tocsr()
                Ag.sum_duplicates()
                cog = Ag.tocoo()
                rcs = np.unravel_index(cog.row, gdims)
                ccs = np.unravel_index(cog.col, gdims)
                # stencil offsets are in {-1,0,1}^d (verified by the
                # recovery): each is one base-3 int, so the dedup is a
                # plain integer unique
                key = np.zeros(cog.row.shape, np.int64)
                for rk, ck in zip(rcs, ccs):
                    key = key * 3 + (ck.astype(np.int64) - rk + 1)
                okeys, oinv = np.unique(key, return_inverse=True)
                K = len(okeys)
                C = None
                if K * n <= 2.0 * max(Ag.nnz, 1):   # boundary-pad guard
                    offs = []
                    for ok in okeys:
                        o, ds = [], int(ok)
                        for _ in gdims:
                            o.append(ds % 3 - 1)
                            ds //= 3
                        offs.append(tuple(reversed(o)))
                    C = np.zeros((K,) + tuple(gdims),
                                 np_dtype(dtype) or A.dtype)
                    C[(oinv,) + rcs] = cog.data
            if C is not None:
                with log_event("MatUpload"):
                    coeffs = torch.from_numpy(C).to(dev)
                return StencilMat(coeffs, tuple(offs), tuple(gdims)), gperm
            if f32 and accel and n < 2_000_000 and sell_viable(Ag):
                Pg = sell_plan_stats(Ag)[0]
                if best is None or Pg < best[0]:
                    best = (Pg, gperm, Ag)
                    grid_won = True
            elif not accel and bandwidth(Ag) <= band_thresh:
                return (band_from_scipy(A, dtype=dtype, perm=gperm,
                                        device=dev), gperm)

    # 4) profile (RCM) candidates — only when grid recovery did not
    #    already win. The candidate RANKING only needs an RCM-shaped
    #    profile, not SPARSPAK-exact tie-breaks: scipy's RCM.
    if not grid_won:
        perm = get_ordering(A, "rcm_fast" if ordering == "rcm"
                            else ordering)
        Ap = A[perm][:, perm].tocsr()
        if not accel and bandwidth(Ap) <= band_thresh:
            return band_from_scipy(A, dtype=dtype, perm=perm,
                                   device=dev), perm
        if f32 and accel:
            Ap.sum_duplicates()
            if sell_viable(Ap):
                Pp = sell_plan_stats(Ap)[0]
                if best is None or Pp < best[0]:
                    best = (Pp, perm, Ap)
    if best is not None:
        return sell_from_scipy(best[2], device=dev), best[1]
    return aij_from_scipy(A, dtype=dtype, device=dev), None
