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

band, dia and sell solve in the permuted space: the returned `perm`
must be applied to b and inverted on x. `auto` is gated on the TPU
backend in petsctpu; its GPU policy is later work and raises.
"""

from __future__ import annotations

import numpy as np
import scipy.sparse as sp

_LATER = {"auto": "ROADMAP queue 1 item 6 (a GPU format policy)"}


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
    if mat_type in _LATER:
        raise NotImplementedError(
            f"-mat_type {mat_type} is not ported yet ({_LATER[mat_type]})")
    raise ValueError(f"unknown -mat_type {mat_type!r} "
                     "(aij|baij|sbaij|dense|band|dia|sell|auto)")
