"""Runtime matrix-format selection (-mat_type, MatSetFromOptions).

Reference: MatSetType/MatSetFromOptions + the registry in
src/mat/interface/matregis.c. Ported formats:

  aij      ELL-packed general sparse (gather SpMV — robust default)
  sell     sliced-ELL through the hand-written CUDA kernel K2
           (mat/sell.py; fp32 only)

sell solves in the permuted space: the returned `perm` must be applied
to b and inverted on x. The other formats of petsctpu raise
NotImplementedError naming their ROADMAP item; `auto` is gated on the
TPU backend in petsctpu, and its GPU policy is later work.
"""

from __future__ import annotations

import scipy.sparse as sp

_LATER = {
    "baij": "ROADMAP queue 1 item 9", "sbaij": "ROADMAP queue 1 item 9",
    "dense": "ROADMAP queue 1 item 3", "band": "ROADMAP queue 1 item 9",
    "dia": "ROADMAP queue 1 item 9",
    "auto": "ROADMAP queue 1 item 6 (a GPU format policy)",
}


def mat_from_options(A, opts=None, mat_type: str = None, dtype=None,
                     device=None):
    """Build a device matrix per options. Returns (mat, perm|None)."""
    from petsctpu_torch.device import resolve_device
    from petsctpu_torch.mat.ell import aij_from_scipy
    from petsctpu_torch.mat.order import get_ordering

    dev = resolve_device(device)
    if opts is not None:
        mat_type = mat_type or opts.get_str("mat_type", "aij")
        ordering = opts.get_str("mat_ordering_type", "rcm")
        if opts.get_bool("info", False):
            from petsctpu_torch.core.logging import info_on
            info_on()
    else:
        mat_type = mat_type or "aij"
        ordering = "rcm"
    A = sp.csr_matrix(A)

    if mat_type == "aij":
        return aij_from_scipy(A, dtype=dtype, device=dev), None
    if mat_type == "sell":
        from petsctpu_torch.mat.sell import sell_from_scipy
        perm = get_ordering(A, ordering)
        Ap = A[perm][:, perm].tocsr()
        Ap.sum_duplicates()
        return sell_from_scipy(Ap, device=dev), perm
    if mat_type in _LATER:
        raise NotImplementedError(
            f"-mat_type {mat_type} is not ported yet ({_LATER[mat_type]})")
    raise ValueError(f"unknown -mat_type {mat_type!r} "
                     "(aij|baij|sbaij|dense|band|dia|sell|auto)")
