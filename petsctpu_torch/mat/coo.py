"""Device-side COO assembly.

Counterpart of petsctpu/mat/coo.py (reference: MatSetValues + MatStash,
src/mat/impls/aij/mpi/mpiaij.c:476, src/mat/utils/matstash.c:435):
generate all (row, col, val) triples in one batch, sort them by (row,
col) on the device, merge duplicates (ADD_VALUES) and pack a frozen ELL
layout. The merge folds each run of equal (row, col) entries in sorted
order from zero through a fold plan (mat/fold.py), the order of
petsctpu's `.at[gid].add`, so it is deterministic on the card; the sort
is stable, so duplicates fold in their input order.
"""

from __future__ import annotations

import torch

from petsctpu_torch.mat.ell import AIJ
from petsctpu_torch.mat.fold import fold_plan


def ell_from_coo(rows: torch.Tensor, cols: torch.Tensor, vals: torch.Tensor,
                 shape: tuple, ell_width: int) -> AIJ:
    """Assemble COO triples into an ELL-packed AIJ on their device.

    Entries with a row or column out of range are dropped; `ell_width`
    must bound the merged nonzeros of a row, and a row's slots past it
    are dropped, as in petsctpu."""
    m, n = shape
    dev = vals.device
    rows = rows.to(torch.int64)
    cols = cols.to(torch.int64)
    valid = (rows >= 0) & (rows < m) & (cols >= 0) & (cols < n)
    # invalid entries go to a sentinel row m, sorted last and dropped
    rows = torch.where(valid, rows, m)
    vals = torch.where(valid, vals, torch.zeros((), dtype=vals.dtype,
                                                device=dev))
    cols = torch.where(valid, cols, 0)
    key, order = torch.sort(rows * (n + 1) + cols, stable=True)
    rows_s, cols_s, vals_s = rows[order], cols[order], vals[order]
    nnz = key.numel()
    newgrp = torch.ones(nnz, dtype=torch.bool, device=dev)
    if nnz:
        newgrp[1:] = key[1:] != key[:-1]
    gid = torch.cumsum(newgrp.to(torch.int64), 0) - 1
    ngrp = int(gid[-1]) + 1 if nnz else 0
    u_rows = rows_s[newgrp]
    u_cols = cols_s[newgrp]
    u_vals = fold_plan(gid).fold(
        torch.zeros(ngrp, dtype=vals.dtype, device=dev), vals_s)
    # slot within the row: position minus the row's first position
    pos = torch.arange(ngrp, device=dev)
    first = torch.ones(ngrp, dtype=torch.bool, device=dev)
    if ngrp:
        first[1:] = u_rows[1:] != u_rows[:-1]
    slot = pos - torch.cummax(torch.where(first, pos, 0), 0).values \
        if ngrp else pos
    ok = (u_rows < m) & (slot < ell_width)
    flat = (u_rows * ell_width + slot)[ok]
    ell_cols = torch.zeros(m * ell_width, dtype=torch.int32, device=dev)
    ell_vals = torch.zeros(m * ell_width, dtype=vals.dtype, device=dev)
    # each kept (row, slot) is one merged entry: unique indices
    ell_cols[flat] = u_cols[ok].to(torch.int32)
    ell_vals[flat] = u_vals[ok]
    return AIJ(ell_cols.reshape(m, ell_width), ell_vals.reshape(m, ell_width),
               (m, n), nnz=0)
