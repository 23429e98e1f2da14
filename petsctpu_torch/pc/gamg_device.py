"""The dense LU coarse solve of the packed algebraic MG.

The part of petsctpu/pc/gamg_device.py on the GAMG path: DenseLUPC, the
coarse exact solve that petsctpu/pc/mg.py's packed branch factors on
the host with scipy.linalg.lu_factor. The device refresh of the GAMG
hierarchy (GAMGDevicePlan, with mat/sell.py's sell_template/sell_fill)
is ROADMAP queue 1 item 8.
"""

from __future__ import annotations

import torch


class DenseLUPC:
    """Coarse exact solve from scipy.linalg.lu_factor's (lu, piv).

    piv is scipy's: 0-based row interchanges (row i was swapped with row
    piv[i], in order). torch.linalg.lu_solve takes LAPACK's 1-based
    pivots, so the apply uses piv + 1."""

    def __init__(self, lu: torch.Tensor, piv: torch.Tensor):
        self.lu = lu
        self.pivots = (piv + 1).to(torch.int32)

    def apply(self, b):
        return torch.linalg.lu_solve(self.lu, self.pivots, b[:, None])[:, 0]
