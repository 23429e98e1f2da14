"""MATIS — an unassembled sum of local subdomain matrices.

Counterpart of petsctpu/mat/matis.py (reference: src/mat/impls/is,
A = Σᵢ Rᵢᵀ Aᵢ Rᵢ with Rᵢ the restriction to subdomain i; the input of
Neumann-Neumann and BDDC). The global operator is never assembled: a
product gathers each subdomain's slice, applies its local AIJ and adds
the result back. One subdomain's local-to-global indices are unique, so
each of those adds (`index_add_`) writes every target once and is
deterministic on the card; the subdomains add one after another, in
petsctpu's order.
"""

from __future__ import annotations

import numpy as np
import scipy.sparse as sp
import torch

from petsctpu_torch.device import resolve_device


class MatIS:
    """locals_: local AIJ operators; l2g: int64 local → global indices."""

    def __init__(self, locals_, l2g, shape):
        self.locals_ = tuple(locals_)
        self.l2g = tuple(l2g)
        self.shape = tuple(shape)

    @property
    def dtype(self):
        return self.locals_[0].dtype

    @property
    def device(self):
        return self.locals_[0].device

    def _sum(self, n, dtype, dev, local):
        y = torch.zeros(n, dtype=dtype, device=dev)
        for Ai, gi in zip(self.locals_, self.l2g):
            y.index_add_(0, gi, local(Ai, gi))   # unique indices: see above
        return y

    def mult(self, x: torch.Tensor) -> torch.Tensor:
        return self._sum(self.shape[0], x.dtype, x.device,
                         lambda Ai, gi: Ai.mult(x[gi]))

    def multT(self, x: torch.Tensor) -> torch.Tensor:
        return self._sum(self.shape[1], x.dtype, x.device,
                         lambda Ai, gi: Ai.multT(x[gi]))

    def diagonal(self) -> torch.Tensor:
        return self._sum(self.shape[0], self.dtype, self.device,
                         lambda Ai, gi: Ai.diagonal())

    def flops_per_mult(self) -> float:
        return sum(getattr(A, "flops_per_mult", lambda: 0.0)()
                   for A in self.locals_)

    def assemble_host(self):
        """MatISGetMPIXAIJ analog: the assembled global scipy matrix
        (for PC setups that need it)."""
        from petsctpu_torch.mat.ell import aij_to_scipy

        G = sp.csr_matrix(self.shape)
        for Ai, gi in zip(self.locals_, self.l2g):
            Al = aij_to_scipy(Ai).tocoo()
            g = gi.cpu().numpy()
            G = G + sp.coo_matrix((Al.data, (g[Al.row], g[Al.col])),
                                  shape=self.shape).tocsr()
        return G


def matis_from_subdomains(local_scipy: list, l2g: list, n: int,
                          dtype=None, device=None) -> MatIS:
    from petsctpu_torch.mat.ell import aij_from_scipy

    dev = resolve_device(device)
    locals_ = tuple(aij_from_scipy(A, dtype=dtype, device=dev)
                    for A in local_scipy)
    l2g_t = tuple(torch.from_numpy(np.asarray(g, np.int64)).to(dev)
                  for g in l2g)
    return MatIS(locals_, l2g_t, (n, n))
