"""Specialty DMs: DMShell, DMRedundant, DMSliced.

Counterpart of petsctpu/dm/shell.py (reference, SURVEY §2.8 "small
specialty DMs"):
  * DMShell (src/dm/impls/shell) — user supplies the vector/matrix
    constructors and global↔local transfer callbacks;
  * DMRedundant (src/dm/impls/redundant) — N dofs stored redundantly
    on every rank; global→local is a broadcast, local→global picks the
    owner;
  * DMSliced (src/dm/impls/sliced) — irregular local blocks with ghost
    entries listed explicitly.

Serial-semantics layouts over tensors, as in petsctpu.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Callable, Optional

import numpy as np
import torch

from petsctpu_torch.device import resolve_device


@dataclass(frozen=True)
class DMShell:
    """User-callback DM (DMShellCreate / DMShellSetCreateGlobalVector /
    DMShellSetGlobalToLocal analogs). create_vec and create_mat are
    called with (dtype, device)."""

    n: int
    create_vec: Optional[Callable] = None
    create_mat: Optional[Callable] = None
    global_to_local: Optional[Callable] = None
    local_to_global: Optional[Callable] = None

    def create_global_vector(self, dtype=torch.float64, device=None):
        dev = resolve_device(device)
        if self.create_vec is not None:
            return self.create_vec(dtype, dev)
        return torch.zeros(self.n, dtype=dtype, device=dev)

    def create_matrix(self, dtype=torch.float64, device=None):
        if self.create_mat is None:
            raise ValueError("DMShell needs create_mat callback for "
                             "DMCreateMatrix")
        return self.create_mat(dtype, resolve_device(device))

    def to_local(self, x):
        return self.global_to_local(x) if self.global_to_local else x

    def to_global(self, xl):
        return self.local_to_global(xl) if self.local_to_global else xl


@dataclass(frozen=True)
class DMRedundant:
    """N redundantly-stored dofs (DMRedundantCreate): serially a dense
    length-N vector with a dense matrix."""

    n: int

    def create_global_vector(self, dtype=torch.float64, device=None):
        return torch.zeros(self.n, dtype=dtype, device=resolve_device(device))

    def create_matrix(self, dtype=torch.float64, device=None):
        from petsctpu_torch.mat.dense import Dense
        return Dense(torch.zeros((self.n, self.n), dtype=dtype,
                                 device=resolve_device(device)))

    def to_local(self, x):      # broadcast: every rank sees all N
        return x

    def to_global(self, xl):
        return xl


@dataclass(frozen=True)
class DMSliced:
    """Irregular local slice: `owned` global indices plus explicit
    `ghosts` (DMSlicedCreate's ghost list). to_local gathers
    owned+ghost values; to_global scatters owned back."""

    n_global: int
    owned: np.ndarray
    ghosts: np.ndarray = field(default_factory=lambda: np.zeros(0, np.int64))

    @property
    def n_local(self) -> int:
        return len(self.owned) + len(self.ghosts)

    def create_global_vector(self, dtype=torch.float64, device=None):
        return torch.zeros(self.n_global, dtype=dtype,
                           device=resolve_device(device))

    def to_local(self, x):
        idx = np.concatenate([self.owned, self.ghosts]).astype(np.int64)
        return x[torch.from_numpy(idx).to(x.device)]

    def to_global(self, xl, x=None):
        """Scatter owned entries into the global vector (ghosts are
        never written back — the reference's INSERT_VALUES local→global
        rule for ghosted layouts). Out of place."""
        x = (torch.zeros(self.n_global, dtype=xl.dtype, device=xl.device)
             if x is None else x.clone())
        no = len(self.owned)
        x[torch.from_numpy(self.owned.astype(np.int64)).to(x.device)] = \
            xl[:no]
        return x
