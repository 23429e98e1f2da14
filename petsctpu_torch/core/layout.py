"""Row-partition layouts.

Counterpart of petsctpu/core/layout.py (reference's PetscLayout,
src/vec/vec/impls/mpi/pmap.c:130 PetscLayoutSetUp): a contiguous
row-range partition of a global axis over the ranks of a communicator.
As in petsctpu, every rank holds the SAME number of rows: the global
size is padded up to a multiple of the rank count and the true size is
kept; pad rows are identity rows / zero entries that never affect
results. Host numpy only.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np


@dataclass(frozen=True)
class Layout:
    """Contiguous equal-size row partition of [0, n) over `nshards` ranks."""

    n: int             # true global size
    nshards: int       # number of ranks

    @property
    def shard_size(self) -> int:
        return -(-self.n // self.nshards)  # ceil

    @property
    def n_padded(self) -> int:
        return self.shard_size * self.nshards

    @property
    def n_pad(self) -> int:
        return self.n_padded - self.n

    def owner(self, gidx) -> np.ndarray:
        """Rank owning each global index (vectorized)."""
        return np.asarray(gidx) // self.shard_size

    def range(self, shard: int) -> tuple:
        """[start, end) of global rows owned by `shard` (may overlap pad)."""
        s = self.shard_size
        return (shard * s, min((shard + 1) * s, self.n))

    def local_index(self, gidx) -> np.ndarray:
        return np.asarray(gidx) % self.shard_size

    def pad_vector(self, x: np.ndarray, fill=0.0) -> np.ndarray:
        """Pad a global host vector up to n_padded."""
        if self.n_pad == 0:
            return x
        pad_shape = (self.n_pad,) + x.shape[1:]
        return np.concatenate([x, np.full(pad_shape, fill, dtype=x.dtype)])

    def unpad_vector(self, x):
        return x[: self.n]
