"""IS — index sets, and local↔global mappings.

Counterpart of petsctpu/vec/indexset.py (reference: src/vec/is, impls
general/stride/block; ISLocalToGlobalMapping src/vec/is/utils/
isltog.c). Index sets are setup-time objects (host numpy), handed out by
the DMs (dm/composite.py); the PCs that take them (fieldsplit) move
their frozen index arrays to the device.
"""

from __future__ import annotations

import numpy as np


class IS:
    """Base index set (general: explicit indices)."""

    def __init__(self, indices):
        self._idx = np.asarray(indices, dtype=np.int64)

    @classmethod
    def general(cls, indices) -> "IS":
        return cls(indices)

    @classmethod
    def stride(cls, n: int, first: int = 0, step: int = 1) -> "IS":
        """ISCreateStride."""
        return StrideIS(n, first, step)

    @classmethod
    def block(cls, bs: int, blocks) -> "IS":
        """ISCreateBlock: indices are block ids; expands to bs·ids+k."""
        return BlockIS(bs, blocks)

    @property
    def indices(self) -> np.ndarray:
        return self._idx


class StrideIS(IS):
    def __init__(self, n, first=0, step=1):
        super().__init__(first + step * np.arange(n))


class BlockIS(IS):
    def __init__(self, bs, blocks):
        blocks = np.asarray(blocks, dtype=np.int64)
        super().__init__((blocks[:, None] * bs
                          + np.arange(bs)[None, :]).reshape(-1))


class LocalToGlobalMapping:
    """ISLocalToGlobalMapping: local index ↔ global index translation.
    The inverse is a search of the sorted global indices; where a global
    index appears twice, the last local index wins (petsctpu's dict)."""

    def __init__(self, global_indices):
        self.l2g = np.asarray(global_indices, dtype=np.int64)
        self._order = np.argsort(self.l2g, kind="stable")
        self._sorted = self.l2g[self._order]

    def apply(self, local_idx) -> np.ndarray:
        return self.l2g[np.asarray(local_idx)]

    def apply_inverse(self, global_idx) -> np.ndarray:
        """Local indices of global ones, −1 where a global index is not
        mapped."""
        g = np.atleast_1d(np.asarray(global_idx, dtype=np.int64))
        if not len(self._sorted):
            return np.full(g.shape, -1, np.int64)
        pos = np.searchsorted(self._sorted, g, side="right") - 1
        hit = pos >= 0
        hit[hit] = self._sorted[pos[hit]] == g[hit]
        return np.where(hit, self._order[np.maximum(pos, 0)], -1)

    @property
    def size(self):
        return len(self.l2g)


def is_indices(field) -> np.ndarray:
    """The int64 indices of an IS or of an index array."""
    return np.asarray(field.indices if hasattr(field, "indices") else field,
                      dtype=np.int64)
