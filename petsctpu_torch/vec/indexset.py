"""IS — index sets (the part of petsctpu/vec/indexset.py that the PCs use).

Reference: src/vec/is (impls general/stride/block). Index sets are
setup-time objects (host numpy); the PCs that take them (fieldsplit)
move their frozen index arrays to the device. Local↔global maps are
ROADMAP queue 1 item 13.
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


def is_indices(field) -> np.ndarray:
    """The int64 indices of an IS or of an index array."""
    return np.asarray(field.indices if hasattr(field, "indices") else field,
                      dtype=np.int64)
