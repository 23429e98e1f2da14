"""DMComposite — packing multiple DMs / field spaces into one system.

Counterpart of petsctpu/dm/composite.py (reference: src/dm/impls/
composite — DMCompositeAddDM, DMCompositeScatter, DMCompositeGetGlobalISs).
A composite is a tuple of components, each a DA or a plain size; packing
is concatenation (contiguous blocks, the reference's serial layout), and
the global ISs feed PCFieldSplit as DMCompositeGetGlobalISs →
PCFieldSplitSetIS does.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Sequence

import numpy as np
import torch

from petsctpu_torch.device import resolve_device
from petsctpu_torch.vec.indexset import IS


@dataclass(frozen=True)
class DMComposite:
    """Composite of sub-spaces; each entry is a DA or an int size."""

    components: tuple

    @classmethod
    def create(cls, *components) -> "DMComposite":
        return cls(tuple(components))

    @property
    def sizes(self) -> tuple:
        return tuple(c if isinstance(c, int) else int(np.prod(c.grid))
                     for c in self.components)

    @property
    def n(self) -> int:
        return sum(self.sizes)

    def offsets(self) -> tuple:
        off = [0]
        for s in self.sizes:
            off.append(off[-1] + s)
        return tuple(off)

    def create_global_vector(self, dtype=torch.float64, device=None):
        return torch.zeros(self.n, dtype=dtype, device=resolve_device(device))

    def global_iss(self) -> Sequence[IS]:
        """DMCompositeGetGlobalISs: one IS per component (drives
        fieldsplit)."""
        off = self.offsets()
        return [IS.stride(self.sizes[i], first=off[i], step=1)
                for i in range(len(self.components))]

    def split(self, x):
        """DMCompositeScatter analog: global vector → per-component."""
        off = self.offsets()
        return [x[off[i]:off[i + 1]] for i in range(len(self.components))]

    def pack(self, *parts):
        """DMCompositeGather analog: per-component vectors → global."""
        if len(parts) != len(self.components):
            raise ValueError(f"{len(parts)} parts for "
                             f"{len(self.components)} components")
        return torch.cat([torch.ravel(p) for p in parts])

    def split_grids(self, x):
        """split + reshape DA components onto their grids."""
        return [p if isinstance(c, int) else p.reshape(c.grid)
                for c, p in zip(self.components, self.split(x))]
