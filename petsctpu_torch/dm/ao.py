"""AO — application ordering (application ↔ framework index permutation).

Counterpart of petsctpu/dm/ao.py: host index tables, numpy as there.

Reference: src/dm/ao (AOCreateBasic ao.c:551-area, AOApplicationToPetsc,
AOPetscToApplication; memory-scalable variant aomemscalable.c). The
serial semantics survive exactly: a pair of permutation tables applied
to index arrays or (as a convenience beyond the reference) to vectors.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np


@dataclass(frozen=True)
class AO:
    app_to_petsc_tab: np.ndarray     # petsc index of each app index
    petsc_to_app_tab: np.ndarray

    @classmethod
    def create_basic(cls, app: np.ndarray, petsc: np.ndarray = None) -> "AO":
        """AOCreateBasic: app[i] ↔ petsc[i] (petsc defaults to 0..n-1)."""
        app = np.asarray(app, np.int64)
        n = app.shape[0]
        petsc = (np.arange(n, dtype=np.int64) if petsc is None
                 else np.asarray(petsc, np.int64))
        a2p = np.empty(n, np.int64)
        a2p[app] = petsc
        p2a = np.empty(n, np.int64)
        p2a[petsc] = app
        return cls(a2p, p2a)

    @classmethod
    def create_mapping(cls, app: np.ndarray) -> "AO":
        """AOCreateMapping: same but app need not be a permutation of
        0..n-1 (sorted-rank compression)."""
        app = np.asarray(app, np.int64)
        order = np.argsort(app, kind="stable")
        petsc = np.empty_like(order)
        petsc[order] = np.arange(len(app))
        a2p = petsc
        p2a = np.empty_like(petsc)
        p2a[petsc] = np.arange(len(app))
        return cls(a2p, p2a)

    def app_to_petsc(self, idx):
        """AOApplicationToPetsc: negative entries pass through (the
        reference's convention for 'not mine')."""
        idx = np.asarray(idx)
        return np.where(idx >= 0, self.app_to_petsc_tab[np.maximum(idx, 0)],
                        idx)

    def petsc_to_app(self, idx):
        idx = np.asarray(idx)
        return np.where(idx >= 0, self.petsc_to_app_tab[np.maximum(idx, 0)],
                        idx)

    def permute_app_to_petsc(self, v):
        """Reorder a vector given in app ordering into petsc ordering."""
        out = np.empty_like(np.asarray(v))
        out[self.app_to_petsc_tab] = np.asarray(v)
        return out

    def permute_petsc_to_app(self, v):
        out = np.empty_like(np.asarray(v))
        out[self.petsc_to_app_tab] = np.asarray(v)
        return out
