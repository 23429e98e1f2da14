"""ctypes bindings of the host graph code (csrc/host_graph.cpp): the
AMG setup's aggregation, the probe refresh's column coloring, the
multilevel k-way partition (mat/partition.py) and the locality RCM
ordering (mat/order.py's "rcm_fast").

The library is built by g++ into petsctpu_torch/_build/ at first use
(ops/_build.py::load_host); a missing compiler or a failed build raises,
there is no Python fallback on the setup path. The Python loops stay as
the plain versions the tests hold these to: pc/gamg.py::aggregate and
mat/coloring.py::greedy_color, whose signatures these take.
"""

from __future__ import annotations

import ctypes
import functools

import numpy as np
import scipy.sparse as sp

from petsctpu_torch.ops import _build


@functools.cache
def _lib() -> ctypes.CDLL:
    lib = _build.load_host("host_graph")
    i64 = ctypes.c_int64
    p64 = np.ctypeslib.ndpointer(np.int64, flags="C")
    p32 = np.ctypeslib.ndpointer(np.int32, flags="C")
    lib.greedy_color.restype = i64
    lib.greedy_color.argtypes = [i64, i64, p64, p32, p64, p32, p32]
    lib.aggregate.restype = i64
    lib.aggregate.argtypes = [i64, p64, p32, p64]
    lib.kway_partition.restype = i64
    lib.kway_partition.argtypes = [i64, p64, p32, ctypes.c_void_p, i64,
                                   ctypes.c_uint64, p32]
    lib.rcm.restype = i64
    lib.rcm.argtypes = [i64, p64, p32, p32]
    return lib


def rcm(S: sp.csr_matrix) -> np.ndarray:
    """Reverse Cuthill-McKee of the symmetric pattern S (diagonal
    included in the degrees): int64 new -> old."""
    S = sp.csr_matrix(S)
    out = np.zeros(S.shape[0], np.int32)
    _lib().rcm(S.shape[0], np.ascontiguousarray(S.indptr, np.int64),
               np.ascontiguousarray(S.indices, np.int32), out)
    return out.astype(np.int64)


def aggregate(S: sp.csr_matrix) -> np.ndarray:
    """Greedy root-based aggregation of the strength graph S: int64
    aggregate id a row (pc/gamg.py::aggregate's three passes)."""
    S = sp.csr_matrix(S)
    out = np.zeros(S.shape[0], np.int64)
    _lib().aggregate(S.shape[0], np.ascontiguousarray(S.indptr, np.int64),
                     np.ascontiguousarray(S.indices, np.int32), out)
    return out


def greedy_color(A) -> np.ndarray:
    """Distance-2 column coloring of A's pattern: int32 color a column
    (mat/coloring.py::greedy_color's greedy order)."""
    A = sp.csc_matrix(A)
    Acsr = A.tocsr()
    out = np.zeros(A.shape[1], np.int32)
    _lib().greedy_color(A.shape[0], A.shape[1],
                        np.ascontiguousarray(Acsr.indptr, np.int64),
                        np.ascontiguousarray(Acsr.indices, np.int32),
                        np.ascontiguousarray(A.indptr, np.int64),
                        np.ascontiguousarray(A.indices, np.int32), out)
    return out


def kway_partition(indptr, indices, nparts: int, ewts=None,
                   seed: int = 1) -> tuple:
    """Multilevel k-way partition of a symmetric CSR graph (HEM coarsen,
    greedy grow, FM refine): (int32 part a vertex, weighted edge cut)."""
    n = len(indptr) - 1
    part = np.zeros(n, np.int32)
    if ewts is not None:
        ewts = np.ascontiguousarray(ewts, np.int64)
    cut = _lib().kway_partition(
        n, np.ascontiguousarray(indptr, np.int64),
        np.ascontiguousarray(indices, np.int32),
        None if ewts is None else ewts.ctypes.data_as(ctypes.c_void_p),
        nparts, seed, part)
    if cut < 0:
        raise ValueError("kway_partition failed")
    return part, int(cut)
