"""ctypes bindings of the host factor numerics (csrc/host_factor.cpp).

The library is built by g++ into petsctpu_torch/_build/ at first use
(ops/_build.py::load_host); a missing compiler or a failed build raises,
there is no Python fallback on the solve path (mat/factor.py keeps the
numpy plain versions that the tests hold these against). All entry
points take numpy CSR arrays (int64 indptr, int32 indices).
"""

from __future__ import annotations

import ctypes
import functools

import numpy as np

from petsctpu_torch.ops import _build

SHIFT_CODES = {"none": 0, "nonzero": 1, "inblocks": 2,
               "positive_definite": 3}


@functools.cache
def _lib() -> ctypes.CDLL:
    lib = _build.load_host("host_factor")
    i64 = ctypes.c_int64
    p64 = np.ctypeslib.ndpointer(np.int64, flags="C")
    p32 = np.ctypeslib.ndpointer(np.int32, flags="C")
    pf64 = np.ctypeslib.ndpointer(np.float64, flags="C")
    pp64 = ctypes.POINTER(ctypes.POINTER(ctypes.c_int64))
    lib.native_free.restype = None
    lib.native_free.argtypes = [ctypes.c_void_p]
    lib.ilu0_csr.restype = i64
    lib.ilu0_csr.argtypes = [i64, p64, p32, pf64]
    lib.tri_levels.restype = i64
    lib.tri_levels.argtypes = [i64, p64, p32, ctypes.c_int32, p64]
    lib.iluk_pattern.restype = i64
    lib.iluk_pattern.argtypes = [i64, p64, p32, i64, pp64, pp64]
    lib.icck_pattern.restype = i64
    lib.icck_pattern.argtypes = [i64, p64, p32, i64, pp64, pp64]
    lib.icc_numeric.restype = i64
    lib.icc_numeric.argtypes = [i64, p64, p32, pf64, p64, p64, pf64, pf64,
                                ctypes.c_int32, ctypes.c_double,
                                ctypes.c_double, pf64]
    return lib


def _csr(indptr, indices):
    return (np.ascontiguousarray(indptr, np.int64),
            np.ascontiguousarray(indices, np.int32))


def ilu0_csr_inplace(indptr, indices, data) -> None:
    """Numeric ILU(0) of sorted CSR arrays, in place in `data` (fp64)."""
    ip, ix = _csr(indptr, indices)
    rc = _lib().ilu0_csr(len(ip) - 1, ip, ix, data)
    if rc < 0:
        raise ValueError(f"ILU(0): missing diagonal in row {-rc - 1}")
    if rc > 0:
        raise ZeroDivisionError(f"ILU(0): zero pivot in row {rc - 1}")


def tri_levels(indptr, indices, lower: bool) -> np.ndarray:
    """Dependency level of each row of a triangle, int64 [n]."""
    ip, ix = _csr(indptr, indices)
    out = np.zeros(len(ip) - 1, np.int64)
    _lib().tri_levels(len(ip) - 1, ip, ix, 1 if lower else 0, out)
    return out


def _pattern(fn, indptr, indices, k: int):
    lib = _lib()
    ip, ix = _csr(indptr, indices)
    n = len(ip) - 1
    ip_p = ctypes.POINTER(ctypes.c_int64)()
    cols_p = ctypes.POINTER(ctypes.c_int64)()
    nnz = int(fn(n, ip, ix, k, ctypes.byref(ip_p), ctypes.byref(cols_p)))
    try:
        out_ip = np.ctypeslib.as_array(ip_p, shape=(n + 1,)).copy()
        cols = np.ctypeslib.as_array(cols_p, shape=(max(nnz, 1),))[:nnz] \
            .copy()
    finally:
        lib.native_free(ctypes.cast(ip_p, ctypes.c_void_p))
        lib.native_free(ctypes.cast(cols_p, ctypes.c_void_p))
    return out_ip, cols


def iluk_pattern(indptr, indices, k: int):
    """Symbolic ILU(k) pattern as CSR (indptr, cols), diagonal included."""
    return _pattern(_lib().iluk_pattern, indptr, indices, k)


def icck_pattern(indptr, indices, levels: int):
    """Symbolic IC(k) strict-upper pattern as CSR (indptr, cols)."""
    return _pattern(_lib().icck_pattern, indptr, indices, levels)


def icc_numeric(ai, aj, aa, ui, uj, shift_type: str, zeropivot: float,
                shift_amount: float):
    """Numeric UᵀDU incomplete Cholesky on the strict-upper pattern (ui,
    uj): (uv, d, nshift, shift) with uv the unit-upper factor's values.
    Raises ZeroDivisionError on an unshifted zero pivot."""
    ai, aj = _csr(ai, aj)
    ui = np.ascontiguousarray(ui, np.int64)
    n = len(ai) - 1
    uv = np.zeros(int(ui[-1]), np.float64)
    d = np.zeros(n, np.float64)
    shift_out = np.zeros(1, np.float64)
    rc = _lib().icc_numeric(n, ai, aj, np.ascontiguousarray(aa, np.float64),
                            ui, np.ascontiguousarray(uj, np.int64), uv, d,
                            SHIFT_CODES[shift_type], zeropivot, shift_amount,
                            shift_out)
    if rc < 0:
        raise ZeroDivisionError(f"icc: zero pivot row {-rc - 1}")
    return uv, d, int(rc), float(shift_out[0])
