"""Host allocator tuning for plan-time (setup) performance.

Counterpart of petsctpu/core/hostmem.py, applied at the port's import
as petsctpu applies it at its own. It acts only on this process's glibc
heap (mallopt), nothing of the machine's. PETSc's setup phase is C code
over malloc'd arrays; ours is numpy/scipy on the host. On kernels with slow anonymous-page fault
paths (measured by petsctpu on such a kernel: ~4 us/page vs the usual ~0.5 us, i.e. first
touch of fresh mmap'd memory runs at ~25-1000 MB/s while warm memory
moves at ~5 GB/s), glibc's default policy of mmap()ing every >=128 KB
allocation and munmap()ing it on free makes EVERY large temporary
numpy array pay the fault cost again: a 40 MB `np.concatenate` was
measured at 1.9 s cold vs 25 ms warm (75x).

The fix is the classic HPC one (PETSc itself ships `-malloc` pooling;
OpenMPI/MKL document the same knobs): tell glibc to never use mmap for
malloc and never trim the heap, so pages are faulted once and reused
forever. We apply it with mallopt(3) at import time, which works at
runtime (the env vars MALLOC_MMAP_MAX_/MALLOC_TRIM_THRESHOLD_ would
have to be set before process start).

Reference analog: PetscMallocAlign/PetscTrMalloc pooling
(src/sys/memory/mal.c, mtr.c) — the reference also interposes its own
allocation layer for performance and debugging.
"""

from __future__ import annotations

import ctypes
import os

_done = False

# glibc mallopt parameter numbers (malloc.h)
_M_TRIM_THRESHOLD = -1
_M_MMAP_THRESHOLD = -3
_M_MMAP_MAX = -4


def tune_host_allocator() -> bool:
    """Disable glibc mmap-per-large-malloc and heap trimming.

    Idempotent; returns True if the tuning was applied (glibc found).
    Set PETSCTPU_NO_MALLOC_TUNE=1 to skip.
    """
    global _done
    if _done or os.environ.get("PETSCTPU_NO_MALLOC_TUNE"):
        return _done
    try:
        libc = ctypes.CDLL("libc.so.6", use_errno=True)
        libc.mallopt(_M_MMAP_MAX, 0)
        libc.mallopt(_M_TRIM_THRESHOLD, 2**31 - 1)
        libc.mallopt(_M_MMAP_THRESHOLD, 2**30)
        _done = True
    except OSError:  # non-glibc platform: nothing to tune
        _done = False
    return _done


def prefault(nbytes: int = 1 << 30) -> None:
    """Touch `nbytes` of heap once so later setup work runs warm.

    Benchmarks that measure setup time call this first to pay the
    one-time kernel page-fault cost outside the measured region
    (the reference's benchmarks similarly warm malloc via a first
    untimed run, src/benchmarks/PetscMalloc.c).
    """
    tune_host_allocator()
    import numpy as np

    n = max(1, nbytes // 8)
    a = np.empty(n, dtype=np.float64)
    a[:: 4096 // 8] = 0.0  # one write per page
    del a
