"""The reference's native library, loaded before a port test compares
against its native route.

petsctpu builds `petsctpu/native/libpetsctpu_native.so` with g++ straight
to its final path when the file is missing, and caches a failed load for
the rest of the process (`petsctpu/native/__init__.py`). g++ creates the
output empty before it writes it, so a test process that looks while
another is still building sees a file that does not load and stays on
the reference's Python fallback (an fp32 ILU(0) in fp32 where the native
route factors in fp64: a different factor). The port's tests that hold
the native route call `ensure_reference_native()` at import: where the
library does not load, it builds it to a temporary file beside the final
path, moves it into place with os.replace (atomic: a reader sees the old
file or the whole new one), clears the reference's cached load and
asserts that the library loads.
"""

import os
import subprocess
import tempfile

import torch

# one intra-op thread: the suite runs in parallel workers (pytest -n)
torch.set_num_threads(1)


def ensure_reference_native() -> None:
    from petsctpu import native

    if native.available():
        return
    so = os.path.abspath(native._SO)
    fd, tmp = tempfile.mkstemp(suffix=".so.tmp", dir=os.path.dirname(so))
    os.close(fd)
    try:
        subprocess.run(["g++", "-O3", "-fPIC", "-shared", "-std=c++17",
                        "-o", tmp, native._SRC], check=True,
                       capture_output=True, timeout=300)
        os.replace(tmp, so)
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)
    native._lib = None
    assert native.available(), f"{so} does not load"


def test_reference_native_loads():
    """The guard leaves the reference on its native route."""
    from petsctpu import native

    ensure_reference_native()
    assert native.available() and native._load()
