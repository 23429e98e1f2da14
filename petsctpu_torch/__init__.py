"""petsctpu_torch — the PyTorch/CUDA port of petsctpu.

A second package beside `petsctpu` (the JAX reference, which it never
imports). Module paths and names mirror petsctpu's, so each counterpart
is easy to find; inside, operators and PCs are plain classes holding
tensors, and solvers are eager loops. The Pallas TPU kernels become
CUDA kernels written by hand for Hopper (`csrc/`, bound in `ops/`).
See `device.py` for the device policy: CUDA unless `device="cpu"`.
Importing the package tunes this process's glibc heap for the host
setup work (core/hostmem.py), as importing petsctpu does.
"""

from petsctpu_torch.core.hostmem import tune_host_allocator as _tune

_tune()  # plan-time (host setup) allocator tuning; see core/hostmem.py

from petsctpu_torch import device  # noqa: E402,F401  (the TF32 policy)
from petsctpu_torch.core.options import Options  # noqa: E402
from petsctpu_torch.core.errors import ConvergedReason  # noqa: E402

__all__ = ["Options", "ConvergedReason"]
