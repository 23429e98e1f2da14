"""petsctpu_torch — the PyTorch/CUDA port of petsctpu.

A second package beside `petsctpu` (the JAX reference, which it never
imports). Module paths and names mirror petsctpu's, so each counterpart
is easy to find; inside, operators and PCs are plain classes holding
tensors, and solvers are eager loops. The Pallas TPU kernels become
CUDA kernels written by hand for Hopper (`csrc/`, bound in `ops/`).
See `device.py` for the device policy: CUDA unless `device="cpu"`.
"""

from petsctpu_torch import device  # noqa: F401  (sets the TF32 policy)
