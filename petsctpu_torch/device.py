"""Device and dtype policy of the port.

Every entry point that builds tensors takes ``device=None``. ``None``
means CUDA; when CUDA is absent the entry point raises instead of
moving to the CPU on its own, so a run that asks for the card never
silently measures the host. Tests pass ``device="cpu"``. Solvers run
on the device of their operands.

GMRES's ``V @ x`` and ``h @ V`` must stay in full fp32/fp64, so TF32
matmuls are switched off explicitly (it is PyTorch's default already).
"""

from __future__ import annotations

import numpy as np
import torch

torch.backends.cuda.matmul.allow_tf32 = False


def resolve_device(device=None) -> torch.device:
    """The device an entry point builds on: CUDA unless told otherwise."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available; pass device='cpu' to build on the CPU")
    return dev


_TORCH_TO_NP = {
    torch.float32: np.float32, torch.float64: np.float64,
    torch.complex64: np.complex64, torch.complex128: np.complex128,
    torch.int8: np.int8, torch.int32: np.int32, torch.int64: np.int64,
}


def np_dtype(dtype):
    """numpy dtype of a numpy or torch dtype (None stays None)."""
    if dtype is None:
        return None
    if isinstance(dtype, torch.dtype):
        return np.dtype(_TORCH_TO_NP[dtype])
    return np.dtype(dtype)
