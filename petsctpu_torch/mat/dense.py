"""Dense matrix operator (SeqDense analog, src/mat/impls/dense).

Counterpart of petsctpu/mat/dense.py. petsctpu leaves its product to
XLA (one MXU matmul at precision "highest"), so the port leaves it to
torch.matmul; TF32 is off (device.py), so the product runs in full
fp32/fp64.
"""

from __future__ import annotations

import torch


class Dense:
    def __init__(self, M: torch.Tensor):
        self.M = M

    @property
    def shape(self):
        return tuple(self.M.shape)

    @property
    def dtype(self):
        return self.M.dtype

    @property
    def device(self):
        return self.M.device

    def mult(self, x):
        return self.M @ x

    def multT(self, x):
        return self.M.T @ x

    def diagonal(self):
        return torch.diagonal(self.M)
