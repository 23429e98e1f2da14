"""Carry state across from petsctpu: its arrays (as numpy) in, the
port's objects out.

This module imports nothing of petsctpu. Callers hand it the arrays
they took from the JAX objects (`np.asarray` of each field), or the
host pack that `sell_pack` returns, in either package.
"""

from __future__ import annotations

import numpy as np
import torch

from petsctpu_torch.device import resolve_device
from petsctpu_torch.mat.ell import AIJ
from petsctpu_torch.mat.sell import SellMat
from petsctpu_torch.pc.simple import JacobiPC


def _tensor(a, dev, dtype=None) -> torch.Tensor:
    # np.array copies: the arrays of a JAX object are read-only views
    return torch.from_numpy(np.array(a)).to(dev, dtype)


def sell_from_arrays(arrays: dict, statics: dict, device=None) -> SellMat:
    """A SellMat from the `(arrays, statics)` pair of `sell_pack`:
    arrays {vals f32, idx i8, qs i32, winstart i32, diag f32}, statics
    {shape, nnz, G, S, Lp, mode}."""
    dev = resolve_device(device)
    return SellMat(_tensor(arrays["vals"], dev, torch.float32),
                   _tensor(arrays["idx"], dev, torch.int8),
                   _tensor(arrays["qs"], dev, torch.int32),
                   _tensor(arrays["winstart"], dev, torch.int32),
                   _tensor(arrays["diag"], dev, torch.float32),
                   tuple(statics["shape"]), int(statics["nnz"]),
                   int(statics["G"]), int(statics["S"]), int(statics["Lp"]),
                   statics.get("mode", "diag"))


def aij_from_arrays(cols, vals, shape, nnz, device=None) -> AIJ:
    """An AIJ from ELL arrays cols [m,K] and vals [m,K]."""
    dev = resolve_device(device)
    return AIJ(_tensor(cols, dev, torch.int64), _tensor(vals, dev),
               tuple(shape), int(nnz))


def jacobi_from_arrays(dinv, device=None) -> JacobiPC:
    """A JacobiPC from its inverse diagonal."""
    return JacobiPC(_tensor(dinv, resolve_device(device)))
