"""H2: the windowed scalar SELL SpMV of the round-4 probes, a CUDA kernel
written by hand for Hopper.

Replaces the Pallas TPU kernel of scripts/probe_pallas_gather2.py:81.
The CUDA source, with its design and bound, is
`petsctpu_torch/csrc/window_spmv.cu`; it is built by nvcc into
`petsctpu_torch/_build/` at first use and called through ctypes.

`window_spmv` launches the kernel for CUDA tensors (or raises) and takes
the plain PyTorch version `window_spmv_plain` only for tensors on the
CPU. Both fold each row's sum from +0 in k order with one rounding per
product and per sum, so on the card they agree bit for bit.
`window_spmv.launches` counts kernel launches.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from petsctpu_torch.ops import _build


def window_spmv_plain(starts, q, r, vals, x, *, Rb: int) -> torch.Tensor:
    """y[i] = Σ_k vals[i,k]·x[starts[i//Rb] + 128·q[i,k] + r[i,k]],
    summed in k order from 0."""
    n, K = vals.shape
    base = starts.long().repeat_interleave(Rb)
    acc = torch.zeros(n, dtype=torch.float32, device=x.device)
    for k in range(K):
        col = base + 128 * q[:, k].long() + r[:, k].long()
        acc = acc + vals[:, k] * x[col]
    return acc


def _check(starts, q, r, vals, x, Rb):
    """The full checks of a call; returns the kernel's (n, K, Rb)."""
    dev = x.device
    for name, t in (("starts", starts), ("q", q), ("r", r), ("vals", vals),
                    ("x", x)):
        if not isinstance(t, torch.Tensor):
            raise TypeError(f"window_spmv: {name} must be a tensor")
        if t.device != dev:
            raise ValueError(f"window_spmv: {name} is on {t.device}, x on "
                             f"{dev}")
        if not t.is_contiguous():
            raise ValueError(f"window_spmv: {name} must be contiguous")
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"window_spmv: tensors on {dev} are not supported "
                         "(cuda runs the kernel, cpu its plain version)")
    if vals.dim() != 2:
        raise ValueError(f"window_spmv: vals must be [n,K], got "
                         f"{tuple(vals.shape)}")
    n, K = vals.shape
    if Rb < 1 or n % Rb:
        raise ValueError(f"window_spmv: Rb={Rb} must divide n={n}")
    expect = {"starts": (starts, torch.int32, (n // Rb,)),
              "q": (q, torch.int32, (n, K)), "r": (r, torch.int32, (n, K)),
              "vals": (vals, torch.float32, (n, K))}
    for name, (t, dt, shape) in expect.items():
        if t.dtype != dt or tuple(t.shape) != shape:
            raise ValueError(f"window_spmv: {name} must be {dt} {shape}, got "
                             f"{t.dtype} {tuple(t.shape)}")
    if x.dtype != torch.float32 or x.dim() != 1:
        raise ValueError(f"window_spmv: x must be float32 1-D, got "
                         f"{x.dtype} {tuple(x.shape)}")
    return n, K, Rb


# the C entry point's argument types, the stream last
ARGTYPES = ((ctypes.c_void_p,) * 6 + (ctypes.c_int,) * 3 + (ctypes.c_void_p,))


@functools.cache
def _launcher():
    return _build.entry("window_spmv", ARGTYPES)


def window_spmv(starts, q, r, vals, x, *, Rb: int) -> torch.Tensor:
    """The windowed SpMV y [n] f32 (see window_spmv_plain).

    Every column starts[i//Rb] + 128·q + r must lie inside x; the kernel
    does not re-check them.
    """
    dims = _check(starts, q, r, vals, x, Rb)
    if not x.is_cuda:
        return window_spmv_plain(starts, q, r, vals, x, Rb=Rb)
    y = x.new_empty(dims[0])
    rc = _build.launch(_launcher(), x.get_device(), (
        starts.data_ptr(), q.data_ptr(), r.data_ptr(), vals.data_ptr(),
        x.data_ptr(), y.data_ptr()) + dims)
    if rc != 0:
        raise RuntimeError(f"window_spmv: kernel launch failed with CUDA "
                           f"error {rc}")
    _build.counted(window_spmv)
    return y


window_spmv.launches = 0
