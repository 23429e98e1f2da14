"""K2: the sliced-ELL SpMV, a CUDA kernel written by hand for Hopper.

Replaces petsctpu/mat/sell.py::_sell_spmv (a Pallas TPU kernel). The
CUDA source, with its design and bound, is
`petsctpu_torch/csrc/sell_spmv.cu`; it is built by nvcc into
`petsctpu_torch/_build/` at first use and called through ctypes.

`sell_spmv` launches the kernel for CUDA tensors (or raises) and takes
the plain PyTorch version `sell_spmv_plain` only for tensors on the
CPU. The plain version repeats the kernel's arithmetic step for step
(a loop over passes, separate multiply and add), so on the card the
two agree bit for bit. `sell_spmv.launches` counts kernel launches.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from petsctpu_torch.ops import _build

_MODES = ("diag", "chunk")


def sell_spmv_plain(vals, idx, qs, winstart, xp, *, G: int, S: int,
                    mode: str = "diag") -> torch.Tensor:
    """y[t,g,l] = Σ_p vals[t,p,g,l]·xp[winstart[t] + qs[t,p] (+ g in
    diag mode), idx[t,p,g,l]], summed in pass order from 0."""
    nt, P = vals.shape[:2]
    acc = torch.zeros((nt, G, 128), dtype=torch.float32, device=xp.device)
    base = winstart.long()[:, None]                        # [nt, 1]
    if mode == "diag":
        base = base + torch.arange(G, device=xp.device)[None, :]
    for p in range(P):
        rows = base + qs[:, p, None].long()                # [nt, G|1]
        picked = xp[rows[:, :, None], idx[:, p].long()]    # [nt, G, 128]
        acc = acc + vals[:, p] * picked
    return acc


def _check(vals, idx, qs, winstart, xp, G, S, mode):
    if mode not in _MODES:
        raise ValueError(f"sell_spmv: mode must be one of {_MODES}, "
                         f"got {mode!r}")
    dev = xp.device
    for name, t in (("vals", vals), ("idx", idx), ("qs", qs),
                    ("winstart", winstart), ("xp", xp)):
        if not isinstance(t, torch.Tensor):
            raise TypeError(f"sell_spmv: {name} must be a tensor")
        if t.device != dev:
            raise ValueError(f"sell_spmv: {name} is on {t.device}, "
                             f"xp on {dev}")
        if not t.is_contiguous():
            raise ValueError(f"sell_spmv: {name} must be contiguous")
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"sell_spmv: tensors on {dev} are not supported "
                         "(cuda runs the kernel, cpu its plain version)")
    if vals.dim() != 4 or vals.shape[2] != G or vals.shape[3] != 128:
        raise ValueError(f"sell_spmv: vals must be [nt,P,{G},128], got "
                         f"{tuple(vals.shape)}")
    nt, P = vals.shape[:2]
    expect = {"vals": (vals, torch.float32, (nt, P, G, 128)),
              "idx": (idx, torch.int8, (nt, P, G, 128)),
              "qs": (qs, torch.int32, (nt, P)),
              "winstart": (winstart, torch.int32, (nt,))}
    for name, (t, dt, shape) in expect.items():
        if t.dtype != dt or tuple(t.shape) != shape:
            raise ValueError(f"sell_spmv: {name} must be {dt} {shape}, got "
                             f"{t.dtype} {tuple(t.shape)}")
    if xp.dtype != torch.float32 or xp.dim() != 2 or xp.shape[1] != 128:
        raise ValueError(f"sell_spmv: xp must be float32 [Lp,128], got "
                         f"{xp.dtype} {tuple(xp.shape)}")
    if not 0 < S <= xp.shape[0]:
        raise ValueError(f"sell_spmv: window rows S={S} must lie in "
                         f"[1, Lp={xp.shape[0]}]")
    return nt, P


# the C entry point's argument types, the stream last
ARGTYPES = ((ctypes.c_void_p,) * 6 + (ctypes.c_int,) * 4 + (ctypes.c_void_p,))


@functools.cache
def _launcher():
    return _build.entry("sell_spmv", ARGTYPES)


def sell_spmv(vals, idx, qs, winstart, xp, *, G: int, S: int,
              mode: str = "diag") -> torch.Tensor:
    """The SELL product y [nt,G,128] f32 (see sell_spmv_plain).

    The indices must come from `mat.sell.sell_pack`, which keeps every
    read inside the padded x buffer; the kernel does not re-check them.
    On the card vals must be 16-byte and idx 4-byte aligned (a fresh
    tensor is; convert.mg_from_packed aligns its views).
    """
    nt, P = _check(vals, idx, qs, winstart, xp, G, S, mode)
    if not xp.is_cuda:
        return sell_spmv_plain(vals, idx, qs, winstart, xp, G=G, S=S,
                               mode=mode)
    if vals.data_ptr() % 16 or idx.data_ptr() % 4:
        raise ValueError("sell_spmv: the kernel reads vals as float4 and "
                         "idx as 32-bit words: vals must be 16-byte and idx "
                         "4-byte aligned")
    y = xp.new_empty((nt, G, 128))
    if nt == 0:
        return y
    rc = _build.launch(_launcher(), xp.get_device(), (
        vals.data_ptr(), idx.data_ptr(), qs.data_ptr(), winstart.data_ptr(),
        xp.data_ptr(), y.data_ptr(), nt, P, G, int(mode == "diag")))
    if rc != 0:
        raise RuntimeError(f"sell_spmv: kernel launch failed with CUDA "
                           f"error {rc}")
    _build.counted(sell_spmv)
    return y


sell_spmv.launches = 0
