"""K3: the chunk-mode SELL transpose product, a CUDA kernel written by
hand for Hopper.

Replaces petsctpu/mat/sell.py::_sell_spmvT_chunk (a Pallas TPU kernel)
and the per-tile window combine that petsctpu's SellMat.multT runs after
it. The CUDA source, with its design and bound, is
`petsctpu_torch/csrc/sell_spmvT.cu`; it is built by nvcc into
`petsctpu_torch/_build/` at first use and called through ctypes.

`sell_spmvT` launches the kernel for CUDA tensors (or raises) and takes
the plain PyTorch version `sell_spmvT_plain` only for tensors on the
CPU. Both fold every sum from +0 in one fixed order, with one rounding
per product and per sum: a pass's row sums its slots in (g, l) order,
a window row sums the rows of its passes in pass order (as petsctpu's
kernel adds a pass's row to its window row), and y sums the windows in
tile order. On the card the two agree bit for bit.
`sell_spmvT.launches` counts kernel launches.
"""

from __future__ import annotations

import ctypes

import torch

from petsctpu_torch.ops import _build


def _ordered_fold(out: torch.Tensor, key: torch.Tensor,
                  src: torch.Tensor) -> None:
    """out[key[i]] += src[i] for i ascending, one rounded add at a time.

    A stable sort lines up the terms of each key in their order; step k
    then adds the k-th term of every key at once (the keys of one step
    are distinct, so no two adds of a step meet)."""
    n = key.numel()
    if n == 0:
        return
    order = torch.sort(key, stable=True).indices
    keys = key[order]
    pos = torch.arange(n, device=key.device)
    first = torch.ones(n, dtype=torch.bool, device=key.device)
    first[1:] = keys[1:] != keys[:-1]
    rank = pos - torch.cummax(torch.where(first, pos, 0), 0).values
    by_rank = torch.sort(rank, stable=True).indices
    order, keys = order[by_rank], keys[by_rank]
    off = 0
    for cnt in torch.bincount(rank).tolist():
        k, i = keys[off:off + cnt], order[off:off + cnt]
        out[k] = out[k] + src[i]
        off += cnt


def sell_spmvT_plain(vals, idx, qs, winstart, rt, *, S: int,
                     Lp: int) -> torch.Tensor:
    """y [Lp,128] with

        part[t,p,c] = Σ vals[t,p,g,l]·rt[t,g,l] over (g, l) with
                      idx[t,p,g,l] = c,
        wins[t,q,c] = Σ part[t,p,c] over the passes p with qs[t,p] = q,
        y[R,c]      = Σ wins[t, R − winstart[t], c] over the tiles t
                      whose window covers row R,

    each a left fold from +0 in ascending (g, l), p and t. Slots whose
    value is 0 (padding) are skipped, which changes no bit."""
    nt, P = vals.shape[:2]
    dev = rt.device
    prod = vals * rt[:, None]                                  # [nt,P,G,128]
    cell = torch.arange(nt * P, device=dev).view(nt, P, 1, 1) * 128 \
        + idx.long()
    live = (vals != 0).reshape(-1)
    part = torch.zeros(nt * P * 128, dtype=torch.float32, device=dev)
    _ordered_fold(part, cell.reshape(-1)[live], prod.reshape(-1)[live])
    wrow = torch.arange(nt, device=dev)[:, None] * S + qs.long()
    wins = torch.zeros((nt * S, 128), dtype=torch.float32, device=dev)
    _ordered_fold(wins, wrow.reshape(-1), part.view(nt * P, 128))
    yrow = winstart.long()[:, None] + torch.arange(S, device=dev)
    y = torch.zeros((Lp, 128), dtype=torch.float32, device=dev)
    _ordered_fold(y, yrow.reshape(-1), wins)
    return y


def _check(vals, idx, qs, winstart, rt, S, Lp):
    dev = rt.device
    for name, t in (("vals", vals), ("idx", idx), ("qs", qs),
                    ("winstart", winstart), ("rt", rt)):
        if not isinstance(t, torch.Tensor):
            raise TypeError(f"sell_spmvT: {name} must be a tensor")
        if t.device != dev:
            raise ValueError(f"sell_spmvT: {name} is on {t.device}, "
                             f"rt on {dev}")
        if not t.is_contiguous():
            raise ValueError(f"sell_spmvT: {name} must be contiguous")
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"sell_spmvT: tensors on {dev} are not supported "
                         "(cuda runs the kernel, cpu its plain version)")
    if vals.dim() != 4 or vals.shape[3] != 128:
        raise ValueError(f"sell_spmvT: vals must be [nt,P,G,128], got "
                         f"{tuple(vals.shape)}")
    nt, P, G = vals.shape[:3]
    expect = {"vals": (vals, torch.float32, (nt, P, G, 128)),
              "idx": (idx, torch.int8, (nt, P, G, 128)),
              "qs": (qs, torch.int32, (nt, P)),
              "winstart": (winstart, torch.int32, (nt,)),
              "rt": (rt, torch.float32, (nt, G, 128))}
    for name, (t, dt, shape) in expect.items():
        if t.dtype != dt or tuple(t.shape) != shape:
            raise ValueError(f"sell_spmvT: {name} must be {dt} {shape}, got "
                             f"{t.dtype} {tuple(t.shape)}")
    if not 0 < S <= Lp:
        raise ValueError(f"sell_spmvT: window rows S={S} must lie in "
                         f"[1, Lp={Lp}]")


def _lib():
    lib = _build.load("sell_spmvT")
    if lib.sell_spmvT_launch.argtypes is None:
        lib.sell_spmvT_launch.argtypes = [ctypes.c_void_p] * 7 \
            + [ctypes.c_int] * 5 + [ctypes.c_void_p]
        lib.sell_spmvT_launch.restype = ctypes.c_int
        lib.sell_spmvT_window_in_smem.argtypes = [ctypes.c_int]
        lib.sell_spmvT_window_in_smem.restype = ctypes.c_int
    return lib


def window_in_shared_memory(S: int, device=None) -> bool:
    """Whether the kernel keeps a window of S rows in shared memory on
    the card (else in global memory)."""
    with torch.cuda.device(device):
        return bool(_lib().sell_spmvT_window_in_smem(S))


def sell_spmvT(vals, idx, qs, winstart, rt, *, S: int,
               Lp: int) -> torch.Tensor:
    """The chunk-mode transpose product y [Lp,128] f32 (see
    sell_spmvT_plain).

    The indices must come from `mat.sell.sell_pack` in chunk mode, which
    keeps every window row below S and every window inside the Lp rows
    of y; the kernel does not re-check them.
    """
    _check(vals, idx, qs, winstart, rt, S, Lp)
    if rt.device.type == "cpu":
        return sell_spmvT_plain(vals, idx, qs, winstart, rt, S=S, Lp=Lp)
    nt, P, G = vals.shape[:3]
    y = torch.empty((Lp, 128), dtype=torch.float32, device=rt.device)
    wins = torch.empty((nt, S, 128), dtype=torch.float32, device=rt.device)
    lib = _lib()
    with torch.cuda.device(rt.device):
        stream = torch.cuda.current_stream(rt.device).cuda_stream
        rc = lib.sell_spmvT_launch(vals.data_ptr(), idx.data_ptr(),
                                   qs.data_ptr(), winstart.data_ptr(),
                                   rt.data_ptr(), wins.data_ptr(),
                                   y.data_ptr(), nt, P, G, S, Lp, stream)
    if rc != 0:
        raise RuntimeError(f"sell_spmvT: kernel launch failed with CUDA "
                           f"error {rc}")
    sell_spmvT.launches += 1
    return y


sell_spmvT.launches = 0
