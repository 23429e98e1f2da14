"""The level-scheduled sparse triangular solve, a CUDA kernel written by
hand for Hopper.

Replaces petsctpu/mat/factor.py::SpTRSVPlan.solve (XLA code in the
reference: one `fori_loop` over levels, vmapped over bjacobi/ASM
subdomains) for every sparse triangle of the port: LU, ILU, ICC, SOR
and each bjacobi/ASM subdomain, nb stacked plans in one launch. The
CUDA source, with its design and bound, is
`petsctpu_torch/csrc/sptrsv.cu`; it is built by nvcc into
`petsctpu_torch/_build/` at first use and called through ctypes.

Both read a plan in level order (`level_order`, derived once a plan on
the host): the plan on the device is those arrays alone. `sptrsv`
launches the kernel for CUDA tensors (or raises) and takes the plain
PyTorch version `sptrsv_plain` only for tensors on the CPU. Both fold
a row's slots in slot order from 0 with a separate multiply and add,
subtract the sum from b and multiply by 1/diag last, so on the card
they agree bit for bit. `sptrsv.launches` counts kernel launches.
"""

from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from petsctpu_torch.ops import _build

# the kernel's launch shapes (csrc/sptrsv.cu): one block a plan when a
# level has at most BLOCK_ROWS rows; wider, a cluster of 8 blocks a plan
# when plans are stacked, and the whole card (a cooperative grid) for a
# single plan
SHAPES = {"block": 0, "cluster": 1, "grid": 2}
BLOCK_ROWS = 1024
_DTYPES = (torch.float32, torch.float64)


def launch_shape(nb: int, rmax: int) -> str:
    """The kernel's launch shape for nb plans of rmax rows a level."""
    if rmax <= BLOCK_ROWS:
        return "block"
    return "grid" if nb == 1 else "cluster"


def sptrsv_plain(lstart, lrows, lcols, lvals, ldinv, b) -> torch.Tensor:
    """x [nb, n] with, for each plan, level after level, every row r of
    the level set to (b[r] − Σ_k vals[r,k]·x[cols[r,k]])·dinv[r], the
    sum a left fold over k from 0, over the plans in level order
    (level_order's arrays; x[n] = 0 is the sentinel)."""
    nb, n = ldinv.shape
    x = b.new_zeros((nb, n + 1))

    def pad(t, v):
        return torch.cat([t, t.new_full((nb, 1) + tuple(t.shape[2:]), v)], 1)

    lr, lc = pad(lrows, n).long(), pad(lcols, n).long()
    lv, ld, bp = pad(lvals, 0), pad(ldinv, 1), pad(b, 0)
    ls = lstart.long()
    width = int((ls[:, 1:] - ls[:, :-1]).max()) if ls.shape[1] > 1 else 0
    i = torch.arange(max(width, 1), device=b.device)
    plan = torch.arange(nb, device=b.device)[:, None]
    for lev in range(ls.shape[1] - 1):
        p = ls[:, lev, None] + i                  # [nb, width] positions
        p = torch.where(p < ls[:, lev + 1, None], p, n)
        rows, c, v = lr[plan, p], lc[plan, p], lv[plan, p]
        acc = torch.zeros_like(rows, dtype=b.dtype)
        for k in range(c.shape[-1]):
            acc = acc + v[..., k] * torch.gather(x, 1, c[..., k])
        x.scatter_(1, rows, (torch.gather(bp, 1, rows) - acc) * ld[plan, p])
    return x[:, :n].contiguous()


def level_order(level_rows, cols, vals, dinv) -> tuple:
    """nb plans in the reference's layout (numpy: level_rows [nb, nlev,
    rmax], cols/vals [nb, n+1, K], dinv [nb, n]) in level order, what
    the kernel reads: lstart [nb, nlev+1] (int32, each level's first
    position), lrows [nb, n] (int32, the row at each position), lcols/
    lvals [nb, n, K'] and ldinv [nb, n] (that row's slots and 1/diag),
    and nlevs [nb] (int32, each plan's levels before its padded ones).
    K' drops the trailing slots that are padding in every row (they add
    0). Raises unless each level's rows come before its padding, each
    plan's levels before its padded ones, and each row is listed once."""
    nb, nlev, rmax = level_rows.shape
    n = dinv.shape[1]
    live = level_rows != n
    if (live[..., 1:] > live[..., :-1]).any():
        raise ValueError("sptrsv: a level's rows must come before its "
                         "padding")
    has = live[..., 0]
    if (has[:, 1:] > has[:, :-1]).any():
        raise ValueError("sptrsv: a plan's levels must come before its "
                         "padded levels")
    lstart = np.zeros((nb, nlev + 1), np.int32)
    lstart[:, 1:] = live.sum(-1).cumsum(1)
    lrows = level_rows[live]
    if (lstart[:, -1] != n).any() or not (
            np.sort(lrows.reshape(nb, n), 1) == np.arange(n)).all():
        raise ValueError("sptrsv: every plan must list each of its rows "
                         "once")
    lrows = lrows.reshape(nb, n).astype(np.int32)
    used = np.flatnonzero((cols[:, :n] != n).any((0, 1)))
    k = int(used[-1]) + 1 if used.size else 1
    at = lrows[..., None]
    return (lstart, lrows,
            np.ascontiguousarray(np.take_along_axis(cols[..., :k], at, 1)),
            np.ascontiguousarray(np.take_along_axis(vals[..., :k], at, 1)),
            np.ascontiguousarray(np.take_along_axis(dinv, lrows, 1)),
            has.sum(-1).astype(np.int32))


def _check(lstart, lrows, lcols, lvals, ldinv, b, nlevs, rmax):
    dev = b.device
    arrays = (("lstart", lstart), ("lrows", lrows), ("lcols", lcols),
              ("lvals", lvals), ("ldinv", ldinv), ("b", b),
              ("nlevs", nlevs))
    for name, t in arrays:
        if not isinstance(t, torch.Tensor):
            raise TypeError(f"sptrsv: {name} must be a tensor")
        if t.device != dev:
            raise ValueError(f"sptrsv: {name} is on {t.device}, b on {dev}")
        if not t.is_contiguous():
            raise ValueError(f"sptrsv: {name} must be contiguous")
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"sptrsv: tensors on {dev} are not supported "
                         "(cuda runs the kernel, cpu its plain version)")
    if lstart.dim() != 2 or lvals.dim() != 3:
        raise ValueError(f"sptrsv: lstart and lvals must be 2-D [nb,nlev+1]"
                         f" and 3-D [nb,n,K], got {tuple(lstart.shape)} and "
                         f"{tuple(lvals.shape)}")
    nb, n, K = lvals.shape
    nlev = lstart.shape[1] - 1
    if b.dtype not in _DTYPES:
        raise ValueError(f"sptrsv: b must be float32 or float64, got "
                         f"{b.dtype}")
    expect = {"lstart": (lstart, torch.int32, (nb, nlev + 1)),
              "lrows": (lrows, torch.int32, (nb, n)),
              "lcols": (lcols, torch.int32, (nb, n, K)),
              "lvals": (lvals, b.dtype, (nb, n, K)),
              "ldinv": (ldinv, b.dtype, (nb, n)),
              "b": (b, b.dtype, (nb, n)),
              "nlevs": (nlevs, torch.int32, (nb,))}
    for name, (t, dt, shape) in expect.items():
        if t.dtype != dt or tuple(t.shape) != shape:
            raise ValueError(f"sptrsv: {name} must be {dt} {shape}, got "
                             f"{t.dtype} {tuple(t.shape)}")
    if not isinstance(rmax, int) or isinstance(rmax, bool) or rmax < 1:
        raise ValueError(f"sptrsv: rmax must be an int >= 1, got {rmax!r}")
    if nlev < 1 or K < 1:
        raise ValueError(f"sptrsv: empty plan (nlev={nlev}, K={K})")
    return nb, n, nlev, K


# the C entry point's argument types, the stream last
ARGTYPES = ((ctypes.c_void_p,) * 9 + (ctypes.c_int,) * 7 + (ctypes.c_void_p,))


@functools.cache
def _launcher():
    return _build.entry("sptrsv", ARGTYPES)


def sptrsv(lstart, lrows, lcols, lvals, ldinv, b, *, nlevs,
           rmax: int) -> torch.Tensor:
    """x = T⁻¹ b for nb stacked plans in level order: x [nb, n] (see
    sptrsv_plain).

    nlevs [nb] says how many levels of each plan come before its padded
    ones (level_order gives both), and rmax is the most rows a level
    holds; mat/factor.SpTRSVPlan derives them once. The kernel does not
    re-check the plan's indices."""
    nb, n, nlev, K = _check(lstart, lrows, lcols, lvals, ldinv, b, nlevs,
                            rmax)
    if not b.is_cuda:
        return sptrsv_plain(lstart, lrows, lcols, lvals, ldinv, b)
    x = b.new_empty((nb, n))
    if nb == 0 or n == 0:
        return x
    shape = launch_shape(nb, rmax)
    bar = torch.empty(1, dtype=torch.int32, device=b.device) \
        if shape == "grid" else None
    rc = _build.launch(_launcher(), b.get_device(), (
        lstart.data_ptr(), nlevs.data_ptr(), lrows.data_ptr(),
        lcols.data_ptr(), lvals.data_ptr(), ldinv.data_ptr(), b.data_ptr(),
        x.data_ptr(), None if bar is None else bar.data_ptr(), nb, n, nlev,
        rmax, K, int(b.dtype == torch.float64), SHAPES[shape]))
    if rc != 0:
        raise RuntimeError(f"sptrsv: kernel launch failed with CUDA error "
                           f"{rc}")
    _build.counted(sptrsv)
    return x


sptrsv.launches = 0
