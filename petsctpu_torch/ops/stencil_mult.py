"""K1: the stencil SpMV of StencilMat.mult, a CUDA kernel written by hand
for Hopper.

Replaces petsctpu/ops/stencil_pallas.py::stencil5_mult_pallas (a Pallas
TPU kernel for the 2-D 5-point case) with the general product of
petsctpu/mat/stencil.py:91-104: D coefficient planes over a 1-, 2- or
3-D grid, D grid offsets, a boundary per axis ("none", "periodic" or
"mirror"), fp32 or fp64. The CUDA source, with its design and bound, is
`petsctpu_torch/csrc/stencil_mult.cu`; it is built by nvcc into
`petsctpu_torch/_build/` at first use and called through ctypes.

`stencil_mult` launches the kernel for CUDA tensors (or raises) and
takes the plain PyTorch version `stencil_mult_plain` (pad+slice shifted
reads, as petsctpu's `_shift`) only for tensors on the CPU. Both sum in
offset order from 0 with a separate multiply and add, so on the card
they agree bit for bit. `stencil_plan` is the kernel's host plan (each
offset's flat delta and the interior box, read by the interior path of
its fp32 5- and 7-point instantiations), built once a stencil.
`stencil_mult.launches` counts kernel launches.
"""

from __future__ import annotations

import ctypes
import functools

import torch
import torch.nn.functional as F

from petsctpu_torch.ops import _build

MAX_OFFSETS = 125          # kMaxOffsets in csrc/stencil_mult.cu
_BOUNDARY_CODES = {"none": 0, "periodic": 1, "mirror": 2}
_DTYPE_CODES = {torch.float32: 0, torch.float64: 1}


def boundary_types(boundary, nd: int) -> tuple:
    """Per-axis boundary names; () means every axis "none"."""
    return tuple(boundary) if boundary else ("none",) * nd


def mirror_index(j: torch.Tensor, m: int) -> torch.Tensor:
    """Reflect indices about the end nodes, period 2(m−1) (numpy's
    reflect pad: −1 reads 1, m reads m−2)."""
    if m == 1:
        return torch.zeros_like(j)
    period = 2 * (m - 1)
    j = torch.remainder(j, period)
    return torch.where(j < m, j, period - j)


def shift(xg: torch.Tensor, off: tuple, boundary: tuple = ()) -> torch.Tensor:
    """s with s[idx] = xg[idx + off]: zero outside the grid on "none"
    axes, wrapped on periodic axes, reflected on mirror axes."""
    bnd = boundary_types(boundary, xg.dim())
    rolls = [(-int(o), ax) for ax, (o, b) in enumerate(zip(off, bnd))
             if b == "periodic" and int(o) != 0]
    if rolls:
        xg = torch.roll(xg, [r for r, _ in rolls], [a for _, a in rolls])
    pads, slices = [], []
    for ax, (o, b) in enumerate(zip(off, bnd)):
        o, m = int(o), xg.shape[ax]
        if b == "periodic" or o == 0:
            pads.append((0, 0))
            slices.append(slice(0, m))
        elif b == "mirror":
            idx = mirror_index(torch.arange(m, device=xg.device) + o, m)
            xg = xg.index_select(ax, idx)
            pads.append((0, 0))
            slices.append(slice(0, m))
        else:
            pads.append((0, o) if o > 0 else (-o, 0))
            slices.append(slice(o, o + m) if o > 0 else slice(0, m))
    if any(p != (0, 0) for p in pads):
        flat = [w for p in reversed(pads) for w in p]
        xg = F.pad(xg, flat)[tuple(slices)]
    return xg


def stencil_mult_plain(coeffs, x, offsets, grid, boundary=()) -> torch.Tensor:
    """y = Σ_d coeffs[d] ⊙ shift(x, +offsets[d]), summed in offset order
    from 0; x flat [N] or grid-shaped, y shaped as x."""
    xg = x.reshape(grid)
    y = torch.zeros_like(xg)
    for d, off in enumerate(offsets):
        y = y + coeffs[d] * shift(xg, off, boundary)
    return y.reshape(x.shape)


def _check(coeffs, x, offsets, grid, boundary):
    """The full checks of a call; returns the kernel's static arguments:
    _host_args's and the dtype code."""
    grid, offsets = tuple(grid), tuple(tuple(o) for o in offsets)
    boundary = tuple(boundary)
    for name, t in (("coeffs", coeffs), ("x", x)):
        if not isinstance(t, torch.Tensor):
            raise TypeError(f"stencil_mult: {name} must be a tensor")
        if not t.is_contiguous():
            raise ValueError(f"stencil_mult: {name} must be contiguous")
    if coeffs.device != x.device:
        raise ValueError(f"stencil_mult: coeffs on {coeffs.device}, "
                         f"x on {x.device}")
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"stencil_mult: tensors on {x.device} are not "
                         "supported (cuda runs the kernel, cpu its plain "
                         "version)")
    if coeffs.dtype not in _DTYPE_CODES or x.dtype != coeffs.dtype:
        raise ValueError(f"stencil_mult: coeffs and x must share a dtype "
                         f"of float32/float64, got {coeffs.dtype} and "
                         f"{x.dtype}")
    nd = len(grid)
    if not 1 <= nd <= 3:
        raise ValueError(f"stencil_mult: grids are 1-, 2- or 3-D, got {grid}")
    D = len(offsets)
    if not 0 < D <= MAX_OFFSETS:
        raise ValueError(f"stencil_mult: 1 to {MAX_OFFSETS} offsets, "
                         f"got {D}")
    if tuple(coeffs.shape) != (D, *grid):
        raise ValueError(f"stencil_mult: coeffs must be {(D, *grid)}, got "
                         f"{tuple(coeffs.shape)}")
    if x.numel() != coeffs[0].numel():
        raise ValueError(f"stencil_mult: x has {x.numel()} entries, the "
                         f"grid {grid} has {coeffs[0].numel()}")
    if any(len(off) != nd for off in offsets):
        raise ValueError(f"stencil_mult: every offset needs {nd} entries")
    bnd = boundary_types(boundary, nd)
    if len(bnd) != nd or any(b not in _BOUNDARY_CODES for b in bnd):
        raise ValueError(f"stencil_mult: boundary must name one of "
                         f"{tuple(_BOUNDARY_CODES)} per axis, got {boundary}")
    return (*_host_args(offsets, grid, boundary), _DTYPE_CODES[x.dtype])


def stencil_plan(offsets: tuple, grid: tuple):
    """K1's host plan of one stencil, on its 3-D grid (leading axes of
    extent 1 for 1- and 2-D grids): (extents, offsets, deltas, lo, hi).
    deltas[d] = (o0·n1 + o1)·n2 + o2 is offset d's step in the flat
    grid; the interior box [lo_k, hi_k) on axis k, from
    max(0, −min_d o_dk) to n_k − max(0, max_d o_dk), holds the points
    whose every neighbour lies inside the grid (none when lo_k ≥ hi_k
    on some axis), where x[i + deltas[d]] is the neighbour whatever the
    boundary."""
    lead = 3 - len(grid)
    n = (1,) * lead + tuple(int(m) for m in grid)
    offs = tuple((0,) * lead + tuple(int(o) for o in off) for off in offsets)
    deltas = tuple((o0 * n[1] + o1) * n[2] + o2 for o0, o1, o2 in offs)
    lo = tuple(max(0, -min(o[k] for o in offs)) for k in range(3))
    hi = tuple(n[k] - max(0, max(o[k] for o in offs)) for k in range(3))
    return n, offs, deltas, lo, hi


@functools.lru_cache(maxsize=256)
def _host_args(offsets: tuple, grid: tuple, boundary: tuple):
    """The kernel's static arguments of one stencil, as ctypes arrays
    (see stencil_plan): offsets, their count, grid, boundary codes, flat
    deltas and the interior box (lo then hi)."""
    n, offs, deltas, lo, hi = stencil_plan(offsets, grid)
    bnd = ("none",) * (3 - len(grid)) + boundary_types(boundary, len(grid))
    flat = [o for off in offs for o in off]
    return ((ctypes.c_int * len(flat))(*flat), len(offs),
            (ctypes.c_longlong * 3)(*n),
            (ctypes.c_int * 3)(*(_BOUNDARY_CODES[b] for b in bnd)),
            (ctypes.c_longlong * len(deltas))(*deltas),
            (ctypes.c_longlong * 6)(*lo, *hi))


# the C entry point's argument types, the stream last
ARGTYPES = ((ctypes.c_void_p,) * 4 + (ctypes.c_int,) + (ctypes.c_void_p,) * 4
            + (ctypes.c_int,) + (ctypes.c_void_p,))


@functools.cache
def _launcher():
    return _build.entry("stencil_mult", ARGTYPES)


def stencil_mult(coeffs, x, offsets, grid, boundary=()) -> torch.Tensor:
    """The stencil product y (see stencil_mult_plain), shaped as x."""
    offs, D, dims, bnd, deltas, box, dtype = _check(coeffs, x, offsets,
                                                    grid, boundary)
    if not x.is_cuda:
        return stencil_mult_plain(coeffs, x,
                                  tuple(tuple(o) for o in offsets),
                                  tuple(grid), tuple(boundary))
    y = torch.empty_like(x)
    rc = _build.launch(_launcher(), x.get_device(), (
        coeffs.data_ptr(), x.data_ptr(), y.data_ptr(), offs, D, dims, bnd,
        deltas, box, dtype))
    if rc != 0:
        raise RuntimeError(f"stencil_mult: kernel launch failed with CUDA "
                           f"error {rc}")
    _build.counted(stencil_mult)
    return y


stencil_mult.launches = 0
