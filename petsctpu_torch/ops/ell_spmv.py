"""The ELL SpMV of AIJ.mult, a CUDA kernel written by hand for Hopper.

Replaces petsctpu/mat/ell.py::AIJ.mult (XLA code in the reference: a
gather, a multiply and a row sum), the product under every AIJ of the
port on the card. The CUDA source, with its design and bound, is
`petsctpu_torch/csrc/ell_spmv.cu`; it is built by nvcc into
`petsctpu_torch/_build/` at first use and called through ctypes.

`ell_spmv` launches the kernel for CUDA tensors (or raises, on a dtype
other than fp32, fp64, complex64 and complex128 too) and takes the plain
PyTorch version `ell_spmv_plain` only for tensors on the CPU. Both fold
a row's slots in slot order from +0.0 with a separate multiply and add
(MatMult_SeqAIJ's order), padding slots included, a complex product as
(ar·br − ai·bi) + (ar·bi + ai·br)i on the parts, each operation rounded
once, so on the card they agree bit for bit. `ell_spmv.launches` counts
kernel launches.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from petsctpu_torch.ops import _build

_DTYPES = {torch.float32: 0, torch.float64: 1, torch.complex64: 2,
           torch.complex128: 3}
SMEM = 48 * 1024      # shared memory a block, without the opt-in
ROWS = 256            # the most rows (threads) a block
MIN_ROWS = 32


def tile(K: int, itemsize: int):
    """(R, Kc, Ks) of a launch: R rows a block (a warp's multiple), Kc
    slots a staged chunk and Ks ≥ Kc the odd row stride of the tile in
    shared memory, so that R·Ks·(8 + itemsize) bytes fit SMEM. Whole rows
    (Kc = K) where 32 of them fit; otherwise 32 rows and the widest
    chunk that fits."""
    slot = 8 + itemsize
    Ks = max(K, 1) | 1
    rows = SMEM // (Ks * slot) // 32 * 32
    if rows >= MIN_ROWS:
        return min(rows, ROWS), max(K, 1), Ks
    Kc = SMEM // (MIN_ROWS * slot)
    Kc -= 1 - Kc % 2                     # odd, so Ks = Kc
    return MIN_ROWS, Kc, Kc


def _fold(p):
    """Σ_k p[:, k] from +0.0, left to right."""
    y = torch.zeros(p.shape[0], dtype=p.dtype, device=p.device)
    for k in range(p.shape[1]):
        y = y + p[:, k]
    return y


def _imag(t):
    return torch.imag(t) if t.is_complex() else torch.zeros_like(t)


def ell_spmv_plain(cols, vals, x) -> torch.Tensor:
    """y[i] = Σ_k vals[i,k]·x[cols[i,k]], folded over k = 0…K−1 from
    +0.0, each product and each add rounded once (a complex product on
    its real and imaginary parts)."""
    xg = x[cols]
    if not (vals.is_complex() or xg.is_complex()):
        return _fold(vals * xg)
    vr, vi = torch.real(vals), _imag(vals)
    xr, xi = torch.real(xg), _imag(xg)
    return torch.complex(_fold(vr * xr - vi * xi), _fold(vr * xi + vi * xr))


def _check(cols, vals, x):
    dev = x.device
    for name, t in (("cols", cols), ("vals", vals), ("x", x)):
        if not isinstance(t, torch.Tensor):
            raise TypeError(f"ell_spmv: {name} must be a tensor")
        if t.device != dev:
            raise ValueError(f"ell_spmv: {name} is on {t.device}, x on {dev}")
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"ell_spmv: tensors on {dev} are not supported "
                         "(cuda runs the kernel, cpu its plain version)")
    if cols.dim() != 2 or vals.shape != cols.shape:
        raise ValueError(f"ell_spmv: cols and vals must be one [m, K] shape, "
                         f"got {tuple(cols.shape)} and {tuple(vals.shape)}")
    if cols.dtype != torch.int64:
        raise ValueError(f"ell_spmv: cols must be int64, got {cols.dtype}")
    if x.dim() != 1:
        raise ValueError(f"ell_spmv: x must be 1-D, got {tuple(x.shape)}")
    if x.is_cuda:
        if vals.dtype not in _DTYPES:
            raise ValueError(f"ell_spmv: the kernel takes float32, "
                             f"float64, complex64 and complex128, got "
                             f"{vals.dtype}")
        if x.dtype != vals.dtype:
            raise ValueError(f"ell_spmv: x is {x.dtype}, vals {vals.dtype}")
        for name, t in (("cols", cols), ("vals", vals), ("x", x)):
            if not t.is_contiguous():
                raise ValueError(f"ell_spmv: {name} must be contiguous")
    return cols.shape


# the C entry point's argument types, the stream last
ARGTYPES = ((ctypes.c_void_p,) * 4 + (ctypes.c_longlong,)
            + (ctypes.c_int,) * 5 + (ctypes.c_void_p,))


@functools.cache
def _launcher():
    return _build.entry("ell_spmv", ARGTYPES)


def ell_spmv(cols, vals, x) -> torch.Tensor:
    """y = A x of the ELL pack (cols, vals) (see ell_spmv_plain).

    The columns must lie in [0, len(x)), as mat/ell.py's packs do; the
    kernel does not re-check them."""
    m, K = _check(cols, vals, x)
    if not x.is_cuda:
        return ell_spmv_plain(cols, vals, x)
    y = x.new_empty(m)
    if m == 0:
        return y
    R, Kc, Ks = tile(K, vals.element_size())
    rc = _build.launch(_launcher(), x.get_device(), (
        cols.data_ptr(), vals.data_ptr(), x.data_ptr(), y.data_ptr(), m, K,
        _DTYPES[vals.dtype], R, Kc, Ks))
    if rc != 0:
        raise RuntimeError(f"ell_spmv: kernel launch failed with CUDA "
                           f"error {rc}")
    _build.counted(ell_spmv)
    return y


ell_spmv.launches = 0
