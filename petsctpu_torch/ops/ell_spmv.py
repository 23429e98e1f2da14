"""The ELL SpMV of AIJ.mult, a CUDA kernel written by hand for Hopper.

Replaces petsctpu/mat/ell.py::AIJ.mult (XLA code in the reference: a
gather, a multiply and a row sum), the product under every AIJ of the
port on the card. The CUDA source, with its design and bound, is
`petsctpu_torch/csrc/ell_spmv.cu`; it is built by nvcc into
`petsctpu_torch/_build/` at first use and called through ctypes.

`ell_spmv` launches the kernel for CUDA tensors (or raises, on a dtype
other than fp32, fp64, complex64 and complex128, on columns other than
int32, or on an array that does not start 16-byte aligned) and takes the
plain PyTorch version `ell_spmv_plain` only for tensors on the CPU. Both
fold a row's slots in slot order from +0.0 with a separate multiply and
add (MatMult_SeqAIJ's order), padding slots included, a complex product
as (ar·br − ai·bi) + (ar·bi + ai·br)i on the parts, each operation
rounded once, so on the card they agree bit for bit. `launch_plan` sizes
a launch: the ring kernel's rows a tile, stages, shared bytes and grid,
or the chunked kernel's for rows too wide for a stage.
`ell_spmv.launches` counts kernel launches.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import torch

from petsctpu_torch.ops import _build

_DTYPES = {torch.float32: 0, torch.float64: 1, torch.complex64: 2,
           torch.complex128: 3}
COL_BYTES = 4              # int32 columns
SMEM_OPTIN = 232448        # a block's shared memory with the opt-in (H100)
SMEM_SM = 233472           # an SM's shared memory
SMEM_RESERVED = 1024       # the system's share of it a block
THREADS_SM = 2048
SMS = 132                  # H100 SXM; the card's own count where it is asked
BAR_BYTES = 128            # the stages' mbarriers, ahead of the ring
THREADS = 256              # a block's threads, both kernels
ROWS = 64                  # the ring's rows a tile
MIN_ROWS = 32              # ... where ROWS do not fit
STAGE_BYTES = 40 * 1024    # a stage's bytes, at most
STAGES = 3                 # the ring's stages (2 where 3 do not fit)
CHUNK_ROWS = 32
CHUNK_SMEM = 48 * 1024     # the chunked kernel's, without the opt-in


class Plan(NamedTuple):
    """A launch: mode 0 the ring kernel (rows a tile, threads a block, its
    stages, row stride ks of the products), mode 1 the chunked kernel
    (rows and threads a block, chunks of kc slots at odd row stride ks);
    smem its dynamic shared bytes, grid its blocks."""
    mode: int
    rows: int
    threads: int
    stages: int
    kc: int
    ks: int
    smem: int
    grid: int


def ring_smem(rows: int, K: int, itemsize: int, stages: int) -> int:
    """The ring kernel's shared bytes: the mbarriers, `stages` tiles of
    cols and vals, and for an even K the products at row stride K + 1
    (csrc/ell_spmv.cu::ring_smem)."""
    prod = rows * (K + 1) * itemsize if K % 2 == 0 else 0
    return BAR_BYTES + stages * rows * K * (COL_BYTES + itemsize) + prod


@functools.lru_cache(maxsize=256)
def launch_plan(m: int, K: int, itemsize: int, sms: int = SMS) -> Plan:
    """The launch of an [m, K] pack of `itemsize`-byte values on a card of
    `sms` SMs. The ring kernel takes THREADS threads a block, ROWS rows a
    tile and STAGES stages, or the first of (ROWS, 2), (MIN_ROWS, STAGES),
    (MIN_ROWS, 2) whose stage fits STAGE_BYTES and whose ring leaves two
    blocks an SM; its grid is as many blocks as the card holds, or the
    tiles if fewer. Rows too wide for all of them take the chunked
    kernel."""
    K = max(K, 1)
    half = SMEM_SM // 2 - SMEM_RESERVED                 # two blocks an SM
    for R, S in ((ROWS, STAGES), (ROWS, 2), (MIN_ROWS, STAGES), (MIN_ROWS, 2)):
        smem = ring_smem(R, K, itemsize, S)
        if R * K * (COL_BYTES + itemsize) <= STAGE_BYTES and smem <= half:
            per_sm = min(SMEM_SM // (smem + SMEM_RESERVED),
                         THREADS_SM // THREADS)
            grid = max(1, min(-(-m // R), sms * per_sm))
            return Plan(0, R, THREADS, S, 0, K if K % 2 else K + 1, smem,
                        grid)
    kc = CHUNK_SMEM // (CHUNK_ROWS * itemsize)
    kc -= 1 - kc % 2                     # odd, so the row stride is kc
    return Plan(1, CHUNK_ROWS, THREADS, 0, kc, kc,
                CHUNK_ROWS * kc * itemsize, max(1, -(-m // CHUNK_ROWS)))


@functools.cache
def _num_sms(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


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
    if cols.dtype != torch.int32:
        raise ValueError(f"ell_spmv: cols must be int32 (the AIJ pack's), "
                         f"got {cols.dtype}")
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
        for name, t in (("cols", cols), ("vals", vals)):
            if t.data_ptr() % 16:
                raise ValueError(f"ell_spmv: {name} must start at a 16-byte-"
                                 f"aligned address (the kernel's bulk copies)")
        if x.data_ptr() % x.element_size():
            raise ValueError("ell_spmv: x must be aligned to its element")
    return cols.shape


# the C entry point's argument types, the stream last
ARGTYPES = ((ctypes.c_void_p,) * 4 + (ctypes.c_longlong,)
            + (ctypes.c_int,) * 7 + (ctypes.c_longlong, ctypes.c_void_p))


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
    fn = _launcher()
    index = x.get_device()
    p = launch_plan(m, K, vals.element_size(), _num_sms(index))
    rc = _build.launch(fn, index, (
        cols.data_ptr(), vals.data_ptr(), x.data_ptr(), y.data_ptr(), m, K,
        _DTYPES[vals.dtype], p.mode, p.rows, p.threads,
        p.kc if p.mode else p.stages, p.ks, p.grid))
    if rc != 0:
        raise RuntimeError(f"ell_spmv: kernel launch failed with CUDA "
                           f"error {rc}")
    _build.counted(ell_spmv)
    return y


ell_spmv.launches = 0
