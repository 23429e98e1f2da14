"""H3: the gather forms of the round-4 TPU probes, a CUDA kernel written
by hand for Hopper.

Replaces the Pallas TPU kernels of scripts/probe_pallas_gather{,2,3,4,5}.py
and scripts/probe_gather6.py. The CUDA source, with its design and bound,
is `petsctpu_torch/csrc/gather_forms.cu`; it is built by nvcc into
`petsctpu_torch/_build/` at first use and called through ctypes.

`gather_forms(form, x, idx, ...)` launches the kernel for CUDA tensors
(or raises) and takes the plain PyTorch version `gather_forms_plain` only
for tensors on the CPU. x is float32; idx (and idx2) int32 or int16.
The forms, for x [S,L]:

    take       out = x[idx]                   x 1-D, out shaped as idx
    rows       out[i,j] = x[idx[i], j]        idx [M]
    axis0      out[i,j] = x[idx[i,j], j]      idx [M,L]  (take_along_axis 0)
    axis1      out[i,j] = x[i, idx[i,j]]      idx [S,N]  (take_along_axis 1)
    chain      out[i,j] = x[idx[i,c], c], c = idx2[i,j]      idx, idx2 [M,L]
    window     out[i,j] = x[t + i + q//L, q%L], q = idx[i,j], or j when
               idx is None and size=(M, N) gives the output
    transpose  out = x.T

axis0, axis1, chain and window take a leading reps axis on the indices
([R,M,N]); the output is then the sum over it, folded from +0 in rep
order. axis1 and window take `blocks`: the gathered row is cut into that
many column blocks, summed left to right. Both versions round every add
on its own in that order, so on the card they agree bit for bit; pure
gathers are exact. `gather_forms.launches` counts kernel launches.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from petsctpu_torch.ops import _build

FORMS = ("take", "rows", "axis0", "axis1", "chain", "window", "transpose")
_IDX_TYPES = (torch.int32, torch.int16)


def _fold(a: torch.Tensor, blocks: int) -> torch.Tensor:
    """a [R,M,N] → Σ over column blocks (left to right), then over R from
    +0 in order (R = 1: no fold)."""
    width = a.shape[2] // blocks
    s = a[..., :width]
    for b in range(1, blocks):
        s = s + a[..., b * width:(b + 1) * width]
    if s.shape[0] == 1:
        return s[0].contiguous()
    acc = torch.zeros(s.shape[1:], dtype=s.dtype, device=s.device)
    for r in range(s.shape[0]):
        acc = acc + s[r]
    return acc


def _as3(idx):
    return None if idx is None else idx.long().reshape(-1, *idx.shape[-2:])


def gather_sources(form, x, idx=None, idx2=None, *, t: int = 0,
                   size=None) -> torch.Tensor:
    """The flat index into x of every element the form gathers, int64:
    shaped as the output for take, rows and transpose, else [R,M,N]
    before the fold."""
    if form == "take":
        return idx.long()
    dev = x.device
    S, L = x.shape
    lanes = torch.arange(L, device=dev)
    if form == "rows":
        return idx.long()[:, None] * L + lanes
    if form == "transpose":
        return torch.arange(S, device=dev) * L + lanes[:, None]
    i3, c3 = _as3(idx), _as3(idx2)
    if form == "axis0":
        return i3 * L + lanes
    if form == "axis1":
        return torch.arange(S, device=dev)[None, :, None] * L + i3
    if form == "chain":
        return torch.gather(i3, 2, c3) * L + c3
    if form == "window":
        if i3 is None:
            M, N = size
            i3 = torch.arange(N, device=dev).expand(1, M, N)
        rows = t + torch.arange(i3.shape[1], device=dev)[None, :, None]
        return (rows + torch.div(i3, L, rounding_mode="floor")) * L + i3 % L
    raise ValueError(f"gather_forms: form must be one of {FORMS}, got "
                     f"{form!r}")


def gather_forms_plain(form, x, idx=None, idx2=None, *, t: int = 0,
                       size=None, blocks: int = 1) -> torch.Tensor:
    """The gather `form` of x (see the module docstring)."""
    a = x.reshape(-1)[gather_sources(form, x, idx, idx2, t=t, size=size)]
    return a if form in ("take", "rows", "transpose") else _fold(a, blocks)


def gather_dims(form, x, idx=None, idx2=None, *, t=0, size=None, blocks=1):
    """(reps, M, N, L, output shape) of a call on these operands: the
    indices' [reps, M, N] and x's row length; ValueError if the form
    does not take them."""
    def fail(msg):
        raise ValueError(f"gather_forms[{form}]: {msg}")

    if form != "chain" and idx2 is not None:
        fail("takes no idx2")
    if form == "take":
        if x.dim() != 1 or idx is None or idx.dim() < 1:
            fail(f"needs x 1-D and idx, got x {tuple(x.shape)}")
        if blocks != 1:
            fail("takes no blocks")
        return 1, 1, idx.numel(), x.numel(), tuple(idx.shape)
    if x.dim() != 2:
        fail(f"x must be 2-D, got {tuple(x.shape)}")
    S, L = x.shape
    if form == "transpose":
        if idx is not None or blocks != 1:
            fail("takes no indices and no blocks")
        return 1, L, S, L, (L, S)
    if form == "rows":
        if idx is None or idx.dim() != 1 or blocks != 1:
            fail("needs idx [M] and no blocks")
        return 1, idx.numel(), L, L, (idx.numel(), L)
    if form == "window" and idx is None:
        if size is None or len(size) != 2:
            fail("needs idx or size=(M, N)")
        reps, M, N = 1, int(size[0]), int(size[1])
    else:
        if idx is None or idx.dim() not in (2, 3):
            fail("needs idx [M,N] or [R,M,N]")
        reps = idx.shape[0] if idx.dim() == 3 else 1
        M, N = idx.shape[-2:]
    if form in ("axis0", "chain") and N != L:
        fail(f"idx must have L={L} columns, got {N}")
    if form == "axis1" and M != S:
        fail(f"idx must have S={S} rows, got {M}")
    if form == "chain" and (idx2 is None or idx2.shape != idx.shape
                            or idx2.dtype != idx.dtype):
        fail("needs idx2 of idx's shape and type")
    if blocks < 1 or N % blocks or (blocks > 1 and form not in
                                    ("axis1", "window")):
        fail(f"blocks={blocks} must divide N={N} (axis1 and window only)")
    if form == "window":
        last = t + M - 1 + ((N - 1) // L if idx is None else 0)
        if t < 0 or last >= S:
            fail(f"rows {t}..{last} must lie in x's {S}")
    return reps, M, N, L, (M, N // blocks)


def _check(form, x, idx, idx2, t, size, blocks):
    """The full checks of a call; returns the kernel's static arguments
    (form code, index bytes, reps, M, N, L, t, blocks) and the output's
    shape and size."""
    if form not in FORMS:
        raise ValueError(f"gather_forms: form must be one of {FORMS}, "
                         f"got {form!r}")
    dev = x.device if isinstance(x, torch.Tensor) else None
    for name, a in (("x", x), ("idx", idx), ("idx2", idx2)):
        if a is None and name != "x":
            continue
        if not isinstance(a, torch.Tensor):
            raise TypeError(f"gather_forms: {name} must be a tensor")
        if a.device != dev:
            raise ValueError(f"gather_forms: {name} is on {a.device}, x on "
                             f"{dev}")
        if not a.is_contiguous():
            raise ValueError(f"gather_forms: {name} must be contiguous")
        if name != "x" and a.dtype not in _IDX_TYPES:
            raise ValueError(f"gather_forms: {name} must be int32 or int16, "
                             f"got {a.dtype}")
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"gather_forms: tensors on {dev} are not supported "
                         "(cuda runs the kernel, cpu its plain version)")
    if x.dtype != torch.float32:
        raise ValueError(f"gather_forms: x must be float32, got {x.dtype}")
    reps, M, N, L, shape = gather_dims(form, x, idx, idx2, t=t, size=size,
                                       blocks=blocks)
    idx_bytes = 2 if idx is not None and idx.dtype == torch.int16 else 4
    total = 1
    for n in shape:
        total *= n
    return ((FORMS.index(form), idx_bytes), (reps, M, N, L, int(t), blocks),
            shape, total)


# the C entry point's argument types, the stream last
ARGTYPES = ((ctypes.c_int,) * 2 + (ctypes.c_void_p,) * 4 + (ctypes.c_longlong,)
            + (ctypes.c_int,) * 6 + (ctypes.c_void_p,))


@functools.cache
def _launcher():
    return _build.entry("gather_forms", ARGTYPES)


def gather_forms(form, x, idx=None, idx2=None, *, t: int = 0, size=None,
                 blocks: int = 1) -> torch.Tensor:
    """The gather `form` of x, float32 (see the module docstring).

    Every index must lie inside x; the kernel does not re-check them.
    """
    head, tail, shape, total = _check(form, x, idx, idx2, t, size, blocks)
    if not x.is_cuda:
        return gather_forms_plain(form, x, idx, idx2, t=t, size=size,
                                  blocks=blocks)
    out = x.new_empty(shape)
    if total == 0:
        return out
    rc = _build.launch(_launcher(), x.get_device(), head + (
        x.data_ptr(), None if idx is None else idx.data_ptr(),
        None if idx2 is None else idx2.data_ptr(), out.data_ptr(),
        total) + tail)
    if rc != 0:
        raise RuntimeError(f"gather_forms: kernel launch failed with CUDA "
                           f"error {rc}")
    _build.counted(gather_forms)
    return out


gather_forms.launches = 0
