"""H1: the SELL pass of the round-4 probes, a CUDA kernel written by hand
for Hopper.

Replaces the Pallas TPU kernels of scripts/probe_sell_bisect.py,
probe_gather7.py, probe_sell2_compact.py, probe_sell2_onehot.py and
probe_sellx_crossed.py (= probe_gather8.py). The CUDA source, with its
design and bound, is `petsctpu_torch/csrc/sell_pass.cu`; it is built by
nvcc into `petsctpu_torch/_build/` at first use and called through
ctypes.

A pass stream of NCH chunks, each of P passes of [G,128] slots, is read
by NT tiles: tile t takes the chunks cstart[t] .. cstart[t]+nch[t]-1 and
reads x from row ws[t] on. The row of a slot in x is, by `mode`:

    tile     qs[ch,p] + g
    group    qbase + qoff[ch,p,g]      (qbase [NCH], [NCH,P] or None = 0)
    crossed  128·hh[ch] + i1[ch, j, G·p + g]   (P·G = 128)

and its column is j = idx[ch,p,g,l]. In crossed mode j and the i1 entry
lie in [0, 128) (one half window of x, its 128 lanes): both are taken
mod 128 (j & 127, i1 & 127), which for int8 is what the TPU kernel's
take_along_axis does (a negative index counts from the end of the
row). `sell_pass` launches the kernel for CUDA tensors (or raises) and
takes the plain PyTorch version `sell_pass_plain` only for tensors on
the CPU. Both fold each chunk's part from +0 in pass order with one
rounding per product and per sum, take the first chunk's part as y and
add each later one in order, so on the card they agree bit for bit.
`sell_pass.launches` counts kernel launches.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from petsctpu_torch.ops import _build

MODES = ("tile", "group", "crossed")
_BYTES = {torch.int8: 1, torch.int32: 4}


def pass_columns(idx, ws_of, ch, p, *, mode, qs=None, qbase=None,
                 qoff=None, hh=None, i1=None) -> torch.Tensor:
    """Flat x index (row·128 + column) of pass p's slots [n,G,128] of the
    chunks `ch` [n], read from window rows ws_of [n]."""
    j = idx[ch, p].long()                                  # [n, G, 128]
    G = idx.shape[2]
    g = torch.arange(G, device=idx.device)[None, :, None]
    if mode == "tile":
        row = qs[ch, p].long()[:, None, None] + g
    elif mode == "group":
        row = qoff[ch, p].long()[:, :, None]
        if qbase is not None:
            qb = qbase[ch, p] if qbase.dim() == 2 else qbase[ch]
            row = row + qb.long()[:, None, None]
    else:
        j = j & 127
        row = 128 * hh[ch].long()[:, None, None] \
            + (i1[ch[:, None, None], j, G * p + g].long() & 127)
    return (ws_of.long()[:, None, None] + row) * 128 + j


def sell_pass_plain(vals, idx, xp, ws, cstart, nch, *, mode="tile", qs=None,
                    qbase=None, qoff=None, hh=None, i1=None) -> torch.Tensor:
    """y [NT,G,128]: per tile, each chunk's part folded from 0 in pass
    order, the parts added in chunk order (see the module docstring)."""
    nt = ws.shape[0]
    P, G = vals.shape[1:3]
    xf = xp.reshape(-1)
    y = torch.zeros((nt, G, 128), dtype=torch.float32, device=xp.device)
    nmax = int(nch.max()) if nt else 0
    for c in range(nmax):
        tiles = torch.nonzero(nch > c).reshape(-1)
        ch = cstart[tiles].long() + c
        acc = torch.zeros((tiles.numel(), G, 128), dtype=torch.float32,
                          device=xp.device)
        for p in range(P):
            col = pass_columns(idx, ws[tiles], ch, p, mode=mode, qs=qs,
                               qbase=qbase, qoff=qoff, hh=hh, i1=i1)
            acc = acc + vals[ch, p] * xf[col]
        y[tiles] = acc if c == 0 else y[tiles] + acc
    return y


def _check(vals, idx, xp, ws, cstart, nch, mode, qs, qbase, qoff, hh, i1):
    """The checks of a call; returns the kernel's static arguments:
    (mode code, idx bytes, qoff bytes) and (nt, P, G, qbase per pass,
    rows of xp)."""
    if mode not in MODES:
        raise ValueError(f"sell_pass: mode must be one of {MODES}, got "
                         f"{mode!r}")
    dev = xp.device
    named = (("vals", vals), ("idx", idx), ("xp", xp), ("ws", ws),
             ("cstart", cstart), ("nch", nch), ("qs", qs), ("qbase", qbase),
             ("qoff", qoff), ("hh", hh), ("i1", i1))
    for name, t in named:
        if t is None:
            continue
        if not isinstance(t, torch.Tensor):
            raise TypeError(f"sell_pass: {name} must be a tensor")
        if t.device != dev:
            raise ValueError(f"sell_pass: {name} is on {t.device}, xp on "
                             f"{dev}")
        if not t.is_contiguous():
            raise ValueError(f"sell_pass: {name} must be contiguous")
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"sell_pass: tensors on {dev} are not supported "
                         "(cuda runs the kernel, cpu its plain version)")
    if vals.dim() != 4 or vals.shape[3] != 128:
        raise ValueError(f"sell_pass: vals must be [NCH,P,G,128], got "
                         f"{tuple(vals.shape)}")
    NCH, P, G = vals.shape[:3]
    nt = ws.shape[0] if ws.dim() == 1 else -1
    need = {"tile": ("qs",), "group": ("qoff",), "crossed": ("hh", "i1")}
    given = {"qs": qs, "qbase": qbase, "qoff": qoff, "hh": hh, "i1": i1}
    allowed = need[mode] + (("qbase",) if mode == "group" else ())
    for name, t in given.items():
        if (t is None and name in need[mode]) or \
                (t is not None and name not in allowed):
            raise ValueError(f"sell_pass: mode {mode!r} takes "
                             f"{' and '.join(allowed)}; {name} is "
                             f"{'missing' if t is None else 'not one'}")
    expect = {"vals": (vals, (torch.float32,), (NCH, P, G, 128)),
              "idx": (idx, (torch.int8, torch.int32), (NCH, P, G, 128)),
              "ws": (ws, (torch.int32,), (nt,)),
              "cstart": (cstart, (torch.int32,), (nt,)),
              "nch": (nch, (torch.int32,), (nt,)),
              "qs": (qs, (torch.int32,), (NCH, P)),
              "qoff": (qoff, (torch.int8, torch.int32), (NCH, P, G)),
              "hh": (hh, (torch.int32,), (NCH,)),
              "i1": (i1, (torch.int8,), (NCH, 128, 128))}
    if qbase is not None:
        expect["qbase"] = (qbase, (torch.int32,),
                           (NCH, P) if qbase.dim() == 2 else (NCH,))
    for name, (t, dts, shape) in expect.items():
        if t is not None and (t.dtype not in dts or tuple(t.shape) != shape):
            raise ValueError(f"sell_pass: {name} must be "
                             f"{'/'.join(map(str, dts))} {shape}, got "
                             f"{t.dtype} {tuple(t.shape)}")
    if xp.dtype != torch.float32 or xp.dim() != 2 or xp.shape[1] != 128:
        raise ValueError(f"sell_pass: xp must be float32 [Lx,128], got "
                         f"{xp.dtype} {tuple(xp.shape)}")
    if mode == "crossed" and P * G != 128:
        raise ValueError(f"sell_pass: crossed mode needs P*G = 128, got "
                         f"P={P} G={G}")
    return ((MODES.index(mode), _BYTES[idx.dtype],
             _BYTES[qoff.dtype] if qoff is not None else 1),
            (nt, P, G, int(qbase is not None and qbase.dim() == 2),
             xp.shape[0]))


# the C entry point's argument types, the stream last
ARGTYPES = ((ctypes.c_int,) * 3 + (ctypes.c_void_p,) * 11 + (ctypes.c_int,) * 5
            + (ctypes.c_void_p,))


@functools.cache
def _launcher():
    return _build.entry("sell_pass", ARGTYPES)


def sell_pass(vals, idx, xp, ws, cstart, nch, *, mode="tile", qs=None,
              qbase=None, qoff=None, hh=None, i1=None) -> torch.Tensor:
    """The SELL pass y [NT,G,128] f32 (see the module docstring).

    Every chunk range and every row must lie inside the arrays and x;
    the kernel does not re-check them. In crossed mode idx and i1 are
    taken mod 128 (see the module docstring), and on the card vals, idx,
    xp and i1 must be 16-byte aligned (a fresh tensor is): the kernel
    reads a pass as float4 values and copies x's half windows and i1's
    slabs into shared memory in 16-byte units.
    """
    head, tail = _check(vals, idx, xp, ws, cstart, nch, mode, qs, qbase,
                        qoff, hh, i1)
    if not xp.is_cuda:
        return sell_pass_plain(vals, idx, xp, ws, cstart, nch, mode=mode,
                               qs=qs, qbase=qbase, qoff=qoff, hh=hh, i1=i1)
    if hh is not None and (vals.data_ptr() % 16 or idx.data_ptr() % 16
                           or xp.data_ptr() % 16 or i1.data_ptr() % 16):
        raise ValueError("sell_pass: crossed mode reads vals and idx in "
                         "16- and 4-byte units and copies xp and i1 to "
                         "shared memory in 16-byte units: all four must be "
                         "16-byte aligned")
    y = xp.new_empty((tail[0], tail[2], 128))
    q = qs if qs is not None else qbase     # the kernel's per-pass rows
    rc = _build.launch(_launcher(), xp.get_device(), head + (
        vals.data_ptr(), idx.data_ptr(), xp.data_ptr(), ws.data_ptr(),
        cstart.data_ptr(), nch.data_ptr(), None if q is None else q.data_ptr(),
        None if qoff is None else qoff.data_ptr(),
        None if hh is None else hh.data_ptr(),
        None if i1 is None else i1.data_ptr(),
        y.data_ptr()) + tail)
    if rc != 0:
        raise RuntimeError(f"sell_pass: kernel launch failed with CUDA "
                           f"error {rc}")
    _build.counted(sell_pass)
    return y


sell_pass.launches = 0
