"""K3: the chunk-mode SELL transpose product, a CUDA kernel written by
hand for Hopper, run over a transpose plan of the pack.

Replaces petsctpu/mat/sell.py::_sell_spmvT_chunk (a Pallas TPU kernel)
and the per-tile window combine that petsctpu's SellMat.multT runs after
it. Mosaic has no scatter, so the TPU kernel sums every pass's row with
a one-hot compare into a window and adds the windows into y. On the card
the natural form of Aᵀr is a gather: `transpose_plan` lists, for every
output (a column of A, a row of y), the pack's live slots that add into
it, and kernel K3 (`petsctpu_torch/csrc/sell_spmvT.cu`, built by nvcc
into `petsctpu_torch/_build/` at first use, called through ctypes)
walks each list once, gathering r.

`sell_spmvT_plain` on the pack is the definition of the function: every
sum a left fold from +0, a pass's row over its slots in (g, l) order, a
window row over its passes in pass order (as petsctpu's kernel adds a
pass's row to its window row), y over the tiles in tile order. A plan
lists an output's entries in that order, (tile, pass, row) ascending,
and flags where a pass and a tile begin, so that the kernel and the
plan's plain version `sell_spmvT_plan_plain` fold the same sums in the
same order: on the card all three agree bit for bit.

`sell_spmvT` launches the kernel for CUDA tensors (or raises) and takes
`sell_spmvT_plan_plain` only for tensors on the CPU.
`sell_spmvT.launches` counts kernel launches.
"""

from __future__ import annotations

import ctypes
import functools
from dataclasses import dataclass

import torch

from petsctpu_torch.ops import _build

WARP = 32
PASS_FLAG = 1 << 30            # src bit: the entry starts a pass
TILE_FLAG = 1 << 31            # src bit: the entry starts a tile
ROW_MASK = PASS_FLAG - 1       # src bits of the fine row
# The warps an H100 holds at once (132 SMs x 64 warps): the split rule's
# limit for a plan built on the CPU, which has no card to ask.
H100_RESIDENT_WARPS = 132 * 64


def warp_shape_max_outputs(device) -> int:
    """Outputs a plan may have and still take the warp shape: as many as
    the card holds warps at once, so that a warp each runs in one wave
    (its SMs x the threads an SM holds / 32; 8,448 on an H100)."""
    device = torch.device(device)
    if device.type != "cuda":
        return H100_RESIDENT_WARPS
    props = torch.cuda.get_device_properties(device)
    return (props.multi_processor_count
            * props.max_threads_per_multi_processor // WARP)


@dataclass(frozen=True)
class TransposePlan:
    """The lists of Aᵀ's outputs, 32 lists to a warp (a group).

    List s holds cnt[s] entries, entry k at first[s] + stride·k. An entry
    is val (f32) and src (int32: the fine row of r, PASS_FLAG and
    TILE_FLAG).

    thread shape (warp_shape False, stride 32): list o is output o, one
    thread each. A group's 32 lists are interleaved by lane, so a warp's
    loads at step k are 128 contiguous bytes; a list shorter than its
    group's longest is padded with entries that are never read.
    warp shape (warp_shape True, stride 1): an output's list is split
    where a tile starts, and its segments, each contiguous, are the
    lists of the groups ogroup[o] .. ogroup[o+1]-1 in tile order (the
    last group's spare lists empty); one warp folds them."""

    val: torch.Tensor           # [E] f32
    src: torch.Tensor           # [E] int32
    first: torch.Tensor         # [32·groups] int32, a list's first entry
    cnt: torch.Tensor           # [32·groups] int32, a list's entries
    ogroup: torch.Tensor        # [nout+1] int32 (warp shape), else empty
    warp_shape: bool
    nout: int                   # outputs: Lp·128
    rows: int                   # r must hold at least this many entries
    longest: int                # the longest list

    @property
    def stride(self) -> int:
        return 1 if self.warp_shape else WARP


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
    rank = _rank(keys)
    by_rank = torch.sort(rank, stable=True).indices
    order, keys = order[by_rank], keys[by_rank]
    off = 0
    for cnt in torch.bincount(rank).tolist():
        k, i = keys[off:off + cnt], order[off:off + cnt]
        out[k] = out[k] + src[i]
        off += cnt


def _rank(keys: torch.Tensor, first: torch.Tensor = None) -> torch.Tensor:
    """Each position's distance from the start of its run of equal sorted
    keys (or of the run that `first` marks)."""
    n = keys.numel()
    pos = torch.arange(n, device=keys.device)
    if first is None:
        first = torch.ones(n, dtype=torch.bool, device=keys.device)
        first[1:] = keys[1:] != keys[:-1]
    return pos - torch.cummax(torch.where(first, pos, 0), 0).values


def sell_spmvT_plain(vals, idx, qs, winstart, rt, *, S: int,
                     Lp: int) -> torch.Tensor:
    """y [Lp,128] with

        part[t,p,c] = Σ vals[t,p,g,l]·rt[t,g,l] over (g, l) with
                      idx[t,p,g,l] = c,
        wins[t,q,c] = Σ part[t,p,c] over the passes p with qs[t,p] = q,
        y[R,c]      = Σ wins[t, R − winstart[t], c] over the tiles t
                      whose window covers row R,

    each a left fold from +0 in ascending (g, l), p and t. Slots whose
    value is 0 (padding) are skipped: a fold from +0 is never −0, so
    adding ±0 to it changes no bit."""
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


def _check_pack(vals, idx, qs, winstart, S, Lp):
    dev = vals.device
    for name, t in (("vals", vals), ("idx", idx), ("qs", qs),
                    ("winstart", winstart)):
        if not isinstance(t, torch.Tensor):
            raise TypeError(f"transpose_plan: {name} must be a tensor")
        if t.device != dev:
            raise ValueError(f"transpose_plan: {name} is on {t.device}, "
                             f"vals on {dev}")
        if not t.is_contiguous():
            raise ValueError(f"transpose_plan: {name} must be contiguous")
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"transpose_plan: tensors on {dev} are not "
                         "supported (cuda runs the kernel, cpu its plain "
                         "version)")
    if vals.dim() != 4 or vals.shape[3] != 128:
        raise ValueError(f"transpose_plan: vals must be [nt,P,G,128], got "
                         f"{tuple(vals.shape)}")
    nt, P, G = vals.shape[:3]
    expect = {"vals": (vals, torch.float32, (nt, P, G, 128)),
              "idx": (idx, torch.int8, (nt, P, G, 128)),
              "qs": (qs, torch.int32, (nt, P)),
              "winstart": (winstart, torch.int32, (nt,))}
    for name, (t, dt, shape) in expect.items():
        if t.dtype != dt or tuple(t.shape) != shape:
            raise ValueError(f"transpose_plan: {name} must be {dt} {shape}, "
                             f"got {t.dtype} {tuple(t.shape)}")
    if not 0 < S <= Lp:
        raise ValueError(f"transpose_plan: window rows S={S} must lie in "
                         f"[1, Lp={Lp}]")
    if nt * G * 128 >= PASS_FLAG:
        raise ValueError(f"transpose_plan: {nt * G * 128} fine rows do not "
                         "fit the 30 bits of a plan entry's row")


def _int32(x: torch.Tensor) -> torch.Tensor:
    """int64 values below 2³² as the int32 of the same 32 bits."""
    return (x - ((x >> 31) & 1) * (1 << 32)).to(torch.int32)


def transpose_plan(vals, idx, qs, winstart, *, S: int, Lp: int,
                   warp_shape: bool = None) -> TransposePlan:
    """The plan of Aᵀ for a chunk-mode pack (see TransposePlan), built on
    the pack's device from one `nonzero` and one stable sort.

    Live slot (t, p, g, l) adds vals·r[f] into output
    o = (winstart[t] + qs[t,p])·128 + idx[t,p,g,l], f = (t·G + g)·128 + l.
    The slots, taken in (t, p, g, l) order and sorted stably by o, give
    each output its entries in the order sell_spmvT_plain folds them.

    Split rule: the thread shape gives each output one thread, and its
    parallelism is the number of outputs. A plan with at most
    warp_shape_max_outputs(device) outputs that have entries (the 128³
    GAMG level 1: 6,373 outputs, 229 entries each on average) would leave
    most of the card idle and walk long lists one thread each, so it
    takes the warp shape, whose warps walk an output's tile segments in
    parallel; larger plans (level 0: 263,552 outputs of 29 entries) keep
    one thread an output. `warp_shape` overrides the rule."""
    _check_pack(vals, idx, qs, winstart, S, Lp)
    nt, P, G = vals.shape[:3]
    dev = vals.device
    nout = Lp * 128
    flat = torch.nonzero(vals.reshape(-1)).squeeze(1)     # (t,p,g,l) order
    tp = flat // (G * 128)                                 # t·P + p
    t = tp // P
    o = (winstart.long()[t] + qs.reshape(-1).long()[tp]) * 128 \
        + idx.reshape(-1)[flat].long()
    order = torch.sort(o, stable=True).indices
    o, tp, flat = o[order], tp[order], flat[order]
    t = tp // P
    f = t * (G * 128) + flat % (G * 128)
    n = o.numel()
    new_out = torch.ones(n, dtype=torch.bool, device=dev)
    new_out[1:] = o[1:] != o[:-1]
    new_tile = new_out.clone()
    new_tile[1:] |= t[1:] != t[:-1]
    new_pass = new_out.clone()
    new_pass[1:] |= tp[1:] != tp[:-1]
    if warp_shape is None:
        warp_shape = int(new_out.sum()) <= warp_shape_max_outputs(dev)

    code = _int32(f + PASS_FLAG * new_pass.long()
                  + TILE_FLAG * new_tile.long())
    val = vals.reshape(-1)[flat]
    if warp_shape:          # a list per (output, tile) segment, in place
        seg_first = torch.nonzero(new_tile).squeeze(1)
        seg_out = o[seg_first]
        nseg = torch.bincount(seg_out, minlength=nout)
        ogroup = torch.zeros(nout + 1, dtype=torch.int64, device=dev)
        ogroup[1:] = torch.cumsum((nseg + WARP - 1) // WARP, 0)
        within = _rank(seg_out)
        slot = (ogroup[seg_out] + within // WARP) * WARP + within % WARP
        nslots = WARP * int(ogroup[-1])
        first = torch.zeros(nslots, dtype=torch.int64, device=dev)
        first[slot] = seg_first
        cnt = torch.zeros(nslots, dtype=torch.int64, device=dev)
        cnt[slot] = torch.diff(seg_first, append=seg_first.new_tensor([n]))
        src = code
    else:                   # a list per output, interleaved by lane
        ogroup = torch.zeros(0, dtype=torch.int64, device=dev)
        cnt = torch.bincount(o, minlength=nout)
        glen = cnt.view(-1, WARP).amax(1)
        gstart = WARP * (torch.cumsum(glen, 0) - glen)
        first = torch.repeat_interleave(gstart, WARP) \
            + torch.arange(nout, device=dev) % WARP
        E = WARP * int(glen.sum())
        pos = first[o] + WARP * _rank(o)
        val = torch.zeros(E, dtype=torch.float32, device=dev) \
            .index_put_((pos,), val)
        src = torch.zeros(E, dtype=torch.int32, device=dev) \
            .index_put_((pos,), code)
    if val.numel() >= 1 << 31:
        raise ValueError(f"transpose_plan: {val.numel()} plan entries "
                         "exceed int32")
    return TransposePlan(val, src, first.to(torch.int32),
                         cnt.to(torch.int32), ogroup.to(torch.int32),
                         bool(warp_shape), nout,
                         int(f.max()) + 1 if n else 0,
                         int(cnt.max()) if cnt.numel() else 0)


def sell_spmvT_plan_plain(plan: TransposePlan, r: torch.Tensor) -> torch.Tensor:
    """y [Lp,128] from the plan, step for step as the kernel folds: each
    list keeps (y, w, part), part restarts at a pass and is added to w,
    w restarts at a tile and is added to y; in the warp shape an output
    then folds its segments' results in tile order."""
    dev = r.device
    cnt, base, step = plan.cnt.long(), plan.first.long(), plan.stride
    y = torch.zeros(cnt.numel(), dtype=torch.float32, device=dev)
    w = torch.zeros_like(y)
    part = torch.zeros_like(y)
    for k in range(plan.longest):
        act = torch.nonzero(cnt > k).squeeze(1)
        e = base[act] + step * k
        code = plan.src[e].long() & 0xFFFFFFFF
        at = act[(code & PASS_FLAG) != 0]
        w[at] = w[at] + part[at]
        part[at] = 0.0
        at = act[(code & TILE_FLAG) != 0]
        y[at] = y[at] + w[at]
        w[at] = 0.0
        part[act] = part[act] + plan.val[e] * r[code & ROW_MASK]
    y = y + (w + part)
    if plan.warp_shape:
        og = plan.ogroup.long()
        first, nsl = WARP * og[:-1], WARP * (og[1:] - og[:-1])
        out = torch.zeros(plan.nout, dtype=torch.float32, device=dev)
        for i in range(int(nsl.max()) if plan.nout else 0):
            at = torch.nonzero(nsl > i).squeeze(1)
            out[at] = out[at] + y[first[at] + i]
        y = out
    return y.view(plan.nout // 128, 128)


def _check(plan, r):
    if not isinstance(plan, TransposePlan):
        raise TypeError("sell_spmvT: plan must be a TransposePlan "
                        "(transpose_plan)")
    if not isinstance(r, torch.Tensor):
        raise TypeError("sell_spmvT: r must be a tensor")
    dev = r.device
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"sell_spmvT: tensors on {dev} are not supported "
                         "(cuda runs the kernel, cpu its plain version)")
    for name, t in (("val", plan.val), ("src", plan.src),
                    ("first", plan.first), ("cnt", plan.cnt),
                    ("ogroup", plan.ogroup)):
        if t.device != dev:
            raise ValueError(f"sell_spmvT: the plan's {name} is on "
                             f"{t.device}, r on {dev}")
    dtypes = {"val": (plan.val, torch.float32), "src": (plan.src, torch.int32),
              "first": (plan.first, torch.int32),
              "cnt": (plan.cnt, torch.int32),
              "ogroup": (plan.ogroup, torch.int32)}
    for name, (t, dt) in dtypes.items():
        if t.dtype != dt:
            raise ValueError(f"sell_spmvT: the plan's {name} must be {dt}, "
                             f"got {t.dtype}")
    if r.dtype != torch.float32 or r.dim() != 1 or not r.is_contiguous():
        raise ValueError(f"sell_spmvT: r must be a contiguous float32 "
                         f"vector, got {r.dtype} {tuple(r.shape)}")
    if r.numel() < plan.rows:
        raise ValueError(f"sell_spmvT: r has {r.numel()} entries, the plan "
                         f"reads {plan.rows}")


# the C entry point's argument types, the stream last
ARGTYPES = ((ctypes.c_void_p,) * 7 + (ctypes.c_int,) * 2 + (ctypes.c_void_p,))


@functools.cache
def _launcher():
    return _build.entry("sell_spmvT", ARGTYPES)


def sell_spmvT(plan: TransposePlan, r: torch.Tensor) -> torch.Tensor:
    """The chunk-mode transpose product y [Lp,128] f32 of the plan's pack
    (see sell_spmvT_plain), r the fine vector (at least plan.rows
    entries)."""
    _check(plan, r)
    if not r.is_cuda:
        return sell_spmvT_plan_plain(plan, r)
    y = r.new_empty(plan.nout)
    rc = _build.launch(_launcher(), r.get_device(), (
        plan.val.data_ptr(), plan.src.data_ptr(), plan.first.data_ptr(),
        plan.cnt.data_ptr(), plan.ogroup.data_ptr(), r.data_ptr(),
        y.data_ptr(), plan.nout, int(plan.warp_shape)))
    if rc != 0:
        raise RuntimeError(f"sell_spmvT: kernel launch failed with CUDA "
                           f"error {rc}")
    _build.counted(sell_spmvT)
    return y.view(plan.nout // 128, 128)


sell_spmvT.launches = 0
