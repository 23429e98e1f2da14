"""The gather-form probes (kernel H3), one case per TPU probe kernel of
scripts/probe_pallas_gather{,2,3,4,5}.py and scripts/probe_gather6.py.

Each case draws its script's inputs from np.random.default_rng(0) in
the script's own order, so they equal the script's array for array, and
carries the script's numpy emulation of its kernel."""

from __future__ import annotations

import numpy as np
import torch

from petsctpu_torch.ops.gather_forms import (gather_dims, gather_forms,
                                             gather_forms_plain,
                                             gather_sources)
from petsctpu_torch.probes.common import (Case, csr, distinct, nbytes,
                                          tensors)


def _case(name, replaces, dev, emulate, form, x, idx=None, idx2=None, *,
          library=None, **kw) -> Case:
    """A gather_forms case; a sum (reps or blocks) is held to REL_TOL,
    a pure gather exactly."""
    blocks = kw.get("blocks", 1)
    reps, _, _, _, shape = gather_dims(form, x, idx, idx2, t=kw.get("t", 0),
                                       size=kw.get("size"), blocks=blocks)
    nout = int(np.prod(shape))
    adds = nout * (reps * (blocks - 1) + (reps if reps > 1 else 0))

    def moved():
        """x's elements that the indices reach, once (and for chain, of
        idx only the entries idx2 picks), the other indices whole and the
        output once."""
        src = gather_sources(form, x, idx, idx2, t=kw.get("t", 0),
                             size=kw.get("size"))
        total = 4 * distinct(src, x.numel()) + 4 * nout
        if form != "chain":
            return total + nbytes(idx)
        c3 = idx2.long().reshape(-1, *idx2.shape[-2:])
        picked = (torch.arange(c3.shape[0] * c3.shape[1], device=x.device)
                  .reshape(c3.shape[:2] + (1,)) * c3.shape[2] + c3)
        return (total + nbytes(idx2)
                + idx.element_size() * distinct(picked, idx.numel()))
    return Case(name=name, kernel="gather_forms", replaces=replaces,
                run=lambda: gather_forms(form, x, idx, idx2, **kw),
                plain=lambda: gather_forms_plain(form, x, idx, idx2, **kw),
                emulate=emulate, exact=reps == 1 and blocks == 1,
                nbytes=moved, flops=adds,
                library=library)


def _sum_csr(rows, cols, shape, x):
    """The yardstick of a gather sum: torch.mv on the 0/1 CSR matrix
    that picks x's entries (duplicates summed)."""
    def make():
        A = csr(rows, cols, torch.ones(rows.numel(), device=x.device), shape)
        xf = x.reshape(-1)
        return lambda: torch.mv(A, xf)
    return make


# ---------------------------------------------------------------- probe 1

def _pallas_gather_inputs():
    W, T, K = 4096, 256, 32
    rng = np.random.default_rng(0)
    x = rng.standard_normal(W).astype(np.float32)
    idx = rng.integers(0, W, size=(T, K)).astype(np.int32)
    il = rng.integers(0, 128, size=(32, 128)).astype(np.int32)
    ia = rng.integers(0, 32, size=(32, 128)).astype(np.int32)
    return x, idx, il, ia


def _flat_take(name, dev):
    x, idx, _, _ = _pallas_gather_inputs()
    xt, it = tensors(dev, x, idx)
    i64 = it.long()
    return _case(name, "scripts/probe_pallas_gather.py:19", dev,
                 lambda: x[idx], "take", xt, it,
                 library=lambda: lambda: torch.take(xt, i64))


def probe_pallas_gather_k1(dev):
    """k1: x[idx] on a 1-D x."""
    return _flat_take("probe_pallas_gather_k1", dev)


def probe_pallas_gather_k2(dev):
    """k2: jnp.take(x, idx, axis=0), the same function as k1."""
    return _flat_take("probe_pallas_gather_k2", dev)


def probe_pallas_gather_k3(dev):
    """k3: take_along_axis(x [32,128], il, axis=1), a lane shuffle."""
    x, _, il, _ = _pallas_gather_inputs()
    xl = x.reshape(32, 128)
    xt, it = tensors(dev, xl, il)
    i64 = it.long()
    return _case("probe_pallas_gather_k3", "scripts/probe_pallas_gather.py:54",
                 dev, lambda: np.take_along_axis(xl, il, axis=1), "axis1",
                 xt, it, library=lambda: lambda: torch.gather(xt, 1, i64))


def probe_pallas_gather_k4(dev):
    """k4: take_along_axis(x [32,128], ia, axis=0), a sublane gather."""
    x, _, _, ia = _pallas_gather_inputs()
    xl = x.reshape(32, 128)
    xt, it = tensors(dev, xl, ia)
    i64 = it.long()
    return _case("probe_pallas_gather_k4", "scripts/probe_pallas_gather.py:69",
                 dev, lambda: np.take_along_axis(xl, ia, axis=0), "axis0",
                 xt, it, library=lambda: lambda: torch.gather(xt, 0, i64))


# ---------------------------------------------------------------- probe 2

def probe_pallas_gather2_rows(dev):
    """k_rowgather: jnp.take(x [512,128], rows [1024], axis=0)."""
    rng = np.random.default_rng(0)
    x2 = rng.standard_normal((512, 128)).astype(np.float32)
    ridx = rng.integers(0, 512, size=(1024,)).astype(np.int32)
    xt, it = tensors(dev, x2, ridx)
    i64 = it.long()
    return _case("probe_pallas_gather2_rows",
                 "scripts/probe_pallas_gather2.py:22", dev,
                 lambda: x2[ridx], "rows", xt, it,
                 library=lambda: lambda: torch.index_select(xt, 0, i64))


# ---------------------------------------------------------------- probe 3

def _gather3_inputs():
    rng = np.random.default_rng(0)
    axis0 = []
    for S, L in ((8, 128), (256, 128), (512, 256)):
        x = rng.standard_normal((S, L)).astype(np.float32)
        ia = rng.integers(0, S, size=(S, L)).astype(np.int32)
        axis0.append((x, ia))
    x = rng.standard_normal((512, 128)).astype(np.float32)
    idx = rng.integers(0, 128, size=(16, 512, 128)).astype(np.int32)
    return axis0, x, idx


def _gather3_axis0(k, dev):
    x, ia = _gather3_inputs()[0][k]
    xt, it = tensors(dev, x, ia)
    i64 = it.long()
    S, L = x.shape
    return _case(f"probe_pallas_gather3_axis0_{S}x{L}",
                 "scripts/probe_pallas_gather3.py:23", dev,
                 lambda: np.take_along_axis(x, ia, axis=0), "axis0", xt, it,
                 library=lambda: lambda: torch.gather(xt, 0, i64))


def probe_pallas_gather3_axis0_8x128(dev):
    """The axis-0 take_along_axis retry at (8,128)."""
    return _gather3_axis0(0, dev)


def probe_pallas_gather3_axis0_256x128(dev):
    """The axis-0 take_along_axis retry at (256,128)."""
    return _gather3_axis0(1, dev)


def probe_pallas_gather3_axis0_512x256(dev):
    """The axis-0 take_along_axis retry at (512,256)."""
    return _gather3_axis0(2, dev)


def probe_pallas_gather3_kgather(dev):
    """kgather: Σ_{t<16} take_along_axis(v, idx[t], axis=1) at the first
    step of the script's chain, v = x·1e-3."""
    _, x, idx = _gather3_inputs()
    v = x * np.float32(1e-3)

    def emulate():
        acc = np.zeros((512, 128), np.float32)
        for t in range(16):
            acc = acc + np.take_along_axis(v, idx[t], axis=1)
        return acc

    vt, it = tensors(dev, v, idx)
    rows = torch.arange(512 * 128, device=dev).repeat(16)
    cols = (torch.arange(512, device=dev)[None, :, None] * 128
            + it.long()).reshape(-1)
    return _case("probe_pallas_gather3_kgather",
                 "scripts/probe_pallas_gather3.py:45", dev, emulate, "axis1",
                 vt, it, library=_sum_csr(rows, cols, (512 * 128, 512 * 128),
                                          vt))


# ---------------------------------------------------------------- probe 4

def _combo(name, replaces, idx_type, dev):
    S, G, t = 64, 16, 3
    rng = np.random.default_rng(0)
    win = rng.standard_normal((S, 128)).astype(np.float32)
    idx = rng.integers(0, 384, size=(G, 384)).astype(np.int32)

    def emulate():
        W2 = win[t:t + G + 2]
        SRC = np.concatenate([W2[0:G], W2[1:G + 1], W2[2:G + 2]], axis=1)
        return np.take_along_axis(SRC, idx, axis=1)

    wt, it = tensors(dev, win, idx.astype(idx_type))
    flat = ((t + torch.arange(G, device=dev)[:, None] + it.long() // 128)
            * 128 + it.long() % 128)
    return _case(name, replaces, dev, emulate, "window", wt, it, t=t,
                 library=lambda: lambda: torch.take(wt, flat))


def probe_pallas_gather4_i32(dev):
    """kernel: a dynamic 18-row slice of win at t = 3, the concat of its
    three shifted 16-row views into [16,384], and a lane gather."""
    return _combo("probe_pallas_gather4_i32",
                  "scripts/probe_pallas_gather4.py:26", np.int32, dev)


def probe_pallas_gather4_i16(dev):
    """kernel16: the same with int16 indices."""
    return _combo("probe_pallas_gather4_i16",
                  "scripts/probe_pallas_gather4.py:51", np.int16, dev)


# ---------------------------------------------------------------- probe 5

def _gather5_inputs():
    G = 16
    rng = np.random.default_rng(0)
    src = rng.standard_normal((G, 384)).astype(np.float32)
    idx = rng.integers(0, 384, size=(G, 384)).astype(np.int32)
    win = rng.standard_normal((64, 128)).astype(np.float32)
    idx_blk = np.concatenate([rng.integers(0, 384, size=(G, 128))
                              for _ in range(3)], axis=1).astype(np.int32)
    return src, idx, win, idx_blk


_G5 = "scripts/probe_pallas_gather5.py:22"


def probe_pallas_gather5_A(dev):
    """A: take_along_axis on [16,384], axis 1."""
    src, idx, _, _ = _gather5_inputs()
    st, it = tensors(dev, src, idx)
    i64 = it.long()
    return _case("probe_pallas_gather5_A", _G5, dev,
                 lambda: np.take_along_axis(src, idx, axis=1), "axis1", st,
                 it, library=lambda: lambda: torch.gather(st, 1, i64))


def probe_pallas_gather5_B(dev):
    """B: the dynamic sublane slice win[3:19]."""
    _, _, win, _ = _gather5_inputs()
    (wt,) = tensors(dev, win)
    return _case("probe_pallas_gather5_B", _G5, dev, lambda: win[3:19],
                 "window", wt, t=3, size=(16, 128),
                 library=lambda: lambda: torch.narrow_copy(wt, 0, 3, 16))


def probe_pallas_gather5_C(dev):
    """C: the concat of win's three shifted 16-row views."""
    _, _, win, _ = _gather5_inputs()
    (wt,) = tensors(dev, win)
    G = 16
    return _case("probe_pallas_gather5_C", _G5, dev,
                 lambda: np.concatenate([win[0:G], win[1:G + 1],
                                         win[2:G + 2]], axis=1),
                 "window", wt, t=0, size=(G, 384),
                 library=lambda: lambda: torch.cat(
                     [wt[0:G], wt[1:G + 1], wt[2:G + 2]], 1))


def probe_pallas_gather5_D(dev):
    """D: the [16,384] lane gather, then a[:, :128] + a[:, 128:256] +
    a[:, 256:]."""
    src, _, _, idx_blk = _gather5_inputs()

    def emulate():
        a = np.take_along_axis(src, idx_blk, axis=1)
        return a[:, 0:128] + a[:, 128:256] + a[:, 256:384]

    st, it = tensors(dev, src, idx_blk)
    rows = (torch.arange(16, device=dev)[:, None] * 128
            + torch.arange(384, device=dev) % 128).reshape(-1)
    cols = (torch.arange(16, device=dev)[:, None] * 384
            + it.long()).reshape(-1)
    return _case("probe_pallas_gather5_D", _G5, dev, emulate, "axis1", st, it,
                 blocks=3, library=_sum_csr(rows, cols, (16 * 128, 16 * 384),
                                            st))


# ---------------------------------------------------------------- probe 6

def _gather6_inputs():
    S, G, REPS = 224, 16, 64
    rng = np.random.default_rng(0)
    win = rng.standard_normal((S, 128)).astype(np.float32)
    R = rng.integers(0, S, (G, 128)).astype(np.int32)
    Cc = rng.integers(0, 128, (G, 128)).astype(np.int32)
    Rb = rng.integers(0, S, (REPS, G, 128)).astype(np.int32)
    Cb = rng.integers(0, 128, (REPS, G, 128)).astype(np.int32)
    return win, R, Cc, Rb, Cb


def _chain_np(win, R, C):
    return np.take_along_axis(np.take_along_axis(win, R, axis=0), C, axis=1)


def _chain_cols(Rt, Ct):
    """Flat index in win [S,128] of each chained pick."""
    return (torch.gather(Rt.long(), -1, Ct.long()) * 128
            + Ct.long()).reshape(-1)


def probe_gather6_A(dev):
    """A: axis-0 take_along_axis, win [224,128] by R [16,128]."""
    win, R, _, _, _ = _gather6_inputs()
    wt, rt = tensors(dev, win, R)
    r64 = rt.long()
    return _case("probe_gather6_A", "scripts/probe_gather6.py:26", dev,
                 lambda: np.take_along_axis(win, R, axis=0), "axis0", wt, rt,
                 library=lambda: lambda: torch.gather(wt, 0, r64))


def probe_gather6_B(dev):
    """B: the chained axis-0 then axis-1 take."""
    win, R, Cc, _, _ = _gather6_inputs()
    wt, rt, ct = tensors(dev, win, R, Cc)
    flat = _chain_cols(rt, ct).reshape(R.shape)
    return _case("probe_gather6_B", "scripts/probe_gather6.py:26", dev,
                 lambda: _chain_np(win, R, Cc), "chain", wt, rt, ct,
                 library=lambda: lambda: torch.take(wt, flat))


def probe_gather6_C(dev):
    """C: the [128,128] transpose of win[:128]."""
    win = _gather6_inputs()[0]
    (wt,) = tensors(dev, win[:128])
    return _case("probe_gather6_C", "scripts/probe_gather6.py:26", dev,
                 lambda: win[:128].T, "transpose", wt,
                 library=lambda: lambda: wt.t().contiguous())


def probe_gather6_D(dev):
    """D: Σ_{p<64} of the chained two-gathers by Rb[p], Cb[p]."""
    win, _, _, Rb, Cb = _gather6_inputs()

    def emulate():
        acc = np.zeros((16, 128), np.float32)
        for p in range(64):
            acc = acc + _chain_np(win, Rb[p], Cb[p])
        return acc

    wt, rt, ct = tensors(dev, win, Rb, Cb)
    rows = torch.arange(16 * 128, device=dev).repeat(64)
    return _case("probe_gather6_D", "scripts/probe_gather6.py:75", dev,
                 emulate, "chain", wt, rt, ct,
                 library=_sum_csr(rows, _chain_cols(rt, ct),
                                  (16 * 128, 224 * 128), wt))


def probe_gather6_E(dev):
    """E: Σ_{p<64} of axis-1 gathers of win[:16] by Cb[p]."""
    win, _, _, _, Cb = _gather6_inputs()
    w16 = win[0:16]

    def emulate():
        acc = np.zeros((16, 128), np.float32)
        for p in range(64):
            acc = acc + np.take_along_axis(w16, Cb[p], axis=1)
        return acc

    wt, ct = tensors(dev, w16, Cb)
    rows = torch.arange(16 * 128, device=dev).repeat(64)
    cols = (torch.arange(16, device=dev)[None, :, None] * 128
            + ct.long()).reshape(-1)
    return _case("probe_gather6_E", "scripts/probe_gather6.py:99", dev,
                 emulate, "axis1", wt, ct,
                 library=_sum_csr(rows, cols, (16 * 128, 16 * 128), wt))


CASES = {f.__name__: f for f in (
    probe_pallas_gather_k1, probe_pallas_gather_k2, probe_pallas_gather_k3,
    probe_pallas_gather_k4, probe_pallas_gather2_rows,
    probe_pallas_gather3_axis0_8x128, probe_pallas_gather3_axis0_256x128,
    probe_pallas_gather3_axis0_512x256, probe_pallas_gather3_kgather,
    probe_pallas_gather4_i32, probe_pallas_gather4_i16,
    probe_pallas_gather5_A, probe_pallas_gather5_B, probe_pallas_gather5_C,
    probe_pallas_gather5_D, probe_gather6_A, probe_gather6_B,
    probe_gather6_C, probe_gather6_D, probe_gather6_E)}
