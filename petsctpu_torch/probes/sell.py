"""The SELL probes (kernels H1 and H2), one case per TPU probe kernel of
scripts/probe_sell_bisect.py, probe_gather7.py, probe_sell2_compact.py,
probe_sell2_onehot.py, probe_sellx_crossed.py (= probe_gather8.py) and
the windowed SpMV of probe_pallas_gather2.py.

Each case draws its script's inputs from np.random.default_rng(0) in
the script's own order, so they equal the script's array for array, and
carries the script's numpy emulation of its kernel (for gather7, which
has none, one written the same way). The yardstick of each is torch.mv on
the CSR matrix of the pack (duplicates summed); the tile-mode cases at
bench scale also run K2 on the same data padded to its uniform layout."""

from __future__ import annotations

import numpy as np
import torch

from petsctpu_torch.ops.sell_pass import (pass_columns, sell_pass,
                                          sell_pass_plain)
from petsctpu_torch.ops.sell_spmv import sell_spmv
from petsctpu_torch.ops.window_spmv import window_spmv, window_spmv_plain
from petsctpu_torch.probes.common import (Case, csr, distinct, nbytes,
                                          tensors)

_OPT = ("qs", "qbase", "qoff", "hh", "i1")


def _passes(a):
    """Each pass of a sell_pass pack, as (tiles, their chunks, p, the
    flat x index of the pass's slots [n,G,128])."""
    nch, cstart, ws = a["nch"], a["cstart"], a["ws"]
    opt = {k: a.get(k) for k in _OPT}
    for c in range(int(nch.max())):
        tiles = torch.nonzero(nch > c).reshape(-1)
        ch = cstart[tiles].long() + c
        for p in range(a["vals"].shape[1]):
            yield tiles, ch, p, pass_columns(a["idx"], ws[tiles], ch, p,
                                             mode=a["mode"], **opt)


def _sell_csr(a):
    """The CSR matrix of a sell_pass pack: row (t,g,l) of y, column
    row·128 + j of x, duplicates summed."""
    G = a["vals"].shape[2]
    dev = a["vals"].device
    gl = (torch.arange(G, device=dev)[:, None] * 128
          + torch.arange(128, device=dev))
    rows, cols, data = [], [], []
    for tiles, ch, p, col in _passes(a):
        cols.append(col.reshape(-1))
        rows.append((tiles[:, None, None] * G * 128 + gl).reshape(-1))
        data.append(a["vals"][ch, p].reshape(-1))
    shape = (a["ws"].numel() * G * 128, a["xp"].numel())
    return csr(torch.cat(rows), torch.cat(cols), torch.cat(data), shape)


def _sell_bytes(a):
    """The bytes an H1 case must move: every array of the pack once,
    except that of x and of i1 only the elements this run's slots read,
    and y once."""
    xp, i1 = a["xp"], a.get("i1")
    G = a["vals"].shape[2]
    dev = xp.device
    xread = torch.zeros(xp.numel(), dtype=torch.bool, device=dev)
    i1read = None if i1 is None else torch.zeros(i1.numel(),
                                                 dtype=torch.bool, device=dev)
    g = torch.arange(G, device=dev)[None, :, None]
    for _, ch, p, col in _passes(a):
        xread[col.reshape(-1)] = True
        if i1read is not None:
            j = a["idx"][ch, p].long() & 127
            i1read[((ch[:, None, None] * 128 + j) * 128 + G * p + g)
                   .reshape(-1)] = True
    rest = nbytes(*(v for k, v in a.items()
                    if isinstance(v, torch.Tensor) and k not in ("xp", "i1")))
    return (rest + 4 * int(xread.sum())
            + (0 if i1read is None else int(i1read.sum()))
            + a["ws"].numel() * G * 128 * 4)


def _sell_case(name, replaces, dev, emulate, arrays, mode, k2=None):
    """An H1 case on the numpy arrays (vals, idx, xp, ws, cstart, nch and
    the mode's row arrays), moved to dev."""
    a = dict(zip(arrays, tensors(dev, *arrays.values())), mode=mode)
    args = [a[k] for k in ("vals", "idx", "xp", "ws", "cstart", "nch")]
    kw = {k: a.get(k) for k in _OPT} | {"mode": mode}
    P, G = a["vals"].shape[1:3]
    slots = int(arrays["nch"].sum()) * P * G * 128

    def library():
        A = _sell_csr(a)
        xf = a["xp"].reshape(-1)
        return lambda: torch.mv(A, xf)

    return Case(name=name, kernel="sell_pass", replaces=replaces,
                run=lambda: sell_pass(*args, **kw),
                plain=lambda: sell_pass_plain(*args, **kw),
                emulate=emulate, exact=False,
                nbytes=lambda: _sell_bytes(a),
                flops=2 * slots, library=library,
                k2=None if k2 is None else (lambda: k2(a)))


def _k2_padded(a):
    """K2 (diag mode) on a tile-mode pack, each tile's chunks laid end to
    end and padded with empty passes (value 0) to the longest tile."""
    vals, idx, qs = a["vals"], a["idx"], a["qs"]
    nch, cstart = a["nch"].long(), a["cstart"].long()
    NCH, PC, G = vals.shape[:3]
    nt, npc = nch.numel(), int(nch.max())
    dev = vals.device
    tile = torch.repeat_interleave(torch.arange(nt, device=dev), nch)
    slot = torch.arange(tile.numel(), device=dev) - \
        (torch.cumsum(nch, 0) - nch)[tile]
    ch = cstart[tile] + slot
    pv = torch.zeros((nt, npc, PC, G, 128), dtype=torch.float32, device=dev)
    pi = torch.zeros((nt, npc, PC, G, 128), dtype=torch.int8, device=dev)
    pq = torch.zeros((nt, npc, PC), dtype=torch.int32, device=dev)
    pv[tile, slot], pi[tile, slot], pq[tile, slot] = vals[ch], idx[ch], qs[ch]
    P = npc * PC
    pv, pi, pq = (pv.view(nt, P, G, 128), pi.view(nt, P, G, 128),
                  pq.view(nt, P))
    ws, xp = a["ws"], a["xp"]
    S = xp.shape[0] - int(ws.max())
    return lambda: sell_spmv(pv, pi, pq, ws, xp, G=G, S=S, mode="diag")


def _uniform(nt, n=1):
    """cstart, nch of nt tiles with n chunks each, laid end to end."""
    return (np.arange(nt) * n).astype(np.int32), np.full(nt, n, np.int32)


# ------------------------------------------------------------ bisect a-f

def _bisect_inputs():
    rng = np.random.default_rng(0)
    G, S, P, nt = 8, 64, 6, 4
    Lp = S + G * nt
    xp = rng.standard_normal((Lp, 128)).astype(np.float32)
    vals = rng.standard_normal((nt, P, G, 128)).astype(np.float32)
    idx8 = rng.integers(0, 128, (nt, P, G, 128)).astype(np.int8)
    qs = rng.integers(0, S - G, (nt, P)).astype(np.int32)
    winstart = (np.arange(nt) * G).astype(np.int32)
    return rng, xp, vals, idx8, qs, winstart


def _bisect_ref(xp, vals, idx, qs, ws, S):
    """The script's ref(): each pass's [G,128] window rows at qs, lane
    gathered, added into the tile's output."""
    nt, P, G = vals.shape[:3]
    out = np.zeros((nt, G, 128), np.float32)
    for t in range(nt):
        win = xp[ws[t]:ws[t] + S]
        for p in range(P):
            V = win[qs[t, p]:qs[t, p] + G]
            out[t] += vals[t, p] * np.take_along_axis(
                V, idx[t, p].astype(np.int64), axis=1)
    return out


def _bisect_step(step, dev):
    _, xp, vals, idx8, qs, winstart = _bisect_inputs()
    S, nt = 64, 4
    emulate = (lambda: _bisect_ref(xp, vals, idx8, qs, winstart, S))
    cstart, nch = _uniform(nt)
    if step in ("a", "b"):
        # the window delivered as an input block per tile
        wins = np.stack([xp[winstart[t]:winstart[t] + S] for t in range(nt)])
        arrays = dict(vals=vals, idx=idx8.astype(np.int32) if step == "a"
                      else idx8, xp=wins.reshape(nt * S, 128),
                      ws=(np.arange(nt) * S).astype(np.int32), cstart=cstart,
                      nch=nch, qs=qs)
        line = 71
    elif step == "c":
        arrays = dict(vals=vals, idx=idx8, xp=xp, ws=winstart, cstart=cstart,
                      nch=nch, qs=qs)
        line = 106
    else:
        # two chunks of 3 passes a tile, a partial sum each
        cstart, nch = _uniform(nt, 2)
        arrays = dict(vals=vals.reshape(nt * 2, 3, 8, 128),
                      idx=idx8.reshape(nt * 2, 3, 8, 128), xp=xp,
                      ws=winstart, cstart=cstart, nch=nch,
                      qs=qs.reshape(nt * 2, 3))
        line = 160
    return _sell_case(f"probe_sell_bisect_{step}",
                      f"scripts/probe_sell_bisect.py:{line}", dev, emulate,
                      arrays, "tile")


def _bisect_small(step, dev):
    """Steps e and f: one tile, unaligned qs, a window of 23 or 24 rows."""
    rng = _bisect_inputs()[0]
    G2, S2, P2, nt2 = 8, (24 if step == "f" else 23), 14, 1
    xp2 = rng.standard_normal((S2, 128)).astype(np.float32)
    vals2 = rng.standard_normal((nt2, P2, G2, 128)).astype(np.float32)
    idx2 = rng.integers(0, 128, (nt2, P2, G2, 128)).astype(np.int8)
    qs2 = rng.integers(1, S2 - G2, (nt2, P2)).astype(np.int32)
    ws2 = np.zeros(nt2, np.int32)
    cstart, nch = _uniform(nt2)
    arrays = dict(vals=vals2, idx=idx2, xp=xp2, ws=ws2, cstart=cstart,
                  nch=nch, qs=qs2)
    return _sell_case(f"probe_sell_bisect_{step}",
                      "scripts/probe_sell_bisect.py:208", dev,
                      lambda: _bisect_ref(xp2, vals2, idx2, qs2, ws2, S2),
                      arrays, "tile")


def probe_sell_bisect_a(dev):
    """Step a: tile rows, window as an input block, int32 idx."""
    return _bisect_step("a", dev)


def probe_sell_bisect_b(dev):
    """Step b: as a, int8 idx."""
    return _bisect_step("b", dev)


def probe_sell_bisect_c(dev):
    """Step c: the window copied from x at winstart."""
    return _bisect_step("c", dev)


def probe_sell_bisect_d(dev):
    """Step d: as c, in 2 chunks of 3 passes, a partial sum each."""
    return _bisect_step("d", dev)


def probe_sell_bisect_e(dev):
    """Step e: one tile, unaligned qs, a 23-row window."""
    return _bisect_small("e", dev)


def probe_sell_bisect_f(dev):
    """Step f: as e, a 24-row window."""
    return _bisect_small("f", dev)


# ------------------------------------------------------------- gather7

def _gather7_inputs():
    rng = np.random.default_rng(0)
    G, S = 16, 224
    NT, P = 128, 96
    vals = rng.standard_normal((NT, P, G, 128)).astype(np.float32)
    idx = rng.integers(0, 128, (NT, P, G, 128)).astype(np.int8)
    qs = rng.integers(0, S - G, (NT, P)).astype(np.int32)
    qg = rng.integers(0, S - G, (NT, P, G)).astype(np.int32)
    qbase = np.minimum(qg.min(axis=2), S - 32).astype(np.int32)
    qoff = np.minimum(qg - qbase[:, :, None], 31).astype(np.int32)
    xp = rng.standard_normal((S + 64, 128)).astype(np.float32)
    return vals, idx, qs, qg, qbase, qoff, xp


def _gather7_emulation(vals, idx, xp, rows):
    """Σ_p vals·take_along_axis(win[rows(p)], idx, axis=1) over the
    window win = xp[0:224], with rows(p) [NT,G] the rows of pass p."""
    win = xp[:224]
    NT, P, G = vals.shape[:3]
    out = np.zeros((NT, G, 128), np.float32)
    for p in range(P):
        V = win[rows(p)]                                     # [NT, G, 128]
        out = out + vals[:, p] * np.take_along_axis(
            V, idx[:, p].astype(np.int64), axis=2)
    return out


def _gather7(variant, dev):
    vals, idx, qs, qg, qbase, qoff, xp = _gather7_inputs()
    NT = vals.shape[0]
    g = np.arange(16)
    cstart, nch = _uniform(NT)
    arrays = dict(vals=vals, idx=idx, xp=xp, ws=np.zeros(NT, np.int32),
                  cstart=cstart, nch=nch)
    if variant == "base":
        arrays["qs"] = qs
        rows = (lambda p: qs[:, p, None] + g)
    elif variant == "V1":
        arrays["qoff"] = qg
        rows = (lambda p: qg[:, p])
    else:
        arrays |= dict(qbase=qbase, qoff=qoff)
        rows = (lambda p: qbase[:, p, None] + qoff[:, p])
    return _sell_case(f"probe_gather7_{variant}",
                      "scripts/probe_gather7.py:48", dev,
                      lambda: _gather7_emulation(vals, idx, xp, rows), arrays,
                      "tile" if variant == "base" else "group",
                      k2=_k2_padded if variant == "base" else None)


def probe_gather7_base(dev):
    """k_base: tile rows qs[t,p] + g (one G-row slice a pass)."""
    return _gather7("base", dev)


def probe_gather7_V1(dev):
    """k_slices: per-group rows qg[t,p,g] (16 one-row slices a pass)."""
    return _gather7("V1", dev)


def probe_gather7_V2(dev):
    """k_onehot: rows qbase[t,p] + qoff[t,p,g], a one-hot [G,32] product
    over a 32-row sub-window on the TPU, an exact row select."""
    return _gather7("V2", dev)


# --------------------------------------------------- compacted streams

def _compact_inputs():
    rng = np.random.default_rng(0)
    G, NT, SW, PC = 16, 256, 224, 24
    Pt = rng.integers(70, 134, NT)
    nch_t = np.ceil(Pt / PC).astype(np.int64)
    chunk_start = np.zeros(NT + 1, np.int64)
    np.cumsum(nch_t, out=chunk_start[1:])
    NCHT = int(chunk_start[-1])
    vals = rng.standard_normal((NCHT, PC, G, 128)).astype(np.float32)
    J = rng.integers(0, 128, (NCHT, PC, G, 128)).astype(np.int8)
    qs = rng.integers(0, SW - G, (NCHT, PC)).astype(np.int32)
    ws = (rng.integers(0, 8, NT) * 8).astype(np.int32)
    xp = rng.standard_normal(((int(ws.max()) + SW + 8), 128)) \
        .astype(np.float32)
    return (vals, J, xp, ws, chunk_start[:-1].astype(np.int32),
            nch_t.astype(np.int32), qs)


def probe_sell2_compact(dev):
    """The compacted chunk stream: tile t takes nch[t] chunks of 24
    passes from cstart[t], tile rows qs[ch,p] + g."""
    vals, J, xp, ws, cstart, nch, qs = _compact_inputs()
    G, SW, PC = 16, 224, 24

    def emulate():
        ref = np.zeros((ws.size, G, 128), np.float32)
        for t in range(ws.size):
            win = xp[ws[t]:ws[t] + SW]
            for c in range(int(nch[t])):
                chn = int(cstart[t]) + c
                for p in range(PC):
                    V = win[qs[chn, p]:qs[chn, p] + G]
                    ref[t] += vals[chn, p] * np.take_along_axis(
                        V, J[chn, p].astype(np.int64), axis=1)
        return ref

    arrays = dict(vals=vals, idx=J, xp=xp, ws=ws, cstart=cstart, nch=nch,
                  qs=qs)
    return _sell_case("probe_sell2_compact",
                      "scripts/probe_sell2_compact.py:90", dev, emulate,
                      arrays, "tile", k2=_k2_padded)


def _onehot_inputs():
    rng = np.random.default_rng(0)
    G, WSUB, NT, SW, PC = 16, 64, 256, 256, 24
    Pt = rng.integers(56, 88, NT)
    Pt = (np.ceil(Pt / 8) * 8).astype(np.int64)
    nch_t = np.ceil(Pt / PC).astype(np.int64)
    chunk_start = np.zeros(NT + 1, np.int64)
    np.cumsum(nch_t, out=chunk_start[1:])
    NCHT = int(chunk_start[-1])
    vals = rng.standard_normal((NCHT, PC, G, 128)).astype(np.float32)
    J = rng.integers(0, 128, (NCHT, PC, G, 128)).astype(np.int8)
    qoff = rng.integers(0, WSUB, (NCHT, PC, G)).astype(np.int8)
    qbase = (rng.integers(0, (SW - WSUB) // 8, NCHT) * 8).astype(np.int32)
    ws = (rng.integers(0, 8, NT) * 8).astype(np.int32)
    xp = rng.standard_normal(((int(ws.max()) + SW + 8), 128)) \
        .astype(np.float32)
    return (vals, J, xp, ws, chunk_start[:-1].astype(np.int32),
            nch_t.astype(np.int32), qoff, qbase)


def probe_sell2_onehot(dev):
    """The compacted stream with group rows qbase[ch] + qoff[ch,p,g]
    (int8 qoff in a 64-row sub-window, a one-hot product on the TPU)."""
    vals, J, xp, ws, cstart, nch, qoff, qbase = _onehot_inputs()
    WSUB, SW, PC = 64, 256, 24

    def emulate():
        ref = np.zeros((ws.size, 16, 128), np.float32)
        for t in range(ws.size):
            win = xp[ws[t]:ws[t] + SW]
            for c in range(int(nch[t])):
                ch = int(cstart[t]) + c
                W = win[qbase[ch]:qbase[ch] + WSUB]
                V_all = W[qoff[ch].reshape(-1).astype(np.int64)]
                for p in range(PC):
                    V = V_all[16 * p:16 * p + 16]
                    ref[t] += vals[ch, p] * np.take_along_axis(
                        V, J[ch, p].astype(np.int64), axis=1)
        return ref

    arrays = dict(vals=vals, idx=J, xp=xp, ws=ws, cstart=cstart, nch=nch,
                  qbase=qbase, qoff=qoff)
    return _sell_case("probe_sell2_onehot",
                      "scripts/probe_sell2_onehot.py:114", dev, emulate,
                      arrays, "group")


# -------------------------------------------------------------- SELL-X

def probe_sellx_crossed(dev):
    """SELL-X: slot (c,p,g,l) with J = J[t,c,p,g,l] reads
    win[128·hh[t,c] + I1[t,c][J, 16p+g], J]."""
    rng = np.random.default_rng(0)
    G, PC, NT, NCH, SW = 16, 8, 128, 5, 256
    vals = rng.standard_normal((NT, NCH, PC, G, 128)).astype(np.float32)
    J = rng.integers(0, 128, (NT, NCH, PC, G, 128)).astype(np.int8)
    I1 = rng.integers(0, 128, (NT, NCH, 128, 128)).astype(np.int8)
    hh = rng.integers(0, 2, (NT, NCH)).astype(np.int32)
    ws = (rng.integers(0, 8, NT) * 8).astype(np.int32)
    x = rng.standard_normal(((int(ws.max()) + SW + 8) * 128,)) \
        .astype(np.float32)
    xp = x.reshape(-1, 128)

    def emulate():
        ref = np.zeros((NT, G, 128), np.float32)
        for t in range(NT):
            win = xp[ws[t]:ws[t] + SW]
            for c in range(NCH):
                T = win[128 * hh[t, c]:128 * hh[t, c] + 128].T
                U = np.take_along_axis(T, I1[t, c].astype(np.int64), axis=1)
                Ut = U.T
                for p in range(PC):
                    V = Ut[16 * p:16 * p + 16]
                    ref[t] += vals[t, c, p] * np.take_along_axis(
                        V, J[t, c, p].astype(np.int64), axis=1)
        return ref

    cstart, nch = _uniform(NT, NCH)
    arrays = dict(vals=vals.reshape(NT * NCH, PC, G, 128),
                  idx=J.reshape(NT * NCH, PC, G, 128), xp=xp, ws=ws,
                  cstart=cstart, nch=nch, hh=hh.reshape(-1),
                  i1=I1.reshape(NT * NCH, 128, 128))
    return _sell_case("probe_sellx_crossed",
                      "scripts/probe_sellx_crossed.py:110 = "
                      "scripts/probe_gather8.py:110", dev, emulate, arrays,
                      "crossed")


# ------------------------------------------------------ windowed SpMV

def probe_pallas_gather2_window(dev):
    """The windowed scalar SELL SpMV (kernel H2): y[i] = Σ_k vals[i,k]·
    x[starts[i//Rb] + 128·q[i,k] + r[i,k]]."""
    rng = np.random.default_rng(0)
    rng.standard_normal((512, 128))                 # the row-gather probe's
    rng.integers(0, 512, size=(1024,))              # inputs, drawn first
    n, K, W, Rb = 131072, 32, 65536, 2048
    nb = n // Rb
    q = rng.integers(0, W // 128, size=(n, K)).astype(np.int32)
    r = rng.integers(0, 128, size=(n, K)).astype(np.int32)
    vals = rng.standard_normal((n, K)).astype(np.float32)
    starts = (rng.integers(0, 2, size=(nb,)) * 128).astype(np.int32)
    x = rng.standard_normal(n + W + 256).astype(np.float32)

    def emulate():
        gidx = (starts[:, None, None].repeat(Rb, 1).reshape(n, 1)
                + q * 128 + r)
        return (vals * x[gidx]).sum(axis=1)

    st, qt, rt, vt, xt = tensors(dev, starts, q, r, vals, x)

    def cols():
        return (st.long().repeat_interleave(Rb)[:, None] + 128 * qt.long()
                + rt.long()).reshape(-1)

    def library():
        rows = torch.arange(n, device=dev).repeat_interleave(K)
        A = csr(rows, cols(), vt.reshape(-1), (n, x.size))
        return lambda: torch.mv(A, xt)

    return Case(name="probe_pallas_gather2_window", kernel="window_spmv",
                replaces="scripts/probe_pallas_gather2.py:81",
                run=lambda: window_spmv(st, qt, rt, vt, xt, Rb=Rb),
                plain=lambda: window_spmv_plain(st, qt, rt, vt, xt, Rb=Rb),
                emulate=emulate, exact=False,
                nbytes=lambda: (nbytes(st, qt, rt, vt) + 4 * n
                                + 4 * distinct(cols(), x.size)),
                flops=2 * n * K,
                library=library)


CASES = {f.__name__: f for f in (
    probe_sell_bisect_a, probe_sell_bisect_b, probe_sell_bisect_c,
    probe_sell_bisect_d, probe_sell_bisect_e, probe_sell_bisect_f,
    probe_gather7_base, probe_gather7_V1, probe_gather7_V2,
    probe_sell2_compact, probe_sell2_onehot, probe_sellx_crossed,
    probe_pallas_gather2_window)}
