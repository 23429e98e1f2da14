"""SellMat — sliced-ELL SpMV with source-slice passes, on the card.

The layout is petsctpu/mat/sell.py's, and the host plan below is a copy
of it, so the two packages pack the same operator into the same bytes:

  * rows are tiled in blocks of C = G*128 (g = row group, l = lane);
    each tile owns a contiguous x-window starting at padded row
    winstart[t];
  * a nonzero (row = (g, l), col = X) needs x[X], which lives in
    window row q + g ("diag" mode) for the unique
    q = row_of(X) - winstart - g; nonzeros are bucketed by q;
  * a PASS = (one bucket q, at most one slot per row): every row reads
    one x entry at the int8 in-chunk position idx;
  * y[g, l] = sum over passes of vals * x, in pass order.

"chunk" mode buckets by the absolute chunk and reads one window row
for all G row groups — the shape for rectangular operators (MG
transfers).

The product is kernel K2 (`petsctpu_torch/ops/sell_spmv.py`, CUDA
source `petsctpu_torch/csrc/sell_spmv.cu`); the chunk-mode transpose
product (the MG restriction through a stored prolongator) is kernel K3
(`petsctpu_torch/ops/sell_spmvT.py`, `petsctpu_torch/csrc/sell_spmvT.cu`),
a gather over a transpose plan that the matrix builds from its pack
once and keeps. The window start stays
1024-aligned as in the JAX package (only the TPU's DMA needs it) so the
packs of the two packages match byte for byte.

fp32 only (the performance path); fp64 callers use AIJ.
"""

from __future__ import annotations

import numpy as np
import scipy.sparse as sp
import torch

from petsctpu_torch.device import resolve_device
from petsctpu_torch.ops.sell_spmv import sell_spmv
from petsctpu_torch.ops.sell_spmvT import sell_spmvT, transpose_plan


class SellMat:
    """vals [nt, P, G, 128] f32; idx [nt, P, G, 128] int8 (position in
    a 128 chunk); qs [nt, P] int32 (window-slice row per pass);
    winstart [nt] int32 (window start row into the G-row-padded x);
    diag [n] f32."""

    def __init__(self, vals, idx, qs, winstart, diag, shape, nnz=0, G=16,
                 S=512, Lp=0, mode="diag"):
        self.vals = vals
        self.idx = idx
        self.qs = qs
        self.winstart = winstart
        self.diag = diag
        self.shape = tuple(shape)
        self.nnz = nnz
        self.G = G
        self.S = S          # window rows
        self.Lp = Lp        # padded x rows
        self.mode = mode
        self._tplan = None  # K3's transpose plan, built at first use

    @property
    def dtype(self):
        return self.vals.dtype

    @property
    def device(self):
        return self.vals.device

    @property
    def nt(self):
        return self.vals.shape[0]

    @property
    def npass(self):
        return self.vals.shape[1]

    def pad_operand(self, x: torch.Tensor) -> torch.Tensor:
        """The kernel's x operand: x at padded row G of a zero
        [Lp, 128] buffer."""
        xp = torch.zeros(self.Lp * 128, dtype=self.dtype, device=self.device)
        off = self.G * 128
        xp[off:off + self.shape[1]] = x.reshape(-1).to(self.dtype)
        return xp.view(self.Lp, 128)

    def mult(self, x: torch.Tensor) -> torch.Tensor:
        """y = A x."""
        y = sell_spmv(self.vals, self.idx, self.qs, self.winstart,
                      self.pad_operand(x), G=self.G, S=self.S, mode=self.mode)
        return y.reshape(-1)[:self.shape[0]]

    def transpose_plan(self):
        """K3's plan of Aᵀ (ops/sell_spmvT.py::transpose_plan), built on
        the matrix's device at the first call and kept. Chunk mode only."""
        if self.mode != "chunk":
            raise NotImplementedError("SellMat.multT: chunk mode only")
        if self._tplan is None:
            self._tplan = transpose_plan(self.vals, self.idx, self.qs,
                                         self.winstart, S=self.S, Lp=self.Lp)
        return self._tplan

    def multT(self, r: torch.Tensor) -> torch.Tensor:
        """y = Aᵀ r for chunk-mode operators (the MG restriction R = Pᵀ
        run through P's own layout, MatMultTranspose on the stored
        prolongator): K3 over the transpose plan, gathering r."""
        plan = self.transpose_plan()
        y = sell_spmvT(plan, r.reshape(-1).to(self.dtype).contiguous())
        off = self.G * 128
        return y.reshape(-1)[off:off + self.shape[1]]

    def diagonal(self) -> torch.Tensor:
        return self.diag

    def flops_per_mult(self) -> float:
        return 2.0 * self.nnz - self.shape[0]


def _plan(A: sp.csr_matrix, G: int, mode: str = "diag"):
    """Host plan: bucket nonzeros by window-slice row, lay out passes.
    mode="chunk" buckets by the absolute chunk (see SellMat.mode)."""
    C = G * 128
    n = A.shape[0]
    nt = -(-n // C)
    if not A.has_sorted_indices:
        A = A.sorted_indices()
    coo = A.tocoo()
    rows = coo.row.astype(np.int64)
    cols = coo.col.astype(np.int64)
    data = coo.data
    t = rows // C
    g = (rows % C) // 128
    lane = rows % 128

    # per-tile window start, 8*128-aligned as in petsctpu (its TPU
    # window copy needs the alignment; kept so the packs match)
    wmin = np.full(nt, 2**62, np.int64)
    if len(cols):
        np.minimum.at(wmin, t, cols)
    wmin[wmin == 2**62] = 0
    wmin = (wmin // 1024) * 1024

    q = (cols - wmin[t]) // 128                # window-relative chunk
    if mode == "diag":
        q = q - g                              # in [-(G-1), ...]
    pos = (cols - wmin[t]) % 128

    # order by (tile, bucket q, row, col) and rank within each row's
    # bucket: the entries come by (row, col), so a stable sort by
    # (tile, q) is petsctpu's lexsort
    q0 = int(q.min()) if len(q) else 0
    span = int(q.max()) - q0 + 1 if len(q) else 1
    order = np.argsort(t * span + (q - q0), kind="stable")
    ts, qs_, rs = t[order], q[order], rows[order]
    new_run = np.ones(len(order), bool)
    new_run[1:] = (ts[1:] != ts[:-1]) | (qs_[1:] != qs_[:-1]) \
        | (rs[1:] != rs[:-1])
    run_id = np.cumsum(new_run) - 1
    first_idx = np.flatnonzero(new_run)
    rank = np.arange(len(order)) - first_idx[run_id]

    # per (tile, q) bucket: passes = max rank + 1
    new_bucket = np.ones(len(order), bool)
    new_bucket[1:] = (ts[1:] != ts[:-1]) | (qs_[1:] != qs_[:-1])
    b_id = np.cumsum(new_bucket) - 1
    nb = int(b_id[-1]) + 1 if len(b_id) else 0
    b_t = ts[new_bucket] if nb else np.zeros(0, np.int64)
    b_q = qs_[new_bucket] if nb else np.zeros(0, np.int64)
    b_m = np.zeros(nb, np.int64)
    if nb:
        np.maximum.at(b_m, b_id, rank)
        b_m += 1

    # within-tile pass offsets: buckets are already tile-ordered
    # (b_t is non-decreasing), so a running cumsum reset per tile works
    bucket_pass0 = np.zeros(nb, np.int64)
    P_t = np.zeros(nt, np.int64)
    if nb:
        cum = np.cumsum(b_m) - b_m
        first_of_tile = np.ones(nb, bool)
        first_of_tile[1:] = b_t[1:] != b_t[:-1]
        tile_base = np.zeros(nt, np.int64)
        tile_base[b_t[first_of_tile]] = cum[first_of_tile]
        bucket_pass0 = cum - tile_base[b_t]
        np.add.at(P_t, b_t, b_m)
    P = max(int(P_t.max()) if nt else 1, 1)
    pass_of = (bucket_pass0[b_id] + rank) if nb else np.zeros(0, np.int64)

    # window rows: diag reads reach q + g, chunk reads reach q;
    # slices need qs_pass + G <= S. S is a multiple of 8, as in
    # petsctpu.
    qg_max = int((qs_ + (g[order] if mode == "diag" else 0)).max()) \
        if len(order) else 0
    q_max = int(qs_.max()) if len(order) else 0
    S = max(qg_max + G + 1, q_max + 2 * G, 2 * G)
    S = -(-S // 8) * 8

    avg_row = A.nnz / max(n, 1)
    slop = P / max(avg_row, 1e-9) if A.nnz else 1.0
    return dict(C=C, nt=nt, order=order, t=ts, g=g[order],
                lane=lane[order],
                pos=pos[order], data=data[order], q=qs_, pass_of=pass_of,
                P=P, wmin=wmin, S=S,
                K=int(np.diff(A.indptr).max()) if n else 0,
                slop=float(slop))


def sell_plan_stats(A, G: int = 16, mode: str = "diag"):
    """(npass, ell_width, window_rows, slop = npass/avg_row_nnz)."""
    m = _plan(sp.csr_matrix(A), G, mode)
    return m["P"], m["K"], m["S"], m["slop"]


def _viable(m, max_span_rows: int, max_slop: float) -> bool:
    return m["S"] <= max_span_rows and m["slop"] <= max_slop


def sell_viable(A, G: int = 16, max_span_rows: int = 8192,
                max_slop: float = 8.0) -> bool:
    A = sp.csr_matrix(A)
    if A.shape[0] < G * 128:
        return False
    return _viable(_plan(A, G), max_span_rows, max_slop)


def _fp32_summed(A) -> sp.csr_matrix:
    A = sp.csr_matrix(A).astype(np.float32)
    A.sum_duplicates()
    return A


def _pack(A: sp.csr_matrix, m: dict, G: int, max_span_rows: int,
          force: tuple, mode: str):
    """sell_pack of the fp32, duplicate-free A from its plan m."""
    n = A.shape[0]
    nt, P, S = m["nt"], m["P"], m["S"]
    if S > max_span_rows:
        raise ValueError(f"window span {S} rows exceeds cap "
                         f"{max_span_rows}; RCM-order or use ELL")
    if force is not None:
        P = max(P, force[0])
        S = -(-max(S, force[1]) // 8) * 8
    vals = np.zeros((nt, P, G, 128), np.float32)
    idx = np.zeros((nt, P, G, 128), np.int8)
    qs = np.zeros((nt, P), np.int64)
    vals[m["t"], m["pass_of"], m["g"], m["lane"]] = m["data"]
    idx[m["t"], m["pass_of"], m["g"], m["lane"]] = m["pos"]
    qs[m["t"], m["pass_of"]] = m["q"]
    # padded-x coordinates: x sits at row G of the padded buffer, so
    # buffer row 0 of a window = original row wmin/128 - G maps to
    # padded row wmin/128; slice rows get the same +G offset
    qs = (qs + G).astype(np.int32)
    winstart = (m["wmin"] // 128).astype(np.int32)
    # Lp must cover the padded OPERAND x (shape[1] entries at offset
    # G*128) — rectangular operators (MG transfers) have ncols != n
    Lp = int(max(winstart.max() + S if nt else S,
                 -(-A.shape[1] // 128) + G + 1))
    if force is not None:
        Lp = max(Lp, force[2])
    dg = A.diagonal().astype(np.float32)
    if dg.shape[0] < n:                       # rectangular operator
        dg = np.pad(dg, (0, n - dg.shape[0]))
    return (dict(vals=vals, idx=idx, qs=qs, winstart=winstart,
                 diag=dg),
            dict(shape=(n, A.shape[1]), nnz=int(A.nnz), G=G, S=S,
                 Lp=Lp, mode=mode))


def sell_pack(A, G: int = 16, max_span_rows: int = 8192,
              force: tuple = None, mode: str = "diag"):
    """Host-side SELL pack (no device transfers): returns
    (arrays dict {vals f32, idx i8, qs i32, winstart i32, diag f32},
    statics dict {shape, nnz, G, S, Lp, mode}) — the single source of
    the layout; sell_from_scipy wraps it with transfers.

    force=(npass, S, Lp) pads the static dimensions to at least these
    values so packs of different local blocks can be stacked (the
    MPIAIJ diag-block route)."""
    A = _fp32_summed(A)
    return _pack(A, _plan(A, G, mode), G, max_span_rows, force, mode)


def sell_pack_cheapest(A, candidates):
    """The pack (sell_pack's pair) of A with the fewest padded slots
    among `candidates` ((G, mode) pairs), or None when none keeps its
    window within 8192 rows or the cheapest pads more than 8 slots per
    average row — petsctpu's cost test (pc/mg.py), shared by its packed
    and non-packed MG branches. Each candidate is planned once."""
    A = _fp32_summed(A)
    n = A.shape[0]
    best = None
    for G, mode in candidates:
        if n < G * 128:
            continue
        m = _plan(A, G, mode)
        cost = m["nt"] * m["P"] * G * 128
        if m["S"] <= 8192 and (best is None or cost < best[0]):
            best = (cost, G, mode, m)
    if best is None or best[0] > 8 * max(A.nnz / max(n, 1), 1e-9) * n:
        return None
    _, G, mode, m = best
    return _pack(A, m, G, 8192, None, mode)


def sell_from_scipy(A, G: int = 16, max_span_rows: int = 8192,
                    force: tuple = None, mode: str = "diag",
                    device=None) -> SellMat:
    """Build a SellMat (fp32). Raises ValueError when the window span
    exceeds the cap — callers should RCM-order first and fall back to
    AIJ when not viable. See sell_pack for `force`."""
    from petsctpu_torch.convert import sell_from_arrays

    dev = resolve_device(device)
    arrs, st = sell_pack(A, G=G, max_span_rows=max_span_rows, force=force,
                         mode=mode)
    return sell_from_arrays(arrs, st, device=dev)


def sell_if_viable(A, device=None):
    """sell_from_scipy(A) when sell_viable(A), both at their defaults,
    else None; A is planned once."""
    from petsctpu_torch.convert import sell_from_arrays

    dev = resolve_device(device)
    A = _fp32_summed(A)
    if A.shape[0] < 16 * 128:
        return None
    m = _plan(A, 16)
    if not _viable(m, 8192, 8.0):
        return None
    return sell_from_arrays(*_pack(A, m, 16, 8192, None, "diag"),
                            device=dev)


def sell_to_scipy(M: SellMat) -> sp.csr_matrix:
    """Back to scipy CSR, from the packed arrays (drops the padding
    slots, whose value is 0, and any explicit zero)."""
    vals = M.vals.cpu().numpy()
    idx = M.idx.cpu().numpy()
    qs = M.qs.cpu().numpy().astype(np.int64)
    ws = M.winstart.cpu().numpy().astype(np.int64)
    t, p, g, lane = np.nonzero(vals)
    chunk = ws[t] + qs[t, p] - M.G + (g if M.mode == "diag" else 0)
    cols = chunk * 128 + idx[t, p, g, lane]
    rows = (t * M.G + g) * 128 + lane
    return sp.csr_matrix((vals[t, p, g, lane], (rows, cols)), shape=M.shape)


# ---------------------------------------------------------------------------
# frozen-pattern templates: numeric refill on the device
# ---------------------------------------------------------------------------
def sell_template(A, G: int = 16, max_span_rows: int = 8192, device=None):
    """(template SellMat, pos, diag_idx): the symbolic side of the
    format, built once from a pattern; sell_fill(tmpl, pos, diag_idx,
    data) then rebuilds the numeric matrix on the device from a
    sorted-CSR data vector (the MatAssembly symbolic/numeric split the
    GAMG device refresh needs; the reference re-runs host assembly per
    refresh, gamg.c:533). Diag mode, as petsctpu's.

    pos: int32 [nnz] flat slot of each sorted-CSR entry in the
    [nt, P, G, 128] value array. diag_idx: int32 [n] sorted-CSR data
    index of each diagonal entry (a missing diagonal points at an
    appended zero)."""
    from petsctpu_torch.convert import sell_from_arrays

    A = _fp32_summed(A)
    n = A.shape[0]
    m = _plan(A, G)
    tmpl = sell_from_arrays(*_pack(A, m, G, max_span_rows, None, "diag"),
                            device=resolve_device(device))
    # the plan's order[k] is the CSR entry of plan slot k (A is
    # canonical), so pos maps CSR data order -> flat slots
    flat = ((m["t"] * m["P"] + m["pass_of"]) * G + m["g"]) * 128 \
        + m["lane"]
    pos = np.empty(A.nnz, np.int64)
    pos[m["order"]] = flat
    diag_idx = np.full(n, A.nnz, np.int64)      # sentinel -> appended 0
    rr = np.repeat(np.arange(n), np.diff(A.indptr))
    isd = rr == A.indices
    diag_idx[rr[isd]] = np.flatnonzero(isd)
    dev = tmpl.device
    return (tmpl, torch.from_numpy(pos.astype(np.int32)).to(dev),
            torch.from_numpy(diag_idx.astype(np.int32)).to(dev))


def sell_fill(tmpl: SellMat, pos, diag_idx, data) -> SellMat:
    """Numeric refill of a SELL template from sorted-CSR data, on the
    template's device: one scatter to distinct slots (deterministic) and
    a gather of the diagonal. The pattern arrays are the template's."""
    d32 = data.to(torch.float32)
    flat = d32.new_zeros(tmpl.vals.numel())
    flat[pos] = d32
    dpad = torch.cat([d32, d32.new_zeros(1)])
    return SellMat(flat.view(tmpl.vals.shape), tmpl.idx, tmpl.qs,
                   tmpl.winstart, dpad[diag_idx], tmpl.shape, tmpl.nnz,
                   tmpl.G, tmpl.S, tmpl.Lp, tmpl.mode)
