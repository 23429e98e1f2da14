"""The level-scheduled sparse triangular solve, a CUDA kernel written by
hand for Hopper.

Replaces petsctpu/mat/factor.py::SpTRSVPlan.solve (XLA code in the
reference: one `fori_loop` over levels, vmapped over bjacobi/ASM
subdomains) for every sparse triangle of the port: LU, ILU, ICC, SOR
and each bjacobi/ASM subdomain, nb stacked plans in one launch; and,
for an LU-type apply, both triangles in one launch (`sptrsv_lu`). The
CUDA source, with its design and bound, is
`petsctpu_torch/csrc/sptrsv.cu`; it is built by nvcc into
`petsctpu_torch/_build/` at first use and called through ctypes.

Both read a plan in level order (`level_order`, derived once a plan on
the host) and, in the cluster-smem shape, its (level, rank) segments
(`segments`): the plan on the device is those arrays alone. `sptrsv`
and `sptrsv_lu` launch the kernel for CUDA tensors (or raise) and take
the plain PyTorch versions `sptrsv_plain` and `sptrsv_lu_plain` only
for tensors on the CPU. Both fold a row's slots in slot order from 0
with a separate multiply and add, subtract the sum from b and multiply
by 1/diag last, so on the card they agree bit for bit. `sptrsv.launches`
and `sptrsv_lu.launches` count kernel launches.
"""

from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from petsctpu_torch.ops import _build

# the kernel's launch shapes (csrc/sptrsv.cu), as launch_shape picks them
SHAPES = {"block": 0, "cluster": 1, "grid": 2, "block-smem": 3,
          "cluster-smem": 4, "cluster16-smem": 5}
SMEM_SHAPES = ("block-smem", "cluster-smem", "cluster16-smem")
BLOCK_ROWS = 1024     # the most threads a block
CLUSTER = 8           # blocks a cluster, the ranks of a plan's rows
CLUSTER16 = 16        # the fused solve's wider cluster (non-portable)
STAGES = 4            # levels of the plan in the shared shapes' ring
SLOTS = 4             # slots a row in the ring (K > SLOTS: none there)
SLACK = 16            # bytes readable past a plan array's end (the ring
                      # copies whole 16-byte units)
_DTYPES = (torch.float32, torch.float64)
# cudaErrorStreamCaptureUnsupported: a shared shape's first launch on a
# device sets its shared-memory limit, which a graph capture refuses
_CAPTURED = 900


def consumers_for(rows: int) -> int:
    """The shared shapes' consumer threads for levels of `rows` rows: a
    warp's multiple, at most BLOCK_ROWS less the producer warp (a block
    is its consumers and one producer warp)."""
    most = BLOCK_ROWS - 32
    return most if rows >= most else -(-rows // 32) * 32


def ranks_of(shape: str) -> int:
    """The blocks of a cluster that share a plan's x in a shared shape."""
    return {"cluster-smem": CLUSTER, "cluster16-smem": CLUSTER16}.get(
        shape, 1)


def _up16(b: int) -> int:
    return -(-b // 16) * 16


def smem_bytes(shape: str, n: int, rmax: int, itemsize: int) -> int:
    """A block's dynamic shared memory in a shared shape: its rows' x
    (all n in block-smem, ⌈n / CLUSTER⌉ in cluster-smem), the STAGES
    mbarriers and a zero (the sentinel's x), and the STAGES stages of
    the ring (a 16-byte header, then the consumers' rows, 1/diag and
    SLOTS slots of cols and vals, each array with 32 bytes of alignment
    slack), each part 16-byte aligned (csrc/sptrsv.cu::smem_bytes)."""
    ranks = ranks_of(shape)
    consumers = consumers_for(-(-rmax // ranks))
    stage = 16 + consumers * (1 + SLOTS) * (4 + itemsize) + 128
    return (_up16(-(-n // ranks) * itemsize) + _up16(8 * STAGES + 16)
            + STAGES * stage)


def with_slack(t: torch.Tensor) -> torch.Tensor:
    """t copied into a storage with SLACK readable bytes (zeros) past its
    end, as a contiguous tensor of t's shape: how a plan's level order
    is allocated, since the shared shapes' ring copies 16-byte units."""
    flat = t.reshape(-1)
    out = flat.new_zeros(flat.numel() + -(-SLACK // t.element_size()))
    out[:flat.numel()] = flat
    return out[:flat.numel()].view(t.shape)


def _need_slack(name, arrays):
    for what, t in arrays:
        left = (t.untyped_storage().nbytes()
                - (t.storage_offset() + t.numel()) * t.element_size())
        if left < SLACK:
            raise ValueError(f"{name}: {what} must be readable {SLACK} "
                             f"bytes past its end in a shared shape "
                             f"(ops.sptrsv.with_slack), has {left}")


def launch_shape(nb: int, n: int, rmax: int, itemsize: int,
                 smem: int) -> str:
    """The kernel's launch shape for nb plans of n rows whose widest
    level holds rmax rows, in `itemsize`-byte floats, on a card whose
    blocks may take `smem` bytes of shared memory: x in one block's
    shared memory (block-smem, levels of at most BLOCK_ROWS rows), else
    in a cluster's (cluster-smem), else x in global memory: one block a
    plan (block), a cluster a plan (cluster) or, for one plan, the whole
    card (grid)."""
    if rmax <= BLOCK_ROWS and smem_bytes("block-smem", n, rmax,
                                         itemsize) <= smem:
        return "block-smem"
    if smem_bytes("cluster-smem", n, rmax, itemsize) <= smem:
        return "cluster-smem"
    if rmax <= BLOCK_ROWS:
        return "block"
    return "grid" if nb == 1 else "cluster"


def pair_shape(nb: int, n: int, rmax: int, itemsize: int, smem: int) -> str:
    """The fused solve's shape (sptrsv_lu, rmax the wider plan's):
    launch_shape's where that is a shared one, else, for one plan whose
    x fits a cluster of CLUSTER16 blocks, cluster16-smem (a non-portable
    cluster size, taken by the fused solve only: a single triangle keeps
    launch_shape's), else launch_shape's, where no fused launch runs."""
    shape = launch_shape(nb, n, rmax, itemsize, smem)
    if shape in SMEM_SHAPES or nb != 1:
        return shape
    if smem_bytes("cluster16-smem", n, rmax, itemsize) <= smem:
        return "cluster16-smem"
    return shape


def segments(lstart, lrows, n: int, ranks: int = CLUSTER) -> np.ndarray:
    """The ownership plan of the cluster-smem shape: lseg [nb, nlev·ranks
    + 1] int32, the first position of level l's rows of rank q at
    l·ranks + q (its last entry n), where rank q owns rows [q·chunk,
    (q+1)·chunk), chunk = ⌈n / ranks⌉. A level's rows ascend in level
    order, so each rank's rows of a level are one run of positions, the
    segment lseg[l·ranks + q] .. lseg[l·ranks + q + 1]. numpy in and out
    (lstart [nb, nlev+1], lrows [nb, n] of level_order); raises unless
    each level's rows fall in ascending ranks."""
    lstart, lrows = np.asarray(lstart), np.asarray(lrows)
    nb, nlev = lstart.shape[0], lstart.shape[1] - 1
    chunk = -(-n // ranks)
    pos = np.arange(n)
    lev = np.stack([np.searchsorted(lstart[s], pos, side="right") - 1
                    for s in range(nb)]).astype(np.int64)
    key = lev * ranks + lrows // chunk
    if (np.diff(key, axis=1) < 0).any():
        raise ValueError("sptrsv: a level's rows must fall in ascending "
                         "ranks (ascending rows)")
    cells = nlev * ranks
    counts = np.bincount((key + cells * np.arange(nb)[:, None]).ravel(),
                         minlength=nb * cells).reshape(nb, cells)
    lseg = np.zeros((nb, cells + 1), np.int32)
    lseg[:, 1:] = counts.cumsum(1)
    return lseg


def sptrsv_plain(lstart, lrows, lcols, lvals, ldinv, b) -> torch.Tensor:
    """x [nb, n] with, for each plan, level after level, every row r of
    the level set to (b[r] − Σ_k vals[r,k]·x[cols[r,k]])·dinv[r], the
    sum a left fold over k from 0, over the plans in level order
    (level_order's arrays; x[n] = 0 is the sentinel). A padding slot is
    col n, val 0, so a level folds only up to the last slot that one of
    its rows uses: the fold starts at +0.0 and so never holds −0.0, and
    adding a padding slot's +0.0 to it is exact."""
    nb, n = ldinv.shape
    x = b.new_zeros((nb, n + 1))

    def pad(t, v):
        return torch.cat([t, t.new_full((nb, 1) + tuple(t.shape[2:]), v)], 1)

    lr, lc = pad(lrows, n).long(), pad(lcols, n).long()
    lv, ld, bp = pad(lvals, 0), pad(ldinv, 1), pad(b, 0)
    ls = lstart.long()
    sizes = (ls[:, 1:] - ls[:, :-1]).amax(0).tolist()    # widest plan a level
    width = max(sizes, default=0)
    i = torch.arange(max(width, 1), device=b.device)
    plan = torch.arange(nb, device=b.device)[:, None]
    # each row's last slot in use + 1, read once; a level's widest
    used = ((lcols != n) * torch.arange(1, lcols.shape[-1] + 1,
                                        device=b.device)).amax(-1) \
        .cpu().numpy() if lcols.shape[-1] else np.zeros((nb, n), np.int64)
    starts = ls.cpu().numpy()
    kmax = [max((int(used[q, starts[q, lev]:starts[q, lev + 1]].max())
                 if starts[q, lev + 1] > starts[q, lev] else 0)
                for q in range(nb)) for lev in range(ls.shape[1] - 1)]
    for lev in range(ls.shape[1] - 1):
        km = kmax[lev]
        if nb == 1:
            # one plan: the level's rows are one run of positions
            s, e = int(starts[0, lev]), int(starts[0, lev + 1])
            rows, c, v, d = (lr[:, s:e], lc[:, s:e, :km], lv[:, s:e, :km],
                             ld[:, s:e])
        else:
            # [nb, the level's width] positions; past a plan's own rows,
            # the sentinel n (its slots are padding, its write lands in
            # x[n])
            p = ls[:, lev, None] + i[:max(sizes[lev], 1)]
            p = torch.where(p < ls[:, lev + 1, None], p, n)
            rows, c, v, d = (lr[plan, p], lc[plan, p, :km], lv[plan, p, :km],
                             ld[plan, p])
        # every product first (one gather), then the fold over k: the
        # same roundings as multiplying and adding slot by slot
        prod = v * torch.gather(x, 1, c.reshape(nb, -1)).view(c.shape)
        acc = torch.zeros_like(rows, dtype=b.dtype)
        for k in range(km):
            acc = acc + prod[..., k]
        x.scatter_(1, rows, (torch.gather(bp, 1, rows) - acc) * d)
    return x[:, :n].contiguous()


def sptrsv_lu_plain(lower, upper, b) -> torch.Tensor:
    """x = U⁻¹ L⁻¹ b for nb stacked pairs of plans in level order (lower,
    upper: each plan's lstart, lrows, lcols, lvals, ldinv): the plain
    version of sptrsv_lu, two plain solves."""
    return sptrsv_plain(*upper, sptrsv_plain(*lower, b))


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


def _check(lstart, lrows, lcols, lvals, ldinv, b, nlevs, lseg, rmax,
           name="sptrsv"):
    dev = b.device
    arrays = (("lstart", lstart), ("lrows", lrows), ("lcols", lcols),
              ("lvals", lvals), ("ldinv", ldinv), ("b", b),
              ("nlevs", nlevs)) + ((("lseg", lseg),) if lseg is not None
                                   else ())
    for what, t in arrays:
        if not isinstance(t, torch.Tensor):
            raise TypeError(f"{name}: {what} must be a tensor")
        if t.device != dev:
            raise ValueError(f"{name}: {what} is on {t.device}, b on {dev}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: {what} must be contiguous")
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"{name}: tensors on {dev} are not supported "
                         "(cuda runs the kernel, cpu its plain version)")
    if lstart.dim() != 2 or lvals.dim() != 3:
        raise ValueError(f"{name}: lstart and lvals must be 2-D [nb,nlev+1]"
                         f" and 3-D [nb,n,K], got {tuple(lstart.shape)} and "
                         f"{tuple(lvals.shape)}")
    nb, n, K = lvals.shape
    nlev = lstart.shape[1] - 1
    if b.dtype not in _DTYPES:
        raise ValueError(f"{name}: b must be float32 or float64, got "
                         f"{b.dtype}")
    expect = {"lstart": (lstart, torch.int32, (nb, nlev + 1)),
              "lrows": (lrows, torch.int32, (nb, n)),
              "lcols": (lcols, torch.int32, (nb, n, K)),
              "lvals": (lvals, b.dtype, (nb, n, K)),
              "ldinv": (ldinv, b.dtype, (nb, n)),
              "b": (b, b.dtype, (nb, n)),
              "nlevs": (nlevs, torch.int32, (nb,))}
    if lseg is not None:
        # CLUSTER or CLUSTER16 ranks' segments (_need_segments matches
        # them to the shape)
        ranks = CLUSTER16 if lseg.dim() == 2 and lseg.shape[-1] == \
            nlev * CLUSTER16 + 1 else CLUSTER
        expect["lseg"] = (lseg, torch.int32, (nb, nlev * ranks + 1))
    for what, (t, dt, shape) in expect.items():
        if t.dtype != dt or tuple(t.shape) != shape:
            raise ValueError(f"{name}: {what} must be {dt} {shape}, got "
                             f"{t.dtype} {tuple(t.shape)}")
    if not isinstance(rmax, int) or isinstance(rmax, bool) or rmax < 1:
        raise ValueError(f"{name}: rmax must be an int >= 1, got {rmax!r}")
    if nlev < 1 or K < 1:
        raise ValueError(f"{name}: empty plan (nlev={nlev}, K={K})")
    return nb, n, nlev, K


# the C entry points' argument types, the stream last: sptrsv_launch's
# (lstart, lseg, nlevs, lrows, lcols, lvals, ldinv, b, x, bar; nb, n,
# nlev, rmax, K, fp64, shape) and sptrsv_lu_launch's (L's seven arrays,
# U's, b, x; nb, n, L's nlev, U's, rmax, L's K, U's, fp64, shape)
ARGTYPES = ((ctypes.c_void_p,) * 10 + (ctypes.c_int,) * 7
            + (ctypes.c_void_p,))
LU_ARGTYPES = ((ctypes.c_void_p,) * 16 + (ctypes.c_int,) * 9
               + (ctypes.c_void_p,))


@functools.cache
def _launcher():
    return _build.entry("sptrsv", ARGTYPES)


@functools.cache
def _lu_launcher():
    return _build.entry("sptrsv", LU_ARGTYPES, "sptrsv_lu_launch")


@functools.cache
def _smem_optin(index: int) -> int:
    """The shared memory a block may take on CUDA device `index`
    (cudaDevAttrMaxSharedMemoryPerBlockOptin), asked once."""
    fn = _build.load("sptrsv").sptrsv_smem_optin
    fn.argtypes = [ctypes.c_int, ctypes.POINTER(ctypes.c_int)]
    fn.restype = ctypes.c_int
    out = ctypes.c_int(0)
    rc = fn(index, ctypes.byref(out))
    if rc != 0:
        raise RuntimeError(f"sptrsv: asking device {index}'s shared memory "
                           f"failed with CUDA error {rc}")
    return out.value


def device_pair_shape(nb: int, n: int, rmax: int, dtype,
                      device: torch.device) -> str:
    """pair_shape on CUDA device `device`; "plain" on the CPU."""
    if device.type != "cuda":
        return "plain"
    return pair_shape(nb, n, rmax, dtype.itemsize, _smem_optin(
        device.index if device.index is not None else
        torch.cuda.current_device()))


def device_shape(nb: int, n: int, rmax: int, dtype,
                 device: torch.device) -> str:
    """launch_shape on CUDA device `device` (its shared memory asked
    once); "plain" on the CPU, where the plain version runs."""
    if device.type != "cuda":
        return "plain"
    return launch_shape(nb, n, rmax, dtype.itemsize, _smem_optin(
        device.index if device.index is not None else
        torch.cuda.current_device()))


def _need_segments(name, shape, lsegs, nlevs=()):
    """The cluster shapes read each plan's (level, rank) segments of
    their own rank count."""
    if shape not in ("cluster-smem", "cluster16-smem"):
        return
    if any(t is None for t in lsegs):
        raise ValueError(f"{name}: the {shape} shape reads the plan's "
                         "(level, rank) segments: lseg must be given "
                         "(ops.sptrsv.segments)")
    ranks = ranks_of(shape)
    for t, nlev in zip(lsegs, nlevs):
        if t.shape[-1] != nlev * ranks + 1:
            raise ValueError(f"{name}: the {shape} shape reads segments of "
                             f"{ranks} ranks, lseg has {t.shape[-1]} "
                             f"entries for {nlev} levels")


def _raise(name, rc):
    hint = (" (a shared shape's first launch on a device sets its "
            "shared-memory limit, which a CUDA graph capture refuses: "
            "launch once before capturing)" if rc == _CAPTURED else "")
    raise RuntimeError(f"{name}: kernel launch failed with CUDA error "
                       f"{rc}{hint}")


def sptrsv(lstart, lrows, lcols, lvals, ldinv, b, *, nlevs, lseg,
           rmax: int) -> torch.Tensor:
    """x = T⁻¹ b for nb stacked plans in level order: x [nb, n] (see
    sptrsv_plain).

    nlevs [nb] says how many levels of each plan come before its padded
    ones (level_order gives both), lseg [nb, nlev·CLUSTER + 1] is the
    plan's (level, rank) segments (`segments`; read only in the
    cluster-smem shape, None otherwise, where the call raises), and rmax
    is the most rows a level holds; mat/factor.SpTRSVPlan derives them
    once. The kernel does not re-check the plan's indices."""
    nb, n, nlev, K = _check(lstart, lrows, lcols, lvals, ldinv, b, nlevs,
                            lseg, rmax)
    if not b.is_cuda:
        return sptrsv_plain(lstart, lrows, lcols, lvals, ldinv, b)
    x = b.new_empty((nb, n))
    if nb == 0 or n == 0:
        return x
    index = b.get_device()
    shape = launch_shape(nb, n, rmax, b.element_size(), _smem_optin(index))
    _need_segments("sptrsv", shape, (lseg,), (nlev,))
    if shape in SMEM_SHAPES:
        _need_slack("sptrsv", (("lrows", lrows), ("lcols", lcols),
                               ("lvals", lvals), ("ldinv", ldinv)))
    bar = torch.empty(1, dtype=torch.int32, device=b.device) \
        if shape == "grid" else None
    rc = _build.launch(_launcher(), index, (
        lstart.data_ptr(), None if lseg is None else lseg.data_ptr(),
        nlevs.data_ptr(),
        lrows.data_ptr(), lcols.data_ptr(), lvals.data_ptr(),
        ldinv.data_ptr(), b.data_ptr(), x.data_ptr(),
        None if bar is None else bar.data_ptr(), nb, n, nlev, rmax, K,
        int(b.dtype == torch.float64), SHAPES[shape]))
    if rc != 0:
        _raise("sptrsv", rc)
    _build.counted(sptrsv)
    return x


sptrsv.launches = 0


def sptrsv_lu(lower, upper, b, *, nlevs, lseg, rmax) -> torch.Tensor:
    """x = U⁻¹ L⁻¹ b for nb stacked pairs of plans in one launch: x [nb,
    n] (see sptrsv_lu_plain). lower and upper are L's and U's level order
    (lstart, lrows, lcols, lvals, ldinv); nlevs, lseg (either None
    outside the cluster shapes; of CLUSTER16 ranks in cluster16-smem)
    and rmax are pairs, L's and then U's (see sptrsv). The pair must take
    a shared shape (pair_shape for the wider rmax), where y = L⁻¹ b stays
    in shared memory between the triangles; else it raises, and the
    caller makes two sptrsv launches (mat/factor.lu_solve decides)."""
    for what, v in (("lower", lower), ("upper", upper), ("nlevs", nlevs),
                    ("lseg", lseg), ("rmax", rmax)):
        if not isinstance(v, (tuple, list)) or len(v) != (
                5 if what in ("lower", "upper") else 2):
            raise TypeError(f"sptrsv_lu: {what} must be a tuple of "
                            f"{5 if what in ('lower', 'upper') else 2}")
    nb, n, lnlev, lk = _check(*lower, b, nlevs[0], lseg[0], rmax[0],
                              "sptrsv_lu")
    _, _, unlev, uk = _check(*upper, b, nlevs[1], lseg[1], rmax[1],
                             "sptrsv_lu")
    if not b.is_cuda:
        return sptrsv_lu_plain(lower, upper, b)
    x = b.new_empty((nb, n))
    if nb == 0 or n == 0:
        return x
    index = b.get_device()
    wide = max(rmax)
    shape = pair_shape(nb, n, wide, b.element_size(), _smem_optin(index))
    if shape not in SMEM_SHAPES:
        raise ValueError(f"sptrsv_lu: {nb} plans of {n} rows take the "
                         f"{shape} shape, not a shared one: solve the two "
                         "triangles with sptrsv")
    _need_segments("sptrsv_lu", shape, lseg, (lnlev, unlev))
    _need_slack("sptrsv_lu", [(f"{tri} {what}", t)
                              for tri, plan in (("L", lower), ("U", upper))
                              for what, t in zip(("lrows", "lcols", "lvals",
                                                  "ldinv"), plan[1:])])
    rc = _build.launch(_lu_launcher(), index, (
        *(t if t is None else t.data_ptr()
          for t in (lower[0], lseg[0], nlevs[0], *lower[1:])),
        *(t if t is None else t.data_ptr()
          for t in (upper[0], lseg[1], nlevs[1], *upper[1:])),
        b.data_ptr(), x.data_ptr(), nb, n, lnlev, unlev, wide, lk, uk,
        int(b.dtype == torch.float64), SHAPES[shape]))
    if rc != 0:
        _raise("sptrsv_lu", rc)
    _build.counted(sptrsv_lu)
    return x


sptrsv_lu.launches = 0
