"""The index rules of kernels K1 (the stencil SpMV) and H2 (the windowed
SELL SpMV), held on the CPU.

* K1's host plan (`stencil_plan`: each offset's flat delta and the
  interior box) against a brute-force numpy enumeration of every point
  and offset, on 1-, 2- and 3-D grids, grids with no interior point, and
  every boundary type; the ctypes arrays the wrapper hands the kernel
  carry the same plan.
* A numpy emulation of K1's split (in the fp32 5- and 7-point
  instantiations, a warp of 32 consecutive points all in the box reads
  x[i + delta_d]; any other point, and every point of the other
  instantiations, resolves each neighbour per axis and reads 0 outside
  a "none" axis) equals `stencil_mult_plain` bit for bit, in fp32 and
  fp64.
* A numpy emulation of H2's chunked fold (a warp of 32 rows, chunks of
  32 slots, lane j's running sum carried across chunks, each row's own
  starts[i // Rb]) equals `window_spmv_plain` bit for bit for K off a
  multiple of 32, Rb off a multiple of 32 and n below a warp's rows.

Inputs come from numpy generators with fixed seeds.
"""

import itertools

import numpy as np
import pytest
import torch

from petsctpu_torch.ops import stencil_mult as k1
from petsctpu_torch.ops.window_spmv import window_spmv_plain

STAR5 = ((0, 0), (-1, 0), (1, 0), (0, -1), (0, 1))
STAR7 = ((0, 0, 0), (-1, 0, 0), (1, 0, 0), (0, -1, 0), (0, 1, 0),
         (0, 0, -1), (0, 0, 1))
BOX27 = tuple(itertools.product((-1, 0, 1), repeat=3))
BOX125 = tuple(itertools.product(range(-2, 3), repeat=3))
STAR19 = STAR7 + tuple(o for o in BOX27 if sum(map(abs, o)) == 2)
BOUNDARIES = ("none", "periodic", "mirror")

# (grid, offsets) of the plan's cases; the last four have no interior
PLAN_CASES = {
    "1d_3pt": ((40,), ((-1,), (0,), (1,))),
    "1d_lopsided": ((17,), ((-2,), (0,), (3,))),
    "2d_star5": ((7, 9), STAR5),
    "2d_skew": ((11, 6), STAR5 + ((2, -1), (-3, 2))),
    "3d_star7": ((5, 4, 6), STAR7),
    "3d_box27": ((6, 5, 37), BOX27),
    "3d_star19": ((5, 6, 33), STAR19),
    "3d_box125": ((6, 7, 40), BOX125),
    "3d_one_sided": ((4, 5, 6), ((0, 0, 0), (0, 0, 2), (1, 1, 0))),
    "none_thin_axis0": ((2, 3, 37), BOX27),
    "none_thin_axis2": ((9, 8, 2), STAR7),
    "none_2d": ((3, 40), STAR5 + ((2, 0),)),
    "none_1d": ((4,), ((-2,), (0,), (2,))),
    # wide fast axes: whole warps lie in the box, some ending on its edge
    "wide_3d_star7": ((6, 5, 100), STAR7),
    "wide_3d_box27": ((4, 5, 70), BOX27),
    "wide_2d_skew": ((9, 160), STAR5 + ((2, -1), (-3, 2))),
    "wide_2d_star5": ((5, 100), STAR5),
    "wide_1d": ((300,), ((-2,), (0,), (1,))),
}


def neighbour(j, m, bnd):
    """The neighbour coordinate along one axis (numpy's reflect for
    mirror, a wrap for periodic), −1 outside a "none" axis."""
    if bnd == "periodic":
        return np.mod(j, m)
    if bnd == "mirror":
        if m == 1:
            return np.zeros_like(j)
        period = 2 * (m - 1)
        j = np.mod(j, period)
        return np.where(j < m, j, period - j)
    return np.where((j >= 0) & (j < m), j, -1)


def coords(n):
    """Each flat point's coordinates on the 3-D grid n, as [N, 3]."""
    return np.stack(np.unravel_index(np.arange(int(np.prod(n))), n), axis=1)


@pytest.mark.parametrize("name", list(PLAN_CASES))
def test_k1_plan_matches_brute_force(name):
    grid, offsets = PLAN_CASES[name]
    n, offs, deltas, lo, hi = k1.stencil_plan(offsets, grid)
    assert n == (1,) * (3 - len(grid)) + grid
    P = coords(n)
    O = np.array(offs)                                     # [D, 3]
    nb = P[:, None, :] + O[None, :, :]                     # [N, D, 3]
    inside = ((nb >= 0) & (nb < np.array(n))).all(axis=(1, 2))
    box = ((P >= np.array(lo)) & (P < np.array(hi))).all(axis=1)
    # the box is exactly the points whose every neighbour is in the grid
    np.testing.assert_array_equal(box, inside)
    if name.startswith("none_"):
        assert not box.any()
    else:
        assert box.any()
    # deltas: the flat step to each neighbour of a point inside the box,
    # whatever the boundary
    flat = np.arange(P.shape[0])
    for bnd in BOUNDARIES:
        j = np.stack([neighbour(nb[box][..., k], n[k], bnd)
                      for k in range(3)], axis=-1)
        step = np.ravel_multi_index(tuple(j.reshape(-1, 3).T), n) \
            .reshape(j.shape[:2]) - flat[box][:, None]
        np.testing.assert_array_equal(step, np.broadcast_to(
            np.array(deltas), step.shape))
    # the wrapper's ctypes arrays carry the same plan
    offs_c, D, dims, bnd_c, deltas_c, box_c = k1._host_args(
        offsets, grid, ("none",) * len(grid))
    assert D == len(offsets) and tuple(dims) == n
    assert tuple(deltas_c) == deltas and tuple(box_c) == lo + hi
    assert tuple(offs_c) == tuple(o for off in offs for o in off)


def has_interior_path(dtype, D):
    """Whether K1's instantiation for dtype and D compiles the interior
    path (kInterior in csrc/stencil_mult.cu): fp32 with 5 or 7 offsets."""
    return dtype == np.float32 and D in (5, 7)


def k1_emulate(C, x, offsets, grid, boundary):
    """K1's interior/boundary split in numpy: where the instantiation
    has the interior path, points of a warp (32 consecutive points) that
    lies wholly in the interior box read x[i + delta_d]; every other
    point resolves each neighbour per axis and adds coeff·0 outside a
    "none" axis. Each offset's product is rounded, then added in offset
    order from 0. Returns y and the points that took the interior path."""
    n, offs, deltas, lo, hi = k1.stencil_plan(offsets, grid)
    bnd = ("none",) * (3 - len(grid)) + k1.boundary_types(boundary,
                                                          len(grid))
    P = coords(n)
    N = P.shape[0]
    inner = ((P >= np.array(lo)) & (P < np.array(hi))).all(axis=1)
    inner &= has_interior_path(x.dtype, len(offs))
    pad = np.zeros(-N % 32, bool)
    fast = np.repeat(np.concatenate([inner, pad]).reshape(-1, 32).all(1),
                     32)[:N]
    flat = np.arange(N)
    xf = x.reshape(-1)
    Cf = C.reshape(len(offs), N)
    acc = np.zeros(N, x.dtype)
    for d, off in enumerate(offs):
        j = np.stack([neighbour(P[:, k] + off[k], n[k], bnd[k])
                      for k in range(3)], axis=1)
        ok = (j >= 0).all(axis=1)
        slow = np.ravel_multi_index(tuple(np.where(ok[:, None], j, 0).T), n)
        src = np.where(fast, np.where(fast, flat + deltas[d], 0), slow)
        xv = np.where(fast | ok, xf[src], x.dtype.type(0))
        acc = acc + Cf[d] * xv
    return acc, fast


EMULATION_CASES = [
    ("2d_skew", ("periodic", "none")),
    ("2d_star5", ("mirror", "mirror")),
    ("3d_box27", ("none",) * 3),
    ("3d_box27", ("periodic", "mirror", "none")),
    ("3d_star19", ("none",) * 3),
    ("3d_box125", ("mirror", "periodic", "none")),
    ("3d_star7", ("periodic",) * 3),
    ("none_thin_axis0", ("none",) * 3),
    ("1d_lopsided", ("mirror",)),
    ("none_1d", ("periodic",)),
    ("wide_3d_star7", ("none",) * 3),
    ("wide_3d_star7", ("mirror", "none", "periodic")),
    ("wide_3d_box27", ("periodic", "periodic", "mirror")),
    ("wide_2d_skew", ("none", "periodic")),
    ("wide_2d_star5", ("periodic", "none")),
    ("wide_1d", ("mirror",)),
]


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("name,boundary", EMULATION_CASES)
def test_k1_split_emulation_equals_plain(name, boundary, dtype):
    grid, offsets = PLAN_CASES[name]
    rng = np.random.default_rng(11)
    C = rng.standard_normal((len(offsets),) + grid).astype(dtype)
    x = rng.standard_normal(int(np.prod(grid))).astype(dtype)
    got, fast = k1_emulate(C, x, offsets, grid, boundary)
    # the wide grids send whole warps down the interior path, where the
    # instantiation has it
    assert fast.any() == (name.startswith("wide_")
                          and has_interior_path(dtype, len(offsets)))
    ref = k1.stencil_mult_plain(torch.from_numpy(C), torch.from_numpy(x),
                                offsets, grid, boundary).numpy()
    assert got.dtype == ref.dtype
    np.testing.assert_array_equal(got.view(np.uint8), ref.view(np.uint8))


def h2_emulate(starts, q, r, vals, x, Rb):
    """H2's fold in numpy: a warp owns 32 consecutive rows; for each chunk
    of 32 slots lane k's product of row j goes to tile[j][k] (slots past
    K are not folded, rows past n not written), and lane j adds row j's
    chunk onto its running sum in slot order; the sum carries across
    chunks. Row j's window base is starts[(row0 + j) // Rb]."""
    n, K = vals.shape
    y = np.zeros(n, np.float32)
    for row0 in range(0, n, 32):
        rows = min(32, n - row0)
        base = starts[(row0 + np.arange(rows)) // Rb].astype(np.int64)
        acc = np.zeros(rows, np.float32)
        for k0 in range(0, K, 32):
            m = min(32, K - k0)
            s = (slice(row0, row0 + rows), slice(k0, k0 + m))
            tile = np.zeros((32, 32), np.float32)
            col = base[:, None] + 128 * q[s].astype(np.int64) + r[s]
            tile[:rows, :m] = vals[s] * x[col]
            for kk in range(m):
                acc = acc + tile[:rows, kk]
        y[row0:row0 + rows] = acc
    return y


@pytest.mark.parametrize("n,K,Rb", [(96, 5, 48), (1000, 33, 100),
                                    (410, 64, 41), (40, 33, 20),
                                    (2047, 32, 89), (4096, 32, 2048),
                                    (7, 1, 7)])
def test_h2_fold_emulation_equals_plain(n, K, Rb):
    rng = np.random.default_rng(n + K)
    starts = (rng.integers(0, 64, n // Rb) * 16).astype(np.int32)
    q = rng.integers(0, 32, (n, K)).astype(np.int32)
    r = rng.integers(0, 128, (n, K)).astype(np.int32)
    vals = rng.standard_normal((n, K)).astype(np.float32)
    x = rng.standard_normal(32 * 128 + 1024).astype(np.float32)
    got = h2_emulate(starts, q, r, vals, x, Rb)
    ref = window_spmv_plain(*map(torch.from_numpy, (starts, q, r, vals, x)),
                            Rb=Rb).numpy()
    np.testing.assert_array_equal(got.view(np.uint32), ref.view(np.uint32))
