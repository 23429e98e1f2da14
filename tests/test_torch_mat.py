"""The port's matrices against petsctpu's, on the CPU.

* AIJ: every op against petsctpu.mat.ell, fp64, rtol 1e-13 (a row sum
  of a few terms may round in another order). The ELL pack's int32
  columns equal petsctpu's byte for byte, and the product's plain version
  equals petsctpu's AIJ.mult bit for bit.
* SELL: the port's host pack must EQUAL petsctpu's, array for array, in
  both modes; its mult (the kernel's plain version) must match the JAX
  SellMat.mult (Pallas interpret mode, as tests/test_sell.py runs it)
  within 1e-6·max|y| — the pass order is the same, and the tolerance
  covers XLA:CPU's freedom to contract a multiply and an add.
* convert: JAX objects carried across by their numpy fields.
* mat_from_options: the same perm as petsctpu.
"""

from dataclasses import replace
from fractions import Fraction

import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse as sp
import torch

from petsctpu.mat import ell as jell
from petsctpu.mat import sell as jsell
from petsctpu.models import ex2_system as jex2, poisson_3d as jpoisson_3d
from petsctpu_torch import convert
from petsctpu_torch.core.options import Options
from petsctpu_torch.mat import ell as tell
from petsctpu_torch.mat import sell as tsell
from petsctpu_torch.mat.factory import mat_from_options
from petsctpu_torch.models import ex2_system, poisson_3d

# one intra-op thread: the suite runs in parallel workers (pytest -n), and
# PyTorch's default of a thread a core oversubscribes the host's cores
torch.set_num_threads(1)

CPU = "cpu"


def banded_random(n, bw, k, seed=0, dtype=np.float32, ncols=None):
    """tests/test_sell.py's generator (plus an optional column count
    for rectangular chunk-mode operators)."""
    rng = np.random.default_rng(seed)
    m = ncols or n
    rows = np.tile(np.arange(n), k)
    cols = np.clip((rows * m) // n + rng.integers(-bw, bw, k * n), 0, m - 1)
    A = sp.coo_matrix((rng.standard_normal(k * n).astype(dtype),
                       (rows, cols)), shape=(n, m)).tocsr()
    A.sum_duplicates()
    return A


# --------------------------------------------------------------- AIJ ----
def _aij_pair():
    A = banded_random(300, 40, 6, seed=3, dtype=np.float64)
    A = (A + sp.eye(300) * 10).tocsr()
    return A, jell.aij_from_scipy(A), tell.aij_from_scipy(A, device=CPU)


AIJ_OPS = {
    "mult": lambda M, v, X, A: M.mult(A(v)),
    "multT": lambda M, v, X, A: M.multT(A(v)),
    "diagonal": lambda M, v, X, A: M.diagonal(),
    "diag_scale": lambda M, v, X, A: M.diag_scale(A(v), A(v[::-1].copy())).vals,
    "shift_diag": lambda M, v, X, A: M.shift_diag(2.5).vals,
    "scale": lambda M, v, X, A: M.scale(-1.75).vals,
    "rows_sum": lambda M, v, X, A: M.rows_sum(),
    "mult_dense": lambda M, v, X, A: M.mult_dense(A(X)),
}


@pytest.mark.parametrize("op", list(AIJ_OPS))
def test_aij_op_matches_jax(op):
    A, J, T = _aij_pair()
    rng = np.random.default_rng(11)
    v = rng.standard_normal(300)
    X = rng.standard_normal((300, 4))
    ref = np.asarray(AIJ_OPS[op](J, v, X, jnp.asarray))
    got = AIJ_OPS[op](T, v, X, torch.from_numpy).numpy()
    assert got.shape == ref.shape
    np.testing.assert_allclose(got, ref, rtol=1e-13, atol=1e-13)


def test_aij_pack_and_flops_match_jax():
    A, J, T = _aij_pair()
    np.testing.assert_array_equal(T.cols.numpy(), np.asarray(J.cols))
    np.testing.assert_array_equal(T.vals.numpy(), np.asarray(J.vals))
    assert T.flops_per_mult() == J.flops_per_mult()
    assert (tell.aij_to_scipy(T) != A).nnz == 0


def _pack_matrix(name):
    """ex45's 3-D Poisson (8³), ksp ex43's golden system at mx = 20, a
    random rectangular matrix."""
    if name == "ex45":
        return poisson_3d(8, 8, 8, np.float64)
    if name == "ex43_golden":
        from petsctpu_torch.models.q1stokes import q1q1_stokes_system
        return q1q1_stokes_system(20, 20, c_str=0, eta0=1.0, eta1=1.0e6,
                                  xc=0.5, nz=2)[0]
    return sp.random(70, 130, density=0.06, random_state=8, format="csr")


@pytest.mark.parametrize("name", ["ex45", "ex43_golden", "rectangular"])
def test_aij_pack_is_the_reference_int32_pack(name):
    A = _pack_matrix(name)
    ref = jell.aij_pack(A)[0]
    port = tell.aij_pack(A)[0]
    T = tell.aij_from_scipy(A, device=CPU)
    assert ref.dtype == port.dtype == np.int32 and T.cols.dtype == torch.int32
    assert port.shape == ref.shape and port.tobytes() == ref.tobytes()
    assert T.cols.numpy().tobytes() == ref.tobytes()


def _fma(a, b, c):
    """a·b + c rounded once: exact in Fractions, rounded to the nearest
    double; an exact zero takes IEEE's sign, which a·b + c then gives."""
    s = Fraction(a) * Fraction(b) + Fraction(c)
    return float(s) if s else a * b + c


def _fused_complex_mult(cols, vals, x):
    """Σ_k vals[i,k]·x[cols[i,k]] folded in slot order from +0.0, each
    complex product formed as XLA:CPU forms it: re = fma(ar, br, −ai·bi),
    im = fma(ai, br, ar·bi)."""
    v, g = vals.ravel(), x[cols].ravel()
    p = np.array([complex(_fma(a.real, b.real, -(a.imag * b.imag)),
                          _fma(a.imag, b.real, a.real * b.imag))
                  for a, b in zip(v.tolist(), g.tolist())]).reshape(vals.shape)
    y = np.zeros(vals.shape[0], np.complex128)
    for k in range(vals.shape[1]):
        y = y + p[:, k]
    return y


@pytest.mark.parametrize("dtype", [np.float32, np.float64, np.complex128])
def test_ell_plain_is_the_reference_mult(dtype):
    """ell_spmv_plain on the int32 pack against petsctpu's AIJ.mult on the
    CPU: bit for bit in fp32 and fp64 (each row folded over its slots from
    +0.0). In complex128 XLA:CPU contracts each product's multiply-add,
    re = fma(ar, br, −ai·bi) and im = fma(ai, br, ar·bi), where the port
    rounds all four products (the kernel's arithmetic): petsctpu's bits
    are rebuilt here in that form, folded in the same slot order, byte
    for byte; the port's products then differ by at most eps·|v||x|, and
    each of the two folds of K terms lies within K·eps·Σ|v||x| of its
    exact sum, so a row differs by at most (2K + 1)·eps·Σ|v||x|.
    XLA:CPU folds a row left to right only up to 32 slots (wider rows it
    reduces in another order), so every dtype takes the golden's own
    pattern, K 27; the complex values' imaginary parts lie on it."""
    from petsctpu_torch.ops.ell_spmv import ell_spmv_plain
    A = _pack_matrix("ex43_golden").astype(dtype)
    rng = np.random.default_rng(5)
    x = rng.standard_normal(A.shape[1])
    if np.iscomplexobj(A):
        Ai = A.copy()
        Ai.data = rng.standard_normal(A.nnz).astype(dtype)
        A = (A + 1j * Ai).tocsr()
        x = x + 1j * rng.standard_normal(A.shape[1])
    x = x.astype(dtype)
    J = jell.aij_from_scipy(A)
    T = tell.aij_from_scipy(A, device=CPU)
    assert T.cols.shape[1] == 27
    got = ell_spmv_plain(T.cols, T.vals, torch.from_numpy(x)).numpy()
    ref = np.asarray(J.mult(jnp.asarray(x)))
    assert got.dtype == ref.dtype
    if not np.iscomplexobj(A):
        assert got.tobytes() == ref.tobytes()
        return
    fused = _fused_complex_mult(T.cols.numpy(), T.vals.numpy(), x)
    assert fused.tobytes() == ref.tobytes()
    K = T.cols.shape[1]
    scale = (abs(A) @ np.abs(x)) * (2 * K + 1) * np.finfo(np.float64).eps
    assert np.all(np.abs(got.real - ref.real) <= scale)
    assert np.all(np.abs(got.imag - ref.imag) <= scale)


# -------------------------------------------------------------- SELL ----
SELL_SHAPES = [                 # tests/test_sell.py:27-31
    (2 * 8 * 128 + 300, 700, 12, 8),
    (4 * 4 * 128, 60, 5, 4),
    (3 * 8 * 128, 2500, 9, 8),
]


def _sell_cases():
    for i, (n, bw, k, G) in enumerate(SELL_SHAPES):
        yield f"test_sell_{i}", (lambda n=n, bw=bw, k=k: banded_random(n, bw, k)), G
    yield "poisson_16", lambda: poisson_3d(16, 16, 16, np.float32), 16


SELL_CASES = list(_sell_cases())
SELL_IDS = [c[0] for c in SELL_CASES]


@pytest.mark.parametrize("mode", ["diag", "chunk"])
@pytest.mark.parametrize("case", SELL_CASES, ids=SELL_IDS)
def test_sell_pack_equals_jax(case, mode):
    _, build, G = case
    A = build()
    ja, js = jsell.sell_pack(A, G=G, mode=mode)
    ta, ts = tsell.sell_pack(A, G=G, mode=mode)
    assert ts == js
    assert set(ta) == set(ja)
    for key in ja:
        assert ta[key].dtype == ja[key].dtype, key
        np.testing.assert_array_equal(ta[key], ja[key], err_msg=key)


@pytest.mark.parametrize("mode", ["diag", "chunk"])
@pytest.mark.parametrize("case", SELL_CASES, ids=SELL_IDS)
def test_sell_to_scipy_inverts_the_pack(case, mode):
    _, build, G = case
    A = sp.csr_matrix(build(), dtype=np.float32)
    B = tsell.sell_to_scipy(tsell.sell_from_scipy(A, G=G, mode=mode,
                                                  device=CPU))
    assert B.shape == A.shape and B.dtype == np.float32
    assert (B != A).nnz == 0


def test_sell_poisson_pack_matches_jax_builder():
    """Both packages' poisson_3d builders give the same matrix."""
    A, B = poisson_3d(16, 16, 16), jpoisson_3d(16, 16, 16)
    assert (A != B).nnz == 0


def _mult_pair(A, G, mode):
    J = jsell.sell_from_scipy(A, G=G, mode=mode)
    T = tsell.sell_from_scipy(A, G=G, mode=mode, device=CPU)
    x = np.random.default_rng(1).standard_normal(A.shape[1]).astype(np.float32)
    return J, T, x, np.asarray(J.mult(jnp.asarray(x)))


@pytest.mark.parametrize("case", SELL_CASES, ids=SELL_IDS)
def test_sell_mult_matches_jax(case):
    _, build, G = case
    A = build()
    J, T, x, ref = _mult_pair(A, G, "diag")
    got = T.mult(torch.from_numpy(x)).numpy()
    assert got.dtype == np.float32 and got.shape == ref.shape
    assert np.abs(got - ref).max() <= 1e-6 * np.abs(ref).max()
    np.testing.assert_allclose(T.diagonal().numpy(), np.asarray(J.diagonal()))


def test_sell_chunk_mode_rectangular_matches_jax():
    """A rectangular chunk-mode operator (the MG transfer shape)."""
    A = banded_random(2 * 8 * 128 + 77, 300, 4, seed=5, ncols=1200)
    J, T, x, ref = _mult_pair(A, 8, "chunk")
    got = T.mult(torch.from_numpy(x)).numpy()
    assert got.shape == (A.shape[0],)
    assert np.abs(got - ref).max() <= 1e-6 * np.abs(ref).max()
    assert np.abs(got - A @ x).max() <= 1e-5 * np.abs(A @ x).max()


def test_sell_from_arrays_carries_jax_sellmat():
    A = banded_random(*SELL_SHAPES[0][:3])
    J = jsell.sell_from_scipy(A, G=8)
    arrays = {k: np.asarray(getattr(J, k))
              for k in ("vals", "idx", "qs", "winstart", "diag")}
    statics = dict(shape=J.shape, nnz=J.nnz, G=J.G, S=J.S, Lp=J.Lp,
                   mode=J.mode)
    T = convert.sell_from_arrays(arrays, statics, device=CPU)
    x = np.random.default_rng(4).standard_normal(A.shape[0]).astype(np.float32)
    ref = np.asarray(J.mult(jnp.asarray(x)))
    got = T.mult(torch.from_numpy(x)).numpy()
    assert np.abs(got - ref).max() <= 1e-6 * np.abs(ref).max()
    assert T.flops_per_mult() == J.flops_per_mult()


def test_aij_and_jacobi_from_arrays():
    A, J, _ = _aij_pair()
    T = convert.aij_from_arrays(np.asarray(J.cols), np.asarray(J.vals),
                                J.shape, J.nnz, device=CPU)
    v = np.random.default_rng(2).standard_normal(300)
    np.testing.assert_allclose(T.mult(torch.from_numpy(v)).numpy(),
                               np.asarray(J.mult(jnp.asarray(v))),
                               rtol=1e-13)
    from petsctpu.pc.simple import make_jacobi
    jpc = make_jacobi(J)
    tpc = convert.jacobi_from_arrays(np.asarray(jpc.dinv), device=CPU)
    np.testing.assert_array_equal(tpc.apply(torch.from_numpy(v)).numpy(),
                                  np.asarray(jpc.apply(jnp.asarray(v))))


def test_sell_multT_is_k3():
    """multT runs K3 in chunk mode only."""
    T = tsell.sell_from_scipy(banded_random(4 * 4 * 128, 60, 5), G=4,
                              mode="diag", device=CPU)
    with pytest.raises(NotImplementedError, match="chunk mode only"):
        T.multT(torch.ones(T.shape[0]))


def _prolongator_like(G, seed=5, wide=False, empty_tile=False):
    """tests/test_sell.py:234's case: few nonzeros a row, columns
    clustered by row blocks. wide=True spreads them over 80,000 columns
    (every window then spans about 640 rows); empty_tile=True leaves the
    second tile's rows empty."""
    rng = np.random.default_rng(seed)
    m, n = G * 128 * 3 + 77, 1400
    rows = np.repeat(np.arange(m), 3)
    if wide:
        n = 80000
        cols = rng.integers(0, n, rows.size)
    else:
        cols = np.clip((rows // (m // n + 1))
                       + rng.integers(-40, 40, rows.size), 0, n - 1)
    vals = rng.standard_normal(rows.size).astype(np.float32)
    if empty_tile:
        vals[(rows >= G * 128) & (rows < 2 * G * 128)] = 0.0
    A = sp.coo_matrix((vals, (rows, cols)), shape=(m, n)).tocsr()
    A.sum_duplicates()
    A.eliminate_zeros()
    return A, rng.standard_normal(m).astype(np.float32)


@pytest.mark.parametrize("G", [8, 16])
def test_sell_multT_matches_jax_and_scipy(G):
    A, r = _prolongator_like(G)
    J = jsell.sell_from_scipy(A, G=G, mode="chunk", interpret=True)
    T = tsell.sell_from_scipy(A, G=G, mode="chunk", device=CPU)
    got = T.multT(torch.from_numpy(r)).numpy()
    assert got.dtype == np.float32 and got.shape == (A.shape[1],)
    np.testing.assert_allclose(got, np.asarray(J.multT(jnp.asarray(r))),
                               rtol=2e-5, atol=2e-4)
    np.testing.assert_allclose(got, A.T @ r, rtol=2e-5, atol=2e-4)
    assert T.transpose_plan() is T.transpose_plan()     # built once, kept


def _sequential_spmvT(T, rt):
    """y = Tᵀr by a direct loop in the definition's order: each pass's row
    over its slots in (g, l) order, each window row over its passes, each
    y row over the tiles."""
    vals, idx, qs, ws = (t.numpy() for t in (T.vals, T.idx, T.qs,
                                             T.winstart))
    nt, P = vals.shape[:2]
    part = np.zeros((nt, P, 128), np.float32)
    for t, p, g, l in zip(*np.nonzero(vals)):
        c = idx[t, p, g, l]
        part[t, p, c] = part[t, p, c] + vals[t, p, g, l] * rt[t, g, l]
    wins = np.zeros((nt, T.S, 128), np.float32)
    for t in range(nt):
        for p in range(P):
            wins[t, qs[t, p]] = wins[t, qs[t, p]] + part[t, p]
    ref = np.zeros((T.Lp, 128), np.float32)
    for t in range(nt):
        ref[ws[t]:ws[t] + T.S] = ref[ws[t]:ws[t] + T.S] + wins[t]
    return ref


def _padded_r(T, r):
    rt = np.zeros(T.nt * T.G * 128, np.float32)
    rt[:r.size] = r
    return rt.reshape(T.nt, T.G, 128)


def test_sell_spmvT_plain_matches_sequential_loop():
    """The plain version sums each pass's row in (g, l) order, each window
    row over its passes in order and each y row over the tiles in order:
    bit-equal to a direct loop, and so is K3's wrapper on a plan."""
    from petsctpu_torch.ops.sell_spmvT import (sell_spmvT, sell_spmvT_plain,
                                               transpose_plan)

    A, r = _prolongator_like(4, seed=8)
    T = tsell.sell_from_scipy(A, G=4, mode="chunk", device=CPU)
    rt = _padded_r(T, r)
    ref = _sequential_spmvT(T, rt)
    y = sell_spmvT_plain(T.vals, T.idx, T.qs, T.winstart,
                         torch.from_numpy(rt), S=T.S, Lp=T.Lp).numpy()
    np.testing.assert_array_equal(y, ref)
    plan = transpose_plan(T.vals, T.idx, T.qs, T.winstart, S=T.S, Lp=T.Lp)
    np.testing.assert_array_equal(
        sell_spmvT(plan, torch.from_numpy(r)).numpy(), ref)


PLAN_CASES = {
    "G4": dict(G=4), "G8": dict(G=8), "G16": dict(G=16),
    "wide_80000_cols": dict(G=8, wide=True),
    "empty_tile": dict(G=8, empty_tile=True),
}


@pytest.mark.parametrize("shape", ["auto", "thread", "warp"])
@pytest.mark.parametrize("case", list(PLAN_CASES))
def test_transpose_plan_plain_equals_definition(case, shape):
    """The plan's plain version equals sell_spmvT_plain on the pack and
    the sequential loop bit for bit, in either launch shape."""
    from petsctpu_torch.ops.sell_spmvT import (sell_spmvT_plain,
                                               sell_spmvT_plan_plain,
                                               transpose_plan)

    kw = PLAN_CASES[case]
    A, r = _prolongator_like(seed=6, **kw)
    T = tsell.sell_from_scipy(A, G=kw["G"], mode="chunk", device=CPU)
    if case == "wide_80000_cols":
        assert T.S >= 600
    if case == "empty_tile":
        assert not T.vals[1].any()
    rt = _padded_r(T, r)
    ref = sell_spmvT_plain(T.vals, T.idx, T.qs, T.winstart,
                           torch.from_numpy(rt), S=T.S, Lp=T.Lp)
    np.testing.assert_array_equal(ref.numpy(), _sequential_spmvT(T, rt))
    warp = {"auto": None, "thread": False, "warp": True}[shape]
    plan = transpose_plan(T.vals, T.idx, T.qs, T.winstart, S=T.S, Lp=T.Lp,
                          warp_shape=warp)
    if warp is not None:
        assert plan.warp_shape == warp
    y = sell_spmvT_plan_plain(plan, torch.from_numpy(r))
    assert y.shape == (T.Lp, 128) and torch.equal(y, ref)
    assert plan.rows <= A.shape[0] and int(plan.cnt.sum()) == A.nnz


def test_transpose_plan_split_rule_limit(monkeypatch):
    """A CPU plan takes the H100's limit (132 SMs x 64 warps); the rule
    picks the warp shape up to the limit and the thread shape above."""
    from petsctpu_torch.ops import sell_spmvT as k3

    assert k3.warp_shape_max_outputs("cpu") == 132 * 64 == 8448
    A, _ = _prolongator_like(seed=6, G=8)
    T = tsell.sell_from_scipy(A, G=8, mode="chunk", device=CPU)
    live = int((torch.bincount(
        torch.from_numpy(sp.csr_matrix(A).indices)) > 0).sum())
    pk = (T.vals, T.idx, T.qs, T.winstart)
    for limit, warp in ((live, True), (live - 1, False)):
        monkeypatch.setattr(k3, "warp_shape_max_outputs",
                            lambda dev, n=limit: n)
        assert k3.transpose_plan(*pk, S=T.S, Lp=T.Lp).warp_shape == warp


def test_transpose_plan_flags_and_padding_on_two_tiles():
    """A hand-made pack: nt 2, P 2, G 1. Output 133 takes slots
    (t0,p0,l0), (t0,p0,l3), (t0,p1,l1) and (t1,p0,l4); output 135 takes
    (t0,p1,l2)."""
    from petsctpu_torch.ops.sell_spmvT import (PASS_FLAG, TILE_FLAG,
                                               sell_spmvT_plain,
                                               sell_spmvT_plan_plain,
                                               transpose_plan)

    vals = torch.zeros((2, 2, 1, 128))
    idx = torch.zeros((2, 2, 1, 128), dtype=torch.int8)
    for (t, p, l), v, c in (((0, 0, 0), 1.0, 5), ((0, 0, 3), 2.0, 5),
                            ((0, 1, 1), 3.0, 5), ((0, 1, 2), 4.0, 7),
                            ((1, 0, 4), 5.0, 5)):
        vals[t, p, 0, l], idx[t, p, 0, l] = v, c
    qs = torch.ones((2, 2), dtype=torch.int32)
    ws = torch.zeros(2, dtype=torch.int32)
    pk = (vals, idx, qs, ws)
    P_, T_ = PASS_FLAG, TILE_FLAG - (1 << 32)      # as int32 bits
    # thread shape: outputs 133 and 135 are lanes 5 and 7 of group 4,
    # the only group with entries; its longest list has 4
    th = transpose_plan(*pk, S=2, Lp=2, warp_shape=False)
    assert (th.val.numel(), th.nout, th.longest) == (128, 256, 4)
    assert th.cnt[133] == 4 and th.cnt[135] == 1 and th.cnt.sum() == 5
    assert th.first[133] == 5 and th.first[135] == 7
    np.testing.assert_array_equal(th.val[5::32].numpy(), [1, 2, 3, 5])
    np.testing.assert_array_equal(th.src[5::32].numpy(),
                                  [0 | P_ | T_, 3, 1 | P_, 132 | P_ | T_])
    assert th.val[7] == 4 and th.src[7] == 2 | P_ | T_
    pad = torch.ones(128, dtype=torch.bool)
    pad[5::32] = False
    pad[7] = False
    assert not th.val[pad].any() and not th.src[pad].any()
    # warp shape: output 133 is split into its tile-0 and tile-1 segments
    wp = transpose_plan(*pk, S=2, Lp=2, warp_shape=True)
    assert wp.val.numel() == 5 and wp.longest == 3
    np.testing.assert_array_equal(wp.val.numpy(), [1, 2, 3, 5, 4])
    assert wp.ogroup[133] == 0 and wp.ogroup[134] == 1
    assert wp.ogroup[135] == 1 and wp.ogroup[136] == 2 == wp.ogroup[-1]
    np.testing.assert_array_equal(wp.first[[0, 1, 32]].numpy(), [0, 3, 4])
    np.testing.assert_array_equal(wp.cnt[[0, 1, 32]].numpy(), [3, 1, 1])
    assert int(wp.cnt.sum()) == 5
    r = torch.from_numpy(np.random.default_rng(0).standard_normal(256)
                         .astype(np.float32))
    ref = sell_spmvT_plain(*pk, r.view(2, 1, 128), S=2, Lp=2)
    w0 = (r[0] * 1.0 + r[3] * 2.0) + r[1] * 3.0    # tile 0: two passes
    assert ref.reshape(-1)[133] == w0 + r[132] * 5.0
    for plan in (th, wp):
        assert torch.equal(sell_spmvT_plan_plain(plan, r), ref)


def test_sell_spmvT_rejects_what_the_kernel_does_not_take():
    from petsctpu_torch.ops.sell_spmvT import sell_spmvT, transpose_plan

    nt, P, G, S, Lp = 2, 3, 4, 8, 16

    def args(device="cpu", **over):
        a = dict(vals=torch.zeros((nt, P, G, 128), dtype=torch.float32),
                 idx=torch.zeros((nt, P, G, 128), dtype=torch.int8),
                 qs=torch.zeros((nt, P), dtype=torch.int32),
                 winstart=torch.zeros((nt,), dtype=torch.int32))
        a = {k: v.to(device) for k, v in a.items()}
        a.update(over)
        return a

    plan = transpose_plan(**args(), S=S, Lp=Lp)
    r = torch.zeros(nt * G * 128)
    assert sell_spmvT(plan, r).shape == (Lp, 128)
    assert not sell_spmvT(plan, r).any()
    with pytest.raises(ValueError, match="not supported"):
        transpose_plan(**args("meta"), S=S, Lp=Lp)
    bad = [dict(vals=torch.zeros((nt, P, G, 128), dtype=torch.float64)),
           dict(idx=torch.zeros((nt, P, G, 128), dtype=torch.int32)),
           dict(qs=torch.zeros((nt, P + 1), dtype=torch.int32)),
           dict(vals=torch.zeros((nt, P, G, 256), dtype=torch.float32)
                [..., ::2])]
    for over in bad:
        with pytest.raises(ValueError):
            transpose_plan(**args(**over), S=S, Lp=Lp)
    with pytest.raises(ValueError, match="window rows"):
        transpose_plan(**args(), S=Lp + 1, Lp=Lp)
    # the fine row and two flags share an entry's 32 bits
    big = 1 << 19                           # nt·G·128 = 2³⁰ at G = 16
    with pytest.raises(ValueError, match="30 bits"):
        transpose_plan(vals=torch.zeros((big, 0, 16, 128)),
                       idx=torch.zeros((big, 0, 16, 128), dtype=torch.int8),
                       qs=torch.zeros((big, 0), dtype=torch.int32),
                       winstart=torch.zeros(big, dtype=torch.int32),
                       S=S, Lp=Lp)
    # the wrapper: r, and the plan, on the same device, of the right type
    with pytest.raises(ValueError, match="not supported"):
        sell_spmvT(plan, r.to("meta"))
    with pytest.raises(ValueError, match="is on"):
        sell_spmvT(replace(plan, val=plan.val.to("meta")), r)
    with pytest.raises(ValueError, match="must be torch.float32"):
        sell_spmvT(replace(plan, val=plan.val.double()), r)
    with pytest.raises(ValueError, match="must be torch.int32"):
        sell_spmvT(replace(plan, src=plan.src.long()), r)
    for bad_r in (r.double(), r.view(nt, G, 128), torch.zeros(2 * r.numel())
                  [::2]):
        with pytest.raises(ValueError, match="contiguous float32 vector"):
            sell_spmvT(plan, bad_r)
    with pytest.raises(TypeError, match="TransposePlan"):
        sell_spmvT(args(), r)
    full = transpose_plan(**args(vals=torch.ones((nt, P, G, 128))), S=S,
                          Lp=Lp)
    assert full.rows == nt * G * 128
    with pytest.raises(ValueError, match="the plan reads"):
        sell_spmvT(full, r[:-1])


def test_sell_plan_stats_and_viability_match_jax():
    A = poisson_3d(16, 16, 16, np.float32)
    assert tsell.sell_plan_stats(A, G=8) == jsell.sell_plan_stats(A, G=8)
    assert tsell.sell_viable(A, G=8) == jsell.sell_viable(A, G=8)


# ---------------------------------------------------------- factory ----
@pytest.mark.parametrize("mat_type", ["aij", "sell"])
@pytest.mark.parametrize("ordering", ["natural", "rcm"])
def test_mat_from_options_perm_matches_jax(ordering, mat_type):
    from petsctpu.core.options import Options as JOptions
    from petsctpu.mat.factory import mat_from_options as jmat_from_options

    if mat_type == "sell":
        A = poisson_3d(12, 12, 12)       # 1728 rows: one G=16 tile
    else:
        A, _, _ = ex2_system(8, 7)
        assert (A != jex2(8, 7)[0]).nnz == 0
    opts = {"mat_type": mat_type, "mat_ordering_type": ordering}
    J, jperm = jmat_from_options(A, JOptions(opts))
    T, tperm = mat_from_options(A, Options(opts), device=CPU)
    if jperm is None:
        assert tperm is None
    else:
        np.testing.assert_array_equal(tperm, jperm)
    x = np.random.default_rng(3).standard_normal(A.shape[0])
    if mat_type == "sell":
        x = x.astype(np.float32)
        ref = np.asarray(J.mult(jnp.asarray(x)))
        got = T.mult(torch.from_numpy(x)).numpy()
        assert np.abs(got - ref).max() <= 1e-6 * np.abs(ref).max()
    else:
        np.testing.assert_allclose(T.mult(torch.from_numpy(x)).numpy(),
                                   np.asarray(J.mult(jnp.asarray(x))),
                                   rtol=1e-13)


@pytest.mark.parametrize("mat_type", ["baij", "sbaij", "dense", "band",
                                      "dia", "auto"])
def test_mat_types_not_ported_raise(mat_type):
    """No -mat_type raises any more: the formats came with slice 12
    (tests/test_torch_formats.py holds them to petsctpu's) and auto with
    slice 16 (on the CPU it takes petsctpu's off-TPU choice, here the
    natural band; tests/test_torch_griddetect.py)."""
    A, _, _ = ex2_system(4, 4)
    M, _ = mat_from_options(A, mat_type=mat_type, device=CPU)
    assert type(M).__name__ == {"baij": "BAIJ", "sbaij": "SBAIJ",
                                "dense": "Dense", "band": "BandMat",
                                "dia": "DiaMat", "auto": "BandMat"}[mat_type]


def test_rcm_fast_and_bandwidth_match_jax():
    from petsctpu.mat.order import bandwidth as jbandwidth
    from petsctpu_torch.mat.order import bandwidth, get_ordering

    A, _, _ = ex2_system(9, 6)
    perm = get_ordering(A, "rcm_fast")
    np.testing.assert_array_equal(np.sort(perm), np.arange(A.shape[0]))
    Ap = A[perm][:, perm]
    assert bandwidth(Ap) == jbandwidth(Ap) <= bandwidth(A)
    with pytest.raises(ValueError, match="unknown ordering"):
        get_ordering(A, "amd")


@pytest.mark.parametrize("G,mode", [(16, "diag"), (8, "chunk")])
def test_plan_of_unsorted_rows_with_duplicates_equals_reference(G, mode):
    """A CSR whose rows list their columns out of order, some twice:
    _plan sorts it first, and its plan (each slot's tile, pass, row,
    window position; the stats) equals petsctpu's lexsorted one."""
    rng = np.random.default_rng(5)
    A = banded_random(3 * G * 128 + 77, 900, 9)
    rows = np.repeat(np.arange(A.shape[0]), np.diff(A.indptr))
    dup = rng.random(A.nnz) < 0.1
    perm = np.lexsort((rng.random(A.nnz + dup.sum()),
                       np.concatenate([rows, rows[dup]])))
    cols = np.concatenate([A.indices, A.indices[dup]])[perm]
    data = np.concatenate([A.data, A.data[dup]])[perm]
    indptr = np.concatenate([[0], np.cumsum(np.bincount(
        rows[np.r_[np.arange(A.nnz), np.flatnonzero(dup)]],
        minlength=A.shape[0]))])
    B = sp.csr_matrix((data, cols, indptr), shape=A.shape)
    assert not B.has_sorted_indices
    ours, ref = tsell._plan(B, G, mode), jsell._plan(B, G, mode)
    for k in ("t", "g", "lane", "pos", "q", "pass_of", "wmin"):
        np.testing.assert_array_equal(ours[k], ref[k])
    assert tsell.sell_plan_stats(B, G, mode) == jsell.sell_plan_stats(
        B, G, mode)
