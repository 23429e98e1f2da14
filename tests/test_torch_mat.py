"""The port's matrices against petsctpu's, on the CPU.

* AIJ: every op against petsctpu.mat.ell, fp64, rtol 1e-13 (a row sum
  of a few terms may round in another order).
* SELL: the port's host pack must EQUAL petsctpu's, array for array, in
  both modes; its mult (the kernel's plain version) must match the JAX
  SellMat.mult (Pallas interpret mode, as tests/test_sell.py runs it)
  within 1e-6·max|y| — the pass order is the same, and the tolerance
  covers XLA:CPU's freedom to contract a multiply and an add.
* convert: JAX objects carried across by their numpy fields.
* mat_from_options: the same perm as petsctpu.
"""

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
    """multT runs K3 in chunk mode only; the GAMG device refresh's
    templates are not ported yet."""
    T = tsell.sell_from_scipy(banded_random(4 * 4 * 128, 60, 5), G=4,
                              mode="diag", device=CPU)
    with pytest.raises(NotImplementedError, match="chunk mode only"):
        T.multT(torch.ones(T.shape[0]))
    for fn in (lambda: tsell.sell_template(None), lambda: tsell.sell_fill(
            None, None, None, None)):
        with pytest.raises(NotImplementedError, match="queue 1 item 8"):
            fn()


def _prolongator_like(G, seed=5):
    """tests/test_sell.py:234's case: few nonzeros a row, columns
    clustered by row blocks."""
    rng = np.random.default_rng(seed)
    m, n = G * 128 * 3 + 77, 1400
    rows = np.repeat(np.arange(m), 3)
    cols = np.clip((rows // (m // n + 1)) + rng.integers(-40, 40, rows.size),
                   0, n - 1)
    A = sp.coo_matrix((rng.standard_normal(rows.size).astype(np.float32),
                       (rows, cols)), shape=(m, n)).tocsr()
    A.sum_duplicates()
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


def test_sell_spmvT_plain_matches_sequential_loop():
    """The plain version sums each pass's row in (g, l) order, each window
    row over its passes in order and each y row over the tiles in order:
    bit-equal to a direct loop."""
    from petsctpu_torch.ops.sell_spmvT import sell_spmvT

    A, r = _prolongator_like(4, seed=8)
    T = tsell.sell_from_scipy(A, G=4, mode="chunk", device=CPU)
    vals, idx, qs, ws = (t.numpy() for t in (T.vals, T.idx, T.qs,
                                             T.winstart))
    nt, P, G = vals.shape[:3]
    rt = np.zeros(nt * G * 128, np.float32)
    rt[:A.shape[0]] = r
    rt = rt.reshape(nt, G, 128)
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
    y = sell_spmvT(T.vals, T.idx, T.qs, T.winstart, torch.from_numpy(rt),
                   S=T.S, Lp=T.Lp).numpy()
    np.testing.assert_array_equal(y, ref)


def test_sell_spmvT_rejects_what_the_kernel_does_not_take():
    from petsctpu_torch.ops.sell_spmvT import sell_spmvT

    nt, P, G, S, Lp = 2, 3, 4, 8, 16

    def args(device="cpu", **over):
        a = dict(vals=torch.zeros((nt, P, G, 128), dtype=torch.float32),
                 idx=torch.zeros((nt, P, G, 128), dtype=torch.int8),
                 qs=torch.zeros((nt, P), dtype=torch.int32),
                 winstart=torch.zeros((nt,), dtype=torch.int32),
                 rt=torch.zeros((nt, G, 128), dtype=torch.float32))
        a = {k: v.to(device) for k, v in a.items()}
        a.update(over)
        return a

    assert sell_spmvT(**args(), S=S, Lp=Lp).shape == (Lp, 128)
    with pytest.raises(ValueError, match="not supported"):
        sell_spmvT(**args("meta"), S=S, Lp=Lp)
    bad = [dict(vals=torch.zeros((nt, P, G, 128), dtype=torch.float64)),
           dict(idx=torch.zeros((nt, P, G, 128), dtype=torch.int32)),
           dict(qs=torch.zeros((nt, P + 1), dtype=torch.int32)),
           dict(rt=torch.zeros((nt, G + 1, 128), dtype=torch.float32)),
           dict(vals=torch.zeros((nt, P, G, 256), dtype=torch.float32)
                [..., ::2])]
    for over in bad:
        with pytest.raises(ValueError):
            sell_spmvT(**args(**over), S=S, Lp=Lp)
    with pytest.raises(ValueError, match="window rows"):
        sell_spmvT(**args(), S=Lp + 1, Lp=Lp)


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
    A, _, _ = ex2_system(4, 4)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        mat_from_options(A, mat_type=mat_type, device=CPU)


def test_rcm_fast_and_bandwidth_match_jax():
    from petsctpu.mat.order import bandwidth as jbandwidth
    from petsctpu_torch.mat.order import bandwidth, get_ordering

    A, _, _ = ex2_system(9, 6)
    perm = get_ordering(A, "rcm_fast")
    np.testing.assert_array_equal(np.sort(perm), np.arange(A.shape[0]))
    Ap = A[perm][:, perm]
    assert bandwidth(Ap) == jbandwidth(Ap) <= bandwidth(A)
    with pytest.raises(NotImplementedError, match="queue 1 item 5"):
        get_ordering(A, "nd")
