"""The port's GAMG (smoothed aggregation on a SELL operator, with the
restriction through kernel K3) against petsctpu's, on the CPU.

* gamg_hierarchy equals petsctpu's exactly on the 2-D 128² Laplacian and
  the 3-D 16³ Poisson operator; the port's Python aggregation equals
  petsctpu.native.aggregate.
* The packed branch, with petsctpu's backend reported as "tpu" (the port
  takes that branch's decisions on every device, as tests/test_sell.py:
  274 builds them): pack_hierarchy's buffers and metas equal
  PackedMGPC's, and the per-level formats equal the metas' kinds, with
  level 0 restricting through P.multT, the plain version of K3's plan
  here; the plan of every transfer level of a small ex45 hierarchy
  equals the definition (sell_spmvT_plain on the pack) bit for bit.
* One V-cycle (and a W-cycle, and additive MG) of the port's own setup
  and of convert.mg_from_packed on the reference's PackedMGPC, against
  PackedMGPC.apply (Pallas interpret mode): within 2e-4·max|y|
  (tests/test_sell.py:290-292). The non-packed branch and fmt="sell"
  (PermutedPC) are held the same way.
* CG+GAMG through KSP: equal its and reason, history within 1e-3
  relative (fp32; the reference's reductions run on XLA:CPU).
* DenseLUPC against scipy on a matrix that pivots; Dense and
  RectBandMat against petsctpu's; the options that are not ported raise.
"""

from dataclasses import replace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.linalg as sla
import scipy.sparse as sp
import torch

from petsctpu import native
from petsctpu.core.options import Options as JOptions
from petsctpu.ksp import KSP as JKSP
from petsctpu.mat import dense as jdense
from petsctpu.mat import rectband as jrectband
from petsctpu.mat import sell as jsell
from petsctpu.pc import gamg as jgamg
from petsctpu.pc import make_pc as jmake_pc
from petsctpu_torch import convert
from petsctpu_torch.core.options import Options
from petsctpu_torch.ksp import KSP
from petsctpu_torch.mat import aij_from_scipy
from petsctpu_torch.mat import dense as tdense
from petsctpu_torch.mat import rectband as trectband
from petsctpu_torch.mat.sell import sell_from_scipy
from petsctpu_torch.models import laplacian_2d, poisson_3d
from petsctpu_torch.ops import sell_spmvT as k3
from petsctpu_torch.pc import gamg as tgamg
from petsctpu_torch.pc import make_pc
from petsctpu_torch.pc.factor import PermutedPC
from petsctpu_torch.pc.gamg_device import DenseLUPC
from petsctpu_torch.pc.mg import pack_hierarchy

CPU = "cpu"
GAMG_OPTS = {"pc_gamg_coarse_eq_limit": "64"}


def _rel(got, ref):
    got, ref = np.asarray(got), np.asarray(ref)
    assert got.shape == ref.shape
    return float(np.abs(got - ref).max() / np.abs(ref).max())


def _jax_fmt(op):
    """The port's op_format of a petsctpu operator."""
    name = type(op).__name__
    if name == "SellMat":
        return ("sell", op.G, op.mode)
    if name == "RectBandMat":
        return ("rectband", op.s, op.off, op.B.shape[1])
    return {"Dense": ("dense",), "AIJ": ("ell",)}[name]


def _meta_fmt(ref):
    """The port's op_format of a PackedMGPC meta entry."""
    if ref is None:
        return None
    if ref[0] == "sell":
        return ("sell", ref[8], ref[12])
    if ref[0] == "rectband":
        return ("rectband", ref[2], ref[3], ref[6][1])
    return (ref[0],)


def _jax_pc_on_tpu_policy(A, opts, J=None):
    """petsctpu's GAMG with its backend reported as "tpu" during the
    setup, so it takes the SELL decisions; the Pallas calls still run in
    interpret mode on the CPU."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax, "default_backend", lambda: "tpu")
        return jmake_pc("gamg", A=J, A_host=A, options=JOptions(opts))


@pytest.fixture(scope="module")
def lap128():
    A = laplacian_2d(128, 128, dtype=np.float32).tocsr()
    b = np.random.default_rng(0).standard_normal(A.shape[0]) \
        .astype(np.float32)
    return A, b, _jax_pc_on_tpu_policy(A, GAMG_OPTS)


@pytest.fixture(scope="module")
def ref_applies(lap128):
    """petsctpu's apply of the packed PC, per (cycles, mg_type)."""
    _, b, jpc = lap128
    cache = {}

    def get(cycles, mg_type):
        if (cycles, mg_type) not in cache:
            p = replace(jpc, cycles=cycles, mg_type=mg_type)
            cache[cycles, mg_type] = np.asarray(
                jax.jit(lambda q, v: q.apply(v))(p, jnp.asarray(b)))
        return cache[cycles, mg_type]

    return get


# ------------------------------------------------------------ hierarchy ----
HIERARCHY_CASES = {
    "lap2d_128": lambda: laplacian_2d(128, 128),
    "poisson3d_16": lambda: poisson_3d(16, 16, 16),
}


@pytest.mark.parametrize("case", list(HIERARCHY_CASES))
def test_gamg_hierarchy_equals_petsctpu(case):
    A = HIERARCHY_CASES[case]()
    As, Ps = tgamg.gamg_hierarchy(A)
    jAs, jPs = jgamg.gamg_hierarchy(A)
    assert len(As) == len(jAs) >= 3 and len(Ps) == len(As) - 1
    for got, ref in zip(As + Ps, jAs + jPs):
        assert got.shape == ref.shape and (got != ref).nnz == 0


@pytest.mark.parametrize("case", list(HIERARCHY_CASES))
def test_python_aggregate_equals_native(case):
    assert native.available()
    A = HIERARCHY_CASES[case]()
    for theta in (0.0, 0.3):
        S = tgamg.strength_graph(A, theta)
        ref = native.aggregate(S.indptr.astype(np.int64),
                               S.indices.astype(np.int32))
        np.testing.assert_array_equal(tgamg.aggregate(S), ref)


def test_aggregate_hem_and_rigid_body_modes_equal_petsctpu():
    A = laplacian_2d(20, 20)
    np.testing.assert_array_equal(tgamg.aggregate_hem(A, rounds=2),
                                  jgamg.aggregate_hem(A, rounds=2))
    coords = np.random.default_rng(3).random((30, 3))
    np.testing.assert_allclose(tgamg.rigid_body_modes(coords),
                               jgamg.rigid_body_modes(coords), rtol=0,
                               atol=1e-14)


# --------------------------------------------------------- packed branch ----
def test_packed_buffers_equal_reference(lap128):
    A, _, jpc = lap128
    As, Ps = tgamg.gamg_hierarchy(A, coarse_n=64)
    fbuf, ibuf, metas, coarse_meta = pack_hierarchy(As, Ps, np.float32,
                                                    use_sell=True)
    assert metas == jpc.metas and coarse_meta == jpc.coarse_meta
    np.testing.assert_array_equal(fbuf, np.asarray(jpc.fbuf))
    np.testing.assert_array_equal(ibuf, np.asarray(jpc.ibuf))


def test_formats_match_reference_and_restrict_through_k3(lap128,
                                                         monkeypatch):
    A, b, jpc = lap128
    T = sell_from_scipy(A, device=CPU)
    pc = make_pc("gamg", A=T, A_host=A, options=Options(GAMG_OPTS))
    ref = [tuple(_meta_fmt(r) for r in m[:3]) for m in jpc.metas]
    assert pc.formats == ref
    assert pc.formats[0][1] == ("sell", 8, "chunk")
    assert pc.formats[0][2] is None               # restricts through P.multT
    calls = []
    plain = k3.sell_spmvT_plan_plain

    def spy(plan, r):
        calls.append(plan.nout)
        return plain(plan, r)

    monkeypatch.setattr(k3, "sell_spmvT_plan_plain", spy)
    y = pc.apply(torch.from_numpy(b))
    via_multT = sum(f[2] is None for f in pc.formats)
    assert len(calls) == via_multT >= 1
    sells = [op for lv in pc.levels for op in (lv.A, lv.P)
             if type(op).__name__ == "SellMat"]
    assert sells and all(op.vals.data_ptr() % 16 == 0 for op in sells)
    assert y.shape == (A.shape[0],) and torch.isfinite(y).all()


@pytest.mark.parametrize("level", [0, 1])
def test_transpose_plan_of_ex45_transfer_levels(level):
    """The chunk-mode pack of each GAMG prolongator of ex45 at 24³: the
    plan's plain version equals sell_spmvT_plain bit for bit, in the
    shape the rule picks and in the other, and Pᵀr of scipy within
    1e-5."""
    As, Ps = tgamg.gamg_hierarchy(poisson_3d(24, 24, 24, np.float32),
                                  coarse_n=64)
    assert len(Ps) >= 2
    P = sp.csr_matrix(Ps[level], dtype=np.float32)
    T = sell_from_scipy(P, G=8, mode="chunk", device=CPU)
    r = np.random.default_rng(level).standard_normal(P.shape[0]) \
        .astype(np.float32)
    rt = torch.zeros(T.nt * T.G * 128)
    rt[:P.shape[0]] = torch.from_numpy(r)
    ref = k3.sell_spmvT_plain(T.vals, T.idx, T.qs, T.winstart,
                              rt.view(T.nt, T.G, 128), S=T.S, Lp=T.Lp)
    auto = T.transpose_plan()
    other = k3.transpose_plan(T.vals, T.idx, T.qs, T.winstart, S=T.S,
                              Lp=T.Lp, warp_shape=not auto.warp_shape)
    for plan in (auto, other):
        assert torch.equal(k3.sell_spmvT_plan_plain(plan,
                                                    torch.from_numpy(r)), ref)
    got = T.multT(torch.from_numpy(r)).double().numpy()
    ref64 = P.T.astype(np.float64) @ r.astype(np.float64)
    assert _rel(got, ref64) <= 1e-5


@pytest.mark.parametrize("setup", ["port", "convert"])
@pytest.mark.parametrize("mg_type,cycles", [("multiplicative", 1),
                                            ("multiplicative", 2),
                                            ("additive", 1)])
def test_mg_apply_matches_reference(lap128, ref_applies, setup, mg_type,
                                    cycles):
    A, b, jpc = lap128
    if setup == "port":
        opts = {**GAMG_OPTS, "pc_mg_type": mg_type,
                "pc_mg_cycle_type": "w" if cycles == 2 else "v"}
        pc = make_pc("gamg", A=sell_from_scipy(A, device=CPU), A_host=A,
                     options=Options(opts))
    else:
        pc = convert.mg_from_packed(np.asarray(jpc.fbuf),
                                    np.asarray(jpc.ibuf), jpc.metas,
                                    jpc.coarse_meta, jpc.sm_its, cycles,
                                    mg_type, device=CPU)
    assert (pc.cycles, pc.mg_type) == (cycles, mg_type)
    y = pc.apply(torch.from_numpy(b)).numpy()
    assert _rel(y, ref_applies(cycles, mg_type)) <= 2e-4


def test_cg_gamg_solve_matches_reference(lap128):
    A, b, _ = lap128
    opts = {"ksp_type": "cg", "pc_type": "gamg", "ksp_rtol": "1e-5",
            **GAMG_OPTS}
    res = KSP(Options(opts)).set_operators(
        sell_from_scipy(A, device=CPU), A_host=A).solve(torch.from_numpy(b))
    jksp = JKSP(JOptions(opts)).set_operators(jsell.sell_from_scipy(A),
                                              A_host=A)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax, "default_backend", lambda: "tpu")
        jksp.set_from_options().setup()
    jres = jksp.solve(jnp.asarray(b))
    its = int(res.its)
    assert its == int(jres.its) and int(res.reason) == int(jres.reason) > 0
    h, jh = res.history[:its + 1].numpy(), np.asarray(jres.history)[:its + 1]
    np.testing.assert_allclose(h, jh, rtol=1e-3)
    x = res.x.double().numpy()
    assert np.linalg.norm(b - A @ x) <= 1e-4 * np.linalg.norm(b)


# ------------------------------------------- non-packed branch, fmt=sell ----
def _interpret(pc):
    """petsctpu's non-packed MGPC with its SellMats in interpret mode
    (they were built while the backend read "tpu")."""
    def fix(op):
        return replace(op, interpret=True) if type(op).__name__ == \
            "SellMat" else op

    levels = tuple(replace(lv, A=fix(lv.A), P=fix(lv.P), R=fix(lv.R))
                   for lv in pc.levels)
    return replace(pc, levels=levels)


def test_nonpacked_branch_matches_reference():
    A = laplacian_2d(64, 64, dtype=np.float32).tocsr()
    opts = {"pc_gamg_coarse_eq_limit": "1000"}
    jpc = _interpret(_jax_pc_on_tpu_policy(A, opts))
    pc = make_pc("gamg", A=sell_from_scipy(A, device=CPU), A_host=A,
                 options=Options(opts))
    assert pc.coarse_A.shape[0] > 192
    ref = [(_jax_fmt(lv.A), _jax_fmt(lv.P),
            None if lv.R is None else _jax_fmt(lv.R)) for lv in jpc.levels]
    assert pc.formats == ref
    assert ref[0][:2] == (("sell", 16, "diag"), ("sell", 8, "chunk"))
    assert ref[0][2] is None
    b = np.random.default_rng(2).standard_normal(A.shape[0]) \
        .astype(np.float32)
    y = pc.apply(torch.from_numpy(b)).numpy()
    assert _rel(y, jax.jit(lambda q, v: q.apply(v))(jpc, jnp.asarray(b))) \
        <= 2e-4


def test_sell_fmt_permuted_matches_reference():
    A = laplacian_2d(64, 64, dtype=np.float32).tocsr()
    opts = {"pc_gamg_coarse_eq_limit": "64", "pc_gamg_mat_type": "sell"}
    jpc = jmake_pc("gamg", A_host=A, options=JOptions(opts))
    pc = make_pc("gamg", A=sell_from_scipy(A, device=CPU), A_host=A,
                 options=Options(opts))
    assert isinstance(pc, PermutedPC)
    np.testing.assert_array_equal(pc.perm.numpy(), np.asarray(jpc.perm))
    assert pc.inner.formats == [tuple(_meta_fmt(r) for r in m[:3])
                                for m in jpc.inner.metas]
    b = np.random.default_rng(4).standard_normal(A.shape[0]) \
        .astype(np.float32)
    y = pc.apply(torch.from_numpy(b)).numpy()
    assert _rel(y, jax.jit(lambda q, v: q.apply(v))(jpc, jnp.asarray(b))) \
        <= 2e-4


# ------------------------------------------------- small pieces, errors ----
def test_dense_lupc_matches_scipy_on_a_pivoting_matrix():
    rng = np.random.default_rng(7)
    M = rng.standard_normal((9, 9))
    M[0, 0] = 1e-3                      # forces row interchanges
    lu, piv = sla.lu_factor(M)
    assert not np.array_equal(piv, np.arange(9))
    pc = DenseLUPC(torch.from_numpy(lu), torch.from_numpy(piv))
    b = rng.standard_normal(9)
    got = pc.apply(torch.from_numpy(b)).numpy()
    assert _rel(got, np.linalg.solve(M, b)) <= 1e-12
    assert _rel(got, sla.lu_solve((lu, piv), b)) <= 1e-13


def test_dense_and_rectband_match_petsctpu():
    rng = np.random.default_rng(9)
    m, n = 300, 1250                     # a slant band of slope ~4
    rows = np.repeat(np.arange(m), 6)
    cols = np.clip(4 * rows + rng.integers(-3, 9, rows.size), 0, n - 1)
    R = sp.coo_matrix((rng.standard_normal(rows.size), (rows, cols)),
                      shape=(m, n)).tocsr()
    assert trectband.rectband_plan(R) == jrectband.rectband_plan(R)
    T = trectband.rectband_from_scipy(R, device=CPU)
    J = jrectband.rectband_from_scipy(R)
    assert (T.s, T.off, T.shape, T.nnz) == (J.s, J.off, J.shape, J.nnz)
    np.testing.assert_array_equal(T.B.numpy(), np.asarray(J.B))
    x = rng.standard_normal(n)
    np.testing.assert_allclose(T.mult(torch.from_numpy(x)).numpy(),
                               np.asarray(J.mult(jnp.asarray(x))),
                               rtol=1e-13, atol=1e-13)
    np.testing.assert_allclose(T.mult(torch.from_numpy(x)).numpy(), R @ x,
                               rtol=1e-12, atol=1e-12)
    assert trectband.rectband_from_scipy(sp.random(40, 4000, 0.005,
                                                   random_state=0)) is None
    D = rng.standard_normal((7, 5))
    Td, Jd = tdense.Dense(torch.from_numpy(D)), jdense.Dense(jnp.asarray(D))
    v5, v7 = rng.standard_normal(5), rng.standard_normal(7)
    for got, ref in ((Td.mult(torch.from_numpy(v5)), Jd.mult(jnp.asarray(v5))),
                     (Td.multT(torch.from_numpy(v7)),
                      Jd.multT(jnp.asarray(v7)))):
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-13)


@pytest.mark.parametrize("opts,exc,match", [
    ({"pc_gamg_coordinates": np.zeros((16, 2))}, NotImplementedError,
     "queue 1 item 8"),
    ({"pc_gamg_dof": "2"}, NotImplementedError, "queue 1 item 8"),
    ({"pc_gamg_mat_type": "band"}, NotImplementedError, "queue 1 item 9"),
])
def test_gamg_routes_not_ported_raise(opts, exc, match):
    A = laplacian_2d(4, 4)
    with pytest.raises(exc, match=match):
        make_pc("gamg", A_host=A, options=Options({**opts,
                                                   "pc_gamg_coarse_eq_limit":
                                                   "4"}))


def test_gamg_needs_the_host_matrix():
    A = laplacian_2d(8, 8, dtype=np.float32)
    with pytest.raises(ValueError, match="host"):
        make_pc("gamg", A=aij_from_scipy(A, device=CPU))
