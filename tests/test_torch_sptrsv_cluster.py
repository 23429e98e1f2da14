"""SpTRSV's shared-memory shapes on the CPU: the ownership plan, the
shape choice, the fused L+U solve and the PC applies routed through it.

* `segments` (ops/sptrsv.py), the (level, rank) segments of the
  cluster-smem shape, on the 16³ bjacobi(8) ILU plans, an ASM(4, overlap
  1) plan, an unequal stacked pair and plans whose levels land in one
  rank: the segments tile each level exactly once, each segment's rows
  lie in its rank's range [q·chunk, (q+1)·chunk), chunk = ⌈n / 8⌉, and
  the starts are monotone; a level whose rows do not ascend raises.
* `launch_shape` over a table that reaches all five shapes, with the
  capacity edge of both shared shapes: a plan that just fits the card's
  shared memory, and one a row over.
* `sptrsv_lu`'s plain version against petsctpu's SpTRSVPlan.solve for L
  and then U, within 1e-14 relative in fp64 (the reference sums a row's
  slots with jnp.sum, the port in slot order).
* ASM (and bjacobi), ILU and LU applies at 16³ through the new route
  (one sptrsv_lu call an apply, no sptrsv) against the JAX package's PC
  applies, within 1e-12 relative in fp64; bjacobi whose blocks tile n
  takes x as a view; ICC keeps two solves.
The kernel itself runs only on the card: tests/test_torch_sptrsv_card.py.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse as sp
import torch

from petsctpu.core.options import Options as JOptions
from petsctpu.mat import aij_from_scipy as jaij_from_scipy
from petsctpu.mat import factor as jfactor
from petsctpu.pc import make_pc as jmake_pc
from petsctpu_torch.core.options import Options
from petsctpu_torch.mat import aij_from_scipy
from petsctpu_torch.mat import factor as tfactor
from petsctpu_torch.models import ex2_system, ex45_system
from petsctpu_torch.ops import sptrsv as trsv
from petsctpu_torch.pc import make_pc

# one intra-op thread: the suite runs in parallel workers (pytest -n), and
# PyTorch's default of a thread a core oversubscribes the host's cores
torch.set_num_threads(1)

CPU = "cpu"
H100 = 232448           # cudaDevAttrMaxSharedMemoryPerBlockOptin, H100


def _ex45(m=16):
    return sp.csr_matrix(ex45_system(m, m, m)[0])


def _pc(pc_type, opts, A):
    return make_pc(pc_type, A=aij_from_scipy(A, device=CPU), A_host=A,
                   options=Options(dict(opts)))


def _layered(n, width, rng, deps=2):
    """A lower triangle whose level l is rows [l·width, (l+1)·width), each
    row reading `deps` random rows of the level before."""
    r = np.repeat(np.arange(width, n), deps)
    lev = r // width
    c = (lev - 1) * width + rng.integers(0, width, r.size)
    T = sp.coo_matrix((rng.uniform(-0.5, 0.5, r.size), (r, c)),
                      shape=(n, n)).tocsr()
    return (T + sp.diags(rng.uniform(1, 2, n))).tocsr()


def _unequal_pair():
    """Two 16³ subdomains of 300 and 1000 rows, the first identity-padded
    to 1000: levels of unequal count in one stack."""
    A = _ex45()
    subs = []
    for lo, m in ((0, 300), (300, 1000)):
        L = tfactor.ilu0(A[lo:lo + m][:, lo:lo + m])[0]
        subs.append(sp.block_diag([L, sp.csr_matrix((1000 - m,) * 2)])
                    .tocsr() if m < 1000 else L)
    return tfactor.stacked_sptrsv_plan(subs, True, True, np.float64,
                                       device=CPU)


def _plans():
    A = _ex45()
    bj = _pc("bjacobi", {"pc_bjacobi_blocks": "8"}, A)
    asm = _pc("asm", {"pc_asm_blocks": "4", "pc_asm_overlap": "1"}, A)
    rng = np.random.default_rng(5)
    return {
        "bjacobi(8) L": bj.Lplans, "bjacobi(8) U": bj.Uplans,
        "ASM(4, overlap 1) L": asm.Lplans,
        "ASM(4, overlap 1) U": asm.Uplans,
        "unequal stacked pair": _unequal_pair(),
        "a level in one rank": tfactor.make_sptrsv_plan(
            _layered(4096, 512, rng), True, False, device=CPU),
        "one rank's rows over several levels": tfactor.make_sptrsv_plan(
            _layered(700, 8, rng), True, False, device=CPU),
    }


PLANS = ["bjacobi(8) L", "bjacobi(8) U", "ASM(4, overlap 1) L",
         "ASM(4, overlap 1) U", "unequal stacked pair",
         "a level in one rank", "one rank's rows over several levels"]


@pytest.fixture(scope="module")
def plans():
    return _plans()


@pytest.mark.parametrize("name", PLANS)
def test_segments_tile_each_level_by_rank(plans, name):
    plan = plans[name]
    lstart, lrows = (t.numpy() for t in plan.order[:2])
    lseg = trsv.segments(lstart, lrows, plan.n)
    C, n = trsv.CLUSTER, plan.n
    chunk = -(-n // C)
    nb, nlev = lstart.shape[0], lstart.shape[1] - 1
    assert lseg.shape == (nb, nlev * C + 1) and lseg.dtype == np.int32
    assert (np.diff(lseg, axis=1) >= 0).all()          # monotone starts
    np.testing.assert_array_equal(lseg[:, ::C], lstart)  # levels tiled
    for s in range(nb):
        seen = np.zeros(n, int)
        for l in range(nlev):
            for q in range(C):
                a, e = lseg[s, l * C + q], lseg[s, l * C + q + 1]
                rows = lrows[s, a:e]
                assert ((rows >= q * chunk) & (rows < (q + 1) * chunk)).all()
                seen[rows] += 1
        assert (seen == 1).all()                        # each row once
    if name == "a level in one rank":
        width = np.diff(lseg[0]).reshape(nlev, C)
        assert ((width > 0).sum(1) == 1).all()
        assert width.max() > trsv.consumers_for(-(-plan.rmax // C))
    if name == "unequal stacked pair":
        assert plan.nlevs[0] < plan.nlevs[1]


@pytest.mark.parametrize("shape", ["block-smem", "cluster-smem", "block",
                                   "cluster", "grid", "plain"])
def test_plan_derives_segments_only_where_x_fits_a_cluster(
        plans, shape, monkeypatch):
    """lseg is derived (and equals `segments`) only where the plan's own
    solve takes a shared shape: a pair with a wider level only grows the
    ring, so a plan that takes no shared shape alone takes none in a
    fused pair, and the big grid and block plans skip the derivation."""
    src = plans["ASM(4, overlap 1) L"]
    seen = []

    def shape_of(nb, n, rmax, dtype, device):
        seen.append((nb, n, rmax, np.dtype(dtype).itemsize))
        return shape
    monkeypatch.setattr(tfactor, "device_shape", shape_of)
    plan = tfactor.SpTRSVPlan(src.level_rows, src.cols, src.vals, src.dinv,
                              src.n, src.nlev, device="cpu")
    assert seen == [(src.nb, src.n, src.rmax, src.dtype.itemsize)]
    if shape in trsv.SMEM_SHAPES:
        lstart, lrows = (t.numpy() for t in plan.order[:2])
        np.testing.assert_array_equal(plan.lseg.numpy(),
                                      trsv.segments(lstart, lrows, src.n))
    else:
        assert plan.lseg is None
    b = torch.from_numpy(np.random.default_rng(0).standard_normal(
        (src.nb, src.n)))
    assert torch.equal(plan.solve(b), src.solve(b))


def test_segments_raise_on_rows_out_of_order():
    lstart = np.array([[0, 3]], np.int32)
    with pytest.raises(ValueError, match="ascending ranks"):
        trsv.segments(lstart, np.array([[2, 0, 1]], np.int32), 3, ranks=3)
    np.testing.assert_array_equal(
        trsv.segments(lstart, np.array([[0, 1, 2]], np.int32), 3, ranks=3),
        [[0, 1, 2, 3]])


def _ring(consumers, es):
    """The shared shapes' bytes besides x: the mbarriers and a zero, and
    the stages."""
    return 16 * -(-(8 * trsv.STAGES + 16) // 16) + trsv.STAGES * (
        16 + consumers * (1 + trsv.SLOTS) * (4 + es) + 128)


# (nb, n, rmax, itemsize, smem) -> shape
SHAPE_TABLE = [
    ((8, 32768, 512, 4, H100), "block-smem"),       # 64³ bjacobi(8) fp32
    ((1, 27, 9, 8, H100), "block-smem"),            # the 27-row coarse LU
    ((8, 262144, 1984, 4, H100), "cluster-smem"),   # 128³ bjacobi(8) fp32
    ((4, 294912, 1984, 4, H100), "cluster-smem"),   # ASM, overlap 1
    ((1, 6000, 3000, 4, H100), "cluster-smem"),     # one plan, wide levels
    ((8, 262144, 1984, 8, H100), "cluster"),        # 128³ bjacobi(8) fp64
    ((1, 2097152, 12288, 4, H100), "grid"),         # ICC / SSOR at 128³
    ((1, 4194304, 1, 4, H100), "block"),            # a long chain
    ((2, 300, 3000, 8, 0), "cluster"),              # no shared memory
    ((1, 300, 3000, 8, 0), "grid"),
    ((3, 300, 300, 8, 0), "block"),
    # the capacity edge of block-smem: x of n rows and 992 consumers' ring
    ((1, (H100 - _ring(992, 4)) // 4, 1024, 4, H100), "block-smem"),
    ((1, (H100 - _ring(992, 4)) // 4 + 1, 1024, 4, H100), "cluster-smem"),
    # ... and of cluster-smem (256 consumers a block, chunk = n / 8)
    ((2, 8 * ((H100 - _ring(256, 8)) // 8), 2048, 8, H100), "cluster-smem"),
    ((2, 8 * ((H100 - _ring(256, 8)) // 8) + 1, 2048, 8, H100), "cluster"),
    ((1, 8 * ((H100 - _ring(256, 8)) // 8) + 1, 2048, 8, H100), "grid"),
]


@pytest.mark.parametrize("args,shape", SHAPE_TABLE,
                         ids=[f"{s}-{a[:4]}" for a, s in SHAPE_TABLE])
def test_launch_shape(args, shape):
    assert trsv.launch_shape(*args) == shape
    nb, n, rmax, es, smem = args
    if shape in trsv.SMEM_SHAPES:
        assert trsv.smem_bytes(shape, n, rmax, es) <= smem


def test_launch_shape_capacity_edge_is_exact():
    """At the edge x and the ring fill the card's shared memory to the
    byte; a row more needs 16 bytes more (x is 16-byte aligned)."""
    n = (H100 - _ring(992, 4)) // 4
    assert trsv.smem_bytes("block-smem", n, 1024, 4) == H100
    assert trsv.smem_bytes("block-smem", n + 1, 1024, 4) == H100 + 16
    m = 8 * ((H100 - _ring(256, 8)) // 8)
    assert trsv.smem_bytes("cluster-smem", m, 2048, 8) == H100
    assert trsv.smem_bytes("cluster-smem", m + 1, 2048, 8) == H100 + 16


def _factors(name):
    if name == "ex2 ILU(0)":
        A = sp.csr_matrix(ex2_system(20, 20)[0])
        A = (A + sp.diags(np.linspace(0, 0.4, A.shape[0] - 1), 1)).tocsr()
        return (*tfactor.ilu0(A), True)
    if name == "ex45 8³ ILU(0)":
        return (*tfactor.ilu0(_ex45(8)), True)
    L, U, _, _ = tfactor.lu_factor(sp.csr_matrix(ex2_system(12, 12)[0]))
    return L, U, False


@pytest.mark.parametrize("name", ["ex2 ILU(0)", "ex45 8³ ILU(0)",
                                  "ex2 12x12 LU"])
def test_sptrsv_lu_plain_matches_reference_solves(name):
    L, U, unit = _factors(name)
    n = L.shape[0]
    b = np.random.default_rng(3).standard_normal(n)
    Lp = tfactor.make_sptrsv_plan(L, True, unit, np.float64, device=CPU)
    Up = tfactor.make_sptrsv_plan(U, False, False, np.float64, device=CPU)
    x = trsv.sptrsv_lu_plain(Lp.order, Up.order,
                             torch.from_numpy(b)[None])[0].numpy()
    jL = jfactor.make_sptrsv_plan(L, True, unit, np.float64)
    jU = jfactor.make_sptrsv_plan(U, False, False, np.float64)
    ref = np.asarray(jU.solve(jL.solve(jnp.asarray(b))))
    assert np.abs(x - ref).max() <= 1e-14 * np.abs(ref).max()
    # the wrapper on CPU tensors is the plain version
    got = trsv.sptrsv_lu(Lp.order, Up.order, torch.from_numpy(b)[None],
                         nlevs=(Lp.nlevs, Up.nlevs),
                         lseg=(Lp.lseg, Up.lseg), rmax=(Lp.rmax, Up.rmax))
    np.testing.assert_array_equal(got[0].numpy(), x)


APPLY_CASES = {
    "bjacobi(8) ILU": ("bjacobi", {"pc_bjacobi_blocks": "8"}),
    "bjacobi(5) ILU, padded": ("bjacobi", {"pc_bjacobi_blocks": "5"}),
    "ASM(4, overlap 1)": ("asm", {"pc_asm_blocks": "4",
                                  "pc_asm_overlap": "1"}),
    "ASM(4, overlap 1) sub-LU": ("asm", {"pc_asm_blocks": "4",
                                         "pc_asm_overlap": "1",
                                         "sub_pc_type": "lu"}),
    "ILU(0)": ("ilu", {}),
    "ILU(1) rcm": ("ilu", {"pc_factor_levels": "1",
                           "pc_factor_mat_ordering_type": "rcm"}),
    "LU": ("lu", {}),
}


@pytest.mark.parametrize("case", list(APPLY_CASES))
def test_pc_apply_through_the_fused_route_matches_reference(case,
                                                            monkeypatch):
    pc_type, opts = APPLY_CASES[case]
    A = _ex45()
    pc = _pc(pc_type, opts, A)
    jpc = jmake_pc(pc_type, A=jaij_from_scipy(A), A_host=A,
                   options=JOptions(dict(opts)))
    calls = {"sptrsv_lu": 0, "sptrsv": 0}

    def counting(name, fn):
        def call(*a, **k):
            calls[name] += 1
            return fn(*a, **k)
        return call
    monkeypatch.setattr(tfactor, "sptrsv_lu",
                        counting("sptrsv_lu", tfactor.sptrsv_lu))
    monkeypatch.setattr(tfactor, "sptrsv", counting("sptrsv", tfactor.sptrsv))
    b = np.random.default_rng(1).standard_normal(A.shape[0])
    got = pc.apply(torch.from_numpy(b)).numpy()
    ref = np.asarray(jpc.apply(jnp.asarray(b)))
    assert got.shape == ref.shape
    assert np.abs(got - ref).max() <= 1e-12 * np.abs(ref).max()
    assert calls == {"sptrsv_lu": 1, "sptrsv": 0}


def test_bjacobi_apply_takes_x_as_a_view_when_blocks_tile_n():
    pc = _pc("bjacobi", {"pc_bjacobi_blocks": "8"}, _ex45())
    seen = []
    real = tfactor.sptrsv_lu

    def spy(lower, upper, b, **k):
        seen.append(b)
        return real(lower, upper, b, **k)
    x = torch.from_numpy(np.random.default_rng(2).standard_normal(4096))
    try:
        tfactor.sptrsv_lu = spy
        pc.apply(x)
    finally:
        tfactor.sptrsv_lu = real
    assert pc.contiguous and seen[0].data_ptr() == x.data_ptr()


def test_icc_apply_keeps_two_solves(monkeypatch):
    pc = _pc("icc", {}, _ex45(8))
    calls = []
    monkeypatch.setattr(tfactor, "sptrsv_lu", lambda *a, **k: calls.append(
        "sptrsv_lu"))
    real = tfactor.sptrsv
    monkeypatch.setattr(tfactor, "sptrsv", lambda *a, **k: calls.append(
        "sptrsv") or real(*a, **k))
    pc.apply(torch.ones(512, dtype=torch.float64))
    assert calls == ["sptrsv", "sptrsv"]


# (nb, n, rmax, itemsize, smem) -> (launch_shape, pair_shape)
PAIR_TABLE = [
    ((8, 262144, 1984, 4, H100), ("cluster-smem", "cluster-smem")),
    # one rank's block of ex45 128³ over 4 ranks, fp32: x fits a cluster
    # of 16 blocks only, which the fused solve alone takes
    ((1, 524288, 3840, 4, H100), ("grid", "cluster16-smem")),
    ((2, 524288, 3840, 4, H100), ("cluster", "cluster")),
    ((1, 2097152, 12288, 4, H100), ("grid", "grid")),
    ((1, 4194304, 1, 4, H100), ("block", "block")),
    ((1, 300, 3000, 8, 0), ("grid", "grid")),
]


@pytest.mark.parametrize("args,shapes", PAIR_TABLE,
                         ids=[f"{s[1]}-{a[:4]}" for a, s in PAIR_TABLE])
def test_pair_shape_takes_a_cluster_of_16_for_one_plan_only(args, shapes):
    assert (trsv.launch_shape(*args), trsv.pair_shape(*args)) == shapes
    nb, n, rmax, es, smem = args
    if shapes[1] in trsv.SMEM_SHAPES:
        assert trsv.smem_bytes(shapes[1], n, rmax, es) <= smem
    assert trsv.ranks_of(shapes[1]) == {"cluster-smem": 8,
                                        "cluster16-smem": 16}.get(shapes[1],
                                                                  1)


def test_fused_solve_reads_segments_of_its_shapes_ranks(plans):
    """sptrsv_lu in cluster16-smem needs 16 ranks' segments (lu_solve
    derives them once a plan, segments16); 8 ranks' raise first."""
    plan = plans["ASM(4, overlap 1) L"]
    lstart, lrows = (t.numpy() for t in plan.order[:2])
    nlev = lstart.shape[1] - 1
    for ranks in (8, 16):
        lseg = torch.from_numpy(trsv.segments(lstart, lrows, plan.n, ranks))
        assert lseg.shape == (plan.nb, nlev * ranks + 1)
        if ranks == 8:
            with pytest.raises(ValueError, match="segments of 16 ranks"):
                trsv._need_segments("sptrsv_lu", "cluster16-smem", (lseg,),
                                    (nlev,))
        else:
            trsv._need_segments("sptrsv_lu", "cluster16-smem", (lseg,),
                                (nlev,))
