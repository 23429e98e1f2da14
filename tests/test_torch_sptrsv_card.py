"""SpTRSV on the card: every launch shape and the fused L+U solve against
the plain versions, bit for bit, on small plans.

Marked `cuda`: each test decides inside itself whether a card is present
and skips without one. It imports neither JAX nor petsctpu, so on a
machine with a card and no JAX it runs without the suite's conftest:

    python -m pytest --noconftest -p no:cacheprovider -q tests/test_torch_sptrsv_card.py

The shared shapes (block-smem, cluster-smem) are the ones launch_shape
picks for these plans on the card; the shapes with x in global memory
(block, cluster, grid) are reached by reporting no shared memory to
launch_shape (`_smem_optin`), the only input it weighs besides the
plan's size. Covered: stacked plans of unequal level counts, identity-
padded subdomains, a level whose rows all fall in one rank (segments
longer than a block), rows of more than four slots, fp32 and fp64.
"""

import numpy as np
import pytest
import scipy.sparse as sp
import torch

from petsctpu_torch.mat import factor as tfactor
from petsctpu_torch.models import ex45_system
from petsctpu_torch.ops import sptrsv as trsv


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the SpTRSV kernel has no CPU mode)")
    return "cuda"


def _layered(n, width, rng, deps=2):
    """A lower triangle whose level l is rows [l·width, (l+1)·width), each
    row reading `deps` random rows of the level before."""
    r = np.repeat(np.arange(width, n), deps)
    c = (r // width - 1) * width + rng.integers(0, width, r.size)
    T = sp.coo_matrix((rng.uniform(-0.5, 0.5, r.size), (r, c)),
                      shape=(n, n)).tocsr()
    return (T + sp.diags(rng.uniform(1, 2, n))).tocsr()


def _mirror(T):
    """The upper triangle P T P of a lower one (P reverses the rows)."""
    return sp.csr_matrix(T[::-1][:, ::-1])


def _padded(T, n):
    m = T.shape[0]
    return sp.block_diag([T, sp.eye(n - m)]).tocsr() if m < n else T


def _bjacobi(nblocks, dev, dt=np.float64):
    """ILU(0)'s stacked L and U plans of ex45 16³ in nblocks row blocks
    (the last one identity-padded when they do not tile n)."""
    A = sp.csr_matrix(ex45_system(16, 16, 16)[0])
    n = A.shape[0]
    bs = -(-n // nblocks)
    Ls, Us = [], []
    for lo in range(0, n, bs):
        B = A[lo:lo + bs][:, lo:lo + bs]
        L, U = tfactor.ilu0(B)
        Ls.append(_padded(L, bs) if B.shape[0] < bs else L)
        Us.append(_padded(U, bs))
    return (tfactor.stacked_sptrsv_plan(Ls, True, True, dt, device=dev),
            tfactor.stacked_sptrsv_plan(Us, False, False, dt, device=dev))


def _plan(name, dev):
    rng = np.random.default_rng(7)
    if name == "bjacobi(8) 16³ L":
        return _bjacobi(8, dev)[0]
    if name == "bjacobi(5) 16³ U, padded":
        return _bjacobi(5, dev, np.float32)[1]
    if name == "one level a rank, fp64":
        return tfactor.make_sptrsv_plan(_layered(32768, 4096, rng), True,
                                        False, np.float64, device=dev)
    if name == "unequal stack, fp32":
        wide, deep = _layered(6000, 3000, rng), _layered(6000, 1500, rng)
        return tfactor.stacked_sptrsv_plan([wide, deep], True, False,
                                           np.float32, device=dev)
    # rows m..2m−1 each read 6 rows of 0..m−1: K = 6 slots
    m = 3000
    r = np.repeat(np.arange(m, 2 * m), 6)
    W = sp.coo_matrix((rng.standard_normal(r.size),
                       (r, rng.integers(0, m, r.size))), shape=(2 * m,) * 2)
    return tfactor.make_sptrsv_plan(
        (W.tocsr() + sp.diags(rng.uniform(1, 2, 2 * m))).tocsr(), True,
        False, np.float64, device=dev)


# (plan, shared memory reported to launch_shape: the card's or none) ->
# the shape it takes
CASES = [
    ("bjacobi(8) 16³ L", "card", "block-smem"),
    ("bjacobi(8) 16³ L", "none", "block"),
    ("bjacobi(5) 16³ U, padded", "card", "block-smem"),
    ("one level a rank, fp64", "card", "cluster-smem"),
    ("one level a rank, fp64", "none", "grid"),
    ("unequal stack, fp32", "card", "cluster-smem"),
    ("unequal stack, fp32", "none", "cluster"),
    ("K = 6, fp64", "card", "cluster-smem"),
    ("K = 6, fp64", "none", "grid"),
]


def _shape(plan, monkeypatch, smem):
    if smem == "none":
        monkeypatch.setattr(trsv, "_smem_optin", lambda index: 0)
    return trsv.device_shape(plan.nb, plan.n, plan.rmax, plan.dtype,
                             plan.device)


@pytest.mark.cuda
@pytest.mark.parametrize("name,smem,shape", CASES,
                         ids=[f"{n}-{s}" for n, _, s in CASES])
def test_sptrsv_shape_equals_plain(name, smem, shape, monkeypatch):
    dev = _card()
    plan = _plan(name, dev)
    assert _shape(plan, monkeypatch, smem) == shape
    rng = np.random.default_rng(1)
    b = torch.from_numpy(rng.standard_normal((plan.nb, plan.n))).to(
        dev, plan.dtype)
    before = trsv.sptrsv.launches
    x = trsv.sptrsv(*plan.order, b, nlevs=plan.nlevs, lseg=plan.lseg,
                    rmax=plan.rmax)
    ref = trsv.sptrsv_plain(*plan.order, b)
    torch.cuda.synchronize()
    assert trsv.sptrsv.launches == before + 1
    assert torch.equal(x, ref), float((x - ref).abs().max())
    # the same bits again (no race between levels)
    assert torch.equal(trsv.sptrsv(*plan.order, b, nlevs=plan.nlevs,
                                   lseg=plan.lseg, rmax=plan.rmax), ref)


def _pair(name, dev):
    if name == "bjacobi(8) 16³":
        return _bjacobi(8, dev)
    if name == "bjacobi(5) 16³ fp32, padded":
        return _bjacobi(5, dev, np.float32)
    rng = np.random.default_rng(3)
    L = _layered(32768, 4096, rng)
    return (tfactor.make_sptrsv_plan(L, True, False, np.float64, device=dev),
            tfactor.make_sptrsv_plan(_mirror(_layered(32768, 1024, rng)),
                                     False, False, np.float64, device=dev))


@pytest.mark.cuda
@pytest.mark.parametrize("name,shape", [
    ("bjacobi(8) 16³", "block-smem"),
    ("bjacobi(5) 16³ fp32, padded", "block-smem"),
    ("layered L and mirrored U, fp64", "cluster-smem")])
def test_sptrsv_lu_equals_plain(name, shape, monkeypatch):
    dev = _card()
    L, U = _pair(name, dev)
    assert L.fuses(U)
    assert trsv.device_shape(L.nb, L.n, max(L.rmax, U.rmax), L.dtype,
                             L.device) == shape
    b = torch.from_numpy(np.random.default_rng(2).standard_normal(
        (L.nb, L.n))).to(dev, L.dtype)
    before = trsv.sptrsv_lu.launches
    x = trsv.sptrsv_lu(L.order, U.order, b, nlevs=(L.nlevs, U.nlevs),
                       lseg=(L.lseg, U.lseg), rmax=(L.rmax, U.rmax))
    ref = trsv.sptrsv_lu_plain(L.order, U.order, b)
    torch.cuda.synchronize()
    assert trsv.sptrsv_lu.launches == before + 1
    assert torch.equal(x, ref), float((x - ref).abs().max())
    # with no shared memory the pair takes no shared shape, and
    # sptrsv_lu raises
    monkeypatch.setattr(trsv, "_smem_optin", lambda index: 0)
    assert trsv.device_shape(L.nb, L.n, max(L.rmax, U.rmax), L.dtype,
                             L.device) not in trsv.SMEM_SHAPES
    with pytest.raises(ValueError, match="not a shared one"):
        trsv.sptrsv_lu(L.order, U.order, b, nlevs=(L.nlevs, U.nlevs),
                       lseg=(L.lseg, U.lseg), rmax=(L.rmax, U.rmax))


def _spread(n, nlev, rng, deps=3):
    """A lower triangle whose level l is the rows r ≡ l (mod nlev), each
    reading `deps` random rows < r of the level before: every level's
    rows lie in every rank of a cluster, and most of its reads cross to
    another rank's shared memory."""
    r = np.repeat(np.arange(n), deps)
    lev = r % nlev
    r, lev = r[lev > 0], lev[lev > 0]
    c = lev - 1 + nlev * rng.integers(0, r // nlev + 1)
    T = sp.coo_matrix((rng.uniform(-0.5, 0.5, r.size), (r, c)),
                      shape=(n, n)).tocsr()
    return (T + sp.diags(rng.uniform(1, 2, n))).tocsr()


@pytest.mark.cuda
@pytest.mark.parametrize("dt", [np.float64, np.float32])
def test_cluster_smem_barriers_hold_over_seeds_and_repeats(dt):
    """The cluster-smem shape's rounds (a release restricted to the
    block's own shared memory before a relaxed cluster arrive, which
    must order a level's x stores before other blocks' reads and, in the
    fused solve, their reads of y before U overwrites it) against the
    plain versions, bit for bit, on stacked plans of unequal level
    counts whose every level reads across ranks: 8 seeds, each solved 25
    times as one triangle and 25 times fused."""
    dev = _card()
    n = 320000 // np.dtype(dt).itemsize   # x past one block's shared memory
    for seed in range(8):
        rng = np.random.default_rng(100 + seed)
        Ls = [_spread(n, k, rng) for k in (48, 31, 64)]
        Us = [_mirror(_spread(n, k, rng)) for k in (40, 57, 23)]
        L = tfactor.stacked_sptrsv_plan(Ls, True, False, dt, device=dev)
        U = tfactor.stacked_sptrsv_plan(Us, False, False, dt, device=dev)
        assert trsv.device_shape(L.nb, n, L.rmax, L.dtype, L.device) \
            == "cluster-smem" and L.fuses(U)
        b = torch.from_numpy(rng.standard_normal((L.nb, n))).to(dev, L.dtype)
        ref = trsv.sptrsv_plain(*L.order, b)
        ref_lu = trsv.sptrsv_lu_plain(L.order, U.order, b)
        for _ in range(25):
            assert torch.equal(L.solve(b), ref), seed
            assert torch.equal(tfactor.lu_solve(L, U, b), ref_lu), seed


@pytest.mark.cuda
@pytest.mark.parametrize("dt", [np.float64, np.float32])
def test_cluster16_fused_solve_equals_plain_over_seeds(dt):
    """A single plan whose x fits no cluster of 8 blocks but one of 16
    fuses in the cluster16-smem shape (a non-portable cluster size, the
    fused solve only; each triangle alone keeps launch_shape's): the
    fused solve through lu_solve against the plain version, bit for bit,
    on plans whose every level reads across the 16 ranks, 4 seeds, each
    solved 10 times (the one-rank-a-plan bjacobi ILU(0) of ex45 at 128³
    over 4 ranks, 524,288 fp32 rows, takes it)."""
    dev = _card()
    n = (1 << 21) // np.dtype(dt).itemsize    # x of 2 MiB: 256 KiB a rank
    for seed in range(4):                     # of 8, 128 KiB of 16
        rng = np.random.default_rng(200 + seed)
        L = tfactor.make_sptrsv_plan(_spread(n, 256, rng), True, False, dt,
                                     device=dev)
        U = tfactor.make_sptrsv_plan(_mirror(_spread(n, 229, rng)), False,
                                     False, dt, device=dev)
        assert trsv.device_shape(1, n, max(L.rmax, U.rmax), L.dtype,
                                 L.device) not in trsv.SMEM_SHAPES
        assert L.pair_shape(U) == "cluster16-smem" and L.fuses(U)
        b = torch.from_numpy(rng.standard_normal(n)).to(dev, L.dtype)
        ref = trsv.sptrsv_lu_plain(L.order, U.order, b[None])[0]
        before = trsv.sptrsv_lu.launches
        for _ in range(10):
            assert torch.equal(tfactor.lu_solve(L, U, b), ref), seed
        assert trsv.sptrsv_lu.launches == before + 10
