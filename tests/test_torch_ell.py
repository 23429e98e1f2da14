"""The ELL SpMV of AIJ.mult (petsctpu_torch/ops/ell_spmv.py) on the CPU.

The plain version is held bit for bit to a slot-order loop (each row
folded over its slots from +0.0, the kernel's and MatMult_SeqAIJ's
order), and to scipy within 1e-13 relative (another summation order);
AIJ.mult goes through it. Every AIJ the port builds stores int32
columns, the reference's pack, the only columns the wrapper takes. A
CUDA tensor never reaches the plain version: the wrapper launches the
kernel or raises (with no kernel built here, the build raises), and a
malformed call (int64 columns, a misaligned view) raises before any
launch. The launch plan is checked for the card's shared memory, whole
16-byte bulk copies and the odd row stride of the products. The kernel
itself is held to the plain version on the card by chip_smoke.py.
"""

import numpy as np
import pytest
import scipy.sparse as sp
import torch

from petsctpu_torch.mat import aij_from_scipy
from petsctpu_torch.ops import _build
from petsctpu_torch.ops import ell_spmv as ell

# one intra-op thread: the suite runs in parallel workers (pytest -n), and
# PyTorch's default of a thread a core oversubscribes the host's cores
torch.set_num_threads(1)


class _OnCard(torch.Tensor):
    """A CPU tensor that reports CUDA device 0 (the wrapper's CUDA path)."""

    @property
    def is_cuda(self):
        return True

    def get_device(self):
        return 0


def _slot_loop(cols, vals, x):
    m, K = cols.shape
    y = np.zeros(m, dtype=np.result_type(vals, x))
    for i in range(m):
        s = y.dtype.type(0.0)
        for k in range(K):
            s = s + vals[i, k] * x[cols[i, k]]
        y[i] = s
    return y


CASES = [
    # (m, n, density, dtype, min_width): square, rectangular both ways,
    # an all-padding row, K = 1, fp32
    (40, 40, 0.15, np.float64, 1),
    (37, 90, 0.08, np.float64, 1),
    (90, 23, 0.2, np.float32, 1),
    (30, 30, 0.0, np.float64, 1),
    (25, 60, 0.1, np.float64, 40),
]


@pytest.mark.parametrize("m,n,density,dtype,min_width", CASES)
def test_plain_matches_slot_loop_and_scipy(m, n, density, dtype, min_width):
    A = sp.random(m, n, density=density, random_state=m + n, format="csr",
                  dtype=dtype)
    if density == 0.0:
        A = sp.eye(m, n, format="csr", dtype=dtype)
    A = sp.lil_matrix(A)
    A[m // 2, :] = 0                                # an all-padding row
    A = sp.csr_matrix(A)
    Ad = aij_from_scipy(A, device="cpu", min_width=min_width)
    x = np.random.default_rng(m).standard_normal(n).astype(dtype)
    y = ell.ell_spmv_plain(Ad.cols, Ad.vals, torch.from_numpy(x)).numpy()
    np.testing.assert_array_equal(
        y, _slot_loop(Ad.cols.numpy(), Ad.vals.numpy(), x))
    assert y[m // 2] == 0.0 and not np.signbit(y[m // 2])
    tol = 1e-13 if dtype == np.float64 else 1e-5
    np.testing.assert_allclose(y, A @ x, rtol=tol,
                               atol=tol * np.abs(A).sum(axis=1).max())
    np.testing.assert_array_equal(Ad.mult(torch.from_numpy(x)).numpy(), y)


@pytest.mark.parametrize("dtype", [np.complex128, np.complex64])
def test_complex_plain_folds_the_parts(dtype):
    """A complex slot is (vr·xr − vi·xi) + (vr·xi + vi·xr)i, each part
    folded from +0.0: the kernel's arithmetic, operation for operation."""
    rng = np.random.default_rng(12)
    A = sp.random(30, 24, density=0.2, random_state=3, format="csr")
    A = (A + 1j * sp.random(30, 24, density=0.2, random_state=4,
                            format="csr")).astype(dtype)
    Ad = aij_from_scipy(A, device="cpu")
    x = (rng.standard_normal(24) + 1j * rng.standard_normal(24)).astype(dtype)
    y = Ad.mult(torch.from_numpy(x)).numpy()
    cols, vals = Ad.cols.numpy(), Ad.vals.numpy()
    real = np.float64 if dtype == np.complex128 else np.float32
    for i in range(30):
        re = im = real(0.0)
        for k in range(cols.shape[1]):
            v, u = vals[i, k], x[cols[i, k]]
            re = re + (v.real * u.real - v.imag * u.imag)
            im = im + (v.real * u.imag + v.imag * u.real)
        assert y[i] == re + 1j * im
    tol = 1e-13 if dtype == np.complex128 else 1e-5
    np.testing.assert_allclose(y, A @ x, rtol=tol, atol=tol)


def test_empty_and_k_one():
    cols = torch.zeros((0, 3), dtype=torch.int32)
    y = ell.ell_spmv(cols, torch.zeros((0, 3)), torch.ones(4))
    assert y.shape == (0,)
    cols = torch.tensor([[2], [0], [1]], dtype=torch.int32)
    vals = torch.tensor([[2.0], [-1.0], [0.5]], dtype=torch.float64)
    x = torch.tensor([1.0, 2.0, 4.0], dtype=torch.float64)
    np.testing.assert_array_equal(ell.ell_spmv(cols, vals, x).numpy(),
                                  [8.0, -1.0, 1.0])


# ---------------------------------------------------------- launch plan

PLAN_CASES = [(K, itemsize) for K in (1, 7, 8, 27, 81, 95, 96, 97, 300)
              for itemsize in (4, 8, 16)]


@pytest.mark.parametrize("K,itemsize", PLAN_CASES)
def test_tile_fits_and_keeps_an_odd_stride(K, itemsize):
    """Every dtype's launch (fp32 4 bytes, fp64 and complex64 8,
    complex128 16) fits the card's shared memory, keeps its products at
    an odd row stride and, in the ring kernel, R a multiple of 4, so that
    every tile's and every stage's bulk copies start and run 16-byte
    aligned; rows too wide for two stages of 32 take the chunked
    kernel."""
    slot = ell.COL_BYTES + itemsize
    half = ell.SMEM_SM // 2 - ell.SMEM_RESERVED
    for m in (1, 1000, 3_145_728):
        p = ell.launch_plan(m, K, itemsize)
        assert p.ks % 2 == 1 and p.grid >= 1
        if p.mode == 1:
            # 32 rows: past a stage, or two blocks an SM no longer fit
            assert (K * slot * ell.MIN_ROWS > ell.STAGE_BYTES
                    or ell.ring_smem(ell.MIN_ROWS, K, itemsize, 2) > half)
            assert p.rows == ell.CHUNK_ROWS <= p.threads and p.ks == p.kc
            assert p.smem == p.rows * p.kc * itemsize <= ell.CHUNK_SMEM
            assert p.grid == -(-m // p.rows)
            continue
        R, S = p.rows, p.stages
        assert R in (ell.ROWS, ell.MIN_ROWS) and S in (ell.STAGES, 2)
        if R == ell.MIN_ROWS:           # 64 rows do not fit, in 2 stages
            assert (K * slot * ell.ROWS > ell.STAGE_BYTES
                    or ell.ring_smem(ell.ROWS, K, itemsize, 2) > half)
        if S == 2:                      # 3 stages do not fit
            assert ell.ring_smem(R, K, itemsize, ell.STAGES) > half
        assert p.threads == ell.THREADS and R <= p.threads
        assert p.ks == (K if K % 2 else K + 1)
        assert p.smem == ell.ring_smem(R, K, itemsize, S) <= half
        stage = R * K * slot
        assert stage <= ell.STAGE_BYTES
        # a tile's cols and vals, each stage and its vals: 16-byte units
        for b in (R * K * ell.COL_BYTES, R * K * itemsize, stage,
                  ell.BAR_BYTES):
            assert b % 16 == 0
        per_sm = min(ell.SMEM_SM // (p.smem + ell.SMEM_RESERVED),
                     ell.THREADS_SM // p.threads)
        assert per_sm >= 2
        assert p.grid == min(-(-m // R), ell.SMS * per_sm)


@pytest.mark.parametrize("K", [2, 8, 96, 298])
def test_even_k_rows_come_from_the_multiply_high(K):
    """For an even K the ring kernel writes slot i's product at
    i + ⌊i·magic / 2³²⌋, magic = ⌊(2³² − 1) / K⌋ + 1: that is i + ⌊i / K⌋
    (row stride K + 1) for every slot of a tile."""
    magic = (2 ** 32 - 1) // K + 1
    i = np.arange(ell.ROWS * K, dtype=np.uint64)
    np.testing.assert_array_equal((i * np.uint64(magic)) >> np.uint64(32),
                                  i // np.uint64(K))


@pytest.mark.parametrize("K,itemsize,plan", [
    (7, 8, (0, 64, 3, 1056)),       # ex14's Jacobian
    (18, 8, (0, 64, 3, 528)),       # ex43's velocity block, GAMG levels
    (27, 8, (0, 64, 3, 396)),       # ex43's A
    (50, 8, (0, 64, 2, 264)),
    (469, 8, (1, 32, 0, 98304)),    # ex43's coarse GAMG level: chunked
])
def test_measured_shapes_keep_their_plans(K, itemsize, plan):
    """The plans of the shapes the card timed (rows a tile, stages,
    grid), and one cached plan a shape."""
    p = ell.launch_plan(3_145_728, K, itemsize)
    assert (p.mode, p.rows, p.stages, p.grid) == plan
    assert ell.launch_plan(3_145_728, K, itemsize) is p


# ----------------------------------------------------- int32 everywhere

def _aij_builders():
    """(name, () -> [AIJ]): every way the port builds an AIJ."""
    from petsctpu_torch import convert
    from petsctpu_torch.mat import spgemm
    from petsctpu_torch.models import laplacian_2d
    from petsctpu_torch.models.bratu import (bratu3d_fd_jacobian,
                                             bratu3d_initial_guess,
                                             bratu3d_residual)

    A = laplacian_2d(12, 12)

    def from_scipy():
        T = aij_from_scipy(A, device="cpu")
        return [T, T.scale(2.0), T.diag_scale(torch.ones(144), None),
                T.shift_diag(1.0)]

    def from_arrays():
        cols = np.zeros((5, 3), np.int64)
        return [convert.aij_from_arrays(cols, np.ones((5, 3)), (5, 5), 5,
                                        device="cpu")]

    def fd_jacobian():
        jac = bratu3d_fd_jacobian(6, device="cpu")
        F = bratu3d_residual(6, 6.0)
        x = bratu3d_initial_guess(6, 6.0, device="cpu")
        return [jac.template, jac.assemble(F, x, F(x))]

    def spgemm_refresh():
        plan = spgemm.PtAPPlan.plan(A, sp.eye(144, 40, format="csr"),
                                    device="cpu")
        return [plan.numeric(torch.from_numpy(spgemm.csr_data_of(A)))]

    def packed_mg():
        from petsctpu_torch.pc.gamg import gamg_hierarchy
        from petsctpu_torch.pc.mg import pack_hierarchy
        As, Ps = gamg_hierarchy(laplacian_2d(24, 24), coarse_n=20)
        mg = convert.mg_from_packed(*pack_hierarchy(As, Ps, np.float64,
                                                    use_sell=False),
                                    device="cpu")
        ops = [op for lev in mg.levels for op in (lev.A, lev.P, lev.R)]
        return [op for op in ops + [mg.coarse_A] if hasattr(op, "cols")]

    return [("from_scipy", from_scipy), ("from_arrays", from_arrays),
            ("fd_jacobian", fd_jacobian), ("spgemm_refresh", spgemm_refresh),
            ("packed_mg", packed_mg)]


@pytest.mark.parametrize("name,build", _aij_builders(),
                         ids=[n for n, _ in _aij_builders()])
def test_every_aij_the_port_builds_holds_int32_columns(name, build):
    aijs = build()
    assert aijs
    for T in aijs:
        assert T.cols.dtype == torch.int32, name
        assert T.cols.shape == T.vals.shape
    if name == "packed_mg":           # views of the int32 buffer, aligned
        assert all(T.cols.data_ptr() % 16 == 0 and
                   T.vals.data_ptr() % 16 == 0 for T in aijs)


# ------------------------------------------------- the CUDA path, here

def test_cuda_tensors_never_reach_the_plain_version(monkeypatch):
    """On the wrapper's CUDA path the plain version is never called: with
    no kernel built (no nvcc here) the call raises."""
    A = sp.random(20, 20, density=0.2, random_state=1, format="csr")
    Ad = aij_from_scipy(A, device="cpu")
    x = torch.ones(20, dtype=torch.float64)

    def boom(*a):
        raise AssertionError("the plain version ran on a CUDA tensor")

    monkeypatch.setattr(ell, "ell_spmv_plain", boom)
    monkeypatch.setattr(_build, "launch", lambda fn, index, a: fn(*a, None))
    ell._launcher.cache_clear()
    monkeypatch.setattr(_build, "_nvcc", lambda: (_ for _ in ()).throw(
        RuntimeError("nvcc not found")))
    monkeypatch.setattr(_build, "_stale", lambda name: True)
    card = [t.clone().as_subclass(_OnCard) for t in (Ad.cols, Ad.vals, x)]
    with pytest.raises(RuntimeError, match="nvcc"):
        ell.ell_spmv(*card)
    ell._launcher.cache_clear()


def _off16(t):
    """A contiguous copy of t whose data starts 8 bytes off 16."""
    nbytes = t.numel() * t.element_size()
    flat = torch.zeros(nbytes + 16, dtype=torch.uint8)
    base = (-flat.data_ptr()) % 16 + 8
    v = flat[base:base + nbytes].view(t.dtype).view(t.shape)
    v.copy_(t)
    assert v.data_ptr() % 16 == 8 and v.is_contiguous()
    return v


@pytest.mark.parametrize("change,exc", [
    (dict(vals=torch.zeros((4, 3), dtype=torch.float16),
          x=torch.zeros(6, dtype=torch.float16)), ValueError),
    (dict(vals=torch.zeros((4, 3), dtype=torch.complex128)), ValueError),
    (dict(x=torch.zeros(6, dtype=torch.float32)), ValueError),
    (dict(cols=torch.zeros((4, 3), dtype=torch.int64)), ValueError),
    (dict(cols=torch.zeros((4, 2), dtype=torch.int32)), ValueError),
    (dict(x=torch.zeros((6, 1), dtype=torch.float64)), ValueError),
    (dict(vals=torch.zeros((3, 4), dtype=torch.float64).T), ValueError),
    (dict(cols=_off16(torch.zeros((4, 3), dtype=torch.int32))), ValueError),
    (dict(vals=_off16(torch.zeros((4, 3), dtype=torch.float64))),
     ValueError),
])
def test_malformed_cuda_calls_raise_before_any_launch(change, exc,
                                                      monkeypatch):
    args = dict(cols=torch.zeros((4, 3), dtype=torch.int32),
                vals=torch.zeros((4, 3), dtype=torch.float64),
                x=torch.zeros(6, dtype=torch.float64))
    args.update(change)
    monkeypatch.setattr(ell, "_launcher", lambda: pytest.fail("launched"))
    with pytest.raises(exc):
        ell.ell_spmv(*(args[k].as_subclass(_OnCard)
                       for k in ("cols", "vals", "x")))


def test_int64_columns_raise_on_the_cpu_too():
    """No silent widening or narrowing copy: the plain version takes the
    AIJ pack's int32 columns only."""
    with pytest.raises(ValueError, match="int32"):
        ell.ell_spmv(torch.zeros((4, 3), dtype=torch.int64),
                     torch.zeros((4, 3), dtype=torch.float64),
                     torch.zeros(6, dtype=torch.float64))
