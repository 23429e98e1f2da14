"""ksp ex49 (Q1 plane-strain elasticity) through the port, against petsctpu
and the reference's goldens (CPU, fp64).

* Assembly byte-equal to petsctpu's: the full operator for every material
  structure, the symmetric BC reduction (ex49_reduced_system: AA's indptr,
  indices and data, the right-hand side, the kept dofs) and the 4-rank
  emulation (ex49_parallel_reduced_system) in the DMDA's PETSc ordering.
* The reduced sizes (1240 dofs at mx = 20, my = 30).
* ex49_1: GMRES(30) + ILU(0) on the reduced system, 54 its, every monitor
  line as output/ex49_1.out prints it but for tests/test_q1elasticity.py's
  two ULP lines (40 and 46, held within 5e-6 relative).
* The unreduced operator symmetric, with the three rigid-body modes in its
  null space.
* tests/test_da_decomp.py through the port's dm/decomp.py: the process
  grid, ownership, the AO permutation, element ownership, the 4-rank
  assembly equal to the serial one up to the permutation, and ex49_2 (GCR +
  ASM with LU subdomains, 29 its) and ex49_3 (GMRES + ASM on the brick
  structure, 31 its) with that test's bounds.
"""

import numpy as np
import pytest
import scipy.sparse as sp
import torch
from test_da_decomp import GOLDEN_2, GOLDEN_3
from test_q1elasticity import GOLDEN, ULP_LINES

from petsctpu.models import q1elasticity as jq

from petsctpu_torch.dm.decomp import DADecomp2D, da_ownership, da_proc_grid
from petsctpu_torch.ksp import ksp_solve
from petsctpu_torch.mat import aij_from_scipy
from petsctpu_torch.models import q1elasticity as tq
from petsctpu_torch.pc import make_pc
from petsctpu_torch.pc.asm import make_asm

# one intra-op thread: the suite runs in parallel workers (pytest -n), and
# PyTorch's default of a thread a core oversubscribes the host's cores
torch.set_num_threads(1)

CPU = "cpu"
SPONGE = dict(c_str=3, E0=1, E1=1000, nu0=0.4, nu1=0.2, t=1, w=8)
BRICK = dict(c_str=2, brick_E=[1, 10, 1000, 100],
             brick_nu=[0.4, 0.2, 0.3, 0.1], span=3)


def same_csr(a, b):
    a, b = sp.csr_matrix(a), sp.csr_matrix(b)
    return a.shape == b.shape and all(
        getattr(a, k).tobytes() == getattr(b, k).tobytes()
        for k in ("indptr", "indices", "data"))


@pytest.fixture(scope="module")
def system():
    return tq.ex49_reduced_system(20, 30, **SPONGE)


@pytest.mark.parametrize("mx,my,params", [
    (6, 5, dict(c_str=0, E=1.0, nu=0.3)),
    (8, 6, dict(c_str=1, E0=1.0, E1=50.0, nu0=0.3, nu1=0.25, xc=0.4)),
    (12, 9, BRICK), (20, 30, SPONGE)])
def test_ex49_assembly_byte_equal(mx, my, params):
    assert same_csr(tq.ex49_system(mx, my, **params),
                    jq.ex49_system(mx, my, **params))
    got = tq.ex49_reduced_system(mx, my, **params)
    ref = jq.ex49_reduced_system(mx, my, **params)
    assert same_csr(got[0], ref[0])
    for g, r in zip(got[1:], ref[1:]):
        assert np.asarray(g).tobytes() == np.asarray(r).tobytes()


@pytest.mark.parametrize("params", [SPONGE, BRICK])
def test_ex49_parallel_assembly_byte_equal(params):
    AA, ff, blocks, dec = tq.ex49_parallel_reduced_system(20, 30, 4,
                                                          **params)
    jAA, jff, jblocks, jdec = jq.ex49_parallel_reduced_system(20, 30, 4,
                                                              **params)
    assert same_csr(AA, jAA)
    assert ff.tobytes() == jff.tobytes()
    assert blocks == jblocks
    assert np.array_equal(dec.natural_to_petsc(), jdec.natural_to_petsc())


def test_reduced_sizes(system):
    """21×31 nodes × 2 dofs = 1302, less the 2×31 east/west Ux dofs; the
    zeroed Uy edge rows stay in AA (ex49.c's |x_bc| < 0.1 filter)."""
    AA, ff, keep, xbc = system
    assert AA.shape == (1240, 1240)
    assert keep.size == 1240 and ff.shape == (1240,)


def test_ex49_1_monitor_stream(system, capsys):
    AA, ff, keep, xbc = system
    Ad = aij_from_scipy(AA, device=CPU)
    pc = make_pc("ilu", A=Ad, A_host=AA)
    capsys.readouterr()
    r = ksp_solve(Ad, torch.from_numpy(ff), pc=pc, ksp_type="gmres",
                  rtol=1e-5, atol=1e-50, cgs_refine="always", monitor=True)
    out = capsys.readouterr().out
    assert int(r.its) == 54
    got = [ln.rstrip() for ln in out.splitlines()]
    want = GOLDEN.splitlines()
    assert len(got) == len(want)
    for i, (g, w) in enumerate(zip(got, want)):
        if i in ULP_LINES:
            gv, wv = float(g.split()[-1]), float(w.split()[-1])
            assert abs(gv - wv) < 5e-6 * wv, (i, g, w)
        else:
            assert g == w, (i, g, w)


def test_full_operator_symmetry_and_nullspace():
    A = tq.ex49_system(6, 5, c_str=0, E=1.0, nu=0.3)
    assert abs(A - A.T).max() < 1e-13
    iy, ix = np.meshgrid(np.arange(6), np.arange(7), indexing="ij")
    x, y = (ix / 6.0).reshape(-1), (iy / 5.0).reshape(-1)
    rb = np.zeros((A.shape[0], 3))
    rb[0::2, 0] = 1.0                         # x translation
    rb[1::2, 1] = 1.0                         # y translation
    rb[0::2, 2] = -y                          # rotation
    rb[1::2, 2] = x
    assert abs(A @ rb).max() < 1e-12


# ---------------------------------------------------------------------------
# tests/test_da_decomp.py through the port
# ---------------------------------------------------------------------------
def test_proc_grid_and_ownership():
    assert da_proc_grid(21, 31, 4) == (2, 2)
    assert da_proc_grid(100, 4, 8) == (8, 1)
    m, n = da_proc_grid(33, 33, 6)
    assert m * n == 6
    np.testing.assert_array_equal(da_ownership(21, 2), [11, 10])
    np.testing.assert_array_equal(da_ownership(31, 2), [16, 15])
    np.testing.assert_array_equal(da_ownership(10, 4), [3, 3, 2, 2])


def test_ao_and_element_ownership():
    dec = DADecomp2D.create(21, 31, dof=2, size=4)
    p = dec.natural_to_petsc()
    assert p.size == 2 * 21 * 31
    assert np.array_equal(np.sort(p), np.arange(p.size))
    for r, (s, e) in enumerate(dec.petsc_row_ranges()):
        xs, xm, ys, ym = dec.patch(r)
        assert e - s == 2 * xm * ym
    counts = np.bincount(dec.element_owner(), minlength=4)
    np.testing.assert_array_equal(counts, [11 * 16, 9 * 16, 11 * 14,
                                           9 * 14])


def test_parallel_assembly_same_matrix():
    """4-rank assembly = serial assembly up to a symmetric permutation and
    the summation order."""
    AA_s, ff_s, keep, xbc = tq.ex49_reduced_system(8, 10, **SPONGE)
    AA_p, ff_p, blocks, dec = tq.ex49_parallel_reduced_system(8, 10, 4,
                                                              **SPONGE)
    perm = dec.natural_to_petsc()
    kept_p = np.sort(perm[keep])
    q = np.searchsorted(kept_p, perm[keep])
    P = sp.csr_matrix((np.ones(q.size), (q, np.arange(q.size))))
    assert abs((P @ AA_s @ P.T) - AA_p).max() < 1e-12
    np.testing.assert_allclose(P @ ff_s, ff_p, rtol=0, atol=1e-12)


def _monitor_values(capsys):
    return [float(ln.split()[-1]) for ln in capsys.readouterr().out
            .splitlines() if "Residual norm" in ln]


@pytest.mark.parametrize("case", ["ex49_2", "ex49_3"])
def test_ex49_parallel_asm_streams(case, capsys):
    """output/ex49_2.out (GCR + ASM(1) LU, 29 its: every line but one ULP)
    and output/ex49_3.out (GMRES + ASM(1) LU on the brick, 31 its, every
    line), through the 4-rank emulation's blocks."""
    params, ksp_type = ((SPONGE, "gcr") if case == "ex49_2"
                        else (BRICK, "gmres"))
    AA, ff, blocks, dec = tq.ex49_parallel_reduced_system(20, 30, 4,
                                                          **params)
    if case == "ex49_2":
        assert [e - s for s, e in blocks] == [336, 304, 315, 285]
    pc = make_asm(AA, blocks=blocks, overlap=1, sub_pc="lu", device=CPU)
    capsys.readouterr()
    kw = dict(cgs_refine="always") if ksp_type == "gmres" else {}
    r = ksp_solve(aij_from_scipy(AA, device=CPU), torch.from_numpy(ff),
                  pc=pc, ksp_type=ksp_type, rtol=1e-5, atol=1e-50,
                  monitor=True, **kw)
    vals = _monitor_values(capsys)
    golden = GOLDEN_2 if case == "ex49_2" else GOLDEN_3
    assert int(r.its) == len(golden) - 1
    assert len(vals) == len(golden)
    exact = sum(f"{v:g}" == f"{g:g}" for v, g in zip(vals, golden))
    if case == "ex49_2":
        assert exact >= 29, exact
        np.testing.assert_allclose(vals, golden, rtol=5e-6)
    else:
        assert exact == len(golden), exact
