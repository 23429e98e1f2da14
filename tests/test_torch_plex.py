"""The port's Plex (petsctpu_torch.dm.plex) against petsctpu.dm.plex, on
the CPU.

* Meshes: create_box_mesh, refine (once and twice), edges, faces,
  boundary_vertices, cone and support of all four cell types are equal
  to the reference's byte for byte (dtype included). The port builds
  them by array operations where the reference loops over cells.
* Element kernels on jittered cells: within 1e-13 of the largest entry.
  They are not bit-equal: XLA:CPU contracts the two-term dot products of
  the 2-D kernels into FMAs (one rounding where the port, and the card,
  round each product), and jnp.linalg and torch.linalg invert the 3-D
  and Q1 Jacobians by different LU routines.
* Assembly (P1 on triangles and tetrahedra, Q1 on quads and hexes, P2,
  with bc_label, neumann and robin): the CSR indptr and indices equal
  the reference's byte for byte; values and b within rtol 1e-13 (of the
  largest entry; entries that cancel to 0 stay in the pattern).
* Solves on them (CG + ILU, CG + GAMG, CG): equal its and reason, the
  history within 1e-10·‖r0‖ of the reference's (the two reduce dot
  products in different orders; measured at most 1.9e-14·‖r0‖), the
  solution within 1e-12, and the orders of convergence of the reference
  tests (tests/test_plex.py, tests/test_plex2.py).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from petsctpu.dm import plex as J
from petsctpu.dm.label import create_label as jcreate_label
from petsctpu.dm.label import mark_boundary as jmark_boundary
from petsctpu.dm.interp import boundary_faces as jboundary_faces
from petsctpu.dm.interp import face_centroids as jface_centroids
from petsctpu.dm.interp import face_point as jface_point
from petsctpu.ksp import ksp_solve as jksp_solve
from petsctpu.pc import make_pc as jmake_pc
from petsctpu_torch import convert
from petsctpu_torch.dm import plex as T
from petsctpu_torch.dm.label import get_label, mark_boundary
from petsctpu_torch.ksp import ksp_solve
from petsctpu_torch.pc import make_pc

# one intra-op thread: the suite runs in parallel workers (pytest -n), and
# PyTorch's default of a thread a core oversubscribes the host's cores
torch.set_num_threads(1)

CPU = "cpu"
RTOL = 1e-13
HIST = 1e-10


def _same(a, b):
    a, b = np.asarray(a), np.asarray(b)
    assert a.dtype == b.dtype and a.shape == b.shape
    assert a.tobytes() == b.tobytes()


def _close(got, ref, rtol=RTOL):
    got, ref = np.asarray(got), np.asarray(ref)
    assert got.shape == ref.shape
    np.testing.assert_allclose(got, ref, rtol=rtol,
                               atol=rtol * max(np.abs(ref).max(), 1e-300))


def f2(c):
    return 2 * np.pi ** 2 * np.sin(np.pi * c[0]) * np.sin(np.pi * c[1])


def f3(c):
    return 3 * np.pi ** 2 * np.prod(np.sin(np.pi * c))


def _both(name, n):
    return (getattr(J, name).create_box_mesh(*n),
            getattr(T, name).create_box_mesh(*n))


def jittered(n=8, seed=3, scale=0.3):
    """tests/test_plex_label_gmsh.py::_irregular_tri_mesh: the box
    triangulated, interior nodes jittered by ±scale·h."""
    plex = J.Plex.create_box_mesh(n, n)
    rng = np.random.default_rng(seed)
    coords = plex.coords.copy()
    interior = np.setdiff1d(np.arange(plex.num_vertices),
                            plex.boundary_vertices())
    h = 1.0 / n
    coords[interior] += rng.uniform(-scale * h, scale * h,
                                    (len(interior), 2))
    return J.Plex(plex.cells, coords), T.Plex(plex.cells, coords)


# ---------------------------------------------------------------- meshes ---
MESHES = [("Plex", (4, 3)), ("PlexQuad", (3, 5)), ("Plex3D", (2, 3, 2)),
          ("PlexHex", (3, 2, 2))]


@pytest.mark.parametrize("name,n", MESHES)
def test_box_mesh_bytes_equal_reference(name, n):
    a, b = _both(name, n)
    _same(b.cells, a.cells)
    _same(b.coords, a.coords)
    _same(b.edges(), a.edges())
    _same(b.boundary_vertices(), a.boundary_vertices())
    if hasattr(a, "faces"):
        _same(b.faces(), a.faces())
    assert (b.num_cells, b.num_vertices) == (a.num_cells, a.num_vertices)
    for c in (0, a.num_cells // 2, a.num_cells - 1):
        _same(b.cone(c), a.cone(c))
    for v in (0, a.num_vertices // 3, a.num_vertices - 1):
        _same(b.support(v), a.support(v))


@pytest.mark.parametrize("name,n", [("Plex", (5, 4)), ("PlexQuad", (3, 3)),
                                    ("Plex3D", (2, 2, 2))])
@pytest.mark.parametrize("times", [1, 2])
def test_refine_bytes_equal_reference(name, n, times):
    a, b = _both(name, n)
    for _ in range(times):
        a, b = a.refine(), b.refine()
    _same(b.cells, a.cells)
    _same(b.coords, a.coords)
    _same(b.boundary_vertices(), a.boundary_vertices())


def test_refine_keeps_a_jittered_mesh_bytes_equal():
    a, b = jittered(7)
    a, b = a.refine(), b.refine()
    _same(b.cells, a.cells)
    _same(b.coords, a.coords)


def test_unique_rows_equals_numpy():
    rng = np.random.default_rng(5)
    for dtype, hi, k in ((np.int32, 9, 2), (np.int64, 40, 3),
                         (np.int32, 1 << 20, 4)):
        a = rng.integers(0, hi, (500, k)).astype(dtype)
        ref = np.unique(a, axis=0, return_index=True, return_inverse=True,
                        return_counts=True)
        got = T.unique_rows(a, return_index=True, return_inverse=True,
                            return_counts=True)
        for g, r in zip(got, ref):
            _same(g, np.asarray(r).reshape(g.shape))
        _same(T.unique_rows(a), np.unique(a, axis=0))


def test_topology_counts_and_boundary():
    """tests/test_plex.py::TestTopology on the port."""
    px = T.Plex.create_box_mesh(3, 3)
    assert (px.num_vertices, px.num_cells) == (16, 18)
    assert 16 - px.edges().shape[0] + 18 == 1          # Euler, a disk
    bnd = px.boundary_vertices()
    assert len(bnd) == 12
    assert all(np.isin(px.coords[v], (0.0, 1.0)).any() for v in bnd)
    for c in range(px.num_cells):
        for v in px.cone(c):
            assert c in px.support(v)


def _area(p):
    v0, v1, v2 = (p.coords[p.cells[:, k]] for k in range(3))
    return 0.5 * np.abs((v1[:, 0] - v0[:, 0]) * (v2[:, 1] - v0[:, 1])
                        - (v2[:, 0] - v0[:, 0]) * (v1[:, 1] - v0[:, 1])).sum()


def test_refine_preserves_measure_and_conformity():
    px = T.Plex.create_box_mesh(2, 2)
    r = px.refine()
    assert r.num_cells == 4 * px.num_cells
    assert r.num_vertices == px.num_vertices + px.edges().shape[0]
    np.testing.assert_allclose(_area(r), _area(px), atol=1e-14)
    t = T.Plex3D.create_box_mesh(2, 2, 2).refine()
    vols = T._simplex_measures(t.coords, t.cells)
    assert t.num_cells == 8 * 48 and (vols > 1e-15).all()
    np.testing.assert_allclose(vols.sum(), 1.0, rtol=1e-12)
    q = T.PlexQuad.create_box_mesh(3, 3).refine()
    assert q.num_cells == 36
    e = np.concatenate([q.cells[:, list(p)] for p in T.PlexQuad._EDGE_PAIRS])
    _, counts = np.unique(np.sort(e, axis=1), axis=0, return_counts=True)
    assert set(counts.tolist()) <= {1, 2}


def test_3d_box_topology_and_volume():
    px = T.Plex3D.create_box_mesh(3, 3, 3)
    assert (px.num_cells, px.num_vertices) == (6 * 27, 64)
    vols = T._simplex_measures(px.coords, px.cells)
    assert (vols > 0).all()
    np.testing.assert_allclose(vols.sum(), 1.0, rtol=1e-12)
    on_face = ((px.coords == 0.0) | (px.coords == 1.0)).any(axis=1)
    np.testing.assert_array_equal(px.boundary_vertices(),
                                  np.where(on_face)[0])


# --------------------------------------------------------- element kernels ---
ELEMENTS = [("p1_element_stiffness", "Plex", 2),
            ("p2_element_stiffness", "Plex", 2),
            ("p1_element_stiffness_3d", "Plex3D", 3),
            ("q1_element_stiffness", "PlexQuad", 2),
            ("q1_element_stiffness_3d", "PlexHex", 3)]


@pytest.mark.parametrize("name,mesh,dim", ELEMENTS)
def test_element_kernel_matches_reference(name, mesh, dim):
    m = getattr(T, mesh).create_box_mesh(*([3] * dim))
    rng = np.random.default_rng(1)
    X = m.coords[m.cells] + rng.uniform(-0.05, 0.05, m.coords[m.cells].shape)
    ref = np.asarray(jax.vmap(getattr(J, name))(jnp.asarray(X)))
    got = getattr(T, name)(torch.from_numpy(X))
    _close(got.numpy(), ref)
    # one cell, the reference's signature
    _close(getattr(T, name)(torch.from_numpy(X[4])).numpy(), ref[4])
    assert getattr(T, name)(torch.from_numpy(X[4])).shape == ref[4].shape


@pytest.mark.parametrize("name,X", [
    ("q1_element_stiffness",
     [[0.0, 0.0], [1.1, 0.1], [1.0, 1.2], [-0.1, 0.9]]),
    ("q1_element_stiffness_3d",
     [[0, 0, 0], [1, 0, 0], [1, 1, 0], [0, 1, 0],
      [0, 0, 1], [1, 0, 1], [1, 1, 1], [0, 1, 1]]),
    ("p2_element_stiffness", [[0.0, 0.0], [1.2, 0.1], [0.3, 1.1]])])
def test_element_patch_consistency(name, X):
    """tests/test_plex2.py's patch tests: rows sum to zero (constants in
    the kernel), symmetric, positive semi-definite."""
    K = getattr(T, name)(torch.tensor(X, dtype=torch.float64)).numpy()
    np.testing.assert_allclose(K.sum(axis=1), 0, atol=1e-12)
    np.testing.assert_allclose(K, K.T, atol=1e-12)
    w = np.linalg.eigvalsh(K)
    assert w[0] > -1e-12 and w[1] > 0


def test_element_kernel_for_and_measures():
    for name, mesh, dim in ELEMENTS[:1] + ELEMENTS[2:]:
        a, b = _both(mesh, (2,) * dim)
        assert T.element_kernel_for(b).__name__ == \
            J.element_kernel_for(a).__name__
        _close(T.cell_measures(b), J.cell_measures(a), 1e-15)
    with pytest.raises(ValueError, match="no element"):
        T.element_kernel_for(T.Plex(np.zeros((1, 5), np.int32),
                                    np.zeros((5, 2))))


# ---------------------------------------------------------------- assembly ---
def _label_cases():
    """(name, reference plex, port plex, kwargs) of the labelled cases:
    the same labels set on both sides from the same arrays."""
    out = []
    a, b = jittered(6)
    jmark_boundary(a, "marker")
    convert.labels_from_arrays(b, {"marker": {1: jmark_boundary(
        a, "marker").stratum(1)}})
    out.append(("bc_label marker", a, b, dict(bc_label=("marker", [1]))))
    # Neumann on x = 1, Dirichlet on x = 0 (tests/test_plex_interp.py)
    for kind, kw in (("neumann", dict(f=lambda c: 0.0,
                                      neumann=("bc", [7], 1.0))),
                     ("neumann g(c)", dict(f=lambda c: -2.0, neumann=(
                         "bc", [7], lambda c: 2.0 + c[1]))),
                     ("robin", dict(robin=("bc", [7], 10.0))),
                     ("robin a(c)", dict(robin=("bc", [7, 1],
                                                lambda c: 1.0 + c[0])))):
        a, b = _both("Plex", (5, 4))
        bf = jboundary_faces(a)
        right = bf[np.abs(jface_centroids(a, bf)[:, 0] - 1.0) < 1e-12]
        lab = jcreate_label(a, "bc")
        lab.set_value(jface_point(a, right), 7)
        lab.set_value(a.num_cells + np.flatnonzero(
            np.abs(a.coords[:, 0]) < 1e-12), 1)
        convert.labels_from_arrays(b, {"bc": {v: lab.stratum(v)
                                              for v in lab.values()}})
        out.append((kind, a, b, dict(bc_label=("bc", [1]), **kw)))
    a, b = _both("PlexQuad", (4, 3))
    jmark_boundary(a, "m", 3)
    mark_boundary(b, "m", 3)
    out.append(("quad robin on vertex set", a, b,
                dict(bc_label=("m", []), robin=("m", [3], 2.0))))
    return out


ASSEMBLY = [("Plex", (6, 5), f2), ("PlexQuad", (5, 4), f2),
            ("Plex3D", (3, 3, 2), f3), ("PlexHex", (3, 2, 3), f3),
            ("Plex", (4, 4), None)]


def _check_assembly(ref, got):
    _, Ah_j, b_j = ref[:3]
    Ad, Ah, b = got[:3]
    _same(Ah.indptr, Ah_j.indptr)
    _same(Ah.indices, Ah_j.indices)
    _close(Ah.data, Ah_j.data)
    _close(b.numpy(), np.asarray(b_j))
    # the device pack is the host CSR's
    from petsctpu_torch.mat.ell import aij_pack
    cols, vals, shape, nnz = aij_pack(Ah)
    assert torch.equal(Ad.cols, torch.from_numpy(cols))
    assert torch.equal(Ad.vals, torch.from_numpy(vals))
    assert (Ad.shape, Ad.nnz) == (shape, nnz) and Ad.device.type == "cpu"


@pytest.mark.parametrize("name,n,f", ASSEMBLY)
def test_fem_assembly_matches_reference(name, n, f):
    a, b = _both(name, n)
    _check_assembly(J.fem_assemble_poisson(a, f=f),
                    T.fem_assemble_poisson(b, f=f, device=CPU))


@pytest.mark.parametrize("case", range(6))
def test_labelled_assembly_matches_reference(case):
    kind, a, b, kw = _label_cases()[case]
    _check_assembly(J.fem_assemble_poisson(a, **kw),
                    T.fem_assemble_poisson(b, device=CPU, **kw))


def test_jittered_p1_assembly_and_fp32_match_reference():
    a, b = jittered(9)
    _check_assembly(J.fem_assemble_poisson(a, f=f2),
                    T.fem_assemble_poisson(b, f=f2, device=CPU))
    _, Ah_j, b_j = J.fem_assemble_poisson(a, dtype=np.float32)
    Ad, Ah, bt = T.fem_assemble_poisson(b, dtype=np.float32, device=CPU)
    assert Ah.dtype == np.float32 and Ad.dtype == bt.dtype == torch.float32
    _same(Ah.indices, Ah_j.indices)
    _close(Ah.data, Ah_j.data, 1e-6)


@pytest.mark.parametrize("n", [4, 5])
def test_p2_assembly_matches_reference(n):
    a, b = _both("Plex", (n, n))
    ref = J.p2_assemble_poisson(a, f=f2)
    got = T.p2_assemble_poisson(b, f=f2, device=CPU)
    _check_assembly(ref, got)
    _same(got[3], ref[3])
    cl_j, e_j = J.p2_closure(a)
    cl_t, e_t = T.p2_closure(b)
    _same(cl_t, cl_j)
    _same(e_t, e_j)


def test_pattern_keeps_cancelled_entries():
    """Right-angle triangles give exact-zero sums on the diagonal edges;
    the pattern keeps them, as the reference's does, and the ELL pack
    keeps them too."""
    a, b = _both("Plex", (4, 4))
    _, Ah_j, _ = J.fem_assemble_poisson(a)
    Ad, Ah, _ = T.fem_assemble_poisson(b, device=CPU)
    i, j = int(b.cells[0, 0]), int(b.cells[0, 2])
    assert j in Ah.indices[Ah.indptr[i]:Ah.indptr[i + 1]]
    assert Ah[i, j] == 0.0 and Ah.nnz == Ah_j.nnz
    assert (Ad.cols[i] == j).any() and Ad.nnz == Ah.nnz


def test_closure_sum_has_add_at_bits():
    rng = np.random.default_rng(4)
    slot = rng.integers(0, 50, 2000)
    vals = rng.standard_normal(2000)
    ref = np.zeros(50)
    np.add.at(ref, slot, vals)
    got = T.closure_sum(slot, 50, torch.from_numpy(vals)).numpy()
    _same(got, ref)


def test_assembly_needs_cuda_without_device():
    if torch.cuda.is_available():
        pytest.skip("CUDA is present: the default device is valid here")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        T.fem_assemble_poisson(T.Plex.create_box_mesh(2, 2))


# ------------------------------------------------------------------ solves ---
def _solve_both(ref, got, pc, **kw):
    Aj, Ah_j, bj = ref[:3]
    Ad, Ah, bt = got[:3]
    rj = jksp_solve(Aj, bj, pc=jmake_pc(pc, A=Aj, A_host=Ah_j) if pc
                    else None, **kw)
    rt = ksp_solve(Ad, bt, pc=make_pc(pc, A=Ad, A_host=Ah) if pc else None,
                   **kw)
    its = int(rj.its)
    assert int(rt.its) == its and int(rt.reason) == int(rj.reason) > 0
    hj = np.asarray(rj.history)[:its + 1]
    assert np.abs(rt.history[:its + 1].numpy() - hj).max() <= HIST * hj[0]
    _close(rt.x.numpy(), np.asarray(rj.x), 1e-12)
    return rt


@pytest.mark.parametrize("name,nx,f,pc,kw", [
    ("Plex", 8, f2, "ilu", dict(ksp_type="cg", rtol=1e-10, maxits=500)),
    ("Plex3D", 4, f3, "ilu", dict(ksp_type="cg", rtol=1e-10, maxits=800)),
    ("PlexQuad", 8, f2, None, dict(ksp_type="cg", rtol=1e-12, maxits=2000)),
])
def test_manufactured_convergence_matches_reference(name, nx, f, pc, kw):
    """tests/test_plex.py / test_plex2.py's orders: P1 ~h² (ratio > 3 in
    2-D, > 2.5 in 3-D), Q1 nodal superconvergence (> 8)."""
    dim = 3 if name == "Plex3D" else 2
    errs = []
    for n in (nx, 2 * nx):
        a, b = _both(name, (n,) * dim)
        r = _solve_both(J.fem_assemble_poisson(a, f=f),
                        T.fem_assemble_poisson(b, f=f, device=CPU), pc, **kw)
        exact = np.prod(np.sin(np.pi * b.coords), axis=1)
        errs.append(np.abs(r.x.numpy() - exact).max())
    assert errs[0] / errs[1] > {"Plex": 3.0, "Plex3D": 2.5,
                                "PlexQuad": 8.0}[name]


def test_gamg_on_plex():
    """tests/test_plex.py::test_gamg_on_plex: the unstructured operator
    through the algebraic-MG path, in fewer than 25 its."""
    a, b = _both("Plex", (12, 12))
    r = _solve_both(J.p1_assemble_poisson(a), T.p1_assemble_poisson(
        b, device=CPU), "gamg", ksp_type="cg", rtol=1e-8, maxits=60)
    assert int(r.its) < 25


def test_hex_poisson_matches_reference():
    a, b = _both("PlexHex", (6, 6, 6))
    r = _solve_both(J.fem_assemble_poisson(a, f=f3),
                    T.fem_assemble_poisson(b, f=f3, device=CPU), None,
                    ksp_type="cg", rtol=1e-12, maxits=3000)
    assert np.abs(r.x.numpy() - np.prod(np.sin(np.pi * b.coords),
                                        axis=1)).max() < 0.02


def test_p2_convergence_and_p1_comparison():
    """P2's nodal error falls > 8× a halving of h, and is below a fifth
    of P1's on the same mesh (tests/test_plex2.py::TestP2Elements)."""
    kw = dict(ksp_type="cg", rtol=1e-13, maxits=4000)
    errs = []
    for n in (4, 8):
        a, b = _both("Plex", (n, n))
        ref, got = (J.p2_assemble_poisson(a, f=f2),
                    T.p2_assemble_poisson(b, f=f2, device=CPU))
        r = _solve_both(ref, got, None, **kw)
        nc = got[3]
        errs.append(np.abs(r.x.numpy() - np.sin(np.pi * nc[:, 0])
                           * np.sin(np.pi * nc[:, 1])).max())
    assert errs[0] / errs[1] > 8, errs
    a, b = _both("Plex", (8, 8))
    r1 = _solve_both(J.fem_assemble_poisson(a, f=f2),
                     T.fem_assemble_poisson(b, f=f2, device=CPU), None, **kw)
    e1 = np.abs(r1.x.numpy() - np.sin(np.pi * b.coords[:, 0])
                * np.sin(np.pi * b.coords[:, 1])).max()
    assert errs[1] < e1 / 5, (e1, errs[1])


def test_plex_from_arrays_carries_mesh_and_labels():
    a, _ = jittered(5)
    lab = jmark_boundary(a, "marker")
    b = convert.plex_from_arrays(a.cells, a.coords, labels={
        "marker": {1: lab.stratum(1)}})
    assert type(b) is T.Plex
    _same(b.cells, a.cells)
    _same(b.coords, a.coords)
    _same(get_label(b, "marker").stratum(1), lab.stratum(1))
    for name, n in MESHES:
        ja = getattr(J, name).create_box_mesh(*n)
        assert type(convert.plex_from_arrays(ja.cells, ja.coords)) is \
            getattr(T, name)
