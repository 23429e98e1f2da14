"""The port's Section, DMLabel, interpolated strata, Gmsh and ExodusII
I/O (petsctpu_torch.dm.{section,label,interp,gmsh,exodus}) against
petsctpu's, on the CPU, and the label-driven FEM goldens.

Host plans on both sides: each case builds both from the same arrays
and requires equal arrays (byte for byte where the reference's are
integers: strata, faces, supports, dof offsets). The port's
interpolate, match_faces and label_faces replace the reference's loops
over cells and faces by array operations; the equalities hold them to
the loops' results. The solves hold the reference tests' own bounds
(tests/test_plex_interp.py, test_plex_label_gmsh.py, test_exodus.py)
and equal its and reason against petsctpu's solve of the same system.
"""

import struct

import numpy as np
import pytest
import scipy.sparse as sp
import scipy.sparse.linalg as spla
import torch

from petsctpu.dm import exodus as jexodus
from petsctpu.dm import gmsh as jgmsh
from petsctpu.dm import interp as jinterp
from petsctpu.dm import label as jlabel
from petsctpu.dm import plex as J
from petsctpu.dm import section as jsection
from petsctpu.ksp import ksp_solve as jksp_solve
from petsctpu.pc import make_pc as jmake_pc
from petsctpu.core.options import Options as JOptions
from petsctpu_torch import convert
from petsctpu_torch.core.options import Options
from petsctpu_torch.dm import exodus, gmsh, interp, label, plex as T, section
from petsctpu_torch.ksp import ksp_solve
from petsctpu_torch.pc import make_pc

# one intra-op thread: the suite runs in parallel workers (pytest -n), and
# PyTorch's default of a thread a core oversubscribes the host's cores
torch.set_num_threads(1)

CPU = "cpu"


def _same(a, b):
    a, b = np.asarray(a), np.asarray(b)
    assert a.dtype == b.dtype and a.shape == b.shape
    assert a.tobytes() == b.tobytes()


def _same_labels(pt, pj):
    names = sorted(jlabel.get_labels(pj))
    assert sorted(label.get_labels(pt)) == names
    for name in names:
        lt, lj = label.get_label(pt, name), jlabel.get_label(pj, name)
        assert lt.values() == lj.values()
        for v in lj.values():
            _same(lt.stratum(v), lj.stratum(v))


def _both(name, n):
    return (getattr(J, name).create_box_mesh(*n),
            getattr(T, name).create_box_mesh(*n))


def irregular(n=8, seed=3):
    """tests/test_plex_label_gmsh.py::_irregular_tri_mesh."""
    plex = J.Plex.create_box_mesh(n, n)
    rng = np.random.default_rng(seed)
    coords = plex.coords.copy()
    interior = np.setdiff1d(np.arange(plex.num_vertices),
                            plex.boundary_vertices())
    h = 1.0 / n
    coords[interior] += rng.uniform(-0.3 * h, 0.3 * h, (len(interior), 2))
    return J.Plex(plex.cells, coords)


def gmsh_text(plex, bc_tag=10, cell_tag=1):
    """MSH 2.2 text with boundary lines in physical group bc_tag and all
    triangles in cell_tag (tests/test_plex_label_gmsh.py::_gmsh_text)."""
    cells = plex.cells
    e = np.sort(np.concatenate([cells[:, [0, 1]], cells[:, [1, 2]],
                                cells[:, [2, 0]]]), axis=1)
    uniq, cnt = np.unique(e, axis=0, return_counts=True)
    bedges = uniq[cnt == 1]
    lines = ["$MeshFormat", "2.2 0 8", "$EndMeshFormat", "$PhysicalNames",
             "2", f'1 {bc_tag} "walls"', f'2 {cell_tag} "domain"',
             "$EndPhysicalNames", "$Nodes", str(len(plex.coords))]
    lines += [f"{k + 1} {x:.16g} {y:.16g} 0"
              for k, (x, y) in enumerate(plex.coords)]
    lines += ["$EndNodes", "$Elements", str(len(bedges) + len(cells))]
    eid = 1
    for a, b in bedges:
        lines.append(f"{eid} 1 2 {bc_tag} 0 {a + 1} {b + 1}")
        eid += 1
    for c in cells:
        lines.append(f"{eid} 2 2 {cell_tag} 0 {c[0] + 1} {c[1] + 1} "
                     f"{c[2] + 1}")
        eid += 1
    lines.append("$EndElements")
    return "\n".join(lines)


# ----------------------------------------------------------------- Section ---
def test_section_offsets_dofs_and_fields():
    s = section.Section(5).set_dof([0, 1, 2, 3, 4], 2)
    s.set_dof([2], 3).setup()
    r = jsection.Section(5).set_dof([0, 1, 2, 3, 4], 2)
    r.set_dof([2], 3).setup()
    assert s.total_dofs == r.total_dofs == 11 and s.offset(3) == 7
    _same(s.offsets, r.offsets)
    _same(s.point_dofs([0, 1]), r.point_dofs([0, 1]))
    s, r = section.Section(4), jsection.Section(4)
    for sec in (s, r):
        sec.set_field("u", np.arange(4), 2)
        sec.set_field("p", np.arange(4), 1)
        sec.setup()
    assert s.total_dofs == 12 and s.field_offset_within("p", 0) == 2
    _same(s.offsets, r.offsets)


@pytest.mark.parametrize("dof,con", [(2, [0, 5]), (1, [3]), (3, [])])
def test_section_constrained_and_closure_match(dof, con):
    s = section.vertex_section(6, dof=dof, constrained=np.array(con))
    r = jsection.vertex_section(6, dof=dof, constrained=np.array(con))
    _same(s.constrained, r.constrained)
    cells = np.array([[0, 2, 4], [1, 3, 5]])
    _same(s.closure_indices(cells), r.closure_indices(cells))


def test_section_mixed_dofs_constrained_matches():
    """Constrained points of unequal dof counts (a P2-like layout with
    two dofs on the edge points), set in two calls."""
    nd = np.array([1, 1, 2, 2, 1, 3])
    s = convert.section_from_arrays(nd, constrained=([5, 0], [3]))
    r = jsection.Section(6, nd)
    r.set_constrained(np.array([5, 0])).set_constrained(np.array([3]))
    r.setup()
    _same(s.constrained, r.constrained)
    _same(s.offsets, r.offsets)
    with pytest.raises(ValueError, match="uniform"):
        s.closure_indices(np.array([[0, 2]]))


# ----------------------------------------------------------------- DMLabel ---
def test_label_set_get_stratum():
    lab, ref = label.DMLabel("m"), jlabel.DMLabel("m")
    for L in (lab, ref):
        L.set_value([3, 1, 7], 5)
        L.set_value(2, 5)
        L.set_value([8], 9)
    assert lab.values() == ref.values() == [5, 9]
    _same(lab.stratum(5), ref.stratum(5))
    assert [lab.get_value(p) for p in range(10)] == \
        [ref.get_value(p) for p in range(10)]
    assert lab.stratum_size(9) == 1 and lab.has_point(8)
    assert lab.num_strata == 2 and not lab.has_point(4)


def test_plex_labels_mark_boundary_and_label_vertices():
    pt, pj = T.Plex.create_box_mesh(4, 4), J.Plex.create_box_mesh(4, 4)
    lt, lj = label.mark_boundary(pt, "marker"), jlabel.mark_boundary(
        pj, "marker")
    assert label.get_label(pt, "marker") is lt
    _same(label.label_vertices(pt, lt, [1]), jlabel.label_vertices(
        pj, lj, [1]))
    label.create_label(pt, "cells").set_value([0, 1], 7)
    jlabel.create_label(pj, "cells").set_value([0, 1], 7)
    _same(label.label_vertices(pt, label.get_label(pt, "cells"), [7]),
          jlabel.label_vertices(pj, jlabel.get_label(pj, "cells"), [7]))
    _same(label.vertex_point(pt, [0, 3]), jlabel.vertex_point(pj, [0, 3]))
    _same(label.point_vertex(pt, [40, 41]), jlabel.point_vertex(pj, [40, 41]))
    assert label.get_label(pt, "none") is None


# ----------------------------------------------------------- interpolation ---
@pytest.mark.parametrize("name,n", [("Plex", (4, 3)), ("PlexQuad", (4, 3)),
                                    ("Plex3D", (3, 2, 2)),
                                    ("PlexHex", (3, 2, 2))])
def test_interpolate_matches_reference(name, n):
    pj, pt = _both(name, n)
    it, ij = interp.interpolate(pt), jinterp.interpolate(pj)
    for field in ("faces", "cell_faces", "face_support", "edges"):
        _same(getattr(it, field), getattr(ij, field))
    assert interp.interpolate(pt) is it
    nc, nv, nf, ne = pt.num_cells, pt.num_vertices, it.num_faces, it.num_edges
    if pt.coords.shape[1] == 2:
        assert nv - nf + nc == 1                      # Euler, a disc
    else:
        assert nv - ne + nf - nc == 1
    assert interp.chart_size(pt) == jinterp.chart_size(pj)
    for p in (0, nc, nc + nv, nc + nv + nf // 2, nc + nv + nf - 1,
              interp.chart_size(pt) - 1):
        _same(interp.cone_of_point(pt, p), jinterp.cone_of_point(pj, p))
        if p < nc + nv + nf:            # the support of faces and below
            _same(interp.support_of_point(pt, p),
                  jinterp.support_of_point(pj, p))
    bf = interp.boundary_faces(pt)
    _same(bf, jinterp.boundary_faces(pj))
    _same(np.unique(it.faces[bf].reshape(-1)), pt.boundary_vertices())
    _same(interp.face_measures(pt), jinterp.face_measures(pj))
    _same(interp.face_centroids(pt, bf), jinterp.face_centroids(pj, bf))
    _same(interp.edge_point(pt, [0, 1]), jinterp.edge_point(pj, [0, 1]))
    _same(interp.point_face(pt, interp.face_point(pt, [2])), np.array([2]))


def test_interpolate_on_a_refined_jittered_mesh_matches():
    pj = irregular(6).refine()
    pt = T.Plex(pj.cells, pj.coords)
    it, ij = interp.interpolate(pt), jinterp.interpolate(pj)
    for field in ("faces", "cell_faces", "face_support"):
        _same(getattr(it, field), getattr(ij, field))


def test_adjacent_facet_groups_stay_distinct():
    plex = T.Plex.create_box_mesh(3, 3)
    bf = interp.boundary_faces(plex)
    cen = interp.face_centroids(plex, bf)
    lab = label.create_label(plex, "bnd")
    lab.set_value(interp.face_point(plex, bf[cen[:, 0] < 1e-12]), 1)
    lab.set_value(interp.face_point(plex, bf[cen[:, 1] < 1e-12]), 2)
    f1 = interp.label_faces(plex, lab, [1])
    f2 = interp.label_faces(plex, lab, [2])
    assert len(np.intersect1d(f1, f2)) == 0
    assert 0 in np.intersect1d(label.label_vertices(plex, lab, [1]),
                               label.label_vertices(plex, lab, [2]))


@pytest.mark.parametrize("name,n", [("Plex", (3, 2)), ("Plex3D", (2, 2, 1)),
                                    ("PlexHex", (2, 1, 2))])
def test_match_faces_and_label_faces_match_reference(name, n):
    pj, pt = _both(name, n)
    ij = jinterp.interpolate(pj)
    rng = np.random.default_rng(2)
    q = ij.faces[rng.permutation(ij.num_faces)[:7]][:, ::-1]
    q = np.concatenate([q, np.full((1, q.shape[1]), pj.num_vertices - 1),
                        np.full((1, q.shape[1]), -1)])
    _same(interp.match_faces(pt, q), jinterp.match_faces(pj, q))
    _same(interp.match_faces(pt, q[:, :-1]), jinterp.match_faces(pj, q[:, :-1]))
    bv = pj.boundary_vertices()
    vset = bv[bv % 3 != 0]
    for P, lab_mod in ((pt, label), (pj, jlabel)):
        L = lab_mod.create_label(P, "x")
        L.set_value(lab_mod.vertex_point(P, vset), 4)
        L.set_value(P.num_cells + P.num_vertices + np.array([0, 2]), 5)
    _same(interp.label_faces(pt, label.get_label(pt, "x"), [4, 5]),
          jinterp.label_faces(pj, jlabel.get_label(pj, "x"), [4, 5]))
    _same(label.label_vertices(pt, label.get_label(pt, "x"), [5]),
          jlabel.label_vertices(pj, jlabel.get_label(pj, "x"), [5]))


# ----------------------------------------------- facet-integral BCs, solves ---
def _right_and_left(plex, mod_i, mod_l, tag=7, with_dirichlet=True):
    bf = mod_i.boundary_faces(plex)
    cen = mod_i.face_centroids(plex, bf)
    lab = mod_l.create_label(plex, "bc")
    lab.set_value(mod_i.face_point(plex, bf[np.abs(cen[:, 0] - 1) < 1e-12]),
                  tag)
    if with_dirichlet:
        lab.set_value(mod_l.vertex_point(plex, np.flatnonzero(
            np.abs(plex.coords[:, 0]) < 1e-12)), 1)
    return lab


def _solve_both(ref, got, **kw):
    rj = jksp_solve(ref[0], ref[2], **kw)
    rt = ksp_solve(got[0], got[2], **kw)
    its = int(rj.its)
    assert int(rt.its) == its and int(rt.reason) == int(rj.reason) > 0
    hj = np.asarray(rj.history)[:its + 1]
    assert np.abs(rt.history[:its + 1].numpy() - hj).max() <= 1e-10 * hj[0]
    return rt


def test_neumann_patch_test_exact():
    """u* = x: Dirichlet u = 0 on x = 0, Neumann g = 1 on x = 1; P1
    reproduces u* to 1e-9 (the facet load is exact)."""
    pj, pt = _both("Plex", (5, 4))
    kw = dict(f=lambda c: 0.0, bc_label=("bc", [1]), neumann=("bc", [7], 1.0))
    for P, mi, ml in ((pj, jinterp, jlabel), (pt, interp, label)):
        _right_and_left(P, mi, ml)
    r = _solve_both(J.fem_assemble_poisson(pj, **kw),
                    T.fem_assemble_poisson(pt, device=CPU, **kw),
                    ksp_type="cg", rtol=1e-13, maxits=500)
    np.testing.assert_allclose(r.x.numpy(), pt.coords[:, 0], atol=1e-9)


def test_neumann_load_entry_exact():
    plex = T.Plex.create_box_mesh(3, 3)
    it = interp.interpolate(plex)
    bf = interp.boundary_faces(plex)
    top = bf[np.abs(interp.face_centroids(plex, bf)[:, 1] - 1.0) < 1e-12]
    label.create_label(plex, "nm").set_value(interp.face_point(plex, top), 4)
    g = 2.5
    _, _, b0 = T.fem_assemble_poisson(plex, f=lambda c: 0.0,
                                      bc_label=("nm", []), device=CPU)
    _, _, b1 = T.fem_assemble_poisson(plex, f=lambda c: 0.0,
                                      bc_label=("nm", []),
                                      neumann=("nm", [4], g), device=CPU)
    expect = np.zeros(plex.num_vertices)
    for f in top:
        v = it.faces[f]
        expect[v] += g * np.linalg.norm(plex.coords[v[1]]
                                        - plex.coords[v[0]]) / 2.0
    np.testing.assert_allclose((b1 - b0).numpy(), expect, atol=1e-14)


def test_mixed_dirichlet_neumann_convergence():
    """u* = x²: f = −2, du/dn = 2 on x = 1; the L2 error falls > 3× a
    halving of h."""
    errs = []
    for n in (4, 8, 16):
        pj, pt = _both("Plex", (n, n))
        kw = dict(f=lambda c: -2.0, bc_label=("bc", [1]),
                  neumann=("bc", [7], 2.0))
        for P, mi, ml in ((pj, jinterp, jlabel), (pt, interp, label)):
            _right_and_left(P, mi, ml)
        r = _solve_both(J.fem_assemble_poisson(pj, **kw),
                        T.fem_assemble_poisson(pt, device=CPU, **kw),
                        ksp_type="cg", rtol=1e-12, maxits=2000)
        errs.append(np.sqrt(np.mean((r.x.numpy() - pt.coords[:, 0] ** 2)
                                    ** 2)))
    assert errs[0] / errs[1] > 3.0 and errs[1] / errs[2] > 3.0, errs


def test_robin_diagonal_bump():
    plex = T.Plex.create_box_mesh(3, 3)
    bf = interp.boundary_faces(plex)
    label.create_label(plex, "rb").set_value(interp.face_point(plex, bf), 9)
    _, A0, _ = T.fem_assemble_poisson(plex, bc_label=("rb", []), device=CPU)
    _, A1, _ = T.fem_assemble_poisson(plex, bc_label=("rb", []),
                                      robin=("rb", [9], 10.0), device=CPU)
    d = A1.diagonal() - A0.diagonal()
    bv = plex.boundary_vertices()
    assert np.all(d[bv] > 0)
    np.testing.assert_allclose(
        d[np.setdiff1d(np.arange(plex.num_vertices), bv)], 0.0, atol=1e-14)


# -------------------------------------------------------------------- Gmsh ---
BINARY_NODES = [(0, 0), (1, 0), (1, 1), (0, 1)]
ASCII_MSH = """$MeshFormat
2.2 0 8
$EndMeshFormat
$PhysicalNames
2
1 7 "inflow"
2 5 "domain"
$EndPhysicalNames
$Nodes
4
1 0 0 0
2 1 0 0
3 1 1 0
4 0 1 0
$EndNodes
$Elements
3
1 1 2 7 1 1 2
2 2 2 5 1 1 2 3
3 2 2 5 1 1 3 4
$EndElements
"""


def _binary_msh(endian="<"):
    def b(*ints):
        return struct.pack(endian + "i" * len(ints), *ints)

    blob = b"$MeshFormat\n2.2 1 8\n" + b(1) + b"\n$EndMeshFormat\n" \
        + b'$PhysicalNames\n2\n1 7 "inflow"\n2 5 "domain"\n' \
        + b"$EndPhysicalNames\n$Nodes\n4\n"
    for nid, (x, y) in enumerate(BINARY_NODES, 1):
        blob += struct.pack(endian + "i3d", nid, float(x), float(y), 0.0)
    blob += b"\n$EndNodes\n$Elements\n3\n"
    blob += b(1, 1, 2) + b(1, 7, 1, 1, 2)
    blob += b(2, 2, 2) + b(2, 5, 1, 1, 2, 3) + b(3, 5, 1, 1, 3, 4)
    return blob + b"\n$EndElements\n"


@pytest.mark.parametrize("src", ["ascii", "binary", "binary big-endian"])
def test_read_gmsh_matches_reference(src):
    data = {"ascii": ASCII_MSH, "binary": _binary_msh(),
            "binary big-endian": _binary_msh(">")}[src]
    pt, pj = gmsh.read_gmsh(data), jgmsh.read_gmsh(data)
    _same(pt.cells, pj.cells)
    _same(pt.coords, pj.coords)
    _same_labels(pt, pj)
    ref = gmsh.read_gmsh(ASCII_MSH)
    _same(pt.cells, ref.cells)
    for name in ("Cell Sets", "Face Sets", "inflow", "domain"):
        assert label.get_label(pt, name) is not None


def test_gmsh_physical_groups_and_round_trip(tmp_path):
    p0 = irregular(6)
    text = gmsh_text(p0)
    pt, pj = gmsh.read_gmsh(text), jgmsh.read_gmsh(text)
    _same(pt.cells, pj.cells)
    _same(pt.coords, pj.coords)
    _same_labels(pt, pj)
    np.testing.assert_array_equal(
        label.label_vertices(pt, label.get_label(pt, "Face Sets"), [10]),
        pt.boundary_vertices())
    assert label.get_label(pt, "Cell Sets").stratum_size(1) == pt.num_cells
    # written by the port, read by both; written by both, the same text
    path, rpath = str(tmp_path / "t.msh"), str(tmp_path / "r.msh")
    gmsh.write_gmsh(T.Plex(p0.cells, p0.coords), path)
    jgmsh.write_gmsh(p0, rpath)
    assert open(path).read() == open(rpath).read()
    back = gmsh.read_gmsh(path)
    _same(back.cells, jgmsh.read_gmsh(path).cells)
    np.testing.assert_array_equal(back.cells, p0.cells)
    np.testing.assert_allclose(back.coords, p0.coords)


@pytest.mark.parametrize("name,n", [("PlexQuad", (3, 2)), ("Plex3D", (2, 1, 1)),
                                    ("PlexHex", (2, 2, 1))])
def test_gmsh_round_trip_other_cells(tmp_path, name, n):
    _, pt = _both(name, n)
    path = str(tmp_path / "m.msh")
    gmsh.write_gmsh(pt, path)
    back, ref = gmsh.read_gmsh(path), jgmsh.read_gmsh(path)
    assert type(back) is type(pt)
    _same(back.cells, ref.cells)
    np.testing.assert_array_equal(back.cells, pt.cells)
    np.testing.assert_allclose(back.coords, pt.coords)


def test_gmsh_rejects_what_it_does_not_read():
    with pytest.raises(ValueError, match="only MSH 2"):
        gmsh.read_gmsh("$MeshFormat\n4.1 0 8\n$EndMeshFormat\n")
    with pytest.raises(ValueError, match="no \\$Nodes"):
        gmsh.read_gmsh("$MeshFormat\n2.2 0 8\n$EndMeshFormat\n")


# ---------------------------------------------------------------- ExodusII ---
@pytest.mark.parametrize("name,n", [("Plex", (4, 3)), ("PlexQuad", (3, 3)),
                                    ("Plex3D", (2, 2, 2)),
                                    ("PlexHex", (3, 2, 2))])
def test_exodus_round_trip_matches_reference(tmp_path, name, n):
    pj, pt = _both(name, n)
    path, rpath = str(tmp_path / "m.exo"), str(tmp_path / "r.exo")
    exodus.write_exodus(path, pt)
    jexodus.write_exodus(rpath, pj)
    for p in (path, rpath):
        rt, rj = exodus.read_exodus(p), jexodus.read_exodus(p)
        _same(rt.cells, rj.cells)
        _same(rt.coords, rj.coords)
        _same_labels(rt, rj)
        np.testing.assert_array_equal(rt.cells, pt.cells)
        assert label.get_label(rt, "Cell Sets").stratum_size(1) == \
            pt.num_cells


def _exodus_sets(plex, mi, ml):
    bf = mi.boundary_faces(plex)
    cen = mi.face_centroids(plex, bf)
    fs = ml.create_label(plex, "Face Sets")
    fs.set_value(mi.face_point(plex, bf[cen[:, 0] < 1e-12]), 10)
    fs.set_value(mi.face_point(plex, bf[np.abs(cen[:, 0] - 1) < 1e-12]), 20)
    corner = np.flatnonzero((np.abs(plex.coords) < 1e-12).all(axis=1))
    ml.create_label(plex, "Vertex Sets").set_value(
        ml.vertex_point(plex, corner), 7)


def test_exodus_side_and_node_sets_match_reference(tmp_path):
    pj, pt = _both("Plex", (5, 4))
    _exodus_sets(pj, jinterp, jlabel)
    _exodus_sets(pt, interp, label)
    path, rpath = str(tmp_path / "m.exo"), str(tmp_path / "r.exo")
    exodus.write_exodus(path, pt)
    jexodus.write_exodus(rpath, pj)
    rt, rj = exodus.read_exodus(path), jexodus.read_exodus(rpath)
    _same_labels(rt, rj)
    fs = label.get_label(rt, "Face Sets")
    assert fs.values() == [10, 20]
    f10 = interp.label_faces(rt, fs, [10])
    np.testing.assert_allclose(interp.face_centroids(rt, f10)[:, 0], 0.0,
                               atol=1e-14)
    assert len(f10) == 4
    assert label.get_label(rt, "Vertex Sets").stratum_size(7) == 1


def test_assembly_with_exodus_sidesets(tmp_path):
    """The Neumann patch test (u* = x) driven off an Exodus file's side
    sets (DMPlexCreateExodus → DMAddBoundary)."""
    pt = T.Plex.create_box_mesh(5, 4)
    bf = interp.boundary_faces(pt)
    cen = interp.face_centroids(pt, bf)
    label.create_label(pt, "Face Sets").set_value(
        interp.face_point(pt, bf[np.abs(cen[:, 0] - 1.0) < 1e-12]), 7)
    path = str(tmp_path / "m.exo")
    exodus.write_exodus(path, pt)
    rt, rj = exodus.read_exodus(path), jexodus.read_exodus(path)
    for P, ml in ((rt, label), (rj, jlabel)):
        ml.get_label(P, "Face Sets").set_value(ml.vertex_point(
            P, np.flatnonzero(np.abs(P.coords[:, 0]) < 1e-12)), 1)
    kw = dict(f=lambda c: 0.0, bc_label=("Face Sets", [1]),
              neumann=("Face Sets", [7], 1.0))
    r = _solve_both(J.fem_assemble_poisson(rj, **kw),
                    T.fem_assemble_poisson(rt, device=CPU, **kw),
                    ksp_type="cg", rtol=1e-13, maxits=500)
    np.testing.assert_allclose(r.x.numpy(), rt.coords[:, 0], atol=1e-9)


# -------------------------------------------------------- label-driven FEM ---
def test_p1_poisson_gamg_vs_scipy():
    """The FEM golden (tests/test_plex_label_gmsh.py): an irregular mesh
    from Gmsh, Dirichlet rows from the 'walls' group, P1 through the
    port; A equals a textbook scipy assembly within 1e-12, and CG + GAMG
    gives scipy's direct solution within 1e-7, with petsctpu's its and
    reason and its history within 1e-10·‖r0‖."""
    text = gmsh_text(irregular(12))
    pt, pj = gmsh.read_gmsh(text), jgmsh.read_gmsh(text)
    Ad, Ah, b = T.fem_assemble_poisson(pt, bc_label=("walls", [10]),
                                       device=CPU)
    pts, cells, n = pt.coords, pt.cells, pt.num_vertices
    rows, cols, vals = [], [], []
    bref = np.zeros(n)
    for c in cells:
        x = pts[c]
        B = np.array([[x[1, 1] - x[2, 1], x[2, 1] - x[0, 1],
                       x[0, 1] - x[1, 1]],
                      [x[2, 0] - x[1, 0], x[0, 0] - x[2, 0],
                       x[1, 0] - x[0, 0]]])
        area = 0.5 * abs(np.linalg.det(np.array([x[1] - x[0], x[2] - x[0]])))
        Ke = (B.T @ B) / (4 * area)
        bref[c] += area / 3.0
        rows += list(np.repeat(c, 3))
        cols += list(np.tile(c, 3))
        vals += list(Ke.reshape(-1))
    AR = sp.coo_matrix((vals, (rows, cols)), shape=(n, n)).tolil()
    bnd = label.label_vertices(pt, label.get_label(pt, "walls"), [10])
    for i in bnd:
        AR[i, :] = 0.0
        AR[:, i] = 0.0
        AR[i, i] = 1.0
    AR = AR.tocsr()
    bref[bnd] = 0.0
    np.testing.assert_allclose((Ah - AR).toarray(), 0.0, atol=1e-12)
    uref = spla.spsolve(AR, bref)
    opts = {"pc_gamg_coarse_eq_limit": 16}
    r = ksp_solve(Ad, b, pc=make_pc("gamg", A=Ad, A_host=Ah,
                                    options=Options(opts)),
                  ksp_type="cg", rtol=1e-10, maxits=100)
    assert int(r.reason) > 0
    np.testing.assert_allclose(r.x.numpy(), uref, atol=1e-7)
    Aj, Ahj, bj = J.fem_assemble_poisson(pj, bc_label=("walls", [10]))
    rj = jksp_solve(Aj, bj, pc=jmake_pc("gamg", A=Aj, A_host=Ahj,
                                        options=JOptions(opts)),
                    ksp_type="cg", rtol=1e-10, maxits=100)
    its = int(rj.its)
    assert int(r.its) == its and int(r.reason) == int(rj.reason)
    hj = np.asarray(rj.history)[:its + 1]
    assert np.abs(r.history[:its + 1].numpy() - hj).max() <= 1e-10 * hj[0]
