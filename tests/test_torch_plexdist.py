"""The distributed Plex (petsctpu_torch/dm/plexdist.py) against petsctpu
(tests/test_plex2.py::TestDistPlex and tests/test_plex_label_gmsh.py::
test_distributed_label_bc_matches_serial) over 4 rank threads
(parallel.comm.World, device "cpu") and petsctpu's 4-device CPU mesh.

The host plan (cell partition, renumbering, per-rank cells, the entry
route, the sharded template's pattern) is held byte for byte; values
within 1e-13 (XLA:CPU contracts the 2-D element kernels' two-term dots
into FMAs, PyTorch does not); the device assembly equal to the host
template within 1e-13, as the reference test holds its own; CG solves
to petsctpu's its and reason, histories within 1e-10 of ‖r0‖, x within
the reference tests' tolerances of the serial solve.
"""

import jax
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

from petsctpu.dm import plex as J
from petsctpu.dm.plexdist import distribute_plex as r_distribute
from petsctpu.parallel import par_ksp_solve as r_par_ksp_solve

from petsctpu_torch.dm import plex as T
from petsctpu_torch.dm.plexdist import distribute_plex
from petsctpu_torch.parallel import World, par_ksp_solve
from tests.test_torch_dm_io import gmsh_text, irregular

torch.set_num_threads(1)

P = 4
_WORLDS = {}


@pytest.fixture(autouse=True, scope="module")
def _close_worlds():
    yield
    for w in _WORLDS.values():
        w.close()
    _WORLDS.clear()


def world() -> World:
    if P not in _WORLDS or _WORLDS[P].closed:
        _WORLDS[P] = World(P, "cpu", timeout=60.0)
    return _WORLDS[P]


def mesh() -> Mesh:
    return Mesh(np.array(jax.devices()[:P]), ("rows",))


def stacked(ts):
    return np.stack([t.cpu().numpy() for t in ts])


def assert_plan_equal(dt, dr):
    np.testing.assert_array_equal(dt.perm, dr.perm)
    np.testing.assert_array_equal(dt.cell_order, dr._cell_order_arr)
    assert (dt.nparts, dt.npc, dt.s, dt.K1, dt.K2) == \
        (dr.nparts, dr.npc, dr.s, dr.K1, dr.K2)
    np.testing.assert_array_equal(stacked(dt.cell_coords),
                                  np.asarray(dr.cell_coords))
    np.testing.assert_array_equal(stacked(dt.cell_mask),
                                  np.asarray(dr.cell_mask))
    np.testing.assert_array_equal(stacked(dt.send_idx),
                                  np.asarray(dr.send_idx))
    np.testing.assert_array_equal(stacked(dt.recv_slot),
                                  np.asarray(dr.recv_slot))
    np.testing.assert_allclose(stacked(dt.base_flat),
                               np.asarray(dr.base_flat), rtol=0, atol=1e-13)
    for f in ("diag_cols", "off_cols", "send_idx", "ghost_src",
              "ghost_gidx"):
        np.testing.assert_array_equal(stacked(getattr(dt.template, f)),
                                      np.asarray(getattr(dr.template, f)))
    np.testing.assert_allclose(dt.b, np.asarray(dr.b).reshape(-1), rtol=0,
                               atol=1e-15)


def assert_vals_close(M, ref, atol=1e-13):
    for f in ("diag_vals", "off_vals"):
        np.testing.assert_allclose(stacked(getattr(M, f)),
                                   np.asarray(getattr(ref, f)), rtol=0,
                                   atol=atol, err_msg=f)


@pytest.mark.parametrize("name,n", [("Plex", (16, 16)),
                                    ("PlexQuad", (16, 16)),
                                    ("Plex3D", (5, 5, 5)),
                                    ("PlexHex", (5, 5, 5))])
def test_distributed_assembly_matches_host_and_reference(name, n):
    """test_distributed_assembly_matches_host on the four cell types: the
    plan of petsctpu's; the device assembly (element kernels, one
    all_to_all, the fold into the ELL slots) equal to the host template
    and to petsctpu's assembled operator."""
    pj = getattr(J, name).create_box_mesh(*n)
    pt = getattr(T, name).create_box_mesh(*n)
    dr = r_distribute(pj, P)
    dt = distribute_plex(pt, P, device="cpu")
    assert_plan_equal(dt, dr)
    w = world()
    w.reset_counts()
    M = dt.assembled(w)
    assert w.comms[0].counts["all_to_all"][0] == 1
    assert_vals_close(M, dr.template)
    for p in range(P):
        np.testing.assert_allclose(M.diag_vals[p].numpy(),
                                   dt.template.diag_vals[p].numpy(),
                                   rtol=0, atol=1e-13)
        np.testing.assert_allclose(M.off_vals[p].numpy(),
                                   dt.template.off_vals[p].numpy(),
                                   rtol=0, atol=1e-13)
    assert_vals_close(M, dr.assembled(mesh()))


def solve_both(dt, Mt, dr, Mr, rtol, maxits):
    rr = r_par_ksp_solve(mesh(), Mr, np.asarray(dr.b).reshape(-1),
                         ksp_type="cg", rtol=rtol, maxits=maxits)
    rt = par_ksp_solve(world(), Mt, dt.b, ksp_type="cg", rtol=rtol,
                       maxits=maxits)
    assert int(rt.its) == int(rr.its) and int(rt.reason) == int(rr.reason)
    assert int(rt.reason) > 0
    k = int(rt.its) + 1
    ref = np.asarray(rr.history[:k])
    np.testing.assert_allclose(rt.history[:k].numpy(), ref, rtol=0,
                               atol=1e-10 * ref[0])
    return rt.x.numpy()[dt.perm]


def test_distributed_solve_matches_serial_and_reference():
    """test_distributed_solve_matches_serial: Q1 on a 20² quad mesh, CG
    rtol 1e-10 over the ranks; x[perm] within 1e-10 of the port's serial
    solve, with its iteration count."""
    from petsctpu_torch.ksp import ksp_solve

    pj = J.PlexQuad.create_box_mesh(20, 20)
    pt = T.PlexQuad.create_box_mesh(20, 20)
    dr, dt = r_distribute(pj, P), distribute_plex(pt, P, device="cpu")
    x = solve_both(dt, dt.assembled(world()), dr, dr.assembled(mesh()),
                   1e-10, 2000)
    Ad, _, b = T.fem_assemble_poisson(pt, device="cpu")
    rs = ksp_solve(Ad, b, ksp_type="cg", rtol=1e-10, maxits=2000)
    np.testing.assert_allclose(x, rs.x.numpy(), atol=1e-10)


def test_coefficient_refresh_matches_reference():
    """test_coefficient_refresh_on_device: random per-cell κ assembled on
    the device with no host work, against petsctpu's assembled(κ) and a
    host oracle (the element matrices scaled by κ, the Dirichlet rows and
    columns zeroed, a unit diagonal) applied to a vector."""
    import scipy.sparse as sp

    pj = J.Plex.create_box_mesh(12, 12)
    pt = T.Plex.create_box_mesh(12, 12)
    dr, dt = r_distribute(pj, P), distribute_plex(pt, P, device="cpu")
    rng = np.random.default_rng(0)
    kappa = np.exp(rng.standard_normal(pt.num_cells))
    M = dt.assembled(world(), kappa=kappa)
    assert_vals_close(M, dr.assembled(mesh(), kappa=kappa))
    cells = T.Plex(dt.perm[pt.cells], pt.coords[np.argsort(dt.perm)])
    nc, npc = cells.cells.shape
    nv = cells.num_vertices
    Ke = T.p1_element_stiffness(torch.from_numpy(
        cells.coords[cells.cells])).numpy() * kappa[:, None, None]
    rows = np.repeat(cells.cells, npc, axis=1).reshape(-1)
    cols = np.tile(cells.cells, (1, npc)).reshape(-1)
    A = sp.coo_matrix((Ke.reshape(-1), (rows, cols)), shape=(nv, nv)).tocsr()
    con = np.zeros(nv, bool)
    con[cells.boundary_vertices()] = True
    rr = np.repeat(np.arange(nv), np.diff(A.indptr))
    A.data[con[rr] | con[A.indices]] = 0.0
    A = (A + sp.diags(con.astype(float))).tocsr()
    x = rng.standard_normal(nv)
    s = M.nloc
    xp = np.zeros(P * s)
    xp[:nv] = x
    y = torch.cat(world().run(lambda c, v: M.rank(c).mult(v), [
        (torch.from_numpy(xp[p * s:(p + 1) * s].copy()),)
        for p in range(P)])).numpy()
    np.testing.assert_allclose(y[:nv], A @ x, atol=1e-11)


def test_distributed_label_bc_matches_serial_and_reference():
    """test_distributed_label_bc_matches_serial: a jittered Gmsh mesh,
    Dirichlet rows from its "walls" label carried through the
    renumbering; CG rtol 1e-9 over the ranks against petsctpu's and the
    port's serial label-driven solve (x within 1e-6)."""
    from petsctpu.dm.gmsh import read_gmsh as r_read

    from petsctpu_torch.dm.gmsh import read_gmsh
    from petsctpu_torch.ksp import ksp_solve

    text = gmsh_text(irregular(10))
    pj, pt = r_read(text), read_gmsh(text)
    bc = ("walls", [10])
    dr = r_distribute(pj, P, bc_label=bc)
    dt = distribute_plex(pt, P, bc_label=bc, device="cpu")
    assert_plan_equal(dt, dr)
    x = solve_both(dt, dt.assembled(world()), dr, dr.assembled(mesh()),
                   1e-9, 400)
    Ad, _, b = T.fem_assemble_poisson(pt, bc_label=bc, device="cpu")
    rs = ksp_solve(Ad, b, ksp_type="cg", rtol=1e-9, maxits=400)
    np.testing.assert_allclose(x, rs.x.numpy(), atol=1e-6)
