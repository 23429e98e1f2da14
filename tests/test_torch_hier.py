"""The two-axis World and the hierarchical halo (petsctpu_torch/parallel/
comm.py's mesh, parallel/hier.py) against petsctpu (tests/test_hier.py's
four cases) on a 2 x 4 mesh: the port's ranks are threads of the test
process (World(8, "cpu", mesh=(2, 4))), petsctpu's the CPU devices of a
("dcn", "ici") Mesh. The plan arrays byte for byte; products and
transposed products within fp64 rtol 1e-12 of scipy and of petsctpu's
(their sums' orders differ); the hier CG's iterations and reason equal
to petsctpu's, its history within rtol 1e-10, its x bit-equal to the
port's flat World solve of the same system; collective counts an
iteration equal to petsctpu's jaxpr audit.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse as sp
import torch
from jax import shard_map
from jax.sharding import Mesh, PartitionSpec as PS

from petsctpu.models import laplacian_2d
from petsctpu.parallel.hier import sharded_aij_hier_from_scipy as r_hier

from petsctpu_torch.parallel import World, par_ksp_solve, \
    sharded_aij_from_scipy, unshard_vector
from petsctpu_torch.parallel.hier import sharded_aij_hier_from_scipy

torch.set_num_threads(1)

H, C = 2, 4
AXES = ("dcn", "ici")
_WORLDS = {}


@pytest.fixture(autouse=True, scope="module")
def _close_worlds():
    yield
    for w in _WORLDS.values():
        w.close()
    _WORLDS.clear()


def world(mesh_shape=(H, C)) -> World:
    """One World a mesh shape per test process (None: flat, of H·C)."""
    key = mesh_shape or H * C
    if key not in _WORLDS or _WORLDS[key].closed:
        P = H * C if mesh_shape is None else mesh_shape[0] * mesh_shape[1]
        _WORLDS[key] = World(P, "cpu", timeout=60.0, mesh=mesh_shape)
    return _WORLDS[key]


def ref_mesh() -> Mesh:
    return Mesh(np.array(jax.devices()[:H * C]).reshape(H, C), AXES)


def random_spd(n, seed=0):
    """tests/test_hier.py's matrix: irregular, so ghosts cross rows and
    columns of the mesh."""
    rng = np.random.default_rng(seed)
    A = sp.random(n, n, density=0.08, random_state=rng, format="csr")
    return sp.csr_matrix(A + A.T + sp.diags(np.full(n, 4.0)))


def nonsym(n=80):
    A = random_spd(n, seed=3)
    return sp.csr_matrix(A + sp.triu(sp.random(
        n, n, density=0.03, random_state=np.random.default_rng(5),
        format="csr")))


def ref_apply(R, xp, method):
    f = jax.jit(shard_map(lambda A, v: getattr(A.local(), method)(v),
                          mesh=ref_mesh(), in_specs=(PS(AXES), PS(AXES)),
                          out_specs=PS(AXES), check_vma=False))
    return np.asarray(f(R, jnp.asarray(xp)))


def port_apply(T, xp, method):
    s = T.nloc
    w = world()
    out = w.run(lambda c, v: getattr(T.rank(c), method)(v),
                [(torch.from_numpy(xp[p * s:(p + 1) * s].copy()),)
                 for p in range(w.size)])
    return torch.cat(out).numpy()


def test_plan_arrays_byte_equal_and_rail_aligned():
    """The two-phase plan and the ELL packs of petsctpu's, and phase 2's
    [H, s2max] buffers: one (possibly empty) message a remote row."""
    from petsctpu.parallel.hier import build_hier_halo as r_build

    from petsctpu_torch.parallel.hier import build_hier_halo

    for A in (random_spd(64, seed=7), random_spd(96), nonsym()):
        R, rpart = r_hier(A, H, C, dtype=np.float64)
        T, part = sharded_aij_hier_from_scipy(A, H, C, dtype=np.float64,
                                              device="cpu")
        pr = r_build(rpart.layout, rpart.garrays, H, C)
        pt = build_hier_halo(part.layout, part.garrays, H, C)
        for f in ("send1_idx", "send2_src", "ghost_src", "n_ghost"):
            a, b = getattr(pt, f), getattr(pr, f)
            assert a.dtype == b.dtype, f
            np.testing.assert_array_equal(a, b, err_msg=f)
        assert (pt.s1max, pt.s2max, pt.gmax) == (pr.s1max, pr.s2max, pr.gmax)
        for f in ("diag_cols", "diag_vals", "off_cols", "off_vals",
                  "send1_idx", "send2_src", "ghost_src"):
            np.testing.assert_array_equal(
                np.stack([t.numpy() for t in getattr(T, f)]),
                np.asarray(getattr(R, f)), err_msg=f)
        assert T.shape == R.shape and T.nnz == R.nnz
        assert T.nshards == R.nshards == H * C
        assert T.send2_src[0].shape[0] == H and T.send1_idx[0].shape[0] == C


@pytest.mark.parametrize("method", ("mult", "multT"))
def test_mult_and_transpose_match_scipy_and_reference(method):
    """tests/test_hier.py's products: A x on its random SPD matrix, Aᵀ x
    on the nonsymmetric one."""
    A = random_spd(96) if method == "mult" else nonsym()
    R, rpart = r_hier(A, H, C, dtype=np.float64)
    T, part = sharded_aij_hier_from_scipy(A, H, C, dtype=np.float64,
                                          device="cpu")
    x = np.random.default_rng(1).standard_normal(A.shape[0])
    xp = part.layout.pad_vector(x)
    n = A.shape[0]
    yt = port_apply(T, xp, method)
    exact = A @ x if method == "mult" else A.T @ x
    np.testing.assert_allclose(yt[:n], exact, rtol=1e-12, atol=1e-12)
    np.testing.assert_allclose(yt, ref_apply(R, xp, method), rtol=1e-12,
                               atol=1e-12)
    np.testing.assert_array_equal(yt[n:], 0.0)


def test_par_cg_on_hier_mesh_matches_reference_and_flat_world():
    """tests/test_hier.py::test_par_cg_solve_on_hier_mesh: CG over both
    axes (the psums over both are the flat Comm's, in global rank order)
    to petsctpu's its, reason and history; x bit-equal to the port's
    flat World solve (the same ghost values by the other route); the
    collectives an iteration equal to petsctpu's jaxpr audit (all_to_all
    2, psum 2)."""
    from petsctpu.core.commaudit import audit_collectives
    from petsctpu.ksp.api import KSP_REGISTRY as R_KSP
    from petsctpu.ksp.common import KSPConfig as RKSPConfig
    from petsctpu.ksp.common import SolveResult as RSolveResult
    from petsctpu.parallel.api import par_ksp_solve as r_par_ksp_solve

    from petsctpu_torch.parallel.api import audit_par_ksp

    A = laplacian_2d(12, 12)
    b = A @ np.ones(144)
    R, _ = r_hier(A, H, C, dtype=np.float64)
    T, part = sharded_aij_hier_from_scipy(A, H, C, dtype=np.float64,
                                          device="cpu")
    rr = r_par_ksp_solve(ref_mesh(), R, b, ksp_type="cg", rtol=1e-10,
                         maxits=300)
    rt = par_ksp_solve(world(), T, b, ksp_type="cg", rtol=1e-10,
                       maxits=300)
    assert int(rt.its) == int(rr.its) and int(rt.reason) == int(rr.reason)
    assert int(rt.reason) > 0
    k = int(rt.its) + 1
    ref = np.asarray(rr.history[:k])
    np.testing.assert_allclose(rt.history[:k].numpy(), ref, rtol=1e-10,
                               atol=1e-12 * ref[0])
    np.testing.assert_allclose(unshard_vector(rt.x, part.layout), 1.0,
                               atol=1e-8)
    F, _ = sharded_aij_from_scipy(A, H * C, dtype=np.float64,
                                  style="alltoall", device="cpu")
    rf = par_ksp_solve(world(None), F, b, ksp_type="cg", rtol=1e-10,
                       maxits=300)
    np.testing.assert_array_equal(rt.x.numpy(), rf.x.numpy())

    cfg = RKSPConfig(ksp_type="cg", maxits=5, rtol=0.0, atol=0.0)
    run = shard_map(lambda A_, b_, x_: R_KSP["cg"](A_.local(), b_, x_, None,
                                                   cfg, AXES),
                    mesh=ref_mesh(), in_specs=(PS(AXES),) * 3,
                    out_specs=RSolveResult(PS(AXES), PS(), PS(), PS(), PS()),
                    check_vma=False)
    bp = jnp.asarray(part.layout.pad_vector(b))
    ra = audit_collectives(run, R, bp, jnp.zeros_like(bp)).per_iteration
    ta = audit_par_ksp(world(), T, b, ksp_type="cg").per_iteration
    assert ta.counts == ra.counts == {"all_to_all": 2, "psum": 2}
    assert ta.bytes == ra.bytes


def test_two_axis_world_axes():
    """Each rank's row (ici) and column (dcn) Comms: sizes and ranks of
    p = h·C + c, their collectives counted in the rank's flat Comm, and
    a psum over both axes with the flat Comm's bits."""
    w = world()

    def body(comm):
        ici, dcn = comm.sub("ici"), comm.sub("dcn")
        assert comm.sub(AXES) is comm and comm.sub("rows") is comm
        row = ici.all_gather(torch.tensor([float(comm.rank)]))
        col = dcn.all_gather(torch.tensor([float(comm.rank)]))
        x = torch.tensor([0.1 * (comm.rank + 1), 1e-17 * comm.rank],
                         dtype=torch.float64)
        return (ici.size, ici.rank, dcn.size, dcn.rank, row.tolist(),
                col.tolist(), comm.psum(x).tolist(),
                dict(comm.counts))

    w.reset_counts()
    out = w.run(body)
    for p, (isz, irk, dsz, drk, row, col, s, counts) in enumerate(out):
        h, c = divmod(p, C)
        assert (isz, irk, dsz, drk) == (C, c, H, h)
        assert row == [float(h * C + k) for k in range(C)]
        assert col == [float(k * C + c) for k in range(H)]
        assert s == out[0][6]
        assert counts["all_gather"][0] == 2 and counts["psum"][0] == 1
    total = np.zeros(2)
    for p in range(H * C):
        total = total + np.array([0.1 * (p + 1), 1e-17 * p])
    assert out[0][6] == total.tolist()
