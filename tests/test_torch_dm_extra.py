"""The port's DMComposite, DMShell, DMRedundant, DMSliced, AO, PetscDT
quadratures and LocalToGlobalMapping against
petsctpu's, on the CPU (tests/test_dm_extra.py, tests/test_dm_shell.py
and tests/test_io.py::TestIS::test_l2g on the port): equal arrays from the same
inputs; the quadratures are the same numpy calls, so bit for bit."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from petsctpu import dm as jdm
from petsctpu.dm import shell as jshell
from petsctpu.vec import indexset as jis
from petsctpu_torch import dm
from petsctpu_torch.dm import shell
from petsctpu_torch.mat.dense import Dense
from petsctpu_torch.vec import indexset as tis

# one intra-op thread: the suite runs in parallel workers (pytest -n), and
# PyTorch's default of a thread a core oversubscribes the host's cores
torch.set_num_threads(1)

CPU = "cpu"


def _same(a, b):
    a, b = np.asarray(a), np.asarray(b)
    assert a.dtype == b.dtype and a.shape == b.shape
    assert a.tobytes() == b.tobytes()


# ---------------------------------------------------------------- composite ---
def test_composite_pack_split_roundtrip():
    comp = dm.DMComposite.create(dm.DA((4, 4)), 5, dm.DA((3,)))
    ref = jdm.DMComposite.create(jdm.DA((4, 4)), 5, jdm.DA((3,)))
    assert comp.n == ref.n == 24 and comp.offsets() == ref.offsets()
    parts = [np.arange(16.0), np.arange(5.0) + 100, np.arange(3.0) + 200]
    x = comp.pack(*map(torch.from_numpy, parts))
    _same(x.numpy(), np.asarray(ref.pack(*map(jnp.asarray, parts))))
    for got, want in zip(comp.split(x), parts):
        _same(got.numpy(), want)
    v = comp.create_global_vector(device=CPU)
    assert v.shape == (24,) and v.dtype == torch.float64 and not v.any()
    with pytest.raises(ValueError, match="parts"):
        comp.pack(x)


def test_composite_global_iss_and_grids():
    comp, ref = dm.DMComposite.create(6, 4), jdm.DMComposite.create(6, 4)
    for got, want in zip(comp.global_iss(), ref.global_iss()):
        _same(got.indices, want.indices)
    g, s = dm.DMComposite.create(dm.DA((3, 5)), 2).split_grids(
        torch.arange(17.0))
    assert g.shape == (3, 5) and s.shape == (2,)
    np.testing.assert_array_equal(g.numpy(), np.arange(15.0).reshape(3, 5))


# ------------------------------------------------------------------ shells ---
def test_dmshell_callbacks_and_defaults():
    sh = shell.DMShell(4, create_vec=lambda dt, dev: torch.ones(
        4, dtype=dt, device=dev),
        global_to_local=lambda x: torch.nn.functional.pad(x, (1, 1)),
        local_to_global=lambda xl: xl[1:-1],
        create_mat=lambda dt, dev: Dense(torch.eye(4, dtype=dt, device=dev)))
    v = sh.create_global_vector(device=CPU)
    assert v.shape == (4,) and float(v[0]) == 1.0
    xl = sh.to_local(v)
    assert xl.shape == (6,)
    _same(sh.to_global(xl).numpy(), v.numpy())
    assert sh.create_matrix(torch.float32, device=CPU).shape == (4, 4)
    d = shell.DMShell(3)
    assert d.create_global_vector(device=CPU).shape == (3,)
    x = torch.arange(3.0)
    assert d.to_local(x) is x and d.to_global(x) is x
    with pytest.raises(ValueError, match="create_mat"):
        d.create_matrix(device=CPU)


def test_dmredundant_vec_and_mat():
    r = shell.DMRedundant(5)
    assert r.create_global_vector(device=CPU).shape == (5,)
    M = r.create_matrix(device=CPU)
    ref = jshell.DMRedundant(5).create_matrix()
    assert M.shape == ref.shape == (5, 5) and M.device.type == "cpu"


@pytest.mark.parametrize("owned,ghosts", [([2, 3, 4], [1, 5]), ([0, 9], []),
                                          ([7, 1, 4], [0, 2, 8])])
def test_dmsliced_gather_scatter_match(owned, ghosts):
    kw = dict(owned=np.array(owned), ghosts=np.array(ghosts, np.int64))
    sl, ref = shell.DMSliced(10, **kw), jshell.DMSliced(10, **kw)
    assert sl.n_local == ref.n_local
    x = np.arange(10.0) * 1.5
    xl = sl.to_local(torch.from_numpy(x))
    _same(xl.numpy(), np.asarray(ref.to_local(jnp.asarray(x))))
    _same(sl.to_global(xl * 10).numpy(),
          np.asarray(ref.to_global(jnp.asarray(xl.numpy() * 10))))
    base = np.full(10, -1.0)
    y = torch.from_numpy(base.copy())
    _same(sl.to_global(xl, y).numpy(),
          np.asarray(ref.to_global(jnp.asarray(xl.numpy()),
                                   jnp.asarray(base))))
    assert (y.numpy() == base).all()                # out of place
    assert sl.create_global_vector(device=CPU).shape == (10,)


def test_dm_entry_points_need_cuda_without_device():
    if torch.cuda.is_available():
        pytest.skip("CUDA is present: the default device is valid here")
    for build in (dm.DMComposite.create(3).create_global_vector,
                  shell.DMShell(2).create_global_vector,
                  shell.DMRedundant(2).create_matrix,
                  shell.DMSliced(4, np.arange(2)).create_global_vector):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            build()


# ---------------------------------------------------------------------- AO ---
@pytest.mark.parametrize("app", [[3, 0, 2, 1], [1, 0], [2, 0, 1]])
def test_ao_basic_matches(app):
    app = np.array(app)
    ao, ref = dm.AO.create_basic(app), jdm.AO.create_basic(app)
    _same(ao.app_to_petsc_tab, ref.app_to_petsc_tab)
    _same(ao.petsc_to_app_tab, ref.petsc_to_app_tab)
    np.testing.assert_array_equal(ao.app_to_petsc(app), np.arange(len(app)))
    q = np.array([-1, *range(len(app))])
    _same(ao.app_to_petsc(q), ref.app_to_petsc(q))
    _same(ao.petsc_to_app(q), ref.petsc_to_app(q))
    v = np.arange(len(app)) * 10.0
    _same(ao.permute_app_to_petsc(v), ref.permute_app_to_petsc(v))
    _same(ao.permute_petsc_to_app(ao.permute_app_to_petsc(v)), v)


def test_ao_mapping_and_explicit_petsc():
    ao = dm.AO.create_mapping(np.array([10, 3, 7]))
    _same(ao.app_to_petsc_tab, np.array([2, 0, 1]))
    a = dm.AO.create_basic(np.array([2, 0, 1]), np.array([1, 2, 0]))
    r = jdm.AO.create_basic(np.array([2, 0, 1]), np.array([1, 2, 0]))
    _same(a.petsc_to_app_tab, r.petsc_to_app_tab)


# ------------------------------------------------------------- quadratures ---
@pytest.mark.parametrize("name,args", [
    ("gauss_quadrature", (4,)), ("gauss_quadrature", (5, 0.0, 2.0)),
    ("gauss_lobatto_quadrature", (4,)), ("gauss_lobatto_quadrature", (2,)),
    ("gauss_jacobi_quadrature", (3, 1.0, 0.0)),
    ("gauss_tensor_quadrature", (2, 3)), ("gauss_tensor_quadrature", (3, 2))])
def test_quadrature_matches_reference(name, args):
    for got, want in zip(getattr(dm, name)(*args), getattr(jdm, name)(*args)):
        _same(got, want)


def test_quadrature_exactness():
    x, w = dm.gauss_quadrature(4)
    for d in range(8):                   # n points: degree 2n-1
        np.testing.assert_allclose(np.sum(w * x ** d),
                                   (1 - (-1) ** (d + 1)) / (d + 1), atol=1e-13)
    x, w = dm.gauss_lobatto_quadrature(4)
    assert x[0] == -1.0 and x[-1] == 1.0
    for d in range(6):                   # degree 2n-3
        np.testing.assert_allclose(np.sum(w * x ** d),
                                   (1 - (-1) ** (d + 1)) / (d + 1), atol=1e-13)
    _, w = dm.gauss_jacobi_quadrature(3, 1.0, 0.0)
    np.testing.assert_allclose(np.sum(w), 2.0, atol=1e-12)
    pts, w = dm.gauss_tensor_quadrature(2, 3)
    np.testing.assert_allclose(np.sum(w * pts[:, 0] ** 2 * pts[:, 1] ** 2),
                               4.0 / 9.0, atol=1e-13)
    with pytest.raises(ValueError, match="lobatto"):
        dm.gauss_lobatto_quadrature(1)


# ------------------------------------------------------- IS and local maps ---
@pytest.mark.parametrize("l2g,queries", [
    ([10, 20, 30], [20, 99, 10, -4]),
    ([5, 3, 5, 9, 3], [3, 5, 9, 4, 0]),      # repeated globals: last wins
    ([], [1, 2]), ([7], 7)])
def test_local_to_global_mapping_matches(l2g, queries):
    m, r = tis.LocalToGlobalMapping(l2g), jis.LocalToGlobalMapping(l2g)
    assert m.size == r.size
    np.testing.assert_array_equal(m.apply_inverse(queries),
                                  r.apply_inverse(queries))
    assert m.apply_inverse(queries).dtype == np.int64
    if len(l2g):
        idx = np.arange(len(l2g))[::-1]
        _same(m.apply(idx), r.apply(idx))
