"""The port's periphery against petsctpu's, on the CPU: VecNest, PF, the
VTK sink, the debug checks, AMS, hostmem, Random and the package
re-exports.

* VecNest: blockwise arithmetic bit for bit, the reductions (dot
  conjugates its first argument, blocks summed in order) within 1e-14.
* PF: every type, string expressions over the 19 names (with Python
  numbers where jnp takes them) within 1e-14 (XLA's and PyTorch's
  transcendentals may round one ulp apart); an unknown name raises
  ValueError in both.
* VTK: the files both packages write for the same fields are equal byte
  for byte (the port's fields given as tensors).
* Debug: checked raises PetscTPUError on a NaN, an out-of-range gather
  (before it runs) and an integer division by zero where petsctpu's
  raises; validate_operator/validate_system pass every format of the
  port's factory and catch what petsctpu's catches.
* AMS: the snooper's JSON snapshot equals petsctpu's (localhost).
* Random: petsctpu's interval and determinism checks (tests/test_misc.py);
  jax.random's bits are not reproduced.
* Re-exports: every public name of petsctpu's top level, mat, pc, core,
  vec and io is in the port's (ops: the Pallas names only are not).
"""

import importlib
import json
import types
import urllib.request

import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse as sp
import torch

from petsctpu.core.debug import checked as r_checked
from petsctpu.core.errors import PetscTPUError as RError
from petsctpu.io import vtk as rvtk
from petsctpu.vec import nest as rnest
from petsctpu.vec import pf as rpf
from petsctpu_torch.core.debug import (checked, fp_trap, validate_operator,
                                       validate_system)
from petsctpu_torch.core.errors import PetscTPUError
from petsctpu_torch.io import vtk as tvtk
from petsctpu_torch.vec import nest as tnest
from petsctpu_torch.vec import pf as tpf

torch.set_num_threads(1)


def _t(a):
    return torch.from_numpy(np.array(a))


# ---------------------------------------------------------------- VecNest
BLOCKS_V = ([1.0, 2.0, -0.5], [3.0], [0.25, -4.0])
BLOCKS_W = ([0.5, 0.5, 2.0], [2.0], [-1.0, 0.125])


def _nests(mod, conv, blocks_v=BLOCKS_V, blocks_w=BLOCKS_W):
    return (mod.VecNest(tuple(conv(b) for b in blocks_v)),
            mod.VecNest(tuple(conv(b) for b in blocks_w)))


NEST_OPS = {
    "add": lambda v, w: (v + w).flatten(),
    "sub": lambda v, w: (v - w).flatten(),
    "scale": lambda v, w: (2.5 * v).flatten(),
    "rscale": lambda v, w: (v * -1.5).flatten(),
    "axpy": lambda v, w: v.axpy(0.75, w).flatten(),
    "dot": lambda v, w: v.dot(w),
    "norm": lambda v, w: v.norm(),
    "norm_inf": lambda v, w: v.norm_inf(),
    "with_sub": lambda v, w: v.with_sub(1, w.sub(1)).flatten(),
    "zeros_like": lambda v, w: type(v).zeros_like(v).flatten(),
    "from_flat": lambda v, w: type(v).from_flat(w.flatten(),
                                                [3, 1, 2]).sub(2),
}


@pytest.mark.parametrize("op", sorted(NEST_OPS))
def test_vecnest_equals_reference(op):
    t = NEST_OPS[op](*_nests(tnest, _t))
    r = np.asarray(NEST_OPS[op](*_nests(rnest, jnp.asarray)))
    np.testing.assert_allclose(np.asarray(t), r, rtol=1e-14, atol=0)
    v, _ = _nests(tnest, _t)
    assert (v.nb, v.n) == (3, 6)


def test_vecnest_complex_dot_conjugates_first():
    rng = np.random.default_rng(0)
    bv = [rng.standard_normal(3) + 1j * rng.standard_normal(3),
          rng.standard_normal(2) + 1j * rng.standard_normal(2)]
    bw = [rng.standard_normal(3) + 1j * rng.standard_normal(3),
          rng.standard_normal(2) + 1j * rng.standard_normal(2)]
    t = _nests(tnest, _t, bv, bw)
    r = _nests(rnest, jnp.asarray, bv, bw)
    np.testing.assert_allclose(complex(t[0].dot(t[1])),
                               complex(r[0].dot(r[1])), rtol=1e-14)
    np.testing.assert_allclose(float(t[0].norm()), float(r[0].norm()),
                               rtol=1e-14)


# --------------------------------------------------------------------- PF
X = np.array([-2.0, -0.3, 0.0, 0.4, 1.7, 3.0])
PF_CASES = {
    "identity": dict(pf_type="identity"),
    "constant": dict(pf_type="constant", value=7.0),
    "quick": dict(pf_type="quick", fn=lambda v: v * v),
    "sin_exp_abs": dict(pf_type="string", expr="sin(x) + exp(-abs(x))"),
    "minimum": dict(pf_type="string", expr="minimum(x, 0.5)"),
    "maximum_left": dict(pf_type="string", expr="maximum(0.25, x) * pi"),
    "where": dict(pf_type="string", expr="where(x > 0, x, 0.0) + e"),
    "trig": dict(pf_type="string",
                 expr="tan(x / 4) + arctan(x) + cos(x) + sign(x)"),
    "hyper": dict(pf_type="string", expr="tanh(x) + sinh(x) - cosh(x)"),
    "inverse_trig": dict(pf_type="string",
                         expr="arcsin(x / 4) + arccos(x / 4)"),
    "log_sqrt": dict(pf_type="string", expr="log(1 + abs(x)) + sqrt(abs(x))"),
}


@pytest.mark.parametrize("case", sorted(PF_CASES))
def test_pf_equals_reference(case):
    kw = PF_CASES[case]
    t = tpf.make_pf(**kw)(_t(X)).numpy()
    r = np.asarray(rpf.make_pf(**kw)(jnp.asarray(X)))
    assert t.shape == r.shape and t.dtype == r.dtype
    np.testing.assert_allclose(t, r, rtol=1e-14, atol=1e-15)


@pytest.mark.parametrize("expr", ("__import__('os')", "open('f')",
                                  "x.numpy()", "foo(x)"))
def test_pf_string_unknown_names_raise(expr):
    for mod in (tpf, rpf):
        with pytest.raises(ValueError):
            mod.make_pf("string", expr=expr)
    with pytest.raises(ValueError):
        tpf.make_pf("nonesuch")


def test_pf_register():
    tpf.register_pf("double", lambda: tpf.PF(lambda v: 2 * v, "double"))
    try:
        np.testing.assert_array_equal(
            tpf.make_pf("double")(_t([1.0, 2.0])).numpy(), [2.0, 4.0])
        assert "double" in tpf.PF_REGISTRY
    finally:
        tpf.PF_REGISTRY.pop("double", None)


# -------------------------------------------------------------------- VTK
@pytest.mark.parametrize("grid,dof", (((7,), 1), ((3, 4), 1), ((3, 4), 2),
                                      ((2, 3, 4), 3)))
def test_vtk_structured_files_equal(tmp_path, grid, dof):
    rng = np.random.default_rng(len(grid) + dof)
    u = rng.standard_normal(grid + ((dof,) if dof > 1 else ()))
    s = np.arange(np.prod(grid), dtype=np.float64).reshape(grid) / 7.0
    kw = dict(spacing=(0.5, 0.25, 2.0)[:len(grid)]) if len(grid) > 1 else {}
    pt, pr = tmp_path / "t.vtk", tmp_path / "r.vtk"
    tvtk.vtk_write_structured(str(pt), {"u": _t(u), "s": _t(s)}, grid, **kw)
    rvtk.vtk_write_structured(str(pr), {"u": u, "s": jnp.asarray(s)}, grid,
                              **kw)
    assert pt.read_bytes() == pr.read_bytes()


@pytest.mark.parametrize("kind", ("Plex", "PlexQuad", "Plex3D"))
def test_vtk_plex_files_equal(tmp_path, kind):
    from petsctpu.dm import plex as rplex
    from petsctpu_torch.dm import plex as tplex

    dims = (3, 2, 2) if kind == "Plex3D" else (3, 3)
    pt_, pr_ = (getattr(m, kind).create_box_mesh(*dims)
                for m in (tplex, rplex))
    u = np.linspace(0, 1, pr_.num_vertices)
    g = np.random.default_rng(2).standard_normal((pr_.num_vertices, 2))
    c = np.arange(pr_.num_cells, dtype=np.float64)
    pt, pr = tmp_path / "t.vtk", tmp_path / "r.vtk"
    tvtk.vtk_write_plex(str(pt), pt_, point_data={"u": _t(u), "g": _t(g)},
                        cell_data={"rank": _t(c)})
    rvtk.vtk_write_plex(str(pr), pr_, point_data={"u": u, "g": g},
                        cell_data={"rank": c})
    assert pt.read_bytes() == pr.read_bytes()


# ------------------------------------------------------------------ debug
DEBUG_CASES = {
    "nan": (lambda x: torch.log(x), lambda x: jnp.log(x), [-1.0], None),
    "oob_gather": (lambda x, i: x[i], lambda x, i: x[i], np.arange(4.0), 10),
    "oob_take": (lambda x, i: torch.take(x, i),
                 lambda x, i: jnp.take(x, i, mode="fill"),
                 np.arange(4.0), [1, 7]),
    "clean": (lambda x: 2.0 * x, lambda x: 2.0 * x, [1.0, 2.0], None),
    "clean_gather": (lambda x, i: x[i], lambda x, i: x[i], np.arange(4.0),
                     [3, 0, -1]),
}


@pytest.mark.parametrize("case", sorted(DEBUG_CASES))
def test_checked_raises_where_reference_raises(case):
    tf, rf, x, i = DEBUG_CASES[case]
    targs = (_t(x),) + (() if i is None else (torch.tensor(i),))
    rargs = (jnp.asarray(x),) + (() if i is None else (jnp.asarray(i),))
    try:
        r = np.asarray(r_checked(rf)(*rargs))
    except RError:
        r = None
    if r is None:
        with pytest.raises(PetscTPUError):
            checked(tf)(*targs)
    else:
        np.testing.assert_array_equal(checked(tf)(*targs).numpy(), r)


def test_checked_stops_the_gather_before_it_runs():
    """The out-of-range index is refused before the op: nothing of the
    gather's output is made (on the card, no launch, no device assert)."""
    seen = []

    def f(x, i):
        seen.append(1)
        y = x.index_select(0, i)
        seen.append(2)
        return y

    with pytest.raises(PetscTPUError, match="index out of range"):
        checked(f)(torch.arange(4.0), torch.tensor([0, 4]))
    assert seen == [1]
    with pytest.raises(PetscTPUError, match="division by zero"):
        checked(lambda a, b: a // b)(torch.tensor([3]), torch.tensor([0]))


def test_fp_trap_on_and_off():
    fp_trap(True)
    try:
        with pytest.raises(PetscTPUError):
            torch.sqrt(torch.tensor([-1.0]))
    finally:
        fp_trap(False)
    assert bool(torch.isnan(torch.sqrt(torch.tensor([-1.0]))).all())


def _formats():
    """An operator of every format of the port, small, on the CPU."""
    from petsctpu_torch.core.options import Options
    from petsctpu_torch.mat import aij_from_scipy
    from petsctpu_torch.mat.bsr import baij_from_scipy_bsr
    from petsctpu_torch.mat.factory import mat_from_options
    from petsctpu_torch.mat.maij import MAIJ
    from petsctpu_torch.mat.nest import make_nest
    from petsctpu_torch.mat.rectband import rectband_from_scipy
    from petsctpu_torch.mat.sell import sell_from_scipy
    from petsctpu_torch.mat.stencil import stencil_from_scipy
    from petsctpu_torch.models import ex2_system, ex45_system
    from petsctpu_torch.models.ddpoisson import matis_poisson_2d
    from petsctpu_torch.models.elasticity import ex55_system

    A2 = sp.csr_matrix(ex2_system(6, 6)[0])
    A55 = ex55_system(31, 1e-3)[0]
    ops = {k: mat_from_options(A2, Options({"mat_type": k}),
                               device="cpu")[0]
           for k in ("aij", "band", "dia", "dense")}
    for k in ("baij", "sbaij"):
        ops[k] = mat_from_options(A55, Options(
            {"mat_type": k, "mat_block_size": "2"}), device="cpu")[0]
    ops["sellbaij"] = baij_from_scipy_bsr(A55, bs=2, dtype=np.float32,
                                          fmt="sell", device="cpu")
    ops["sell"] = sell_from_scipy(sp.csr_matrix(ex45_system(16, 16, 16)[0]).astype(
        np.float32), device="cpu")
    ops["stencil"] = stencil_from_scipy(A2, (6, 6), device="cpu")
    a = aij_from_scipy(A2, device="cpu")
    ops["nest"] = make_nest([[a, None], [None, a]])
    ops["maij"] = MAIJ(a, 2)
    ops["is"] = matis_poisson_2d(8, 2, device="cpu")
    ops["rectband"] = rectband_from_scipy(sp.diags(
        [np.ones(36), -np.ones(35)], [0, 1], shape=(36, 36)).tocsr(),
        device="cpu")
    return ops


def test_validate_system_every_format():
    """validate_system passes an operator of every format of the port."""
    ops = _formats()
    for name, M in ops.items():
        validate_system(M, torch.ones(M.shape[0], dtype=torch.float64))
    assert len(ops) == 13 and all(M is not None for M in ops.values())


def test_validate_catches_what_reference_catches():
    from petsctpu.core.debug import validate_operator as r_validate
    from petsctpu.mat import aij_from_scipy as r_aij
    from petsctpu.mat.ell import AIJ as RAIJ
    from petsctpu_torch.mat import aij_from_scipy
    from petsctpu_torch.mat.ell import AIJ
    from petsctpu_torch.models import ex2_system

    A, b, _ = ex2_system(5, 5)
    T, R = aij_from_scipy(A, device="cpu"), r_aij(A)
    vals = T.vals.clone()
    vals[0, 0] = float("nan")
    with pytest.raises(PetscTPUError):
        validate_operator(AIJ(T.cols, vals, T.shape, T.nnz))
    with pytest.raises(RError):
        r_validate(RAIJ(R.cols, R.vals.at[0, 0].set(jnp.nan), R.shape,
                        R.nnz))
    cols = T.cols.clone()
    cols[3, 0] = 25
    with pytest.raises(PetscTPUError, match="out of range"):
        validate_operator(AIJ(cols, T.vals, T.shape, T.nnz))
    with pytest.raises(PetscTPUError):
        validate_system(T, torch.ones(7, dtype=torch.float64))
    with pytest.raises(PetscTPUError):
        validate_system(T, torch.full((25,), float("inf")))
    ops = _formats()
    S = ops["sbaij"]
    bad = S.bcols.clone()
    bad[0, 0] = S.shape[1]
    with pytest.raises(PetscTPUError):
        validate_operator(type(S)(bad, S.bvals, S.shape, S.bs, S.nnzb))
    Mis = ops["is"]
    validate_operator(Mis)


# -------------------------------------------------------------------- AMS
def test_ams_snapshot_equals_reference():
    """Both snoopers serve the same JSON for the same publishables, and
    a log text (each package's log_view)."""
    from petsctpu.core import ams as rams
    from petsctpu_torch.core import ams as tams

    state = {"its": 0}
    snaps = []
    for mod in (tams, rams):
        mod.publish("static", 42)
        mod.publish("solver", lambda: dict(state))
        mod.publish("broken", lambda: 1 / 0)
        url = mod.start()
        try:
            assert mod.start() == url
            state["its"] = 7
            snaps.append(json.loads(urllib.request.urlopen(
                url, timeout=5).read()))
            log = urllib.request.urlopen(url + "/log", timeout=5).read()
            assert isinstance(log, bytes)
        finally:
            mod.stop()
            for name in ("static", "solver", "broken"):
                mod.unpublish(name)
    assert snaps[0] == snaps[1]
    assert snaps[0]["static"] == 42 and snaps[0]["solver"]["its"] == 7


# ----------------------------------------------------------------- hostmem
def test_hostmem_applied_at_import():
    from petsctpu.core import hostmem as rh
    from petsctpu_torch.core import hostmem as th

    assert th._done and th.tune_host_allocator() is True
    assert th.tune_host_allocator() == rh.tune_host_allocator()
    th.prefault(1 << 20)


# ------------------------------------------------------------------ Random
def test_random_interval_and_determinism():
    """tests/test_misc.py's checks of petsctpu's Random, on the port's."""
    from petsctpu.core.random import Random as RRandom
    from petsctpu_torch.core.random import Random

    for R, dev in ((Random, "cpu"), (RRandom, None)):
        kw = {} if dev is None else {"device": dev}
        r1 = R(seed=42, lo=-2.0, hi=3.0, **kw)
        v = np.asarray(r1.get_values((1000,)))
        assert v.min() >= -2.0 and v.max() <= 3.0 and v.dtype == np.float64
        r2 = R(seed=42, lo=-2.0, hi=3.0, **kw)
        np.testing.assert_array_equal(v, np.asarray(r2.get_values((1000,))))
        assert not np.array_equal(v, np.asarray(r1.get_values((1000,))))
        assert np.asarray(r1.get_value()).shape == ()
        assert np.asarray(r1.get_normal((5, 2))).shape == (5, 2)
    r = Random(seed=1, device="cpu").set_interval(5.0, 6.0)
    w = r.get_values((100,), dtype=torch.float32)
    assert w.dtype == torch.float32 and float(w.min()) >= 5.0


# -------------------------------------------------------------- re-exports
@pytest.mark.parametrize("sub", ("", ".mat", ".pc", ".core", ".vec", ".io",
                                 ".ops"))
def test_reexports_cover_reference(sub):
    r = importlib.import_module("petsctpu" + sub)
    t = importlib.import_module("petsctpu_torch" + sub)
    # submodules are attributes only once something imported them: the
    # names compared are those the package itself binds
    missing = {n for n in dir(r) if not n.startswith("_") and not
               isinstance(getattr(r, n), types.ModuleType)} - set(dir(t))
    # the Pallas names: the port's kernels are its own
    allowed = {"pallas_available", "stencil5_mult_pallas"}
    assert missing <= (allowed if sub == ".ops" else set()), missing
    for name in getattr(r, "__all__", ()):
        if name not in allowed:
            assert name in getattr(t, "__all__", ()) or sub == "", name
