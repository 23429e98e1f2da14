"""The port's elasticity models and its GAMG elasticity routes against
petsctpu's, on the CPU.

* ex55_system and elasticity_2d: the CSR (indptr, indices, data), b and
  the coordinates equal petsctpu's byte for byte.
* ex56_system: skips while its element file (elem_3d_elast_v_25.txt, a
  data file of the reference's tutorials) is not in the repository, as
  petsctpu's tests skip.
* CG + GAMG on ksp ex55 through KSP, on the fp32 SELL operator, with
  petsctpu's backend reported as "tpu" during its setup (the port takes
  that branch's format decisions on every device): the rigid-body-mode
  route (pc_gamg_coordinates), the blocked route (pc_gamg_dof 2 alone),
  the blocked route on the non-packed branch (three levels, a sparse LU
  coarse solve) and -pc_type asa: equal its and reason, histories
  within 1e-3 relative (fp32; the reference's reductions run on
  XLA:CPU); and the fp64 AIJ RBM route within 1e-10.
* The cases of tests/test_elasticity.py on the port: the element null
  space, rigid-body modes beating plain GAMG on the cantilever, ex55's
  oracle digits, and the oracle's iteration counts of both routes.
"""

from dataclasses import replace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse.linalg as spla
import torch

from petsctpu.core.options import Options as JOptions
from petsctpu.ksp import KSP as JKSP
from petsctpu.mat import aij_from_scipy as jaij_from_scipy
from petsctpu.mat import sell as jsell
from petsctpu.models import elasticity as jel
from petsctpu_torch.core.options import Options
from petsctpu_torch.ksp import KSP, ksp_solve
from petsctpu_torch.mat import aij_from_scipy
from petsctpu_torch.mat.sell import sell_from_scipy
from petsctpu_torch.models import elasticity as tel
from petsctpu_torch.pc import make_pc
from petsctpu_torch.pc.gamg import rigid_body_modes

# one intra-op thread: the suite runs in parallel workers (pytest -n), and
# PyTorch's default of a thread a core oversubscribes the host's cores
torch.set_num_threads(1)

CPU = "cpu"
NE = 63                                   # 8192 dofs: level 0 on SELL


def _same_csr(got, ref):
    assert got.shape == ref.shape and got.dtype == ref.dtype
    for f in ("indptr", "indices", "data"):
        assert getattr(got, f).tobytes() == getattr(ref, f).tobytes(), f


@pytest.mark.parametrize("ne", [1, 4, 29, 63, 100])
@pytest.mark.parametrize("dtype", [np.float64, np.float32])
def test_ex55_system_byte_equal(ne, dtype):
    A, b, c = tel.ex55_system(ne, 1e-3, dtype=dtype)
    jA, jb, jc = jel.ex55_system(ne, 1e-3, dtype=dtype)
    _same_csr(A, jA)
    assert b.dtype == jb.dtype and b.tobytes() == jb.tobytes()
    assert c.tobytes() == jc.tobytes()


def test_ex55_other_inclusion_byte_equal():
    A, _, _ = tel.ex55_system(37, 0.5)
    jA, _, _ = jel.ex55_system(37, 0.5)
    _same_csr(A, jA)


@pytest.mark.parametrize("mx,my", [(8, 4), (24, 12)])
def test_elasticity_2d_byte_equal(mx, my):
    A, c, b = tel.elasticity_2d(mx, my)
    jA, jc, jb = jel.elasticity_2d(mx, my)
    _same_csr(A, jA)
    assert c.tobytes() == jc.tobytes() and b.tobytes() == jb.tobytes()
    np.testing.assert_array_equal(tel._q1_element_stiffness(),
                                  jel._q1_element_stiffness())


def test_elasticity_2d_spd_and_cantilever_sags():
    A, coords, b = tel.elasticity_2d(8, 4)
    assert abs(A - A.T).max() < 1e-12
    lam = spla.eigsh(A, k=1, which="SA", return_eigenvectors=False)[0]
    assert lam > 0
    x = spla.spsolve(A.tocsc(), b)
    assert x[1::2].min() < -1e-3
    B = rigid_body_modes(coords)
    np.testing.assert_allclose(B.T @ B, np.eye(3), atol=1e-12)


def test_ex56_system_byte_equal():
    if not tel.ELEM_FILE.exists():
        pytest.skip("ksp ex56's element file elem_3d_elast_v_25.txt is not "
                    "in the repository")
    A, b, c = tel.ex56_system(5, 1e-3)
    jA, jb, jc = jel.ex56_system(5, 1e-3, elem_file=str(tel.ELEM_FILE))
    _same_csr(A, jA)
    assert b.tobytes() == jb.tobytes() and c.tobytes() == jc.tobytes()


def test_ex56_missing_element_file_raises(tmp_path):
    with pytest.raises(FileNotFoundError):
        tel.ex56_system(2, elem_file=tmp_path / "absent.txt")


# ------------------------------------------------------ CG + GAMG, ex55 ----
def _interpret(pc):
    """petsctpu's non-packed MGPC with its SellMats in interpret mode
    (they were built while the backend read "tpu")."""
    def fix(op):
        return replace(op, interpret=True) if type(op).__name__ == \
            "SellMat" else op

    levels = tuple(replace(lv, A=fix(lv.A), P=fix(lv.P), R=fix(lv.R))
                   for lv in pc.levels)
    return replace(pc, levels=levels)


@pytest.fixture(scope="module")
def ex55():
    return tel.ex55_system(NE, 1e-3)


def _route_options(route, coords):
    if route == "asa":
        return {"ksp_type": "cg", "pc_type": "asa", "ksp_rtol": "1e-5"}
    o = {"ksp_type": "cg", "pc_type": "gamg", "ksp_rtol": "1e-5",
         "pc_gamg_coarse_eq_limit": "80", "pc_gamg_dof": "2"}
    if route in ("rbm", "rbm_fp64"):
        o["pc_gamg_coordinates"] = coords
    if route == "nc_nonpacked":
        o["pc_mg_levels"] = "3"
    return o


@pytest.mark.parametrize("route", ["rbm", "nc", "nc_nonpacked", "asa",
                                   "rbm_fp64"])
def test_cg_gamg_ex55_matches_reference(ex55, route):
    A, b, coords = ex55
    opts = _route_options(route, coords)
    if route == "rbm_fp64":
        M, jM, bb, rtol = (aij_from_scipy(A, device=CPU),
                           jaij_from_scipy(A), b, 1e-10)
    else:
        A32 = A.astype(np.float32)
        M, jM, bb, rtol = (sell_from_scipy(A32, device=CPU),
                           jsell.sell_from_scipy(A32), b.astype(np.float32),
                           1e-3)
    ksp = KSP(Options(opts)).set_operators(M, A_host=A)
    res = ksp.solve(torch.from_numpy(bb))
    jksp = JKSP(JOptions(opts)).set_operators(jM, A_host=A)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax, "default_backend", lambda: "tpu")
        jksp.set_from_options().setup()
    if route == "nc_nonpacked":
        jksp.pc = _interpret(jksp.pc)
    jres = jksp.solve(jnp.asarray(bb))
    its = int(res.its)
    assert its == int(jres.its) and int(res.reason) == int(jres.reason) > 0
    h, jh = res.history[:its + 1].numpy(), np.asarray(jres.history)[:its + 1]
    np.testing.assert_allclose(h, jh, rtol=rtol)
    x = res.x.double().numpy()
    assert x.shape == (A.shape[0],) and np.isfinite(x).all()
    pc = ksp.pc
    if route == "nc_nonpacked":
        assert len(pc.levels) == 2 and pc.coarse_A.shape[0] > 192
    if route in ("rbm", "nc"):
        assert pc.formats[0][0] == ("sell", 16, "diag")
    if route == "rbm":
        assert its <= 11                 # PETSc's oracle count (ex55 SA)


def test_gamg_routes_need_no_coordinates_for_blocked_operators(ex55):
    """pc_gamg_dof 2 alone builds translational candidates: the
    prolongators of level 0 have two columns an aggregate."""
    A, _, _ = ex55
    opts = Options({"pc_gamg_coarse_eq_limit": "80", "pc_gamg_dof": "2"})
    pc = make_pc("gamg", A=aij_from_scipy(A, device=CPU), A_host=A,
                 options=opts)
    nc = pc.levels[0].P.shape[1]
    assert nc % 2 == 0 and nc < A.shape[0] // 4


# ---------------------------------- tests/test_elasticity.py, on the port ----
def test_rigid_body_modes_are_the_element_null_space():
    Ke = tel._q1_element_stiffness()
    xy = np.array([[0, 0], [1, 0], [1, 1], [0, 1]], float)
    rb = np.zeros((8, 3))
    rb[0::2, 0] = 1
    rb[1::2, 1] = 1
    rb[0::2, 2] = -xy[:, 1]
    rb[1::2, 2] = xy[:, 0]
    assert np.abs(Ke @ rb).max() < 1e-12
    _, coords, _ = tel.elasticity_2d(3, 3)
    B = rigid_body_modes(coords)
    np.testing.assert_allclose(B.T @ B, np.eye(3), atol=1e-12)


def test_gamg_coordinates_beat_plain_gamg():
    A, coords, b = tel.elasticity_2d(24, 12)
    Ad = aij_from_scipy(A, device=CPU)
    bt = torch.from_numpy(b)
    its = []
    for opts in ({}, {"pc_gamg_coordinates": coords}):
        pc = make_pc("gamg", A=Ad, A_host=A, options=Options(opts))
        r = ksp_solve(Ad, bt, pc=pc, ksp_type="cg", rtol=1e-8, maxits=400)
        assert int(r.reason) > 0
        its.append(int(r.its))
    assert its[1] < its[0]                  # rigid modes help
    np.testing.assert_allclose(A @ r.x.numpy(), b, atol=1e-7)


def test_ex55_model_digits_against_the_oracle():
    """ksp ex55 at ne = 29: CG + Jacobi's first residuals, the digits
    tests/test_elasticity.py pins."""
    A, b, _ = tel.ex55_system(29, 1e-3)
    Ad = aij_from_scipy(A, device=CPU)
    r = ksp_solve(Ad, torch.from_numpy(b), pc=make_pc("jacobi", A=Ad),
                  ksp_type="cg", rtol=1e-30, maxits=3)
    np.testing.assert_allclose(r.history[:4].numpy(),
                               [6.59495, 10.9339, 8.90538, 6.6421],
                               rtol=2e-5)


@pytest.mark.parametrize("route,oracle_its", [("nc", 15), ("rbm", 11)])
def test_ex55_gamg_routes_within_the_oracle_counts(route, oracle_its):
    """runex55_NC and runex55_SA (PETSc: 15 and 11 its) at ne = 29."""
    A, b, coords = tel.ex55_system(29, 1e-3)
    Ad = aij_from_scipy(A, device=CPU)
    o = {"pc_gamg_coarse_eq_limit": 80, "pc_gamg_dof": 2}
    if route == "rbm":
        o["pc_gamg_coordinates"] = coords
    pc = make_pc("gamg", A=Ad, A_host=A, options=Options(o))
    r = ksp_solve(Ad, torch.from_numpy(b), pc=pc, ksp_type="cg", rtol=1e-5,
                  atol=1e-50, maxits=100)
    assert int(r.reason) > 0 and int(r.its) <= oracle_its, int(r.its)


def test_ex56_gamg_rbm_3d():
    """runex56 (ne = 19, 6 rigid-body modes; PETSc: 13 its)."""
    if not tel.ELEM_FILE.exists():
        pytest.skip("ksp ex56's element file elem_3d_elast_v_25.txt is not "
                    "in the repository")
    A, b, coords = tel.ex56_system(19, 1e-3)
    Ad = aij_from_scipy(A, device=CPU)
    pc = make_pc("gamg", A=Ad, A_host=A, options=Options(
        {"pc_gamg_coarse_eq_limit": 80, "pc_gamg_dof": 3,
         "pc_gamg_coordinates": coords}))
    r = ksp_solve(Ad, torch.from_numpy(b), pc=pc, ksp_type="cg", rtol=1e-5,
                  atol=1e-50, maxits=100)
    assert int(r.reason) > 0 and int(r.its) <= 13, int(r.its)
