"""The port's I/O (petsctpu_torch/io) against petsctpu's (tests/test_io.py).

The cases of tests/test_io.py on the port's functions; files written by
either package read by the other, byte for byte (indptr, indices and
values compared as bytes); every tests/data/*.bin read to the same
arrays through both readers; the blocked readers' padding and packs.
Exact equality throughout (tolerance 0): the readers and writers move
bits, they compute nothing.
"""

import glob
import os

import numpy as np
import pytest
import scipy.sparse as sp
import torch

from petsctpu.io import viewer as rv

from petsctpu_torch.io import viewer as tv
from petsctpu_torch.io import (load_any_matrix, load_mat, load_system,
                               load_vec, petsc_binary_read_mat,
                               petsc_binary_read_vec, petsc_binary_write_mat,
                               petsc_binary_write_vec, save_mat, save_system,
                               save_vec)
from petsctpu_torch.models import laplacian_2d

# one intra-op thread: the suite runs in parallel workers (pytest -n), and
# PyTorch's default of a thread a core oversubscribes the host's cores
torch.set_num_threads(1)

DATA = os.path.join(os.path.dirname(__file__), "data")
BINS = sorted(os.path.basename(p) for p in glob.glob(os.path.join(DATA,
                                                                  "*.bin")))


def same_csr(A, B):
    """Byte equality of two scipy CSR matrices' arrays and shapes."""
    assert A.shape == B.shape
    for k in ("indptr", "indices", "data"):
        a, b = getattr(A, k), getattr(B, k)
        assert a.dtype == b.dtype, (k, a.dtype, b.dtype)
        assert a.tobytes() == b.tobytes(), k


def test_data_files_are_the_four():
    assert BINS == ["ex10_baij3.bin", "ex10_nonsym.bin", "ex10_poisson.bin",
                    "ex39_H.bin"]


class TestNpz:
    def test_vec_roundtrip(self, tmp_path):
        x = np.random.default_rng(0).standard_normal(17)
        p = str(tmp_path / "v.npz")
        save_vec(p, x)
        np.testing.assert_array_equal(load_vec(p), x)
        np.testing.assert_array_equal(rv.load_vec(p), x)

    def test_mat_roundtrip(self, tmp_path):
        A = laplacian_2d(5, 6)
        p = str(tmp_path / "m.npz")
        save_mat(p, A)
        assert (load_mat(p) != A).nnz == 0
        same_csr(load_mat(p), rv.load_mat(p))

    def test_system_roundtrip(self, tmp_path):
        A = laplacian_2d(4, 4)
        b = np.arange(16.0)
        p = str(tmp_path / "s.npz")
        save_system(p, A, b=b)
        A2, b2, x2 = load_system(p)
        assert (A2 != A).nnz == 0
        np.testing.assert_array_equal(b2, b)
        assert x2 is None
        x = np.ones(16)
        save_system(p, A, x=x)
        _, b3, x3 = load_system(p)
        assert b3 is None
        np.testing.assert_array_equal(x3, x)

    def test_kind_is_checked(self, tmp_path):
        p = str(tmp_path / "v.npz")
        save_vec(p, np.zeros(3))
        with pytest.raises(ValueError, match="kind"):
            load_mat(p)


class TestPetscBinary:
    def test_mat_roundtrip(self, tmp_path):
        A = laplacian_2d(6, 4) + sp.random(24, 24, density=0.1,
                                           random_state=0)
        A = A.tocsr()
        p = str(tmp_path / "m.petsc")
        petsc_binary_write_mat(p, A)
        A2 = petsc_binary_read_mat(p)
        np.testing.assert_allclose(A2.toarray(), A.toarray(), rtol=1e-15)

    def test_vec_roundtrip(self, tmp_path):
        x = np.random.default_rng(1).standard_normal(9)
        p = str(tmp_path / "v.petsc")
        petsc_binary_write_vec(p, x)
        np.testing.assert_array_equal(petsc_binary_read_vec(p), x)

    def test_endianness_is_big(self, tmp_path):
        """First 4 bytes must be the classid big-endian (reference
        format compat)."""
        p = str(tmp_path / "v.petsc")
        petsc_binary_write_vec(p, np.zeros(3))
        raw = open(p, "rb").read(4)
        assert int.from_bytes(raw, "big") == 1211214

    def test_load_any_dispatch(self, tmp_path):
        A = laplacian_2d(4, 4)
        p1 = str(tmp_path / "a.npz")
        save_mat(p1, A)
        p2 = str(tmp_path / "a.petsc")
        petsc_binary_write_mat(p2, A)
        p3 = str(tmp_path / "s.npz")
        save_system(p3, A, b=np.ones(16))
        p4 = str(tmp_path / "a.mtx")
        from scipy.io import mmwrite
        mmwrite(p4, A)
        for p in (p1, p2, p3, p4):
            assert (load_any_matrix(p) != A).nnz == 0
            same_csr(load_any_matrix(p), rv.load_any_matrix(p))

    def test_wrong_classid_raises(self, tmp_path):
        p = str(tmp_path / "v.petsc")
        petsc_binary_write_vec(p, np.zeros(3))
        with pytest.raises(ValueError, match="classid"):
            petsc_binary_read_mat(p)


@pytest.mark.parametrize("seed", (0, 1, 2))
def test_files_written_by_either_package_read_byte_equal(tmp_path, seed):
    """A random CSR (unsorted columns, explicit zeros, an empty row) and
    a vector, written by one package and read by both: the same bytes
    on disk and the same arrays back."""
    rng = np.random.default_rng(seed)
    n = 40 + seed
    A = sp.random(n, n, density=0.12, random_state=seed, format="csr")
    A = (A + sp.eye(n)).tocsr()
    A.data[::7] = 0.0
    A = A.tolil()
    A[3, :] = 0
    A = A.tocsr()
    x = rng.standard_normal(n)
    for write in (tv, rv):
        pa = str(tmp_path / f"{write.__name__}.mat")
        pv = str(tmp_path / f"{write.__name__}.vec")
        write.petsc_binary_write_mat(pa, A)
        write.petsc_binary_write_vec(pv, x)
        same_csr(tv.petsc_binary_read_mat(pa), rv.petsc_binary_read_mat(pa))
        assert (tv.petsc_binary_read_vec(pv).tobytes()
                == rv.petsc_binary_read_vec(pv).tobytes())
    files = [open(str(tmp_path / f"{w.__name__}.{e}"), "rb").read()
             for e in ("mat", "vec") for w in (tv, rv)]
    assert files[0] == files[1] and files[2] == files[3]


def test_system_file_roundtrip_both_ways(tmp_path):
    """The ex10 same-file layout (Mat then Vec in one file), written
    with the port's writers and read by both readers."""
    A = laplacian_2d(7, 5)
    b = np.random.default_rng(3).standard_normal(35)
    p = str(tmp_path / "sys.bin")
    petsc_binary_write_mat(p + ".m", A)
    petsc_binary_write_vec(p + ".v", b)
    with open(p, "wb") as f:
        f.write(open(p + ".m", "rb").read() + open(p + ".v", "rb").read())
    At, bt = tv.petsc_binary_read_system(p)
    Ar, br = rv.petsc_binary_read_system(p)
    same_csr(At, Ar)
    assert bt.tobytes() == br.tobytes()
    with pytest.raises(ValueError, match="rhs"):
        tv.petsc_binary_read_system(p + ".m")


@pytest.mark.parametrize("name", BINS)
def test_data_files_read_the_same_through_both(name):
    """Every tests/data/*.bin through both readers: the matrix (complex
    where ex39's oracle wrote complex scalars) and, for the ex10 systems,
    the right-hand side after it."""
    path = os.path.join(DATA, name)
    same_csr(tv.petsc_binary_read_mat(path), rv.petsc_binary_read_mat(path))
    if name.startswith("ex39"):
        T = tv.petsc_binary_read_mat(path, complex_scalars=True)
        assert T.dtype == np.complex128
        same_csr(T, rv.petsc_binary_read_mat(path, complex_scalars=True))
        return
    At, bt = tv.petsc_binary_read_system(path)
    Ar, br = rv.petsc_binary_read_system(path)
    same_csr(At, Ar)
    assert bt.tobytes() == br.tobytes()


@pytest.mark.parametrize("bs", (1, 3, 5))
def test_pad_to_block_size_and_blocked_readers(tmp_path, bs):
    """pad_to_block_size (MatLoad_SeqBAIJ's unit-diagonal padding) equal
    to petsctpu's; the BAIJ and SBAIJ readers' packs equal to the port's
    packs of that padded matrix, their products to it on the CPU."""
    from petsctpu_torch.mat import baij_from_scipy_bsr, sbaij_from_scipy

    A = laplacian_2d(7, 4)                       # 28 rows
    p = str(tmp_path / "a.petsc")
    petsc_binary_write_mat(p, A)
    same_csr(tv.pad_to_block_size(A, bs), rv.pad_to_block_size(A, bs))
    Ap = tv.pad_to_block_size(A, bs)
    M, Ah = tv.petsc_binary_read_mat_baij(p, bs, device="cpu")
    same_csr(Ah, Ap)
    ref = baij_from_scipy_bsr(Ap, bs=bs, fmt="ell", device="cpu")
    x = torch.from_numpy(np.random.default_rng(bs).standard_normal(
        Ap.shape[0]))
    assert torch.equal(M.mult(x), ref.mult(x))
    np.testing.assert_allclose(M.mult(x).numpy(), Ap @ x.numpy(),
                               rtol=1e-14, atol=1e-14)
    S, Sh = tv.petsc_binary_read_mat_sbaij(p, bs, device="cpu")
    same_csr(Sh, Ap)
    assert torch.equal(S.mult(x), sbaij_from_scipy(Ap, bs=bs,
                                                   device="cpu").mult(x))


class TestResumeDeterminism:
    def test_solve_resume_identical(self, tmp_path):
        """Checkpoint mid-workflow: loading must reproduce the exact
        arrays (deterministic layout), so a resumed solve repeats."""
        from petsctpu_torch.ksp import ksp_solve
        from petsctpu_torch.mat import aij_from_scipy
        from petsctpu_torch.pc import make_pc

        A = laplacian_2d(8, 8)
        b = A @ np.ones(64)
        p = str(tmp_path / "ck.npz")
        save_system(p, A, b=b)
        A2, b2, _ = load_system(p)
        Ad1 = aij_from_scipy(A, device="cpu")
        Ad2 = aij_from_scipy(A2, device="cpu")
        r1 = ksp_solve(Ad1, torch.from_numpy(b), pc=make_pc("jacobi", A=Ad1),
                       ksp_type="cg", rtol=1e-10)
        r2 = ksp_solve(Ad2, torch.from_numpy(b2),
                       pc=make_pc("jacobi", A=Ad2), ksp_type="cg",
                       rtol=1e-10)
        assert int(r1.its) == int(r2.its)
        assert torch.equal(r1.x, r2.x)


class TestHDF5Viewer:
    def test_vec_roundtrip(self, tmp_path):
        pytest.importorskip("h5py")
        p = str(tmp_path / "v.h5")
        x = np.random.default_rng(0).standard_normal(37)
        tv.hdf5_save_vec(p, "solution", x)
        tv.hdf5_save_vec(p, "rhs", x * 2)          # second object, same file
        np.testing.assert_array_equal(tv.hdf5_load_vec(p, "solution"), x)
        np.testing.assert_array_equal(tv.hdf5_load_vec(p, "rhs"), 2 * x)
        tv.hdf5_save_vec(p, "solution", x + 1)     # overwrite
        np.testing.assert_array_equal(tv.hdf5_load_vec(p, "solution"), x + 1)
        np.testing.assert_array_equal(rv.hdf5_load_vec(p, "rhs"), 2 * x)

    def test_mat_roundtrip(self, tmp_path):
        pytest.importorskip("h5py")
        p = str(tmp_path / "m.h5")
        A = laplacian_2d(6, 5)
        tv.hdf5_save_mat(p, "A", A)
        B = tv.hdf5_load_mat(p, "A")
        assert (A != B).nnz == 0
        same_csr(B, rv.hdf5_load_mat(p, "A"))
