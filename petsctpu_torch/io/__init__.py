"""I/O: the native .npz checkpoints, the PETSc binary format and HDF5
(petsctpu/io)."""

from petsctpu_torch.io.viewer import (
    save_vec, load_vec, save_mat, load_mat, save_system, load_system,
    petsc_binary_write_mat, petsc_binary_read_mat,
    petsc_binary_write_vec, petsc_binary_read_vec, load_any_matrix,
    petsc_binary_read_system,
)

__all__ = [
    "save_vec", "load_vec", "save_mat", "load_mat", "save_system",
    "load_system", "petsc_binary_write_mat", "petsc_binary_read_mat",
    "petsc_binary_write_vec", "petsc_binary_read_vec", "load_any_matrix",
    "petsc_binary_read_system",
]
