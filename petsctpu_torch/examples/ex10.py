"""KSP ex10 analog: read a matrix (and optional RHS) from file, solve.

Counterpart of petsctpu's examples/ex10.py. Reference:
src/ksp/ksp/examples/tutorials/ex10.c ("Reads a PETSc matrix and vector
from a file and solves a linear system"). Accepts native .npz
checkpoints, MatrixMarket .mtx, or reference-format PETSc binary files
(-f <file>, -rhs <file>). `-mat_type` picks the format (default aij);
band, dia, sell and auto solve in a permuted ordering, and the
solution is mapped back to the application's.

    python -m petsctpu_torch.examples.ex10 -f A.bin -mat_type auto \\
        -ksp_type cg -pc_type jacobi -ksp_rtol 1e-8

With logging on (core/logging.log_begin), the setup is booked under
the events MatLoad, MatSetFromOptions (with -mat_type auto's
MatGridDetect, MatStencilPack and MatUpload inside it) and KSPSetUp,
the solve under KSPSolve[<type>].
"""

from __future__ import annotations

import sys
from dataclasses import dataclass

import numpy as np
import scipy.sparse as sp
import torch

from petsctpu_torch.core.logging import log_event
from petsctpu_torch.core.options import Options
from petsctpu_torch.device import resolve_device
from petsctpu_torch.io import load_any_matrix, load_vec, petsc_binary_read_vec
from petsctpu_torch.ksp import KSP
from petsctpu_torch.ksp.common import SolveResult
from petsctpu_torch.mat import mat_from_options


@dataclass
class Ex10Run:
    """A run: the file's matrix and right-hand side (application
    order), the device operator and its permutation (or None), the KSP
    (set up, reusable for another solve of b_solve), its result, the
    solution in application order and ‖b − A x‖."""
    A: sp.csr_matrix
    b: np.ndarray
    M: object
    perm: np.ndarray
    ksp: KSP
    b_solve: torch.Tensor
    res: SolveResult
    x: np.ndarray
    rnorm: float


def run(opts: Options, device=None) -> Ex10Run:
    dev = resolve_device(device)
    fname = opts.get_str("f")
    with log_event("MatLoad"):
        A = load_any_matrix(fname)
        rhs = opts.get_str("rhs", "")
        if rhs:
            b = load_vec(rhs) if rhs.endswith(".npz") else \
                petsc_binary_read_vec(rhs)
        else:
            b = A @ np.ones(A.shape[1])          # ex10's default: b = A·1
    with log_event("MatSetFromOptions"):
        M, perm = mat_from_options(A, opts, device=dev)
    A_solve = sp.csr_matrix(A)[perm][:, perm] if perm is not None else A
    b_solve = np.asarray(b)[perm] if perm is not None else np.asarray(b)
    ksp = KSP(options=opts)
    ksp.set_operators(M, A_host=A_solve)
    with log_event("KSPSetUp"):
        ksp.set_from_options()
        ksp.setup()
    bs = torch.from_numpy(np.ascontiguousarray(b_solve)).to(dev)
    res = ksp.solve(bs)
    x = res.x.cpu().numpy()
    if perm is not None:                     # back to application ordering
        xa = np.empty_like(x)
        xa[perm] = x
        x = xa
    rnorm = float(np.linalg.norm(np.asarray(b) - A @ x))
    return Ex10Run(A, np.asarray(b), M, perm, ksp, bs, res, x, rnorm)


def main(argv, device=None):
    resolve_device(device)
    opts = Options.from_args(argv)
    if not opts.get_str("f"):
        print("usage: ex10.py -f <matrixfile> [-rhs <vecfile>] [options]")
        return None
    r = run(opts, device)
    print(f"Number of iterations = {int(r.res.its):3d}")
    print(f"Residual norm {r.rnorm:.4e}")
    return r


if __name__ == "__main__":
    sys.exit(0 if main(sys.argv[1:]) is not None else 1)
