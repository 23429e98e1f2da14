"""PCFieldSplit — physics-based block preconditioning.

Counterpart of petsctpu/pc/fieldsplit.py (reference: src/ksp/pc/impls/
fieldsplit/fieldsplit.c, PCApply_FieldSplit :829, the Schur path
:744). Fields are index sets; the operator is split into the blocks
A00/A01/A10/A11 at setup (host scipy, stored zeros kept), each
diagonal block with its own sub-preconditioner from the
`fieldsplit_<k>_` options prefix.

Types: additive (block diagonal), multiplicative (block Gauss-Seidel),
symmetric_multiplicative, schur (factorization diag|lower|upper|full
with S = A11 − A10·Ã00⁻¹·A01 applied matrix-free; the Schur solve is an
inner GMRES with the A11 block's PC, the reference's
`-pc_fieldsplit_schur_precondition a11` default).

On the device a split is a gather of each field, the sub-solves, the
ELL products between fields and two `index_add_` calls back into the
full vector (each call's indices are distinct, so the sums do not
depend on the order of a scatter). The Schur path runs a KSP inside the
PC apply: each inner iteration reads the host once.
"""

from __future__ import annotations

import scipy.sparse as sp
import torch

from petsctpu_torch.core.logging import log_event
from petsctpu_torch.core.options import Options
from petsctpu_torch.device import resolve_device
from petsctpu_torch.ksp.common import KSPConfig
from petsctpu_torch.vec.indexset import is_indices

# the Schur complement's inner solve (petsctpu's FieldSplitPC default;
# its make_fieldsplit sets no other, and the A00 solves are preonly)
SCHUR_KSP = KSPConfig(ksp_type="gmres", rtol=1e-9, maxits=100)


class _SchurOp:
    """S v = A11 v − A10 solve0(A01 v), solve0 the A00 block's PC apply:
    an operator the KSP loops read (`mult`, `shape`, `dtype`, `device`),
    not a Mat."""

    def __init__(self, A01, A10, A11, solve0):
        self.A01, self.A10, self.A11 = A01, A10, A11
        self.solve0 = solve0

    @property
    def shape(self):
        return self.A11.shape

    @property
    def dtype(self):
        return self.A11.dtype

    @property
    def device(self):
        return self.A11.device

    def mult(self, v):
        return self.A11.mult(v) - self.A10.mult(
            self.solve0(self.A01.mult(v)))


class FieldSplitPC:
    """Two fields isa, isb (device int64 indices); the pmat blocks
    A00..A11 feed the sub-solves, the optional amat blocks A00a, A01a,
    A10a (pc->mat != pc->pmat, the KSPSetOperators(A, B) split of ksp
    ex43) the multiplicative residual updates (fieldsplit.c:581
    jac->Afield)."""

    def __init__(self, isa, isb, A00, A01, A10, A11, pc0, pc1, n: int,
                 fs_type: str = "additive", schur_fact: str = "full",
                 A00a=None, A01a=None, A10a=None):
        self.isa, self.isb = isa, isb
        self.A00, self.A01, self.A10, self.A11 = A00, A01, A10, A11
        self.pc0, self.pc1 = pc0, pc1
        self.n = n
        self.fs_type = fs_type
        self.schur_fact = schur_fact
        self.A00a, self.A01a, self.A10a = A00a, A01a, A10a

    def _scatter(self, ya, yb):
        # ADD_VALUES as the reference's FieldSplitSplitSolveAdd
        # (fieldsplit.c:855,876): insert for disjoint splits, and each
        # split's correction accumulates where splits overlap (runex19_8)
        y = torch.zeros(self.n, dtype=ya.dtype, device=ya.device)
        return y.index_add_(0, self.isa, ya).index_add_(0, self.isb, yb)

    def _solve0(self, r):
        return self.pc0.apply(r) if self.pc0 is not None else r

    def _solve1(self, r):
        return self.pc1.apply(r) if self.pc1 is not None else r

    def _solve_schur(self, r):
        from petsctpu_torch.ksp.api import KSP_REGISTRY

        S = _SchurOp(self.A01, self.A10, self.A11, self._solve0)
        return KSP_REGISTRY[SCHUR_KSP.ksp_type](
            S, r, torch.zeros_like(r), self.pc1, SCHUR_KSP).x

    def apply(self, x):
        xa, xb = x[self.isa], x[self.isb]
        t = self.fs_type
        if t == "additive":
            return self._scatter(self._solve0(xa), self._solve1(xb))
        if t in ("multiplicative", "symmetric_multiplicative"):
            # block Gauss-Seidel (fieldsplit.c:858-884); the inter-field
            # residual runs through the amat rows
            A10 = self.A10a if self.A10a is not None else self.A10
            A01 = self.A01a if self.A01a is not None else self.A01
            ya = self._solve0(xa)
            yb = self._solve1(xb - A10.mult(ya))
            if t == "symmetric_multiplicative":
                A00 = self.A00a if self.A00a is not None else self.A00
                ya = ya + self._solve0(xa - A00.mult(ya) - A01.mult(yb))
            return self._scatter(ya, yb)
        if t == "schur":
            f = self.schur_fact
            if f == "diag":
                # the reference's sign: the diag factorization uses −S
                return self._scatter(self._solve0(xa),
                                     -self._solve_schur(xb))
            if f == "lower":
                ya = self._solve0(xa)
                return self._scatter(
                    ya, self._solve_schur(xb - self.A10.mult(ya)))
            if f == "upper":
                yb = self._solve_schur(xb)
                return self._scatter(self._solve0(xa - self.A01.mult(yb)),
                                     yb)
            ya_t = self._solve0(xa)
            yb = self._solve_schur(xb - self.A10.mult(ya_t))
            return self._scatter(ya_t - self._solve0(self.A01.mult(yb)), yb)
        raise ValueError(f"unknown fieldsplit type {self.fs_type}")


def split_blocks(A_host, ia, ib):
    """The four blocks A[ia,ia], A[ia,ib], A[ib,ia], A[ib,ib] (scipy,
    stored zeros kept: the inner ILU(0)/ICC patterns depend on them)."""
    from petsctpu_torch.mat.base import csr_submatrix_keep_zeros

    A = sp.csr_matrix(A_host)
    return tuple(csr_submatrix_keep_zeros(A, r, c)
                 for r, c in ((ia, ia), (ia, ib), (ib, ia), (ib, ib)))


def make_fieldsplit(A_host, fields, options: Options = None, dtype=None,
                    Amat_host=None, device=None) -> FieldSplitPC:
    """A 2-field FieldSplitPC from index sets (PCFieldSplitSetIS).
    Sub-PC types come from fieldsplit_0_pc_type / fieldsplit_1_pc_type
    (defaults lu, and jacobi for schur, else lu).

    A_host is the PC matrix (pc->pmat) whose diagonal blocks feed the
    sub-solves; Amat_host, when given, is the operator (pc->mat) whose
    rows drive the multiplicative inter-field updates. The block
    extraction is timed under the log event PCFieldSplitBlocks, the
    sub-PC setups under PCFieldSplitSubPC."""
    from petsctpu_torch.mat.ell import aij_from_scipy
    from petsctpu_torch.pc.api import make_pc

    opts = options or Options()
    if len(fields) != 2:
        raise ValueError("make_fieldsplit takes 2 fields; "
                         "make_multi_fieldsplit takes more")
    dev = resolve_device(device)
    ia, ib = is_indices(fields[0]), is_indices(fields[1])

    def dev_op(M):
        return aij_from_scipy(M, dtype=dtype, device=dev)

    with log_event("PCFieldSplitBlocks"):
        A00, A01, A10, A11 = split_blocks(A_host, ia, ib)
        d0, d01, d10, d1 = map(dev_op, (A00, A01, A10, A11))
        amat = (None, None, None) if Amat_host is None else tuple(
            map(dev_op, split_blocks(Amat_host, ia, ib)[:3]))
    fs_type = opts.get_str("pc_fieldsplit_type", "additive")
    o0, o1 = opts.prefixed("fieldsplit_0_"), opts.prefixed("fieldsplit_1_")
    with log_event("PCFieldSplitSubPC"):
        pc0 = make_pc(o0.get_str("pc_type", "lu"), A=d0, A_host=A00,
                      options=o0)
        pc1 = make_pc(o1.get_str("pc_type", "jacobi" if fs_type == "schur"
                                 else "lu"), A=d1, A_host=A11, options=o1)
    return FieldSplitPC(
        torch.from_numpy(ia).to(dev), torch.from_numpy(ib).to(dev),
        d0, d01, d10, d1, pc0, pc1, int(sp.csr_matrix(A_host).shape[0]),
        fs_type=fs_type,
        schur_fact=opts.get_str("pc_fieldsplit_schur_fact_type", "full"),
        A00a=amat[0], A01a=amat[1], A10a=amat[2])


class MultiFieldSplitPC:
    """N-field additive / multiplicative fieldsplit (PCApply_FieldSplit
    fieldsplit.c:829, the general-split loop). Each field has device
    indices and a sub-PC on its diagonal block; multiplicative updates the
    residual through the full operator A between fields."""

    def __init__(self, iss, pcs, A, n: int, fs_type: str = "additive"):
        self.iss = tuple(iss)
        self.pcs = tuple(pcs)
        self.A = A
        self.n = n
        self.fs_type = fs_type

    def _solve(self, f, r):
        pc = self.pcs[f]
        return pc.apply(r) if pc is not None else r

    def apply(self, x):
        y = torch.zeros(self.n, dtype=x.dtype, device=x.device)
        if self.fs_type == "additive":
            for f, idx in enumerate(self.iss):
                y[idx] = self._solve(f, x[idx])
            return y
        if self.fs_type in ("multiplicative", "symmetric_multiplicative"):
            order = list(range(len(self.iss)))
            if self.fs_type == "symmetric_multiplicative":
                order = order + order[-2::-1]
            for f in order:
                idx = self.iss[f]
                r = x - self.A.mult(y)
                y[idx] = y[idx] + self._solve(f, r[idx])
            return y
        raise ValueError(f"unknown fieldsplit type {self.fs_type}")


def make_multi_fieldsplit(A_host, fields, options: Options = None,
                          dtype=None, device=None) -> MultiFieldSplitPC:
    """An N-field FieldSplit from index sets (PCFieldSplitSetIS ×N).
    Sub-PC types come from fieldsplit_<k>_pc_type (default ilu, the
    reference's default inner preonly+ILU)."""
    from petsctpu_torch.mat.base import csr_submatrix_keep_zeros
    from petsctpu_torch.mat.ell import aij_from_scipy
    from petsctpu_torch.pc.api import make_pc

    opts = options or Options()
    dev = resolve_device(device)
    A = sp.csr_matrix(A_host)
    iss, pcs = [], []
    for k, f in enumerate(fields):
        idx = is_indices(f)
        Akk = csr_submatrix_keep_zeros(A, idx, idx)
        dk = aij_from_scipy(Akk, dtype=dtype, device=dev)
        pcs.append(make_pc(opts.get_str(f"fieldsplit_{k}_pc_type", "ilu"),
                           A=dk, A_host=Akk,
                           options=opts.prefixed(f"fieldsplit_{k}_")))
        iss.append(torch.from_numpy(idx).to(dev))
    return MultiFieldSplitPC(
        iss, pcs, aij_from_scipy(A, dtype=dtype, device=dev),
        n=A.shape[0], fs_type=opts.get_str("pc_fieldsplit_type",
                                           "additive"))
