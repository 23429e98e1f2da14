"""Specialty preconditioners: Galerkin, redistribute, LSC, SVD, CP,
Eisenstat.

Counterpart of petsctpu/pc/extra.py (reference: src/ksp/pc/impls/
{galerkin,redistribute,lsc,svd,cp,eisens}). Setup is host work
(scipy); the applies compose the port's ELL products, LU and SOR
(whose triangular solves are SpTRSV launches) and, for SVD, two dense
products.
"""

from __future__ import annotations

import numpy as np
import scipy.sparse as sp
import torch

from petsctpu_torch.device import np_dtype, resolve_device
from petsctpu_torch.mat.ell import aij_from_scipy
from petsctpu_torch.pc.factor import make_lu


def _dt(dtype, default):
    return np_dtype(dtype) or np.dtype(default)


# ---------------------------------------------------------------------------
# PCGalerkin — P-projected preconditioner
# ---------------------------------------------------------------------------

class GalerkinPC:
    """x ← P · inner(Pᵀ x): a solve in a user subspace
    (src/ksp/pc/impls/galerkin/galerkin.c; the restriction is Pᵀ)."""

    def __init__(self, P, inner):
        self.P = P                  # interpolation op: mult (c→f), multT
        self.inner = inner          # PC on the coarse space

    def apply(self, x):
        return self.P.mult(self.inner.apply(self.P.multT(x)))


def make_galerkin(A_host, P, P_host=None, dtype=None,
                  device=None) -> GalerkinPC:
    """P: device op (mult/multT); the coarse operator PᵀAP is formed on
    the host from P_host and LU-factored."""
    if P_host is None:
        raise ValueError("pc galerkin needs P_host (scipy)")
    Ac = (P_host.T @ A_host @ P_host).tocsc()
    return GalerkinPC(P, make_lu(Ac, dtype=dtype, device=device))


# ---------------------------------------------------------------------------
# PCRedistribute — strip Dirichlet rows, solve the reduced system
# ---------------------------------------------------------------------------

class RedistributePC:
    """Rows whose only entry is the diagonal (Dirichlet rows) are solved
    directly (x_i = b_i/a_ii); the coupled rows by an inner PC on the
    reduced matrix, with the Dirichlet part moved to the right-hand side
    (src/ksp/pc/impls/redistribute/redistribute.c)."""

    def __init__(self, keep, drop, ddiag_inv, coupling, inner, n: int):
        self.keep = keep            # device indices of coupled rows
        self.drop = drop            # device indices of Dirichlet rows
        self.ddiag_inv = ddiag_inv  # 1/a_ii on the dropped rows
        self.coupling = coupling    # A[keep, drop] (AIJ), None: no drop
        self.inner = inner          # PC on A[keep, keep]
        self.n = n

    def apply(self, b):
        if self.coupling is None:
            return self.inner.apply(b)
        xd = self.ddiag_inv * b[self.drop]
        xk = self.inner.apply(b[self.keep] - self.coupling.mult(xd))
        x = torch.zeros(self.n, dtype=b.dtype, device=b.device)
        x[self.drop] = xd
        x[self.keep] = xk
        return x


def make_redistribute(A_host, dtype=None, device=None) -> RedistributePC:
    dev = resolve_device(device)
    A = sp.csr_matrix(A_host)
    n = A.shape[0]
    first = A.indices[np.minimum(A.indptr[:-1], max(A.nnz - 1, 0))] \
        if A.nnz else np.zeros(n, np.int64)
    only_diag = (np.diff(A.indptr) == 1) & (first == np.arange(n))
    drop = np.flatnonzero(only_diag)
    keep = np.flatnonzero(~only_diag)

    def inner_of(M):
        return make_lu(M, dtype=dtype, device=dev)

    def idx(a):
        return torch.from_numpy(a.astype(np.int64)).to(dev)

    dt = _dt(dtype, np.float64)
    if drop.size == 0:
        return RedistributePC(idx(keep), idx(drop),
                              torch.from_numpy(np.zeros(0, dt)).to(dev),
                              None, inner_of(A), n)
    dd = A.diagonal()[drop]
    ddiag_inv = np.where(dd != 0, 1.0 / np.where(dd != 0, dd, 1.0), 1.0)
    Akk = A[keep][:, keep].tocsr()
    Akd = A[keep][:, drop].tocsr()
    return RedistributePC(idx(keep), idx(drop),
                          torch.from_numpy(ddiag_inv.astype(dt)).to(dev),
                          aij_from_scipy(Akd, dtype=dtype, device=dev),
                          inner_of(Akk), n)


# ---------------------------------------------------------------------------
# PCLSC — least-squares commutator (Stokes Schur complements)
# ---------------------------------------------------------------------------

class LSCPC:
    """S⁻¹ ≈ L⁻¹ (B A Bᵀ) L⁻¹ with L = B Bᵀ (src/ksp/pc/impls/lsc/lsc.c;
    Elman–Howle–Shadid–Shuttleworth–Tuminaro). B is the divergence block
    A10, A the momentum block A00; L solves through an LU of BBᵀ."""

    def __init__(self, B, A00, Linner):
        self.B = B
        self.A00 = A00
        self.Linner = Linner

    def apply(self, x):
        y = self.Linner.apply(x)
        return self.Linner.apply(self.B.mult(self.A00.mult(self.B.multT(y))))


def make_lsc(A00_host, B_host, dtype=None, device=None) -> LSCPC:
    dev = resolve_device(device)
    B = sp.csr_matrix(B_host)
    L = (B @ B.T).tocsr()
    L = L + 1e-12 * sp.eye(L.shape[0], format="csr")   # petsctpu's shift
    return LSCPC(aij_from_scipy(B, dtype=dtype, device=dev),
                 aij_from_scipy(sp.csr_matrix(A00_host), dtype=dtype,
                                device=dev),
                 make_lu(L, dtype=dtype, device=dev))


# ---------------------------------------------------------------------------
# PCSVD — dense pseudo-inverse with a singular-value cutoff
# ---------------------------------------------------------------------------

class SVDPC:
    """x ← V Σ⁺ Uᵀ x (src/ksp/pc/impls/svd/svd.c): exact for small or
    rank-deficient systems; singular values below rtol·σ_max are
    dropped. The apply is two dense matrix-vector products."""

    def __init__(self, U, sinv, Vt):
        self.U = U
        self.sinv = sinv
        self.Vt = Vt

    def apply(self, x):
        return self.Vt.T @ (self.sinv * (self.U.T @ x))


def make_svd(A_host, dtype=None, rtol: float = 1e-12,
             device=None) -> SVDPC:
    from petsctpu_torch.convert import svd_from_arrays

    Ad = np.asarray(A_host.todense() if sp.issparse(A_host) else A_host,
                    _dt(dtype, np.float64))
    U, s, Vt = np.linalg.svd(Ad)
    cutoff = rtol * (s[0] if s.size else 1.0)
    sinv = np.where(s > cutoff, 1.0 / np.where(s > cutoff, s, 1.0), 0.0)
    return svd_from_arrays(U, sinv, Vt, device=device)


# ---------------------------------------------------------------------------
# PCCP — column projections (Gauss-Seidel on the normal equations)
# ---------------------------------------------------------------------------

class _NormalEqPC:
    """inner(Aᵀ b): the inner PC on the normal equations."""

    def __init__(self, At, inner):
        self.At = At
        self.inner = inner

    def apply(self, b):
        return self.inner.apply(self.At.mult(b))


def make_cp(A_host, dtype=None, device=None) -> _NormalEqPC:
    """PCCP (src/ksp/pc/impls/cp/cp.c): cyclic column projections
    x_j ← x_j + aⱼ·r/‖aⱼ‖², Gauss-Seidel on AᵀA x = Aᵀb: AᵀA is formed
    on the host and swept by the port's SOR (SpTRSV), applied to Aᵀb."""
    from petsctpu_torch.pc.sor import make_sor

    dev = resolve_device(device)
    A = sp.csr_matrix(A_host)
    sor = make_sor((A.T @ A).tocsr(), symmetric=False, dtype=dtype,
                   device=dev)
    return _NormalEqPC(aij_from_scipy(sp.csr_matrix(A.T), dtype=dtype,
                                      device=dev), sor)


# ---------------------------------------------------------------------------
# PCEisenstat — SSOR through Eisenstat's trick
# ---------------------------------------------------------------------------

def make_eisenstat(A_host, omega: float = 1.0, dtype=None, device=None):
    """-pc_type eisenstat: the SSOR formulation (the same preconditioned
    operator and history as Eisenstat's trick, src/ksp/pc/impls/eisens/
    eisen.c); make_eisenstat_system is the reference's literal
    transformed system, whose monitored norms the sweep holds."""
    from petsctpu_torch.pc.sor import make_sor

    return make_sor(A_host, omega=omega, sweeps=1, symmetric=True,
                    dtype=dtype, device=device)


class _DiagMultPC:
    """y = D·x (PCApply_Eisenstat's VecPointwiseMult with the matrix
    diagonal, eisen.c:46)."""

    def __init__(self, d):
        self.d = d

    def apply(self, x):
        return self.d * x


def _eisenstat_mult(ctx, b):
    # Eisenstat's trick (MatSOR SOR_EISENSTAT, aij.c:1510-1527):
    # x₁ = (E+U)⁻¹b; t = b − (2/ω−1)·D·x₁; x = x₁ + (E+L)⁻¹t
    Lp, Up, d, scale = ctx
    x1 = Up.solve(b)
    return x1 + Lp.solve(b - scale * d * x1)


def eisenstat_system(Lp, Up, d, omega: float = 1.0):
    """(shell, pc, presolve, postsolve) of the Eisenstat system from its
    two triangular plans (E+L) and (E+U) and the diagonal d."""
    from petsctpu_torch.mat.base import Shell

    n = int(d.shape[0])
    shell = Shell(ctx=(Lp, Up, d, 2.0 / omega - 1.0),
                  mult_fn=_eisenstat_mult, shape=(n, n))
    return shell, _DiagMultPC(d), Lp.solve, Up.solve


def make_eisenstat_system(A_host, omega: float = 1.0, dtype=None,
                          device=None):
    """The reference's literal Eisenstat formulation: returns (shell, pc,
    presolve, postsolve).

    With A = L + D + U and E = D/ω, KSP solves the transformed system
      Ã y = b̃,  Ã = (E+L)⁻¹ A (E+U)⁻¹,  b̃ = (E+L)⁻¹ b,  x = (E+U)⁻¹ y
    (PCPreSolve_Eisenstat eisen.c:84, PCPostSolve_Eisenstat :103). The
    shell's mult is one upper and one lower SpTRSV solve, no product
    with A; the PC is the diagonal scaling by D."""
    from petsctpu_torch.mat.factor import make_sptrsv_plan

    dev = resolve_device(device)
    A = sp.csr_matrix(A_host)
    D = A.diagonal()
    E = D / omega
    Lmat = (sp.tril(A, k=-1, format="csr") + sp.diags(E)).tocsr()
    Umat = (sp.triu(A, k=1, format="csr") + sp.diags(E)).tocsr()
    Lp = make_sptrsv_plan(Lmat, lower=True, unit_diag=False, dtype=dtype,
                          device=dev)
    Up = make_sptrsv_plan(Umat, lower=False, unit_diag=False, dtype=dtype,
                          device=dev)
    d = torch.from_numpy(D.astype(_dt(dtype, D.dtype))).to(dev)
    return eisenstat_system(Lp, Up, d, omega)
