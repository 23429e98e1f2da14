"""Vector operations (serial).

The reference's Vec layer (src/vec — _VecOps vtable
include/petsc-private/vecimpl.h:222). A "vector" is a 1-D tensor on
any device. `axis` names the mesh axis of the SPMD path in petsctpu;
here only `axis=None` (serial) exists, and any other value raises
until the torch.distributed port lands (ROADMAP queue 1 item 14).

`reduce_all` keeps the fused multi-reduction interface of the
reference's split-phase VecDotBegin/End (src/vec/vec/utils/comb.c:57),
so the solvers keep one call site per collective.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch


def require_serial(axis: Optional[str]) -> None:
    if axis is not None:
        raise NotImplementedError(
            "vec ops: only the serial path (axis=None) is ported; the "
            "SPMD path is ROADMAP queue 1 item 14")


def psum(x, axis: Optional[str]):
    """All-reduce sum over the mesh axis; identity when serial."""
    require_serial(axis)
    return x


def dot(a: torch.Tensor, b: torch.Tensor, axis: Optional[str] = None):
    """Global inner product aᴴb (VecDot): conjugates the first argument."""
    return psum(torch.vdot(a.reshape(-1), b.reshape(-1)), axis)


def norm(a: torch.Tensor, axis: Optional[str] = None):
    """Global 2-norm (VecNorm NORM_2): sum of squares then sqrt."""
    a = a.reshape(-1)
    return torch.sqrt(psum(torch.vdot(a, a).real, axis))


def norm_1(a: torch.Tensor, axis: Optional[str] = None):
    return psum(torch.sum(torch.abs(a)), axis)


def norm_inf(a: torch.Tensor, axis: Optional[str] = None):
    require_serial(axis)
    return torch.max(torch.abs(a))


def mdot(x: torch.Tensor, V: torch.Tensor, axis: Optional[str] = None):
    """Batched inner products V[i]ᴴx for a stack of vectors V [k, n]
    (VecMDot, src/vec/vec/impls/seq/dvec2.c:36): one matrix-vector
    product, full precision (TF32 is off, see device.py)."""
    return psum(V.conj() @ x, axis)


def axpy(y, alpha, x):
    """y ← y + alpha·x (VecAXPY)."""
    return y + alpha * x


def aypx(y, alpha, x):
    """y ← x + alpha·y (VecAYPX)."""
    return x + alpha * y


def waxpy(alpha, x, y):
    """w = alpha·x + y (VecWAXPY)."""
    return alpha * x + y


def reduce_all(locals_: Sequence, axis: Optional[str]):
    """Fuse several scalar reductions into one collective (comb.c
    analog). Serial: returns the local values as they are."""
    require_serial(axis)
    return tuple(locals_)
