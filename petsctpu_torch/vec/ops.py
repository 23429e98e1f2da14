"""Vector operations, serial and SPMD.

The reference's Vec layer (src/vec — _VecOps vtable
include/petsc-private/vecimpl.h:222; VecNorm_MPI = local norm +
MPI_Allreduce, src/vec/vec/impls/mpi/pvec2.c:48). A "vector" is a 1-D
tensor on any device. `axis` is None (serial) or a parallel.comm.Comm,
the port's counterpart of petsctpu's mesh-axis name: the same solver
code runs on every rank of a World, and the global reductions become
the Comm's collectives (psum sums the ranks' partials in rank order, so
every rank holds the same bits). Any other axis raises TypeError.

`reduce_all` keeps the fused multi-reduction interface of the
reference's split-phase VecDotBegin/End (src/vec/vec/utils/comb.c:57):
several partial values, ONE collective.
"""

from __future__ import annotations

from typing import Sequence

import torch


def _comm(axis):
    if axis is None or hasattr(axis, "psum"):
        return axis
    raise TypeError(f"axis must be None or a parallel.comm.Comm, got "
                    f"{axis!r} (a mesh-axis name is petsctpu's)")


def psum(x, axis=None):
    """All-reduce sum over the Comm's ranks; identity when serial."""
    axis = _comm(axis)
    return x if axis is None else axis.psum(x)


def local_dot(a: torch.Tensor, b: torch.Tensor):
    """This rank's partial aᴴb (VecDot_Seq), the term every global inner
    product and 2-norm here reduces."""
    return torch.vdot(a.reshape(-1), b.reshape(-1))


def dot(a: torch.Tensor, b: torch.Tensor, axis=None):
    """Global inner product aᴴb (VecDot): conjugates the first argument."""
    return psum(local_dot(a, b), axis)


def norm(a: torch.Tensor, axis=None):
    """Global 2-norm (VecNorm NORM_2): sum of squares then sqrt."""
    return torch.sqrt(psum(local_dot(a, a).real, axis))


def norm_1(a: torch.Tensor, axis=None):
    return psum(torch.sum(torch.abs(a)), axis)


def norm_inf(a: torch.Tensor, axis=None):
    local = torch.max(torch.abs(a))
    axis = _comm(axis)
    return local if axis is None else axis.pmax(local)


def mdot(x: torch.Tensor, V: torch.Tensor, axis=None):
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


def pointwise_mult(x, y):
    """w = x ⊙ y (VecPointwiseMult)."""
    return x * y


def pointwise_divide(x, y):
    """w = x ⊘ y (VecPointwiseDivide)."""
    return x / y


def reduce_all(locals_: Sequence, axis=None):
    """Fuse several scalar reductions into one collective (comb.c
    analog): pass the LOCAL partial values, get the global ones. Serial:
    returns the local values as they are."""
    axis = _comm(axis)
    if axis is None:
        return tuple(locals_)
    vals = [torch.as_tensor(v) for v in locals_]
    dt = vals[0].dtype
    for v in vals[1:]:
        dt = torch.promote_types(dt, v.dtype)
    red = axis.psum(torch.stack([v.to(dt) for v in vals]))
    # a real partial stacked with complex ones comes back real
    return tuple(red[i] if v.is_complex() or not red.is_complex()
                 else red[i].real for i, v in enumerate(vals))
