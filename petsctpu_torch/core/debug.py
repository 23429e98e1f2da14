"""Debug-mode validation: the fp-trap and bounds-check analog.

Counterpart of petsctpu/core/debug.py (reference: PetscSetFPTrap,
src/sys/error/fp.c:449; PetscMallocValidate and CHKMEMQ,
src/sys/memory/mtr.c:124; the MatAssembled checks). petsctpu wraps a
function in jax.experimental.checkify. PyTorch has no checkify, so the
port checks each PyTorch op as the dispatcher runs it
(`TorchDispatchMode`):

  * `checked(fn)`: while fn runs, every indexing op (x[i], index_select,
    gather, take, scatter, index_add, index_put, embedding) has its
    indices checked against the indexed dimension BEFORE the op runs, and
    every op's floating outputs are checked for NaN after it (integer
    division by zero too, before the op). A failed check raises
    PetscTPUError. On the card an out-of-range gather would fire a
    device-side assert that leaves the CUDA context unusable for the rest
    of the process; checked stops it on the host, before the launch, so
    the process goes on. fn's tensor arguments and its outputs are
    checked for NaN as well.
  * `fp_trap(True)`: the same NaN check on every PyTorch op of the
    calling thread until `fp_trap(False)` (jax_debug_nans).
  * `validate_operator(A)` / `validate_system(A, b)`: the assembly-state
    audit of a device operator of any of the port's formats (finite
    values, indices in range, shapes), and of a right-hand side.

How far the checks reach: the hand kernels (ops/*.py) launch through
ctypes, so the dispatcher sees their wrappers' allocations but nothing
inside a kernel. A NaN a kernel writes is caught when fn returns, or at
the first PyTorch op that reads it; an out-of-range index inside a
kernel's operands (an ELL column, a SpTRSV plan) is what
validate_operator audits, not checked. Each check reads a reduction
back to the host: a debug mode, not a solve's.
"""

from __future__ import annotations

import functools

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten

from petsctpu_torch.core.errors import PetscTPUError


def _ops(*names) -> set:
    """The aten overloads "op.overload" of this PyTorch (one missing in
    another version is left out)."""
    out = set()
    for name in names:
        op, _, overload = name.partition(".")
        try:
            out.add(getattr(getattr(torch.ops.aten, op), overload))
        except AttributeError:
            pass
    return out


# op -> (position of the indexed tensor, of the dim (None: 0; -1: the
# flattened tensor), of the index, whether negative indices are valid)
_INDEXED = {}
for _names, _spec in (
        (("index_select.default", "gather.default", "scatter.src",
          "scatter.value", "scatter_.src", "scatter_.value",
          "scatter_add.default", "scatter_add_.default", "index_add.default",
          "index_add_.default", "index_copy.default", "index_copy_.default",
          "index_fill.int_Scalar", "index_fill_.int_Scalar"), (0, 1, 2, False)),
        (("embedding.default",), (0, None, 1, False)),
        (("take.default",), (0, -1, 1, True)),
        (("select.int",), (0, 1, 2, True))):
    _INDEXED.update(dict.fromkeys(_ops(*_names), _spec))
# x[i0, i1, ...] and its writes: a list of optional indices, one a dim
_INDEX_LIST = _ops("index.Tensor", "index_put.default", "index_put_.default",
                   "_index_put_impl_.default", "_unsafe_index.Tensor")
_INT_DIV = _ops("div.Tensor", "div.Tensor_mode", "div_.Tensor",
                "remainder.Tensor", "remainder_.Tensor",
                "floor_divide.default", "floor_divide_.Tensor", "fmod.Tensor",
                "fmod_.Tensor")
# ops whose outputs are uninitialized memory: never NaN-checked
_FACTORY = _ops("empty.memory_format", "empty_strided.default",
                "empty_like.default", "new_empty.default",
                "new_empty_strided.default")


def _bounds(op, idx, size: int, negative: bool) -> None:
    if not isinstance(idx, torch.Tensor):           # x[i], an int (select)
        idx = torch.tensor(int(idx))
    if idx.numel() == 0:
        return
    if idx.dtype == torch.bool:
        if idx.shape and idx.shape[0] != size:
            raise PetscTPUError(f"{op}: mask of length {idx.shape[0]} for "
                                f"a dimension of size {size}")
        return
    lo, hi = (int(v) for v in torch.aminmax(idx))
    if lo < (-size if negative else 0) or hi >= size:
        raise PetscTPUError(f"{op}: index out of range [{lo}, {hi}] for "
                            f"a dimension of size {size}")


def _check_indices(op, args) -> None:
    if op in _INDEX_LIST:
        x, indices = args[0], args[1]
        dim = 0
        for idx in indices:
            if idx is None:
                dim += 1
                continue
            if idx.dtype == torch.bool:
                _bounds(op, idx, x.shape[dim], True)
                dim += idx.dim()
                continue
            _bounds(op, idx, x.shape[dim], True)
            dim += 1
        return
    spec = _INDEXED.get(op)
    if spec is None:
        return
    ix, idim, iidx, negative = spec
    x, idx = args[ix], args[iidx]
    if idim is None:
        size = x.shape[0]
    elif idim == -1:
        size = x.numel()
    else:
        d = args[idim]
        size = x.shape[d] if x.dim() else 1
    _bounds(op, idx, size, negative)


def _nan(where, tensors) -> None:
    for t in tensors:
        if isinstance(t, torch.Tensor) and (t.is_floating_point()
                                            or t.is_complex()):
            if bool(torch.isnan(t).any()):
                raise PetscTPUError(f"NaN in the output of {where}")


class _Checks(TorchDispatchMode):
    """Bounds before an op (bounds=True), NaN in its outputs after."""

    def __init__(self, bounds: bool = True):
        super().__init__()
        self.bounds = bounds

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if self.bounds:
            _check_indices(func, args)
            if func in _INT_DIV and len(args) > 1 and isinstance(
                    args[1], torch.Tensor) and not (
                    args[1].is_floating_point() or args[1].is_complex()) \
                    and bool((args[1] == 0).any()):
                raise PetscTPUError(f"{func}: integer division by zero")
        out = func(*args, **kwargs)
        if func not in _FACTORY:
            _nan(func, tree_flatten(out)[0])
        return out


def checked(fn):
    """fn with every PyTorch op it runs checked (see the module
    docstring): out-of-range indices and integer division by zero before
    the op, NaN after it, and NaN in fn's tensor arguments and outputs,
    each raising PetscTPUError."""

    @functools.wraps(fn)
    def run(*args, **kw):
        name = getattr(fn, "__name__", fn)
        try:
            _nan(f"the arguments of {name}", tree_flatten((args, kw))[0])
            with _Checks():
                out = fn(*args, **kw)
            _nan(f"{name} (its result)", tree_flatten(out)[0])
        except (PetscTPUError, IndexError) as e:
            # IndexError: PyTorch's own host-side check of an int index
            # (x[i] with a Python or 0-d integer i), also before a launch
            raise PetscTPUError(f"debug check failed in {name}: {e}") from e
        return out

    return run


_TRAP = []


def fp_trap(flag: bool = True) -> None:
    """PetscSetFPTrap: while on, a PyTorch op of the calling thread that
    outputs a NaN raises PetscTPUError (the dispatch modes are the
    thread's)."""
    if flag and not _TRAP:
        mode = _Checks(bounds=False)
        mode.__enter__()
        _TRAP.append(mode)
    elif not flag and _TRAP:
        _TRAP.pop().__exit__(None, None, None)


def _finite(A, t, what) -> None:
    if t is not None and t.numel() and not bool(torch.isfinite(t).all()):
        bad = int((~torch.isfinite(t)).sum())
        raise PetscTPUError(f"{type(A).__name__}: {bad} non-finite entries "
                            f"in {what}")


def _in_range(A, idx, hi: int, what, lo: int = 0) -> None:
    if idx.numel():
        a, b = (int(v) for v in torch.aminmax(idx.to(torch.int64)))
        if a < lo or b >= hi:
            raise PetscTPUError(f"{type(A).__name__}: {what} index out of "
                                f"range [{a}, {b}] vs bound {hi}")


def validate_operator(A) -> None:
    """MatValid / the assembly-state audit: raises PetscTPUError on
    non-finite values or out-of-range indices of a device operator
    (every format of the port; wrappers recurse into what they hold)."""
    from petsctpu_torch.mat.band import BandMat
    from petsctpu_torch.mat.bsr import BAIJ
    from petsctpu_torch.mat.dia import DiaMat
    from petsctpu_torch.mat.maij import MAIJ
    from petsctpu_torch.mat.matis import MatIS
    from petsctpu_torch.mat.nest import Nest
    from petsctpu_torch.mat.rectband import RectBandMat
    from petsctpu_torch.mat.sbaij import SBAIJ
    from petsctpu_torch.mat.sell import SellMat

    n_rows, n_cols = A.shape
    if isinstance(A, BAIJ):                      # BAIJ, SellBAIJ
        _in_range(A, A.cols, n_cols // A.bs, "block column")
        _finite(A, A.vals, "vals")
        if hasattr(A, "sell"):
            validate_operator(A.sell)
    elif isinstance(A, SBAIJ):
        _in_range(A, A.bcols, n_cols // A.bs, "block column")
        _finite(A, A.bvals, "bvals")
    elif isinstance(A, SellMat):
        _in_range(A, A.winstart, max(n_cols, 1), "window start")
        _finite(A, A.vals, "vals")
        _finite(A, A.diag, "diag")
    elif hasattr(A, "cols") and hasattr(A, "vals"):   # AIJ
        _in_range(A, A.cols, n_cols, "column")
        _finite(A, A.vals, "vals")
    elif isinstance(A, DiaMat):
        for o in A.offsets:
            if not -n_rows < o < n_cols:
                raise PetscTPUError(f"DiaMat: diagonal offset {o} outside "
                                    f"the {n_rows}x{n_cols} operator")
        _finite(A, A.coeffs, "coeffs")
    elif hasattr(A, "coeffs"):                   # StencilMat
        _finite(A, A.coeffs, "coeffs")
    elif isinstance(A, BandMat):
        _finite(A, A.tiles, "tiles")
    elif isinstance(A, RectBandMat):
        _finite(A, A.B, "band")
    elif isinstance(A, MatIS):
        for i, (Ai, gi) in enumerate(zip(A.locals_, A.l2g)):
            _in_range(A, torch.as_tensor(gi), n_rows, f"l2g[{i}]")
            validate_operator(Ai)
    elif isinstance(A, MAIJ):
        validate_operator(A.A)
    elif isinstance(A, Nest):
        for row in A.blocks:
            for blk in row:
                if blk is not None:
                    validate_operator(blk)
    else:                                        # Dense; implicit wrappers
        M = getattr(A, "M", None)
        if isinstance(M, torch.Tensor):
            _finite(A, M, "dense")


def validate_system(A, b) -> None:
    """The KSPSolve entry checks: the operator valid, the right-hand side
    finite and of the operator's row count."""
    validate_operator(A)
    bb = torch.as_tensor(b)
    if not bool(torch.isfinite(bb).all()):
        raise PetscTPUError("rhs contains non-finite entries")
    if bb.reshape(-1).shape[0] != A.shape[0]:
        raise PetscTPUError(f"rhs size {bb.reshape(-1).shape[0]} != "
                            f"operator rows {A.shape[0]}")
