"""PC registry and factory.

Reference: PC interface src/ksp/pc/interface/precon.c (PCApply :369,
PCSetUp :805) and registry pcregis.c:90-146. A PC is an object with
`.apply(x)`; setup happens in the factory. Ported: none, jacobi,
pbjacobi, lu/cholesky/redundant (exact LU) and geometric mg. Every
other type of petsctpu raises NotImplementedError naming its ROADMAP
item.
"""

from __future__ import annotations

from typing import Optional

from petsctpu_torch.core.options import Options
from petsctpu_torch.pc.factor import make_lu
from petsctpu_torch.pc.simple import NonePC, make_jacobi, make_pbjacobi

PC_REGISTRY = {}

_Q = "ROADMAP queue 1 item"
_LATER = {
    **dict.fromkeys(("ilu", "icc", "sor", "bjacobi", "asm", "gasm"),
                    f"{_Q} 5"),
    "gamg": f"{_Q} 8",
    "fft": f"{_Q} 9",
    **dict.fromkeys(("fieldsplit", "ksp", "composite", "mat", "shell",
                     "hmpi", "nn", "bddc", "eisenstat", "galerkin",
                     "redistribute", "lsc", "svd", "cp", "supportgraph",
                     "asa", "exotic", "wb", "tfs", "spai"), f"{_Q} 10"),
}


_PORTED = {"none", "jacobi", "pbjacobi", "lu", "cholesky", "redundant", "mg"}


def register_pc(name: str, factory) -> None:
    """PCRegisterDynamic analog: factory(A, A_host, options, axis) -> pc."""
    PC_REGISTRY[name] = factory


def make_pc(pc_type: str, A=None, A_host=None, options: Options = None,
            axis: Optional[str] = None):
    """Build a preconditioner (PCSetFromOptions + PCSetUp analog).

    A: device operator (needed by jacobi/pbjacobi and the device MG
    setup; the other setups build on its device)
    A_host: scipy matrix (needed by the LU and host MG setups)
    """
    opts = options or Options()
    if opts.get_bool("info", False):
        from petsctpu_torch.core.logging import info_on
        info_on()
    from petsctpu_torch.core.logging import petsc_info
    petsc_info("PCSetUp", f"pc_type={pc_type}")
    if pc_type in PC_REGISTRY:
        return PC_REGISTRY[pc_type](A, A_host, opts, axis)
    if pc_type == "none":
        return NonePC()
    if pc_type == "jacobi":
        return make_jacobi(A, variant=opts.get_str("pc_jacobi_type", "diag"))
    if pc_type == "pbjacobi":
        bs = opts.get_int("pc_pbjacobi_block_size", 0) or None
        return make_pbjacobi(A, bs=bs)
    dt = getattr(A, "dtype", None)
    dev = getattr(A, "device", None)
    if pc_type in ("lu", "cholesky", "redundant"):
        # redundant: serial semantics, every rank solves the full
        # system, so an exact LU (src/ksp/pc/impls/redundant)
        _require_host(A_host, pc_type)
        return make_lu(A_host, dtype=dt, device=dev)
    if pc_type == "mg":
        return _make_mg(A, A_host, opts, dt)
    if pc_type in _LATER:
        raise NotImplementedError(
            f"pc_type={pc_type} is not ported yet ({_LATER[pc_type]})")
    raise ValueError(f"unknown pc_type {pc_type!r}; known: "
                     f"{sorted(set(PC_REGISTRY) | set(_LATER) | _PORTED)}")


def _require_host(A_host, pc_type: str) -> None:
    if A_host is None:
        raise ValueError(f"pc_type={pc_type} needs the host (scipy) matrix"
                         ": pass A_host (KSP.set_operators(A, A_host))")


def _make_mg(A, A_host, opts: Options, dt):
    from petsctpu_torch.mat.stencil import StencilMat
    from petsctpu_torch.pc.mg import (make_geometric_mg,
                                      make_geometric_mg_device)

    da = opts.get("pc_mg_da")
    if da is None:
        raise ValueError("pc_type=mg needs options key 'pc_mg_da' (a DA)"
                         " for the grid hierarchy; use pc_type=gamg for "
                         "unstructured operators")
    setup = opts.get_str("pc_mg_setup_type", "auto")
    if setup != "host" and isinstance(A, StencilMat) and \
            not any(b == "periodic" for b in A.boundary) and \
            opts.get_str("mg_levels_pc_type", "jacobi") == "jacobi":
        # device setup: Galerkin coarsening by probing, no host SpGEMM
        return make_geometric_mg_device(A, da, dtype=dt, options=opts)
    _require_host(A_host, "mg")
    return make_geometric_mg(A_host, da, dtype=dt, options=opts,
                             device=getattr(A, "device", None))
