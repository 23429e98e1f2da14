"""PC registry and factory.

Reference: PC interface src/ksp/pc/interface/precon.c (PCApply :369,
PCSetUp :805) and registry pcregis.c:90-146. A PC is an object with
`.apply(x)`; setup happens in the factory. Ported: none, jacobi and
pbjacobi. Every other type of petsctpu raises NotImplementedError
naming its ROADMAP item.
"""

from __future__ import annotations

from typing import Optional

from petsctpu_torch.core.options import Options
from petsctpu_torch.pc.simple import NonePC, make_jacobi, make_pbjacobi

PC_REGISTRY = {}

_Q = "ROADMAP queue 1 item"
_LATER = {
    **dict.fromkeys(("ilu", "icc", "lu", "cholesky", "redundant", "sor",
                     "bjacobi", "asm", "gasm"), f"{_Q} 5"),
    **dict.fromkeys(("mg", "gamg"), f"{_Q} 8"),
    "fft": f"{_Q} 9",
    **dict.fromkeys(("fieldsplit", "ksp", "composite", "mat", "shell",
                     "hmpi", "nn", "bddc", "eisenstat", "galerkin",
                     "redistribute", "lsc", "svd", "cp", "supportgraph",
                     "asa", "exotic", "wb", "tfs", "spai"), f"{_Q} 10"),
}


def register_pc(name: str, factory) -> None:
    """PCRegisterDynamic analog: factory(A, A_host, options, axis) -> pc."""
    PC_REGISTRY[name] = factory


def make_pc(pc_type: str, A=None, A_host=None, options: Options = None,
            axis: Optional[str] = None):
    """Build a preconditioner (PCSetFromOptions + PCSetUp analog).

    A: device operator (needed by jacobi/pbjacobi)
    A_host: scipy matrix (needed by the factorization setups, not
    ported yet)
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
    if pc_type in _LATER:
        raise NotImplementedError(
            f"pc_type={pc_type} is not ported yet ({_LATER[pc_type]})")
    raise ValueError(f"unknown pc_type {pc_type!r}; known: "
                     f"{sorted(set(PC_REGISTRY) | set(_LATER) | {'none', 'jacobi', 'pbjacobi'})}")
