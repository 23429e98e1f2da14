"""PC registry and factory.

Reference: PC interface src/ksp/pc/interface/precon.c (PCApply :369,
PCSetUp :805) and registry pcregis.c:90-146. A PC is an object with
`.apply(x)`; setup happens in the factory. Ported: none, jacobi,
pbjacobi, lu/cholesky/redundant (exact LU), ilu (ILU(k), orderings,
ILUTP, transpose solves), icc, sor (scalar and inode), bjacobi and
asm/gasm, geometric mg and gamg (smoothed aggregation, scalar route).
Every other type of petsctpu raises NotImplementedError naming its
ROADMAP item.
"""

from __future__ import annotations

from typing import Optional

from petsctpu_torch.core.options import Options
from petsctpu_torch.pc.asm import make_asm
from petsctpu_torch.pc.factor import make_icc, make_ilu, make_iludt, make_lu
from petsctpu_torch.pc.simple import NonePC, make_jacobi, make_pbjacobi
from petsctpu_torch.pc.sor import make_inode_sor, make_sor

PC_REGISTRY = {}

_Q = "ROADMAP queue 1 item"
_LATER = {
    "fft": f"{_Q} 9",
    **dict.fromkeys(("fieldsplit", "ksp", "composite", "mat", "shell",
                     "hmpi", "nn", "bddc", "eisenstat", "galerkin",
                     "redistribute", "lsc", "svd", "cp", "supportgraph",
                     "asa", "exotic", "wb", "tfs", "spai"), f"{_Q} 10"),
}


_PORTED = {"none", "jacobi", "pbjacobi", "lu", "cholesky", "redundant", "mg",
           "gamg", "ilu", "icc", "sor", "bjacobi", "asm", "gasm"}


def register_pc(name: str, factory) -> None:
    """PCRegisterDynamic analog: factory(A, A_host, options, axis) -> pc."""
    PC_REGISTRY[name] = factory


def make_pc(pc_type: str, A=None, A_host=None, options: Options = None,
            axis: Optional[str] = None):
    """Build a preconditioner (PCSetFromOptions + PCSetUp analog).

    A: device operator (needed by jacobi/pbjacobi and the device MG
    setup; the other setups build on its device)
    A_host: scipy matrix (needed by the factorization, SOR, ASM and host
    MG setups)
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
    if pc_type == "ilu":
        return _make_ilu(A_host, opts, dt, dev)
    if pc_type == "icc":
        _require_host(A_host, "icc")
        return make_icc(
            A_host, dtype=dt, levels=opts.get_int("pc_factor_levels", 0),
            ordering=opts.get_str("pc_factor_mat_ordering_type", "natural"),
            tri=opts.get_str("pc_factor_tri_solve", "auto"),
            # the PCICC default is the Manteuffel shift (icc.c:198)
            shift_type=opts.get_str("pc_factor_shift_type",
                                    "positive_definite"),
            shift_amount=opts.get("pc_factor_shift_amount"),
            zeropivot=opts.get("pc_factor_zeropivot"), device=dev)
    if pc_type == "bjacobi":
        # serial block Jacobi = zero-overlap ASM on contiguous row
        # blocks (PCSetUp_BJacobi bjacobi.c:14)
        _require_host(A_host, "bjacobi")
        return make_asm(A_host, dtype=dt, options=opts,
                        nblocks=opts.get_int("pc_bjacobi_blocks", 1),
                        overlap=0, restricted=False,
                        sub_pc=opts.get_str("sub_pc_type", "ilu"),
                        device=dev)
    if pc_type in ("asm", "gasm"):
        _require_host(A_host, "asm")
        return make_asm(A_host, dtype=dt, options=opts, device=dev)
    if pc_type == "sor":
        return _make_sor(A_host, opts, dt, dev)
    if pc_type == "mg":
        return _make_mg(A, A_host, opts, dt)
    if pc_type == "gamg":
        from petsctpu_torch.pc.gamg import make_gamg
        _require_host(A_host, "gamg")
        return make_gamg(A_host, dtype=dt, options=opts, device=dev)
    if pc_type in _LATER:
        raise NotImplementedError(
            f"pc_type={pc_type} is not ported yet ({_LATER[pc_type]})")
    raise ValueError(f"unknown pc_type {pc_type!r}; known: "
                     f"{sorted(set(PC_REGISTRY) | set(_LATER) | _PORTED)}")


def _require_host(A_host, pc_type: str) -> None:
    if A_host is None:
        raise ValueError(f"pc_type={pc_type} needs the host (scipy) matrix"
                         ": pass A_host (KSP.set_operators(A, A_host))")


def _make_ilu(A_host, opts: Options, dt, dev):
    _require_host(A_host, "ilu")
    dtv = opts.get("pc_factor_drop_tolerance")
    if dtv is not None and opts.get_str("pc_factor_drop_solver",
                                        "superlu") == "petsc":
        # the reference's native drop-tolerance ILU (MatILUDTFactor_SeqAIJ;
        # its PCILU options path never reaches it, so ksp ex2_7 runs
        # plain ILU(0) there)
        parts = ([float(x) for x in str(dtv).split(",")]
                 if isinstance(dtv, str) else [float(dtv)])
        return make_iludt(A_host, dt=parts[0],
                          dtcount=int(parts[2]) if len(parts) > 2 else None,
                          dtype=dt, device=dev)
    return make_ilu(A_host, dtype=dt,
                    levels=opts.get_int("pc_factor_levels", 0),
                    ordering=opts.get_str("pc_factor_mat_ordering_type",
                                          "natural"),
                    tri=opts.get_str("pc_factor_tri_solve", "auto"),
                    drop_tol=opts.get_real("pc_factor_drop_tolerance", 0.0),
                    fill_factor=opts.get_real("pc_factor_fill", 10.0),
                    transpose_solves=opts.has("pc_factor_transpose_solves"),
                    device=dev)


def _make_sor(A_host, opts: Options, dt, dev):
    _require_host(A_host, "sor")
    omega = opts.get_real("pc_sor_omega", 1.0)
    sweeps = opts.get_int("pc_sor_its", 1)
    fwd = opts.get_bool("pc_sor_forward", False)
    bwd = opts.get_bool("pc_sor_backward", False)
    symmetric = opts.get_bool("pc_sor_symmetric", False) or not (fwd or bwd)
    if not opts.get_bool("mat_no_inode", False):
        # the reference's default: AIJ matrices with inodes take the
        # node-blocked sweep (MatSOR_SeqAIJ_Inode, inode.c:2757), silently;
        # make_inode_sor returns None without inodes or for omega != 1
        ipc = make_inode_sor(A_host, omega=omega, sweeps=sweeps,
                             symmetric=symmetric,
                             forward_only=fwd and not symmetric, dtype=dt,
                             device=dev)
        if ipc is not None:
            return ipc
    return make_sor(A_host, omega=omega, sweeps=sweeps, symmetric=symmetric,
                    dtype=dt, device=dev)


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
