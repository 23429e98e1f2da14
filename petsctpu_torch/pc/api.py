"""PC registry and factory.

Reference: PC interface src/ksp/pc/interface/precon.c (PCApply :369,
PCSetUp :805) and registry pcregis.c:90-146. A PC is an object with
`.apply(x)`; setup happens in the factory. Ported: none, jacobi,
pbjacobi, lu/cholesky/redundant (exact LU), ilu (ILU(k), orderings,
ILUTP, transpose solves), icc, sor (scalar and inode), bjacobi and
asm/gasm, geometric mg, gamg (smoothed aggregation: the scalar route,
and the rigid-body-mode and blocked routes for elasticity), asa
(adaptive smoothed aggregation), and the compositional and specialty
PCs: fieldsplit, ksp, composite, mat, shell, eisenstat, galerkin,
redistribute, lsc, svd, cp, spai, supportgraph, exotic/wb and tfs;
and over the Mat formats, nn and bddc (on a MatIS) and fft (the DST
Poisson solver); and hmpi, an inner distributed solve over a World of
rank threads (pc/parallel.py).
"""

from __future__ import annotations

from typing import Optional

from petsctpu_torch.core.options import Options
from petsctpu_torch.pc.asm import make_asm
from petsctpu_torch.pc.factor import make_icc, make_ilu, make_iludt, make_lu
from petsctpu_torch.pc.simple import NonePC, make_jacobi, make_pbjacobi
from petsctpu_torch.pc.sor import make_inode_sor, make_sor

PC_REGISTRY = {}

_PORTED = {"none", "jacobi", "pbjacobi", "lu", "cholesky", "redundant", "mg",
           "gamg", "asa", "ilu", "icc", "sor", "bjacobi", "asm", "gasm",
           "hmpi"}


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
    if pc_type == "asa":
        from petsctpu_torch.pc.asa import make_asa
        _require_host(A_host, "asa")
        return make_asa(A_host, dtype=dt, options=opts, device=dev)
    if pc_type == "hmpi":
        from petsctpu_torch.pc.parallel import make_hmpi
        _require_host(A_host, "hmpi")
        return make_hmpi(A_host, options=opts, dtype=dt, device=dev)
    if pc_type in _SLICE8:
        return _SLICE8[pc_type](A, A_host, opts, axis, dt, dev)
    if pc_type in _SLICE12:
        return _SLICE12[pc_type](A, A_host, opts, axis, dt, dev)
    known = set(PC_REGISTRY) | _PORTED | set(_SLICE8) | set(_SLICE12)
    raise ValueError(f"unknown pc_type {pc_type!r}; known: {sorted(known)}")


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


def _make_fieldsplit(A, A_host, opts: Options, axis, dt, dev):
    from petsctpu_torch.pc.fieldsplit import (make_fieldsplit,
                                              make_multi_fieldsplit)

    _require_host(A_host, "fieldsplit")
    fields = opts.get("pc_fieldsplit_fields")
    if fields is None:
        raise ValueError("pc_type=fieldsplit needs options key "
                         "'pc_fieldsplit_fields' (list of IS)")
    if len(fields) != 2:
        return make_multi_fieldsplit(A_host, fields, options=opts, dtype=dt,
                                     device=dev)
    return make_fieldsplit(A_host, fields, options=opts, dtype=dt,
                           device=dev)


def _make_ksp(A, A_host, opts: Options, axis, dt, dev):
    """-pc_type ksp: the inner KSP from the ksp_ prefix (default GMRES,
    rtol 1e-2, 20 its) with inner PC ilu given the host matrix, else
    jacobi; -ksp_ksp_type specest takes the stateful SpecEstPC."""
    from petsctpu_torch.ksp.api import config_from_options
    from petsctpu_torch.ksp.common import KSPConfig
    from petsctpu_torch.pc.composite import KSPPC

    inner = opts.prefixed("ksp_")
    icfg = config_from_options(inner, KSPConfig(ksp_type="gmres", rtol=1e-2,
                                                maxits=20))
    ipc = make_pc(inner.get_str("pc_type", "ilu" if A_host is not None
                                else "jacobi"),
                  A=A, A_host=A_host, options=inner, axis=axis)
    if icfg.ksp_type == "specest":
        # the stateful two-phase estimator (specest.c); ksp_solve then
        # takes the host-driven flexible outer (fgmres_host)
        from petsctpu_torch.ksp.specest import SpecEstPC

        spec, cheap = inner.prefixed("specest_"), inner.prefixed("speccheap_")
        return SpecEstPC(
            A, pc=ipc, est_type=spec.get_str("ksp_type", "gmres"),
            cheap_type=cheap.get_str("ksp_type", "chebyshev"),
            est_maxits=spec.get_int("ksp_max_it", 5),
            cheap_maxits=cheap.get_int("ksp_max_it", 5),
            minfactor=inner.get_real("ksp_specest_minfactor", 0.9),
            maxfactor=inner.get_real("ksp_specest_maxfactor", 1.1),
            richfactor=inner.get_real("ksp_specest_richfactor", 1.0))
    return KSPPC(A, ipc, icfg, axis)


def _make_composite(A, A_host, opts: Options, axis, dt, dev):
    from petsctpu_torch.pc.composite import CompositePC

    names = opts.get_str("pc_composite_pcs", "jacobi,sor").split(",")
    pcs = [make_pc(nm.strip(), A=A, A_host=A_host,
                   options=opts.prefixed(f"sub_{i}_"), axis=axis)
           for i, nm in enumerate(names)]
    return CompositePC(pcs, A, opts.get_str("pc_composite_type", "additive"))


def _make_mat(A, A_host, opts: Options, axis, dt, dev):
    from petsctpu_torch.pc.composite import MatPC

    return MatPC(opts.get("pc_mat_operator") or A)


def _make_shell(A, A_host, opts: Options, axis, dt, dev):
    # PCShell: the callable rides the Options object, as
    # pc_mat_operator does: apply_fn(ctx, x) -> z
    from petsctpu_torch.pc.composite import ShellPC

    ap = opts.get("pc_shell_apply")
    if ap is None:
        raise ValueError("pc_type=shell needs pc_shell_apply "
                         "(a callable (ctx, x) -> z) in options")
    return ShellPC(opts.get("pc_shell_ctx"), ap)


def _make_eisenstat(A, A_host, opts: Options, axis, dt, dev):
    from petsctpu_torch.pc.extra import make_eisenstat

    _require_host(A_host, "eisenstat")
    return make_eisenstat(A_host, omega=opts.get_real("pc_eisenstat_omega",
                                                      1.0),
                          dtype=dt, device=dev)


def _make_galerkin(A, A_host, opts: Options, axis, dt, dev):
    from petsctpu_torch.pc.extra import make_galerkin

    _require_host(A_host, "galerkin")
    P = opts.get("pc_galerkin_interpolation")
    if P is None:
        raise ValueError("pc_type=galerkin needs options key "
                         "'pc_galerkin_interpolation' (device op) and "
                         "'pc_galerkin_interpolation_host' (scipy)")
    return make_galerkin(A_host, P,
                         P_host=opts.get("pc_galerkin_interpolation_host"),
                         dtype=dt, device=dev)


def _make_redistribute(A, A_host, opts: Options, axis, dt, dev):
    from petsctpu_torch.pc.extra import make_redistribute

    _require_host(A_host, "redistribute")
    return make_redistribute(A_host, dtype=dt, device=dev)


def _make_lsc(A, A_host, opts: Options, axis, dt, dev):
    from petsctpu_torch.pc.extra import make_lsc

    A00, B = opts.get("pc_lsc_a00"), opts.get("pc_lsc_b")
    if A00 is None or B is None:
        raise ValueError("pc_type=lsc needs options keys 'pc_lsc_a00' "
                         "and 'pc_lsc_b' (scipy blocks)")
    return make_lsc(A00, B, dtype=dt, device=dev)


def _make_svd(A, A_host, opts: Options, axis, dt, dev):
    from petsctpu_torch.pc.extra import make_svd

    _require_host(A_host, "svd")
    return make_svd(A_host, dtype=dt,
                    rtol=opts.get_real("pc_svd_monitor_rtol", 1e-12),
                    device=dev)


def _make_cp(A, A_host, opts: Options, axis, dt, dev):
    from petsctpu_torch.pc.extra import make_cp

    _require_host(A_host, "cp")
    return make_cp(A_host, dtype=dt, device=dev)


def _make_supportgraph(A, A_host, opts: Options, axis, dt, dev):
    from petsctpu_torch.pc.supportgraph import make_supportgraph

    _require_host(A_host, "supportgraph")
    return make_supportgraph(A_host, dtype=dt, options=opts, device=dev)


def _make_exotic(A, A_host, opts: Options, axis, dt, dev):
    from petsctpu_torch.pc.exotic import make_exotic_from_options

    _require_host(A_host, "exotic")
    return make_exotic_from_options(A, A_host, opts)


def _make_tfs(A, A_host, opts: Options, axis, dt, dev):
    from petsctpu_torch.pc.exotic import make_tfs

    _require_host(A_host, "tfs")
    return make_tfs(A_host, dtype=dt,
                    drop_tol=opts.get_real("pc_tfs_drop_tolerance", 0.0),
                    device=dev)


def _matis(A, pc_type: str):
    from petsctpu_torch.mat.matis import MatIS

    if not isinstance(A, MatIS):
        raise ValueError(f"pc_type={pc_type} needs a MatIS operator "
                         "(unassembled local Neumann matrices)")
    return A


def _make_nn(A, A_host, opts: Options, axis, dt, dev):
    from petsctpu_torch.pc.nn import make_nn

    return make_nn(_matis(A, "nn"), dtype=dt,
                   balanced=opts.get_bool("pc_nn_balanced", True))


def _make_bddc(A, A_host, opts: Options, axis, dt, dev):
    # vertex and edge constraint spaces (bddc.c)
    from petsctpu_torch.pc.bddc import make_bddc

    return make_bddc(_matis(A, "bddc"), dtype=dt,
                     vertices=opts.get_bool("pc_bddc_use_vertices", True),
                     edges=opts.get_bool("pc_bddc_use_edges", True))


def _make_fft(A, A_host, opts: Options, axis, dt, dev):
    from petsctpu_torch.mat.fft import make_poisson_fft

    dims = opts.get("pc_fft_dims")
    if dims is None:
        raise ValueError("pc_type=fft needs options key 'pc_fft_dims' "
                         "(grid shape of the Dirichlet Laplacian)")
    return make_poisson_fft(tuple(dims), dtype=dt,
                            scale=opts.get_real("pc_fft_scale", 1.0),
                            shift=opts.get_real("pc_fft_shift", 0.0),
                            device=dev)


def _make_spai(A, A_host, opts: Options, axis, dt, dev):
    from petsctpu_torch.pc.spai import make_spai

    _require_host(A_host, "spai")
    return make_spai(A_host, dtype=dt,
                     pattern_power=opts.get_int("pc_spai_nbsteps", 1),
                     max_pattern=opts.get_int("pc_spai_max", 64), device=dev)


# the slice-8 types, under petsctpu's option names and defaults
# (petsctpu/pc/api.py:131-286)
_SLICE8 = {
    "fieldsplit": _make_fieldsplit, "ksp": _make_ksp,
    "composite": _make_composite, "mat": _make_mat, "shell": _make_shell,
    "eisenstat": _make_eisenstat, "galerkin": _make_galerkin,
    "redistribute": _make_redistribute, "lsc": _make_lsc, "svd": _make_svd,
    "cp": _make_cp, "supportgraph": _make_supportgraph,
    "exotic": _make_exotic, "wb": _make_exotic, "tfs": _make_tfs,
    "spai": _make_spai,
}
# the PCs over the Mat formats (petsctpu/pc/api.py:202-216, :272)
_SLICE12 = {"nn": _make_nn, "bddc": _make_bddc, "fft": _make_fft}
