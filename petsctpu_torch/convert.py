"""Carry state across from petsctpu: its arrays (as numpy) in, the
port's objects out.

This module imports nothing of petsctpu. Callers hand it the arrays
they took from the JAX objects (`np.asarray` of each field), or the
host pack that `sell_pack` returns, in either package.
"""

from __future__ import annotations

import numpy as np
import torch

from petsctpu_torch.core.logging import log_event
from petsctpu_torch.device import resolve_device
from petsctpu_torch.mat.ell import AIJ
from petsctpu_torch.mat.sell import SellMat
from petsctpu_torch.mat.stencil import StencilMat
from petsctpu_torch.pc.simple import JacobiPC


def _tensor(a, dev, dtype=None) -> torch.Tensor:
    # np.array copies: the arrays of a JAX object are read-only views
    return torch.from_numpy(np.array(a)).to(dev, dtype)


def sell_from_arrays(arrays: dict, statics: dict, device=None) -> SellMat:
    """A SellMat from the `(arrays, statics)` pair of `sell_pack`:
    arrays {vals f32, idx i8, qs i32, winstart i32, diag f32}, statics
    {shape, nnz, G, S, Lp, mode}."""
    dev = resolve_device(device)
    return SellMat(_tensor(arrays["vals"], dev, torch.float32),
                   _tensor(arrays["idx"], dev, torch.int8),
                   _tensor(arrays["qs"], dev, torch.int32),
                   _tensor(arrays["winstart"], dev, torch.int32),
                   _tensor(arrays["diag"], dev, torch.float32),
                   tuple(statics["shape"]), int(statics["nnz"]),
                   int(statics["G"]), int(statics["S"]), int(statics["Lp"]),
                   statics.get("mode", "diag"))


def aij_from_arrays(cols, vals, shape, nnz, device=None) -> AIJ:
    """An AIJ from ELL arrays cols [m,K] (stored int32) and vals [m,K]."""
    dev = resolve_device(device)
    return AIJ(_tensor(cols, dev, torch.int32), _tensor(vals, dev),
               tuple(shape), int(nnz))


def baij_from_arrays(cols, vals, shape, bs: int, nnz: int, device=None):
    """A BAIJ from block-ELL arrays cols [brows, K] (stored int32) and
    vals [brows, K, bs, bs]."""
    from petsctpu_torch.mat.bsr import BAIJ

    dev = resolve_device(device)
    return BAIJ(_tensor(cols, dev, torch.int32), _tensor(vals, dev),
                tuple(shape), int(bs), int(nnz))


def sbaij_from_arrays(bcols, bvals, shape, bs: int, nnzb: int,
                      device=None):
    """An SBAIJ from its upper block-ELL arrays."""
    from petsctpu_torch.mat.sbaij import SBAIJ

    dev = resolve_device(device)
    return SBAIJ(_tensor(bcols, dev, torch.int32), _tensor(bvals, dev),
                 tuple(shape), int(bs), int(nnzb))


def band_from_arrays(tiles, bandwidth: int, tile: int, shape, nnz: int,
                     device=None):
    """A BandMat from its tiles [nt, T, T + 2B]."""
    from petsctpu_torch.mat.band import BandMat

    return BandMat(_tensor(tiles, resolve_device(device)), bandwidth, tile,
                   tuple(shape), nnz)


def dia_from_arrays(coeffs, offsets, shape, nnz: int, device=None):
    """A DiaMat from its diagonals [D, n] and their offsets."""
    from petsctpu_torch.mat.dia import DiaMat

    return DiaMat(_tensor(coeffs, resolve_device(device)), offsets,
                  tuple(shape), nnz)


def jacobi_from_arrays(dinv, device=None) -> JacobiPC:
    """A JacobiPC from its inverse diagonal."""
    return JacobiPC(_tensor(dinv, resolve_device(device)))


def stencil_from_arrays(coeffs, offsets, grid, boundary=(),
                        device=None) -> StencilMat:
    """A StencilMat from its coefficient planes [D, *grid] and statics."""
    return StencilMat(_tensor(coeffs, resolve_device(device)), offsets,
                      grid, boundary)


def mg_from_arrays(levels, coarse, cycles: int = 1,
                   mg_type: str = "multiplicative", device=None):
    """An MGPC from each level's state, fine first.

    levels: one dict a level with the operator's `coeffs`, `offsets`,
    `grid` and `boundary`, the smoother's `dinv`, `emin`, `emax` and
    `its`, and the next coarser `coarse_grid` (the Q1 prolongation).
    coarse: the coarsest operator's `coeffs`, `offsets`, `grid` and
    `boundary`, and its SuperLU factors `L`, `U` (scipy), `perm_r` and
    `perm_c`."""
    from petsctpu_torch.dm.da import Q1Interp
    from petsctpu_torch.pc.factor import lupc_from_factors
    from petsctpu_torch.pc.mg import ChebySmoother, MGLevel, MGPC

    dev = resolve_device(device)

    def op(s):
        return stencil_from_arrays(s["coeffs"], s["offsets"], s["grid"],
                                   s.get("boundary", ()), dev)

    mg_levels = []
    for lv in levels:
        A = op(lv)
        mg_levels.append(MGLevel(
            A, Q1Interp(A.grid, lv["coarse_grid"]),
            ChebySmoother(_tensor(lv["dinv"], dev), float(lv["emin"]),
                          float(lv["emax"]), int(lv["its"]))))
    coarse_A = op(coarse)
    lu = lupc_from_factors(coarse["L"], coarse["U"], coarse["perm_r"],
                           coarse["perm_c"], dtype=coarse_A.dtype,
                           device=dev)
    return MGPC(tuple(mg_levels), lu, coarse_A, cycles, mg_type)


def mg_from_packed(fbuf, ibuf, metas, coarse_meta, sm_its: int = 2,
                   cycles: int = 1, mg_type: str = "multiplicative",
                   device=None):
    """An MGPC from a packed algebraic hierarchy: the two flat buffers
    and the static metas of petsctpu's PackedMGPC (fbuf, ibuf as numpy,
    metas, coarse_meta), or what pc.mg.pack_hierarchy returns.

    Each buffer goes to the device in one copy; every operator is a
    view of it, carved at the metas' offsets as PackedMGPC.unpack
    carves them: "sell" (the int8 idx read from its int32 words; vals
    copied out when its offset is not 16-byte aligned, as K2 needs),
    "dense", "rectband" and "ell" operators (an ELL operator's int32
    cols and its vals copied out likewise, for the ELL kernel's bulk
    copies), Chebyshev+Jacobi smoothers
    with bounds 0.1·λ and 1.1·λ rounded in the buffer's dtype, an ELL
    coarsest operator and its dense LU (DenseLUPC). A level that
    restricts through P.multT (no restriction meta) builds P's transpose
    plan here, under the log event PCMGTransposePlan."""
    from petsctpu_torch.mat.dense import Dense
    from petsctpu_torch.mat.rectband import RectBandMat
    from petsctpu_torch.pc.gamg_device import DenseLUPC
    from petsctpu_torch.pc.mg import ChebySmoother, MGLevel, MGPC

    dev = resolve_device(device)
    sdt = np.asarray(fbuf).dtype.type
    fb = _tensor(fbuf, dev)
    ib = _tensor(ibuf, dev, torch.int32)

    def getf(off_shape):
        off, shape = off_shape
        return fb[off:off + int(np.prod(shape))].view(tuple(shape))

    def geti(off_shape):
        off, shape = off_shape
        return ib[off:off + int(np.prod(shape))].view(tuple(shape))

    def aligned(t):                       # K2's float4, ELL's bulk copies
        return t.clone() if t.data_ptr() % 16 else t

    def op(ref):
        kind = ref[0]
        if kind == "ell":
            _, ci, vi, sha, nza = ref
            return AIJ(aligned(geti(ci)), aligned(getf(vi)), sha, nza)
        if kind == "rectband":
            _, bref, s_, off_, sha, nnz, bshape = ref
            return RectBandMat(getf((bref[0], bshape)), s_, off_, sha, nnz)
        if kind == "dense":
            _, dref, sha, _ = ref
            return Dense(getf((dref[0], sha)))
        (_, vi, ii, qi, wi, di, sha, nnz, G, S, Lp, vshape, mode) = ref
        words = int(np.prod(vshape)) // 4
        idx = geti((ii[0], (words,))).view(torch.int8).view(tuple(vshape))
        return SellMat(aligned(getf((vi[0], vshape))), idx,
                       geti((qi[0], vshape[:2])), geti((wi[0], (vshape[0],))),
                       getf((di[0], (sha[0],))), sha, nnz, G, S, Lp, mode)

    levels = []
    for amref, pref, rref, do, lam in metas:
        A, P = op(amref), op(pref)
        if rref is None:                  # restricts through P.multT (K3)
            with log_event("PCMGTransposePlan"):
                P.transpose_plan()
        dinv = getf((do, (A.shape[0],)))
        levels.append(MGLevel(A, P, ChebySmoother(
            dinv, sdt(0.1 * lam), sdt(1.1 * lam), sm_its),
            None if rref is None else op(rref)))
    ci, vi, shc, nzc, lum, pivo = coarse_meta
    coarse_A = AIJ(aligned(geti(ci)), aligned(getf(vi)), shc, nzc)
    coarse = DenseLUPC(getf(lum), geti((pivo, (shc[0],))))
    return MGPC(tuple(levels), coarse, coarse_A, cycles, mg_type)


def sptrsv_from_arrays(level_rows, cols, vals, dinv, n: int, nlev: int,
                       device=None):
    """A SpTRSVPlan from petsctpu's plan arrays (level_rows, cols int32;
    vals, dinv), a plan or nb stacked ones (a leading axis)."""
    from petsctpu_torch.mat.factor import SpTRSVPlan

    return SpTRSVPlan(np.asarray(level_rows, np.int32),
                      np.asarray(cols, np.int32), np.asarray(vals),
                      np.asarray(dinv), int(n), int(nlev), device=device)


def _plan(p: dict, dev):
    return sptrsv_from_arrays(p["level_rows"], p["cols"], p["vals"],
                              p["dinv"], p["n"], p["nlev"], dev)


def ilu_from_arrays(L: dict, U: dict, LT: dict = None, UT: dict = None,
                    perm=None, device=None):
    """An ILUPC from petsctpu's L and U plans (each a dict of its arrays
    and statics), an ILUPCT with the transpose plans LT (of Lᵀ, upper)
    and UT (of Uᵀ, lower), and a PermutedPC around it given the
    ordering's perm."""
    from petsctpu_torch.pc.factor import ILUPC, ILUPCT, PermutedPC

    dev = resolve_device(device)
    pc = (ILUPC(_plan(L, dev), _plan(U, dev)) if LT is None else
          ILUPCT(_plan(L, dev), _plan(U, dev), _plan(LT, dev),
                 _plan(UT, dev)))
    return pc if perm is None else PermutedPC(pc, _tensor(perm, dev,
                                                          torch.int64))


def icc_from_arrays(L: dict, U: dict, dinv, perm=None, device=None):
    """An ICCPC from petsctpu's plans of Uᵀ (L) and U and 1/d."""
    from petsctpu_torch.pc.factor import ICCPC, PermutedPC

    dev = resolve_device(device)
    pc = ICCPC(_plan(L, dev), _plan(U, dev), _tensor(dinv, dev))
    return pc if perm is None else PermutedPC(pc, _tensor(perm, dev,
                                                          torch.int64))


def sor_from_arrays(fwd: dict, bwd: dict, U_ell: tuple, L_ell: tuple, diag,
                    omega: float, sweeps: int, symmetric: bool,
                    device=None):
    """A SORPC from petsctpu's two sweep plans, its strict triangles as
    ELL (cols, vals, shape, nnz) and its diagonal."""
    from petsctpu_torch.pc.sor import SORPC

    dev = resolve_device(device)
    return SORPC(_plan(fwd, dev), _plan(bwd, dev),
                 aij_from_arrays(*U_ell, device=dev),
                 aij_from_arrays(*L_ell, device=dev), _tensor(diag, dev),
                 float(omega), int(sweeps), bool(symmetric))


def asm_from_arrays(idx, own, valid, L: dict, U: dict, perm_r, perm_c,
                    n: int, restricted: bool, use_perm: bool,
                    contiguous: bool, device=None):
    """An ASMPC from petsctpu's subdomain index arrays and its stacked
    L and U plans (a leading subdomain axis on every plan array)."""
    from petsctpu_torch.pc.asm import ASMPC

    dev = resolve_device(device)
    return ASMPC(_tensor(idx, dev, torch.int64), _tensor(own, dev),
                 _tensor(valid, dev), _plan(L, dev), _plan(U, dev),
                 _tensor(perm_r, dev, torch.int64),
                 _tensor(perm_c, dev, torch.int64), int(n),
                 bool(restricted), bool(use_perm), bool(contiguous))


def svd_from_arrays(U, sinv, Vt, device=None):
    """An SVDPC from petsctpu's U, Σ⁺ (sinv) and Vᵀ."""
    from petsctpu_torch.pc.extra import SVDPC

    dev = resolve_device(device)
    return SVDPC(_tensor(U, dev), _tensor(sinv, dev), _tensor(Vt, dev))


def tfs_from_arrays(X, device=None):
    """A TFSPC from petsctpu's XXT factor X."""
    from petsctpu_torch.pc.exotic import TFSPC

    return TFSPC(_tensor(X, resolve_device(device)))


def eisenstat_from_arrays(L: dict, U: dict, d, omega: float = 1.0,
                          device=None):
    """The Eisenstat system (shell, pc, presolve, postsolve) from
    petsctpu's plans of E+L and E+U (each a dict of its arrays and
    statics) and the diagonal d."""
    from petsctpu_torch.pc.extra import eisenstat_system

    dev = resolve_device(device)
    return eisenstat_system(_plan(L, dev), _plan(U, dev), _tensor(d, dev),
                            omega)


def fieldsplit_from_arrays(isa, isb, blocks, pc0, pc1, n: int,
                           fs_type: str, schur_fact: str = "full",
                           amat_blocks=None, device=None):
    """A FieldSplitPC from petsctpu's field indices, its pmat blocks
    A00, A01, A10, A11 (each the ELL (cols, vals, shape, nnz) of an AIJ),
    the port's sub-PCs pc0 and pc1 (built from their own state), and,
    for an (Amat, Pmat) split, the amat blocks A00a, A01a, A10a."""
    from petsctpu_torch.pc.fieldsplit import FieldSplitPC

    dev = resolve_device(device)
    ops = [aij_from_arrays(*b, device=dev) for b in blocks]
    amat = ([None] * 3 if amat_blocks is None else
            [aij_from_arrays(*b, device=dev) for b in amat_blocks])
    return FieldSplitPC(_tensor(isa, dev, torch.int64),
                        _tensor(isb, dev, torch.int64), *ops, pc0, pc1,
                        int(n), fs_type=fs_type, schur_fact=schur_fact,
                        A00a=amat[0], A01a=amat[1], A10a=amat[2])
