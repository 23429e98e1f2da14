"""PCASM — (restricted) additive Schwarz with overlap, and block Jacobi.

Counterpart of petsctpu/pc/asm.py (reference: src/ksp/pc/impls/asm/
asm.c, PCSetUp_ASM :175, PCApply_ASM :424; overlap growth as
MatIncreaseOverlap, src/mat/impls/aij/mpi/mpiov.c:17). Setup (host):
partition the rows into nb contiguous blocks, grow each block `overlap`
times through the matrix's connectivity, factor each subdomain with
ILU(0) or LU. Apply (device): gather the subdomains' slices, solve all
of them with one stacked triangular plan a triangle (one SpTRSV launch
for all nb subdomains, where the reference vmaps), and scatter with
full addition (basic) or owner-only writes (restricted, the reference's
default). Block Jacobi is the zero-overlap contiguous case, where the
gather and the scatter are a reshape.
"""

from __future__ import annotations

import numpy as np
import scipy.sparse as sp
import torch

from petsctpu_torch.core.options import Options
from petsctpu_torch.device import resolve_device
from petsctpu_torch.mat.base import csr_submatrix_keep_zeros
from petsctpu_torch.mat.factor import ilu0, lu_factor, stacked_sptrsv_plan
from petsctpu_torch.pc.factor import _tri_policy


def increase_overlap(A: sp.csr_matrix, idx: np.ndarray,
                     overlap: int) -> np.ndarray:
    """Grow an index set by matrix connectivity `overlap` times
    (MatIncreaseOverlap analog)."""
    idx = np.asarray(idx)
    for _ in range(overlap):
        cols = A[idx].indices
        idx = np.unique(np.concatenate([idx, cols]))
    return idx


class ASMPC:
    """idx/own/valid [nb, bmax]: subdomain rows (padding n), owner mask
    (restricted writes), non-padding mask; Lplans/Uplans stacked plans
    over the nb subdomains; perm_r/perm_c [nb, bmax] the LU (or
    ordering) permutations, used when use_perm; contiguous: the bjacobi
    shape, the padded-flat [nb, bmax] layout being the vector's."""

    def __init__(self, idx, own, valid, Lplans, Uplans, perm_r, perm_c,
                 n: int, restricted: bool = True, use_perm: bool = False,
                 contiguous: bool = False):
        self.idx = idx
        self.own = own
        self.valid = valid
        self.Lplans = Lplans
        self.Uplans = Uplans
        self.perm_r = perm_r
        self.perm_c = perm_c
        self.n = n
        self.restricted = restricted
        self.use_perm = use_perm
        self.contiguous = contiguous
        if not contiguous:
            mask = valid & own if restricted else valid
            self._tgt = torch.where(mask, idx, n).reshape(-1)
            self._mask = mask

    def apply(self, x):
        nb, bmax = self.idx.shape
        if self.contiguous:
            xs = x.new_zeros(nb * bmax)
            xs[:self.n] = x
            xs = xs.view(nb, bmax)
        else:
            xs = torch.cat([x, x.new_zeros(1)])[self.idx]
        if self.use_perm:
            xs = torch.zeros_like(xs).scatter_(1, self.perm_r, xs)
        ys = self.Uplans.solve(self.Lplans.solve(xs))
        if self.use_perm:
            ys = torch.gather(ys, 1, self.perm_c)
        if self.contiguous:
            return ys.reshape(-1)[:self.n]
        y = x.new_zeros(self.n + 1).index_add_(
            0, self._tgt, torch.where(self._mask, ys, 0).reshape(-1))
        return y[:self.n]


def _blocks(A, n, nblocks, overlap, blocks, outer):
    if blocks is not None:
        bases = [np.arange(b[0], b[1]) if isinstance(b, tuple)
                 else np.asarray(b) for b in blocks]
    else:
        bs = -(-n // nblocks)
        bases = [np.arange(k * bs, min((k + 1) * bs, n))
                 for k in range(nblocks)]
    out = []
    for k, base in enumerate(bases):
        if len(base) == 0:
            continue
        ext = (np.sort(np.asarray(outer[k])) if outer is not None
               else increase_overlap(A, base, overlap))
        out.append((base, ext))
    return out


def make_asm(A_host, nblocks: int = 4, overlap: int = 1,
             restricted: bool = True, sub_pc: str = "ilu", dtype=None,
             options: Options = None, blocks=None, outer=None,
             sub_ordering: str = "natural", tri: str = "auto",
             device=None) -> ASMPC:
    """blocks: explicit non-overlapping subdomains, (start, end) ranges
    or index arrays (PCASMSetLocalSubdomains; the default is the
    reference's equal split). outer: explicit overlapping subdomains
    paired with blocks (PCGASMSetSubdomains), skipping the overlap
    growth. sub_pc: "lu", or ILU(0) for any other value (as the
    reference). sub_ordering: each subdomain's ILU ordering
    (-sub_pc_factor_mat_ordering_type). tri (-sub_pc_factor_tri_solve):
    the subdomains solve by levels; band and band2 raise."""
    opts = options or Options()
    nblocks = opts.get_int("pc_asm_blocks", nblocks)
    overlap = opts.get_int("pc_asm_overlap", overlap)
    if opts.get_str("pc_asm_type", "restrict") == "basic":
        restricted = False
    sub_pc = opts.get_str("sub_pc_type", sub_pc)
    sub_ordering = opts.get_str("sub_pc_factor_mat_ordering_type",
                                sub_ordering)
    _tri_policy(opts.get_str("sub_pc_factor_tri_solve", tri))
    dev = resolve_device(device)

    A = sp.csr_matrix(A_host)
    n = A.shape[0]
    parts = _blocks(A, n, nblocks, overlap, blocks, outer)
    nb = len(parts)
    bmax = max(len(e) for _, e in parts)
    idx = np.full((nb, bmax), n, np.int64)
    own = np.zeros((nb, bmax), bool)
    valid = np.zeros((nb, bmax), bool)
    subs = []
    for k, (base, ext) in enumerate(parts):
        idx[k, :len(ext)] = ext
        valid[k, :len(ext)] = True
        own[k, :len(ext)] = np.isin(ext, base)
        # the subdomain matrix, padded to bmax with an identity tail
        Sub = csr_submatrix_keep_zeros(A, ext, ext)
        if len(ext) < bmax:
            Sub = sp.block_diag([Sub, sp.eye(bmax - len(ext))]).tocsr()
        subs.append(Sub)

    if sub_pc == "lu":
        facs = [lu_factor(S) for S in subs]
        Lp = stacked_sptrsv_plan([f[0] for f in facs], True, False, dtype,
                                 dev)
        Up = stacked_sptrsv_plan([f[1] for f in facs], False, False, dtype,
                                 dev)
        pr = np.stack([f[2] for f in facs])
        pcm = np.stack([f[3] for f in facs])
        use_perm = True
    else:
        Ls, Us, iperms = [], [], []
        for S in subs:
            if sub_ordering not in ("natural", ""):
                from petsctpu_torch.mat.order import get_ordering
                perm = get_ordering(S, sub_ordering)
                S = S[perm][:, perm].tocsr()
                iperms.append(np.argsort(perm))
            else:
                iperms.append(np.arange(S.shape[0]))
            L, U = ilu0(S)
            Ls.append(L)
            Us.append(U)
        Lp = stacked_sptrsv_plan(Ls, True, True, dtype, dev)
        Up = stacked_sptrsv_plan(Us, False, False, dtype, dev)
        # a symmetric permutation reuses the LU perm slots: pb[iperm[i]]
        # = b[i] permutes in, z[iperm] permutes back
        pr = pcm = np.stack(iperms)
        use_perm = sub_ordering not in ("natural", "")

    # the bjacobi shape: the padded-flat [nb, bmax] layout is the vector's
    expected = np.arange(nb * bmax).reshape(nb, bmax)
    contiguous = bool(
        np.array_equal(np.where(valid, idx, -1), np.where(valid, expected, -1))
        and valid.ravel()[:n].all() and not valid.ravel()[n:].any())

    def t(a):
        return torch.from_numpy(np.asarray(a)).to(dev)

    return ASMPC(t(idx), t(own), t(valid), Lp, Up,
                 t(pr.astype(np.int64)), t(pcm.astype(np.int64)), n,
                 restricted, use_perm, contiguous)
