"""GAMG — smoothed-aggregation algebraic multigrid.

Counterpart of petsctpu/pc/gamg.py (reference: src/ksp/pc/impls/gamg —
PCSetUp_GAMG gamg.c:533; strength graph PCGAMGgraph_AGG agg.c:927; MIS
aggregation PCGAMGCoarsen_AGG agg.c:977 + MatCoarsenApply_MIS mis.c:335;
smoothed prolongator PCGAMGProlongator_AGG agg.c:1110; Galerkin
MatPtAP gamg.c:156).

Setup is host-side graph work, as in the reference: filtered strength
graph → greedy root-based aggregation → tentative piecewise-constant
prolongator → Jacobi-smoothed P → PᵀAP coarse operator, recursively.
The hierarchy then runs on the device through pc/mg.py's algebraic MG.
The setup aggregates with the native copy of petsctpu's C++
(mat/host_graph.py::aggregate, built at first use; no fallback);
`aggregate` below is the plain Python loop the tests hold it to.

Elasticity takes pc/asa.py's multi-candidate hierarchy, as in
petsctpu: with pc_gamg_coordinates, the rigid-body modes of the nodes
(PCSetCoordinates_AGG agg.c:246); with pc_gamg_dof > 1 alone, the dof
translational vectors (the default null space of a blocked operator).
Either way aggregation runs on the dof-collapsed node graph.
"""

from __future__ import annotations

import numpy as np
import scipy.sparse as sp

from petsctpu_torch.core.logging import log_event, petsc_info
from petsctpu_torch.core.options import Options
from petsctpu_torch.mat import host_graph
from petsctpu_torch.pc.mg import (_power_lambda_max,
                                  make_algebraic_mg_from_hierarchy)


def strength_graph(A: sp.csr_matrix, theta: float) -> sp.csr_matrix:
    """Symmetrized filtered graph: keep |a_ij| > θ·sqrt(|a_ii·a_jj|)
    (agg.c:927 'filter' semantics)."""
    A = sp.csr_matrix(A)
    d = np.abs(A.diagonal())
    d = np.where(d > 0, d, 1.0)
    coo = A.tocoo()
    scale = np.sqrt(d[coo.row] * d[coo.col])
    keep = (np.abs(coo.data) > theta * scale) & (coo.row != coo.col)
    S = sp.coo_matrix((np.ones(keep.sum()), (coo.row[keep], coo.col[keep])),
                      shape=A.shape).tocsr()
    return ((S + S.T) > 0).astype(np.int8).tocsr()


def aggregate(S: sp.csr_matrix) -> np.ndarray:
    """Greedy root-based aggregation (the serial equivalent of MIS-based
    aggregation, mis.c:30 maxIndSetAgg): pass 1 picks independent roots
    and claims their neighborhoods; pass 2 attaches leftovers to an
    adjacent aggregate; pass 3 makes singletons."""
    n = S.shape[0]
    agg = np.full(n, -1, dtype=np.int64)
    ai, aj = S.indptr, S.indices
    na = 0
    for i in range(n):
        if agg[i] != -1:
            continue
        nbrs = aj[ai[i]:ai[i + 1]]
        if np.all(agg[nbrs] == -1):
            agg[i] = na
            agg[nbrs] = na
            na += 1
    for i in range(n):
        if agg[i] == -1:
            nbrs = aj[ai[i]:ai[i + 1]]
            owned = nbrs[agg[nbrs] != -1]
            if len(owned):
                agg[i] = agg[owned[0]]
    for i in range(n):
        if agg[i] == -1:
            agg[i] = na
            na += 1
    return agg


def aggregate_hem(S: sp.csr_matrix, rounds: int = 1) -> np.ndarray:
    """Heavy-edge-matching coarsening (MatCoarsen HEM, src/mat/coarsen/
    impls/hem): greedily match each vertex to its heaviest unmatched
    neighbor; matched pairs form aggregates, leftovers become
    singletons. `rounds` > 1 re-matches the pair graph for coarser
    aggregates (aggregate size up to 2^rounds)."""
    S = sp.csr_matrix(S)
    n = S.shape[0]
    agg = np.arange(n, dtype=np.int64)
    for _ in range(rounds):
        na = int(agg.max()) + 1
        C = sp.coo_matrix((np.abs(S.data),
                           (agg[sp.coo_matrix(S).row],
                            agg[sp.coo_matrix(S).col])),
                          shape=(na, na)).tocsr()
        C.setdiag(0)
        C.eliminate_zeros()
        matched = np.full(na, -1, np.int64)
        # visit heaviest edges first: sort vertices by max incident weight
        order = np.argsort(-np.asarray(C.max(axis=1).todense()).ravel())
        for v in order:
            if matched[v] != -1:
                continue
            lo, hi = C.indptr[v], C.indptr[v + 1]
            nbrs, w = C.indices[lo:hi], C.data[lo:hi]
            free = matched[nbrs] == -1
            if not free.any():
                matched[v] = v               # singleton
                continue
            u = nbrs[free][np.argmax(w[free])]
            matched[v] = v
            matched[u] = v
        roots = np.unique(matched)
        remap = np.empty(na, np.int64)
        remap[roots] = np.arange(len(roots))
        agg = remap[matched[agg]]
    return agg


def tentative_prolongator(agg: np.ndarray, nullspace: np.ndarray = None):
    """P0 from aggregates × near-null-space (constant vector by default),
    column-normalized (agg.c:1110)."""
    n = len(agg)
    na = int(agg.max()) + 1
    v = np.ones(n) if nullspace is None else np.asarray(nullspace)
    P0 = sp.coo_matrix((v, (np.arange(n), agg)), shape=(n, na)).tocsr()
    norms = np.sqrt(np.asarray(P0.multiply(P0).sum(axis=0))).ravel()
    norms = np.where(norms > 0, norms, 1.0)
    return (P0 @ sp.diags(1.0 / norms)).tocsr()


def smooth_prolongator(A: sp.csr_matrix, P0: sp.csr_matrix) -> sp.csr_matrix:
    """P = (I − ω D⁻¹A) P0 with ω = 4/(3 λmax(D⁻¹A)) (agg.c optprol)."""
    d = A.diagonal()
    d = np.where(d != 0, d, 1.0)
    dinv = 1.0 / d
    lam = _power_lambda_max(A, dinv)
    omega = 4.0 / (3.0 * max(lam, 1e-12))
    DA = sp.diags(dinv) @ A
    return (P0 - omega * (DA @ P0)).tocsr()


def gamg_hierarchy(A, theta: float = 0.0, coarse_n: int = 64,
                   max_levels: int = 10, smooth: bool = True,
                   nullspace=None, coarsen: str = "mis"):
    """Build (As, Ps): As[0]=A fine … As[-1] coarsest; Ps[l]: l+1 → l.
    coarsen: 'mis' (MIS aggregation) or 'hem' (heavy-edge matching,
    2 rounds ≈ size-4 aggregates)."""
    As = [sp.csr_matrix(A)]
    Ps = []
    nsp = nullspace
    while As[-1].shape[0] > coarse_n and len(As) < max_levels:
        Ac = As[-1]
        S = strength_graph(Ac, theta)
        agg = (aggregate_hem(Ac, rounds=2) if coarsen == "hem"
               else host_graph.aggregate(S))
        na = int(agg.max()) + 1
        if na >= Ac.shape[0]:        # no coarsening progress
            break
        # relabel aggregates by first fine-row occurrence: a column
        # permutation of P that keeps the fine level's locality in the
        # coarse numbering, so every level and both transfer directions
        # stay SELL/slant-band friendly (createLevel gamg.c:174-198)
        first = np.full(na, len(agg), np.int64)
        np.minimum.at(first, agg, np.arange(len(agg)))
        relabel = np.empty(na, np.int64)
        relabel[np.argsort(first, kind="stable")] = np.arange(na)
        agg = relabel[agg]
        P0 = tentative_prolongator(agg, nsp)
        P = smooth_prolongator(Ac, P0) if smooth else P0
        As.append((P.T @ Ac @ P).tocsr())
        Ps.append(P)
        nsp = None                   # constant-vector null space propagates
    return As, Ps


def rigid_body_modes(coords: np.ndarray, dof: int = None) -> np.ndarray:
    """Near-null space of elasticity from node coordinates
    (PCSetCoordinates_AGG agg.c:246): 2-D → 3 modes (tx, ty, rot),
    3-D → 6. Returns (ndof_total, nmodes)."""
    coords = np.asarray(coords, np.float64)
    n, dim = coords.shape
    dof = dof or dim
    if dim == 2:
        B = np.zeros((n * dof, 3))
        B[0::dof, 0] = 1.0
        B[1::dof, 1] = 1.0
        B[0::dof, 2] = -coords[:, 1]
        B[1::dof, 2] = coords[:, 0]
    else:
        B = np.zeros((n * dof, 6))
        for k in range(3):
            B[k::dof, k] = 1.0
        x, y, z = coords[:, 0], coords[:, 1], coords[:, 2]
        B[1::dof, 3], B[2::dof, 3] = -z, y       # rot x
        B[0::dof, 4], B[2::dof, 4] = z, -x       # rot y
        B[0::dof, 5], B[1::dof, 5] = -y, x       # rot z
    q, _ = np.linalg.qr(B)
    return q


def make_gamg(A_host, dtype=None, options: Options = None, device=None):
    """PCGAMG factory (PCSetUp_GAMG analog). Options key
    'pc_gamg_coordinates' (node coords array) activates rigid-body-mode
    candidates via the multi-candidate block prolongator
    (PCSetCoordinates_AGG agg.c:246); pc_gamg_dof > 1 alone takes the
    dof translational vectors. The hierarchy is timed under the log
    event PCGAMGHierarchy."""
    from petsctpu_torch.pc.asa import asa_hierarchy

    opts = options or Options()
    theta = opts.get_real("pc_gamg_threshold", 0.0)
    coarse_n = opts.get_int("pc_gamg_coarse_eq_limit", 64)
    max_levels = opts.get_int("pc_mg_levels", 10)
    smooth = opts.get_int("pc_gamg_agg_nsmooths", 1) > 0
    sm_its = opts.get_int("mg_levels_ksp_max_it", 2)
    coords = opts.get("pc_gamg_coordinates")
    dof = opts.get_int("pc_gamg_dof", 0)
    with log_event("PCGAMGHierarchy"):
        if coords is not None:
            B = rigid_body_modes(np.asarray(coords), dof=dof or None)
            As, Ps = asa_hierarchy(A_host, B, theta=theta,
                                   coarse_n=coarse_n, max_levels=max_levels,
                                   smooth=smooth, bs=dof or 1)
        elif dof > 1:
            n = sp.csr_matrix(A_host).shape[0]
            B = np.tile(np.eye(dof), (n // dof, 1))
            As, Ps = asa_hierarchy(A_host, B, theta=theta,
                                   coarse_n=coarse_n, max_levels=max_levels,
                                   smooth=smooth, bs=dof)
        else:
            As, Ps = gamg_hierarchy(
                A_host, theta=theta, coarse_n=coarse_n,
                max_levels=max_levels, smooth=smooth,
                coarsen=opts.get_str("pc_gamg_coarsen_type", "mis"))
    petsc_info("PCSetUp_GAMG",
               "level sizes " + " -> ".join(str(a.shape[0]) for a in As))
    return make_algebraic_mg_from_hierarchy(
        As, Ps, dtype=dtype, sm_its=sm_its,
        fmt=opts.get_str("pc_gamg_mat_type", "auto"),
        cycles=2 if opts.get_str("pc_mg_cycle_type", "v") == "w" else 1,
        mg_type=opts.get_str("pc_mg_type", "multiplicative"), device=device)
