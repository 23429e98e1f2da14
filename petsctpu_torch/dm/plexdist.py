"""Distributed Plex: partitioned unstructured FEM assembly over a World.

Counterpart of petsctpu/dm/plexdist.py (reference: DMPlexDistribute,
partition cells and ship closures, with MatSetValues stashing of
off-process rows, src/mat/utils/matstash.c). The symbolic work is a
host plan, made once:

  * partition the cells (multilevel k-way on the cell dual graph,
    mat/partition.py), give each vertex to the lowest part that touches
    it and renumber the vertices by owner;
  * assemble the pattern once (the serial fem_assemble_poisson on the
    renumbered mesh), shard it (parallel/pmat.py);
  * freeze a static entry route: every element-matrix entry knows its
    destination rank and its slot in that rank's ELL storage (the
    MatStash, precomputed), built with array operations.

`assembled(world, kappa)` then runs on the device of every rank: the
rank's element kernels, one all_to_all (the stash flush), and the sum
into its ELL slots, folded (mat/fold.py) in petsctpu's slot order (its
`.at[slot].add`), into a ShardedAIJ whose diagonal blocks the ELL kernel
multiplies. New cell coefficients need no host work.
"""

from __future__ import annotations

import time

import numpy as np
import scipy.sparse as sp
import torch

from petsctpu_torch.core.logging import log_event
from petsctpu_torch.device import np_dtype, resolve_device
from petsctpu_torch.dm.plex import (fem_assemble_poisson,
                                    p1_element_stiffness,
                                    p1_element_stiffness_3d,
                                    q1_element_stiffness,
                                    q1_element_stiffness_3d)
from petsctpu_torch.mat.fold import fold_plan

# the element kernel of a cell type, by (nodes a cell, dimension)
_KERNELS = {(3, 2): p1_element_stiffness, (4, 3): p1_element_stiffness_3d,
            (4, 2): q1_element_stiffness, (8, 3): q1_element_stiffness_3d}


class DistPlex:
    """The frozen distributed-assembly plan of a Plex and its sharded
    operator template. Per rank p (lists, on the device): cell_coords[p]
    [ncmax, npc, dim], cell_mask[p] [ncmax] (1 real, 0 padding),
    send_idx[p] [P, emax] (its entries sent to each rank, padding the
    appended zero entry), recv_slot[p] [P·emax] (the ELL flat slot of
    each received entry; F = dropped), base_flat[p] [F + 1] (the
    template's values at the slots no element writes: Dirichlet and pad
    identity rows). template: the ShardedAIJ of the host assembly; b:
    the padded load vector (host); perm: new vertex id of each old one."""

    def __init__(self, cell_coords, cell_mask, send_idx, recv_slot,
                 base_flat, template, b, perm, nparts, npc, cell_order):
        self.cell_coords = cell_coords
        self.cell_mask = cell_mask
        self.send_idx = send_idx
        self.recv_slot = recv_slot
        self.base_flat = base_flat
        self.template = template
        self.b = b
        self.perm = perm
        self.nparts = nparts
        self.npc = npc
        self.cell_order = cell_order
        self.timings = {}
        self._folds = {}

    @property
    def K1(self) -> int:
        return self.template.diag_cols[0].shape[1]

    @property
    def K2(self) -> int:
        return self.template.off_cols[0].shape[1]

    @property
    def s(self) -> int:
        return self.template.nloc

    def assemble_local(self, comm, kappa_loc: torch.Tensor):
        """On rank comm.rank: (diag_vals, off_vals) of its rows from its
        cells' element matrices scaled by kappa_loc [ncmax]."""
        p = comm.rank
        coords = self.cell_coords[p]
        ker = _KERNELS[(self.npc, coords.shape[-1])]
        Ke = ker(coords)                                # [ncmax, npc, npc]
        ent = (Ke * (kappa_loc * self.cell_mask[p])[:, None, None]) \
            .reshape(-1)
        ent = torch.cat([ent, ent.new_zeros(1)])
        recv = comm.all_to_all(ent[self.send_idx[p]])  # the stash flush
        F = self.s * (self.K1 + self.K2)
        if p not in self._folds:
            # the padding's slot F (dropped) left out of the plan: else
            # every pad entry would be one more rank of the fold
            self._folds[p] = fold_plan(self.recv_slot[p],
                                       self.recv_slot[p] < F)
        flat = self._folds[p].fold(self.base_flat[p], recv.reshape(-1))[:F]
        dv = flat[: self.s * self.K1].reshape(self.s, self.K1)
        ov = flat[self.s * self.K1:].reshape(self.s, self.K2)
        return dv.contiguous(), ov.contiguous()

    def assembled(self, world, kappa=None):
        """One device assembly over the World's ranks -> a ShardedAIJ.
        kappa: [nc] per-cell coefficients in the mesh's cell order (None:
        ones)."""
        from petsctpu_torch.mat.ell import AIJ
        from petsctpu_torch.parallel.pmat import ShardedAIJ

        T = self.template
        P, ncmax = self.nparts, self.cell_mask[0].shape[0]
        dt, dev = self.cell_coords[0].dtype, self.cell_coords[0].device
        if kappa is None:
            kaps = [torch.ones(ncmax, dtype=dt, device=dev)
                    for _ in range(P)]
        else:
            k = np.asarray(kappa)[self.cell_order].reshape(P, ncmax)
            kaps = [torch.from_numpy(np.ascontiguousarray(k[p])).to(dev, dt)
                    for p in range(P)]
        with log_event("DMPlexDistAssembly"):
            out = world.run(self.assemble_local, [(k,) for k in kaps])
        dvs = [o[0] for o in out]
        ovs = [o[1] for o in out]
        ops = [AIJ(op.cols, dv, op.shape, op.nnz)
               for op, dv in zip(T.diag_ops, dvs)]
        return ShardedAIJ(T.diag_cols, dvs, T.off_cols, ovs, T.send_idx,
                          T.ghost_src, T.ghost_gidx, T.shape, T.nshards,
                          T.style, T.nnz, T.offsets, ops, T.fmt)


def _renumber_by_owner(plex, nparts: int, cell_part: np.ndarray):
    """Vertex owner = the lowest cell part touching it; vertices
    renumbered grouped by owner. Returns (order: old ids in new order,
    vnew: the new id of each old vertex, owner)."""
    nv = plex.num_vertices
    owner = np.full(nv, nparts, np.int64)
    for p in range(nparts):
        vs = np.unique(plex.cells[cell_part == p])
        owner[vs] = np.minimum(owner[vs], p)
    owner[owner == nparts] = 0          # isolated vertices -> rank 0
    order = np.argsort(owner, kind="stable")
    vnew = np.empty(nv, np.int64)
    vnew[order] = np.arange(nv)
    return order, vnew, owner


def _slots(t, gi, gj, s, K1, K2, part):
    """The ELL flat slot, in rank t's storage, of each entry (gi, gj)
    (petsctpu's slot_of, over arrays): li·K1 + k in the diagonal block,
    s·K1 + li·K2 + k in the off block, k the column's place in its row."""
    P = len(part.diag_blocks)
    li = gi - t * s
    diag = (gj >= t * s) & (gj < (t + 1) * s)
    out = np.empty(len(gi), np.int64)

    def lookup(blocks, qt, qrow, qcol, ncol):
        keys, pos = [], []
        for b in range(P):
            B = sp.csr_matrix(blocks[b], copy=True)
            B.sort_indices()                 # the ELL pack's slot order
            rows = np.repeat(np.arange(B.shape[0]), np.diff(B.indptr))
            keys.append((b * s + rows) * ncol + B.indices)
            pos.append(np.arange(B.nnz) - B.indptr[rows])
        keys, pos = np.concatenate(keys), np.concatenate(pos)
        q = (qt * s + qrow) * ncol + qcol
        j = np.searchsorted(keys, q)
        assert np.all(j < len(keys)) and np.all(keys[np.minimum(
            j, len(keys) - 1)] == q), "an entry outside the pattern"
        return pos[j]

    out[diag] = li[diag] * K1 + lookup(part.diag_blocks, t[diag], li[diag],
                                       gj[diag] - t[diag] * s, s)
    off = ~diag
    if off.any():
        G = max(len(g) for g in part.garrays) + 1
        gkeys = np.concatenate([b * (P * s + 1) + np.asarray(g)
                                for b, g in enumerate(part.garrays)])
        gstart = np.cumsum([0] + [len(g) for g in part.garrays])
        q = t[off] * (P * s + 1) + gj[off]
        j = np.searchsorted(gkeys, q)
        assert np.all(gkeys[np.minimum(j, len(gkeys) - 1)] == q), \
            "a ghost outside the garray"
        gs = j - gstart[t[off]]
        out[off] = s * K1 + li[off] * K2 + lookup(
            part.off_blocks, t[off], li[off], gs, G)
    return out


def distribute_plex(plex, nparts: int, dtype=np.float64, f=None,
                    bc_label=None, device=None) -> DistPlex:
    """The DistPlex plan for −Δu = f with a Dirichlet boundary (the
    topological boundary, or bc_label = (name, values): the vertices of
    those label values, remapped through the renumbering, as
    DMPlexDistribute carries labels, plex.c:3097). The serial
    fem_assemble_poisson on the renumbered mesh is the pattern and BC
    oracle; the plan reproduces its values on the device, sharded.
    dp.timings splits the host plan by part."""
    from petsctpu_torch.mat.partition import partition_kway
    from petsctpu_torch.parallel.pmat import sharded_aij_from_scipy

    dev = resolve_device(device)
    dtype = np_dtype(dtype).type
    tdt = torch.float64 if dtype == np.float64 else torch.float32
    timings = {}
    cells = plex.cells
    nc, npc = cells.shape
    nv = plex.num_vertices
    dim = plex.coords.shape[1]

    t = time.perf_counter()
    # 1. the cell partition on the cell dual graph (shared vertices)
    B = sp.coo_matrix((np.ones(nc * npc), (np.repeat(np.arange(nc), npc),
                                           cells.reshape(-1))),
                      shape=(nc, nv)).tocsr()
    cell_part = (partition_kway((B @ B.T).tocsr(), nparts) if nparts > 1
                 else np.zeros(nc, np.int32))
    timings["partition"] = time.perf_counter() - t

    # 2. the vertices renumbered by owner
    t = time.perf_counter()
    order, vnew, _ = _renumber_by_owner(plex, nparts, cell_part)
    plex_perm = type(plex)(vnew[cells].astype(cells.dtype),
                           plex.coords[order])
    section = None
    if bc_label is not None:
        from petsctpu_torch.dm.label import get_label, label_vertices
        from petsctpu_torch.dm.section import vertex_section
        name, vals = bc_label
        lab = get_label(plex, name)
        if lab is None:
            raise ValueError(f"no label {name!r} on this Plex")
        bnd = np.sort(vnew[label_vertices(plex, lab, vals)])
        section = vertex_section(nv, dof=1, constrained=bnd)
    else:
        bnd = plex_perm.boundary_vertices()
    timings["renumber"] = time.perf_counter() - t

    # 3. the pattern and BC oracle: the serial assembly, sharded
    t = time.perf_counter()
    _, Ah, b_host = fem_assemble_poisson(plex_perm, f=f, dtype=dtype,
                                         section=section, device=dev)
    timings["host assembly"] = time.perf_counter() - t
    t = time.perf_counter()
    mat, part = sharded_aij_from_scipy(Ah, nparts, dtype=dtype, device=dev)
    timings["shard"] = time.perf_counter() - t
    s = part.layout.shard_size
    K1, K2 = mat.diag_cols[0].shape[1], mat.off_cols[0].shape[1]
    F = s * (K1 + K2)
    con = np.zeros(nv, bool)
    con[bnd] = True

    # 4. per-rank padded cell arrays (renumbered vertex ids)
    t = time.perf_counter()
    cells_new = vnew[cells]
    by_part = [np.flatnonzero(cell_part == p) for p in range(nparts)]
    ncmax = max(max(len(ix) for ix in by_part), 1)
    cell_coords = np.zeros((nparts, ncmax, npc, dim), dtype)
    cell_mask = np.zeros((nparts, ncmax), dtype)
    cell_order = np.zeros(nparts * ncmax, np.int64)
    pad_cell = plex_perm.coords[cells_new[0]]   # a valid geometry: the
    for p, ix in enumerate(by_part):            # padding's Ke must be
        k = len(ix)                             # finite (masked later)
        cell_coords[p, k:] = pad_cell
        if k:
            cell_coords[p, :k] = plex_perm.coords[cells_new[ix]]
            cell_mask[p, :k] = 1.0
            cell_order[p * ncmax: p * ncmax + k] = ix
            cell_order[p * ncmax + k: (p + 1) * ncmax] = ix[0]

    # 5. the entry route: (rank p, cell c, i, j) -> destination rank t
    # and ELL flat slot; constrained rows and columns dropped (their
    # identity is in base_flat)
    nent = ncmax * npc * npc
    sends, slots = [], []
    for p, ix in enumerate(by_part):
        vc = cells_new[ix]                               # [k, npc]
        gi = np.repeat(vc, npc, axis=1).reshape(-1)      # (c, a, b) order
        gj = np.tile(vc, (1, npc)).reshape(-1)
        eidx = np.arange(gi.size)
        keep = ~con[gi] & ~con[gj]
        gi, gj, eidx = gi[keep], gj[keep], eidx[keep]
        tt = gi // s
        slot = _slots(tt, gi, gj, s, K1, K2, part)
        by_t = np.argsort(tt, kind="stable")
        cnt = np.bincount(tt, minlength=nparts)
        sends.append(np.split(eidx[by_t], np.cumsum(cnt)[:-1]))
        slots.append(np.split(slot[by_t], np.cumsum(cnt)[:-1]))
    emax = max(max(len(x) for x in sl) for sl in sends)
    emax = max(emax, 1)
    send_idx = np.full((nparts, nparts, emax), nent, np.int64)
    recv_slot = np.full((nparts, nparts * emax), F, np.int64)
    for p in range(nparts):
        for t_ in range(nparts):
            k = len(sends[p][t_])
            send_idx[p, t_, :k] = sends[p][t_]
            recv_slot[t_, p * emax: p * emax + k] = slots[p][t_]

    # 6. base values: the host template less every routed slot
    base = np.zeros((nparts, F + 1), dtype)
    for p in range(nparts):
        base[p, :s * K1] = mat.diag_vals[p].cpu().numpy().reshape(-1)
        base[p, s * K1:F] = mat.off_vals[p].cpu().numpy().reshape(-1)
        rs = recv_slot[p]
        base[p, rs[rs < F]] = 0.0
    b_sh = np.zeros(part.layout.n_padded, dtype)
    b_sh[:nv] = b_host.cpu().numpy()
    timings["route"] = time.perf_counter() - t

    def put(a, dt=None):
        return [torch.from_numpy(np.ascontiguousarray(a[p])).to(dev, dt)
                for p in range(nparts)]

    dp = DistPlex(put(cell_coords, tdt), put(cell_mask, tdt), put(send_idx),
                  put(recv_slot), put(base, tdt), mat, b_sh, vnew, nparts,
                  npc, cell_order)
    dp.timings = timings
    return dp
