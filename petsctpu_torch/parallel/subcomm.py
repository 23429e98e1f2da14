"""Subcommunicator nesting — sub-groups of a World's ranks.

Counterpart of petsctpu/parallel/subcomm.py (reference: PetscSubcomm,
src/sys/objects/subcomm.c, and its consumers PCREDUNDANT and PCHMPI).
petsctpu nests a 2-axis mesh ("sub", "rows"); here `nested_mesh`
splits a World's ranks into nsub contiguous groups, each with its own
gloo group, and `sub_ksp_solve` runs nsub independent distributed
solves at once, one a group: the ordinary solver with the group's Comm.
"""

from __future__ import annotations

from dataclasses import replace

import torch

from petsctpu_torch.device import np_dtype
from petsctpu_torch.ksp.common import KSPConfig, SolveResult
from petsctpu_torch.parallel.api import gather_result, rank_view, \
    split_vector


class NestedWorld:
    """A World and its split into nsub groups of size/nsub ranks."""

    def __init__(self, world, nsub: int):
        self.world = world
        self.nsub = nsub
        self.group_size = world.size // nsub
        self.subs = world.split(nsub)

    def group_of(self, rank: int) -> int:
        return rank // self.group_size


def nested_mesh(world, nsub: int) -> NestedWorld:
    """PetscSubcommCreate analog: the World's ranks in nsub groups of
    equal size; a group's collectives stay inside it."""
    return NestedWorld(world, nsub)


def sub_ksp_solve(nested: NestedWorld, A_list, b_list,
                  cfg: KSPConfig = None, pc_list=None,
                  **kw) -> SolveResult:
    """Solve nsub independent systems, one a group, CONCURRENTLY, each
    distributed over its group (the PCREDUNDANT / PCHMPI execution
    shape). A_list: one sharded operator (nshards = group size) a group;
    b_list: host global vectors. Returns a SolveResult whose fields
    stack the groups' results along a leading axis."""
    from petsctpu_torch.ksp.api import KSP_REGISTRY

    cfg = replace(cfg or KSPConfig(), **kw) if (kw or cfg is None) else cfg
    world, k = nested.world, nested.group_size
    assert len(A_list) == nested.nsub and len(b_list) == nested.nsub
    pieces = [split_vector(world, b, A.shape[0], k, np_dtype(A.dtype))
              for A, b in zip(A_list, b_list)]
    fn = KSP_REGISTRY[cfg.ksp_type]

    def body(comm, g, b_loc):
        pc = rank_view(pc_list[g], comm) if pc_list is not None else None
        return fn(A_list[g].rank(comm), b_loc, torch.zeros_like(b_loc), pc,
                  cfg, comm)

    args = [(nested.group_of(r), pieces[nested.group_of(r)][r % k])
            for r in range(world.size)]
    out = world.run(body, args, comms=nested.subs)
    res = [gather_result(out[g * k:(g + 1) * k]) for g in range(nested.nsub)]
    return SolveResult(torch.stack([r.x for r in res]),
                       torch.stack([r.its for r in res]),
                       torch.stack([r.reason for r in res]),
                       torch.stack([torch.as_tensor(r.rnorm) for r in res]),
                       torch.stack([r.history for r in res]))
