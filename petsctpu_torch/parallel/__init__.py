"""The distributed layer: communicators over torch.distributed (a flat
World, or a two-axis (dcn, ici) one), sharded operators (the
hierarchical halo's ShardedAIJHier among them), and the distributed KSP,
SNES and TS (petsctpu/parallel)."""

from petsctpu_torch.parallel.comm import Comm, World, world_from_env
from petsctpu_torch.parallel.pmat import ShardedAIJ, sharded_aij_from_scipy
from petsctpu_torch.parallel.pbaij import ShardedBAIJ, sharded_baij_from_scipy
from petsctpu_torch.parallel.pstencil import ShardedStencil, \
    sharded_stencil_from
from petsctpu_torch.parallel.hier import ShardedAIJHier, \
    sharded_aij_hier_from_scipy
from petsctpu_torch.parallel.api import ParKSP, par_ksp_solve, shard_vector, \
    unshard_vector
from petsctpu_torch.parallel.subcomm import nested_mesh, sub_ksp_solve
from petsctpu_torch.parallel.psnes import (ShardedFDJac, pad_shard,
                                           par_snes_solve, par_ts_solve)

__all__ = ["Comm", "World", "world_from_env", "ShardedAIJ",
           "sharded_aij_from_scipy", "ShardedBAIJ",
           "sharded_baij_from_scipy", "ShardedStencil", "ShardedAIJHier",
           "sharded_aij_hier_from_scipy",
           "sharded_stencil_from", "ParKSP", "par_ksp_solve",
           "shard_vector", "unshard_vector", "nested_mesh",
           "sub_ksp_solve", "ShardedFDJac", "pad_shard",
           "par_snes_solve", "par_ts_solve"]
