"""The distributed layer: communicators over torch.distributed, sharded
operators, and the distributed KSP, SNES and TS (petsctpu/parallel; its
2-axis hierarchical mesh, parallel/hier.py, is ROADMAP queue 1 item 14,
slice 15)."""

from petsctpu_torch.parallel.comm import Comm, World, world_from_env
from petsctpu_torch.parallel.pmat import ShardedAIJ, sharded_aij_from_scipy
from petsctpu_torch.parallel.pbaij import ShardedBAIJ, sharded_baij_from_scipy
from petsctpu_torch.parallel.pstencil import ShardedStencil, \
    sharded_stencil_from
from petsctpu_torch.parallel.api import ParKSP, par_ksp_solve, shard_vector, \
    unshard_vector
from petsctpu_torch.parallel.subcomm import nested_mesh, sub_ksp_solve
from petsctpu_torch.parallel.psnes import (ShardedFDJac, pad_shard,
                                           par_snes_solve, par_ts_solve)

__all__ = ["Comm", "World", "world_from_env", "ShardedAIJ",
           "sharded_aij_from_scipy", "ShardedBAIJ",
           "sharded_baij_from_scipy", "ShardedStencil",
           "sharded_stencil_from", "ParKSP", "par_ksp_solve",
           "shard_vector", "unshard_vector", "nested_mesh",
           "sub_ksp_solve", "ShardedFDJac", "pad_shard",
           "par_snes_solve", "par_ts_solve"]
