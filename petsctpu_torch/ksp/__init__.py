from petsctpu_torch.ksp.common import KSPConfig, SolveResult
from petsctpu_torch.ksp.api import (KSP, ksp_solve, ksp_solve_transpose,
                                    register_ksp, KSP_REGISTRY)

__all__ = ["KSP", "KSPConfig", "SolveResult", "ksp_solve",
           "ksp_solve_transpose", "register_ksp", "KSP_REGISTRY"]
