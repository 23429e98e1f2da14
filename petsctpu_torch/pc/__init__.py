from petsctpu_torch.pc.api import make_pc, register_pc, PC_REGISTRY
from petsctpu_torch.pc.simple import NonePC, JacobiPC, PBJacobiPC

__all__ = ["make_pc", "register_pc", "PC_REGISTRY", "NonePC", "JacobiPC",
           "PBJacobiPC"]
