from petsctpu_torch.pc.api import make_pc, register_pc, PC_REGISTRY
from petsctpu_torch.pc.simple import NonePC, JacobiPC, PBJacobiPC
from petsctpu_torch.pc.factor import LUPC, make_lu
from petsctpu_torch.pc.mg import MGPC

__all__ = ["make_pc", "register_pc", "PC_REGISTRY", "NonePC", "JacobiPC",
           "PBJacobiPC", "LUPC", "make_lu", "MGPC"]
