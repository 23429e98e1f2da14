from petsctpu_torch.pc.api import make_pc, register_pc, PC_REGISTRY
from petsctpu_torch.pc.simple import NonePC, JacobiPC, PBJacobiPC
from petsctpu_torch.pc.factor import ILUPC, LUPC, make_lu
from petsctpu_torch.pc.sor import SORPC
from petsctpu_torch.pc.mg import MGPC, make_geometric_mg
from petsctpu_torch.pc.gamg import make_gamg

__all__ = ["make_pc", "register_pc", "PC_REGISTRY", "NonePC", "JacobiPC",
           "PBJacobiPC", "ILUPC", "LUPC", "SORPC", "MGPC", "make_lu",
           "make_geometric_mg", "make_gamg"]
