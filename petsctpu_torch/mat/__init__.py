from petsctpu_torch.mat.ell import AIJ, aij_from_scipy, aij_to_scipy
from petsctpu_torch.mat.base import Transpose
from petsctpu_torch.mat.sell import SellMat, sell_from_scipy
from petsctpu_torch.mat.factory import mat_from_options
from petsctpu_torch.mat.stencil import (StencilMat, galerkin_coarsen,
                                        stencil_from_scipy, stencil_to_scipy)

__all__ = ["AIJ", "aij_from_scipy", "aij_to_scipy", "Transpose", "SellMat",
           "sell_from_scipy", "mat_from_options", "StencilMat",
           "stencil_from_scipy", "stencil_to_scipy", "galerkin_coarsen"]
