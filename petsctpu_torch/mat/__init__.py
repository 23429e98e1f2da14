from petsctpu_torch.mat.ell import (AIJ, aij_from_dense, aij_from_scipy,
                                    aij_to_scipy)
from petsctpu_torch.mat.base import (
    Shell, Transpose, Normal, NormalHermitian, ShiftScale, Composite, LRC,
    Diagonal, Identity,
)
from petsctpu_torch.mat.coo import ell_from_coo
from petsctpu_torch.mat.dense import Dense
from petsctpu_torch.mat.sell import SellMat, sell_from_scipy
from petsctpu_torch.mat.factory import mat_from_options
from petsctpu_torch.mat.band import BandMat, band_from_scipy
from petsctpu_torch.mat.bsr import BAIJ, SellBAIJ, baij_from_scipy_bsr
from petsctpu_torch.mat.dia import DiaMat, dia_fill, dia_from_scipy
from petsctpu_torch.mat.sbaij import SBAIJ, sbaij_from_scipy
from petsctpu_torch.mat.maij import MAIJ
from petsctpu_torch.mat.matis import MatIS, matis_from_subdomains
from petsctpu_torch.mat.partition import (MatPartitioning, edge_cut,
                                          partition_rcb, partition_rcm)
from petsctpu_torch.mat.stencil import (StencilMat, galerkin_coarsen,
                                        stencil_from_scipy, stencil_to_scipy)

__all__ = ["AIJ", "aij_from_scipy", "aij_from_dense", "aij_to_scipy",
           "Shell", "Transpose", "Normal", "NormalHermitian", "ShiftScale",
           "Composite", "LRC", "Diagonal", "Identity", "ell_from_coo",
           "Dense", "SellMat", "sell_from_scipy", "mat_from_options",
           "StencilMat", "stencil_from_scipy", "stencil_to_scipy",
           "galerkin_coarsen", "BandMat", "band_from_scipy", "BAIJ",
           "SellBAIJ", "baij_from_scipy_bsr", "DiaMat", "dia_fill",
           "dia_from_scipy", "SBAIJ", "sbaij_from_scipy", "MAIJ", "MatIS",
           "matis_from_subdomains", "MatPartitioning", "edge_cut",
           "partition_rcb", "partition_rcm"]
