from petsctpu_torch.dm.ao import AO
from petsctpu_torch.dm.composite import DMComposite
from petsctpu_torch.dm.da import (DA, Q1Interp, interp_dof_scipy,
                                  q0_interp_scipy, q1_interp_scipy)
from petsctpu_torch.dm.dt import (
    gauss_jacobi_quadrature, gauss_lobatto_quadrature, gauss_quadrature,
    gauss_tensor_quadrature,
)

__all__ = ["DA", "Q1Interp", "q1_interp_scipy", "q0_interp_scipy",
           "interp_dof_scipy", "DMComposite", "AO",
           "gauss_quadrature", "gauss_lobatto_quadrature",
           "gauss_jacobi_quadrature", "gauss_tensor_quadrature"]
