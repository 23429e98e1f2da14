from petsctpu_torch.dm.da import (DA, Q1Interp, interp_dof_scipy,
                                  q0_interp_scipy, q1_interp_scipy)

__all__ = ["DA", "Q1Interp", "q1_interp_scipy", "q0_interp_scipy",
           "interp_dof_scipy"]
