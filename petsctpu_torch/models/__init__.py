from petsctpu_torch.models.poisson import (laplacian_2d, poisson_3d,
                                           ex2_system, ex45_system)

__all__ = ["laplacian_2d", "poisson_3d", "ex2_system", "ex45_system"]
