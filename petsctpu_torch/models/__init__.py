from petsctpu_torch.models.poisson import (laplacian_2d, poisson_3d,
                                           ex2_system, ex45_system,
                                           ex34_system, ex29_system,
                                           ex45_true_system, ex54_system,
                                           cell_neumann_laplacian_3d)
from petsctpu_torch.models.pbratu import (pbratu_initial_guess,  # noqa: F401
                                          pbratu_residual)
from petsctpu_torch.models.radiative import (  # noqa: F401
    radiative_initial_guess, radiative_residual)

__all__ = ["laplacian_2d", "poisson_3d", "ex2_system", "ex45_system",
           "ex34_system", "ex29_system", "ex45_true_system", "ex54_system",
           "cell_neumann_laplacian_3d"]
