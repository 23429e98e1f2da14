"""Hand-written CUDA kernels of the port, with their plain versions.

The counterparts of petsctpu.ops' Pallas stencil product
(`stencil_pallas.stencil5_mult_pallas`: here `stencil_mult`) and of the
other kernels, one module each under the port's own names; each
module's wrapper takes its plain version for CPU tensors and launches
its kernel (built at first use) for CUDA tensors."""

from petsctpu_torch.ops import (ell_spmv, sell_spmv, sell_spmvT,  # noqa: F401
                                sptrsv, stencil_mult)

__all__ = ["stencil_mult", "sell_spmv", "sell_spmvT", "ell_spmv", "sptrsv"]
