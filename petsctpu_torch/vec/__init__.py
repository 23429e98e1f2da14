from petsctpu_torch.vec.ops import (
    psum, dot, norm, norm_1, norm_inf, mdot, axpy, aypx, waxpy, reduce_all,
    pointwise_mult, pointwise_divide,
)

__all__ = [
    "psum", "dot", "norm", "norm_1", "norm_inf", "mdot", "axpy", "aypx",
    "waxpy", "reduce_all", "pointwise_mult", "pointwise_divide",
]
