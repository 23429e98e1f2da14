"""petsctpu_torch.vec.ops against petsctpu.vec.ops, fp64 and complex128.

The same seeded numpy inputs go through both packages (the port on the
CPU). Tolerance: rtol 1e-14 — the reductions may sum in another order,
which moves an fp64 result by a few ulps, never more."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from petsctpu.vec import ops as jops
from petsctpu_torch.vec import ops as tops

N = 1000
RTOL = 1e-14


def _vectors(dtype, k=3):
    rng = np.random.default_rng(7)
    out = [rng.standard_normal(N) for _ in range(k)]
    if dtype == np.complex128:
        out = [v + 1j * rng.standard_normal(N) for v in out]
    return out


def _both(fn_name, dtype):
    a, b, c = _vectors(dtype)
    V = np.stack(_vectors(dtype, k=5))
    alpha = 0.37 - (0.21j if dtype == np.complex128 else 0.0)
    calls = {
        "dot": lambda m, A: m.dot(A(a), A(b)),
        "norm": lambda m, A: m.norm(A(a)),
        "norm_1": lambda m, A: m.norm_1(A(a)),
        "norm_inf": lambda m, A: m.norm_inf(A(a)),
        "mdot": lambda m, A: m.mdot(A(a), A(V)),
        "axpy": lambda m, A: m.axpy(A(a), alpha, A(b)),
        "aypx": lambda m, A: m.aypx(A(a), alpha, A(b)),
        "waxpy": lambda m, A: m.waxpy(alpha, A(a), A(b)),
        "reduce_all": lambda m, A: m.reduce_all(
            (m.dot(A(a), A(b)), m.norm(A(c))), None),
    }
    call = calls[fn_name]
    ref = call(jops, jnp.asarray)
    got = call(tops, torch.from_numpy)
    return ref, got


@pytest.mark.parametrize("dtype", [np.float64, np.complex128],
                         ids=["f64", "c128"])
@pytest.mark.parametrize("fn_name", [
    "dot", "norm", "norm_1", "norm_inf", "mdot", "axpy", "aypx", "waxpy",
    "reduce_all"])
def test_op_matches_jax(fn_name, dtype):
    ref, got = _both(fn_name, dtype)
    if not isinstance(ref, tuple):
        ref, got = (ref,), (got,)
    assert len(ref) == len(got)
    for r, g in zip(ref, got):
        r, g = np.asarray(r), g.numpy()
        assert g.dtype == r.dtype, (g.dtype, r.dtype)
        np.testing.assert_allclose(g, r, rtol=RTOL, atol=0)


def test_dot_conjugates_first_argument():
    a = torch.tensor([1j, 2.0 + 0j], dtype=torch.complex128)
    b = torch.tensor([1.0 + 0j, 1j], dtype=torch.complex128)
    assert complex(tops.dot(a, b)) == complex(jops.dot(jnp.asarray(a.numpy()),
                                                       jnp.asarray(b.numpy())))
    assert complex(tops.dot(a, b)) == -1j + 2j


def test_axis_other_than_none_raises():
    a = torch.ones(4, dtype=torch.float64)
    for call in (lambda: tops.dot(a, a, axis="rows"),
                 lambda: tops.norm(a, axis="rows"),
                 lambda: tops.norm_inf(a, axis="rows"),
                 lambda: tops.reduce_all((a,), "rows")):
        with pytest.raises(NotImplementedError, match="queue 1 item 14"):
            call()
