"""PF: the pointwise function class.

Counterpart of petsctpu/vec/pf.py (reference: src/vec/pf, PFCreate/
PFSetType/PFApply/PFApplyVec; types constant, identity, quick and
string). A PF is a named wrapper around an elementwise function of a
tensor. The "string" type evaluates an expression in a restricted
namespace of the same 19 names as petsctpu's jnp namespace, each a
torch callable (or a number) that takes what jnp's takes: Python
numbers as well as tensors, in any argument (`minimum(x, 0.5)`,
`where(x > 0, x, 0.0)`). Any other name raises ValueError.
"""

from __future__ import annotations

import math

import torch

PF_REGISTRY = {}


def register_pf(name: str, factory) -> None:
    """PFRegisterDynamic: factory(**kwargs) -> PF."""
    PF_REGISTRY[name] = factory


class PF:
    """Pointwise function: apply maps a tensor elementwise (PFApplyVec,
    src/vec/pf/interface/pf.c)."""

    def __init__(self, fn, name: str = "quick"):
        self.fn = fn
        self.name = name

    def apply(self, x):
        return self.fn(x)

    __call__ = apply


def _like(*args):
    """The tensor among args (the first), and args with every Python
    number made a 0-d tensor of its dtype and device."""
    ref = next((a for a in args if isinstance(a, torch.Tensor)), None)
    if ref is None:
        return tuple(torch.as_tensor(a) for a in args)
    return tuple(a if isinstance(a, torch.Tensor) else
                 torch.as_tensor(a, dtype=ref.dtype, device=ref.device)
                 for a in args)


def _unary(f):
    return lambda x: f(*_like(x))


def _binary(f):
    return lambda a, b: f(*_like(a, b))


def _where(c, a, b):
    c = torch.as_tensor(c)
    a, b = _like(a, b)
    return torch.where(c, a, b)


_NAMESPACE = {
    "sin": _unary(torch.sin), "cos": _unary(torch.cos),
    "tan": _unary(torch.tan), "exp": _unary(torch.exp),
    "log": _unary(torch.log), "sqrt": _unary(torch.sqrt),
    "abs": _unary(torch.abs), "tanh": _unary(torch.tanh),
    "sinh": _unary(torch.sinh), "cosh": _unary(torch.cosh),
    "arctan": _unary(torch.arctan), "arcsin": _unary(torch.arcsin),
    "arccos": _unary(torch.arccos), "sign": _unary(torch.sign),
    "minimum": _binary(torch.minimum), "maximum": _binary(torch.maximum),
    "where": _where, "pi": math.pi, "e": math.e,
}


def make_pf(pf_type: str = "identity", **kw) -> PF:
    """PFCreate + PFSetType."""
    if pf_type in PF_REGISTRY:
        return PF_REGISTRY[pf_type](**kw)
    if pf_type == "identity":
        return PF(lambda x: x, "identity")
    if pf_type == "constant":
        c = kw.get("value", 0.0)
        return PF(lambda x: torch.full_like(x, c), "constant")
    if pf_type == "quick":
        return PF(kw["fn"], "quick")
    if pf_type == "string":
        expr = kw["expr"]
        code = compile(expr, "<pf-string>", "eval")
        for nm in code.co_names:
            if nm not in _NAMESPACE and nm != "x":
                raise ValueError(f"pf string: unknown name {nm!r}")

        def fn(x, _code=code):
            return eval(_code, {"__builtins__": {}}, dict(_NAMESPACE, x=x))
        return PF(fn, "string")
    raise ValueError(f"unknown pf_type {pf_type!r}")
