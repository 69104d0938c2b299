"""symalg — the symmetrized algebra namespace.

The ported part of ``symtensor_tpu.symalg``, under the JAX package's
names: ``add``/``subtract``/``multiply`` are callables with a ``.outer``
attribute holding the *symmetrized* outer product; ``tensordot``,
``symmetric_outer``, the named elementwise unaries and ``apply``; the
comparisons; the full contraction with a vector, single-input and
batched, with its power-sum helpers; the contraction with a matrix (the
basis change) and with a list of tensors; and the dense
symmetrization oracles. The rest of the namespace waits for its ROADMAP
items.
"""

import torch as _torch

from . import elementwise as elementwise
from .contract import (
    contract_all_indices_with_matrix,
    contract_all_indices_with_vector,
    contract_all_indices_with_vector_batched,
    contract_tensor_list,
    monomial_symmetric,
    power_sums,
)
from .elementwise import allclose, array_equal, isclose
from .outer import symmetric_outer, tensordot
from .symmetrize import is_symmetric, symmetrize


class _SymUfunc:
    """Symmetrized parallel of a NumPy binary ufunc: calling it applies the
    elementwise op; ``.outer`` is the symmetrized outer product."""

    def __init__(self, name: str):
        self.name = name
        self.__name__ = name

    def __call__(self, a, b):
        return elementwise.binary(self.name, a, b)

    def outer(self, a, b):
        return symmetric_outer(a, b, self.name)

    def __repr__(self):
        return f"<symmetrized ufunc '{self.name}'>"


add = _SymUfunc("add")
subtract = _SymUfunc("subtract")
multiply = _SymUfunc("multiply")


def transpose(symtensor, *axes):
    """No-op on symmetric tensors."""
    return symtensor


def apply(fn, symtensor):
    """Apply any elementwise ``()->()`` torch function over the independent
    components; valid because every dense element equals its
    representative's stored value."""
    return elementwise.unary(fn, symtensor)


def _named_unary(name, torch_fn):
    def op(symtensor):
        return elementwise.unary(torch_fn, symtensor)

    op.__name__ = name
    op.__qualname__ = name
    op.__doc__ = (
        f"Elementwise {name} over independent components; "
        f"symalg.apply(torch.{torch_fn.__name__}, A)."
    )
    return op


exp = _named_unary("exp", _torch.exp)
expm1 = _named_unary("expm1", _torch.expm1)
log = _named_unary("log", _torch.log)
log1p = _named_unary("log1p", _torch.log1p)
sqrt = _named_unary("sqrt", _torch.sqrt)
square = _named_unary("square", _torch.square)
reciprocal = _named_unary("reciprocal", _torch.reciprocal)
negative = _named_unary("negative", _torch.neg)
absolute = _named_unary("absolute", _torch.abs)
abs = absolute
sign = _named_unary("sign", _torch.sign)
sin = _named_unary("sin", _torch.sin)
cos = _named_unary("cos", _torch.cos)
tanh = _named_unary("tanh", _torch.tanh)


__all__ = [
    "add",
    "subtract",
    "multiply",
    "transpose",
    "apply",
    "exp",
    "expm1",
    "log",
    "log1p",
    "sqrt",
    "square",
    "reciprocal",
    "negative",
    "absolute",
    "abs",
    "sign",
    "sin",
    "cos",
    "tanh",
    "tensordot",
    "symmetric_outer",
    "contract_all_indices_with_matrix",
    "contract_all_indices_with_vector",
    "contract_all_indices_with_vector_batched",
    "contract_tensor_list",
    "monomial_symmetric",
    "power_sums",
    "elementwise",
    "allclose",
    "array_equal",
    "isclose",
    "is_symmetric",
    "symmetrize",
]
