"""Elementwise algebra on symmetric tensors.

The counterpart of ``symtensor_tpu/ops/elementwise.py:37-142, 209-259``,
for the flat format. Elementwise ops map independent components to
independent components, so on packed storage each is one torch op over the
packed values. Scalars (Python numbers, 0-d NumPy arrays and 0-d tensors)
and rank-0 tensors broadcast; any other array must be wrapped with
``from_dense`` first.

The other formats raise ``NotImplementedError`` naming their ROADMAP item
(``ops/contract.py:_NOT_PORTED``): permcls and dense ("PermCls and
Dense"), decomp ("Decomp format") and sparse ("Sparse format"). Format
promotion and the structure-preserving decomp and sparse arithmetic come
with them.
"""

from __future__ import annotations

import numbers
import operator
from typing import Callable

import numpy as np
import torch

from ..core.base import SymmetricTensor
from ..core.flat import FlatSymmetricTensor
from .contract import require_ported

_FNS = {
    "add": operator.add,
    "subtract": operator.sub,
    "multiply": operator.mul,
    "divide": operator.truediv,
    "power": operator.pow,
}


def _is_scalar(x) -> bool:
    if isinstance(x, numbers.Number):
        return True
    return isinstance(x, (np.ndarray, np.generic, torch.Tensor)) and x.ndim == 0


def _scalar(x, like: torch.Tensor):
    """A scalar operand as torch takes it: Python numbers as they are
    (weakly typed), arrays as 0-d tensors on the other operand's device."""
    if isinstance(x, numbers.Number):
        return x
    return torch.as_tensor(x, device=like.device)


def _flat_of(t: SymmetricTensor) -> FlatSymmetricTensor:
    require_ported(t)
    return t


def _map(t: SymmetricTensor, fn: Callable) -> FlatSymmetricTensor:
    t = _flat_of(t)
    return FlatSymmetricTensor._raw(t.rank, t.dim, fn(t.data))


def unary(fn: Callable, t: SymmetricTensor) -> FlatSymmetricTensor:
    """Apply an elementwise fn to the packed values; valid because each
    dense element equals its representative's stored value."""
    return _map(t, fn)


def binary(op_name: str, a, b, reverse: bool = False):
    fn = _FNS[op_name]
    if reverse:
        a, b = b, a
    a_sym = isinstance(a, SymmetricTensor)
    b_sym = isinstance(b, SymmetricTensor)

    if a_sym and b_sym:
        a, b = _flat_of(a), _flat_of(b)
        # rank-0 operands broadcast as scalars
        if a.rank == 0 and b.rank != 0:
            return binary(op_name, a.data.reshape(()), b)
        if b.rank == 0 and a.rank != 0:
            return binary(op_name, a, b.data.reshape(()))
        if (a.rank, a.dim) != (b.rank, b.dim):
            raise ValueError(
                f"shape mismatch: rank/dim ({a.rank},{a.dim}) vs "
                f"({b.rank},{b.dim})"
            )
        return FlatSymmetricTensor._raw(a.rank, a.dim, fn(a.data, b.data))

    if a_sym and _is_scalar(b):
        a = _flat_of(a)
        s = _scalar(b, a.data)
        return _map(a, lambda x: fn(x, s))
    if b_sym and _is_scalar(a):
        b = _flat_of(b)
        s = _scalar(a, b.data)
        return _map(b, lambda x: fn(s, x))

    other = a if not a_sym else b
    raise TypeError(
        f"cannot apply '{op_name}' between a SymmetricTensor and "
        f"{type(other).__name__}; wrap array operands with from_dense() "
        "(only scalars broadcast implicitly)"
    )


# ---------------------------------------------------------------- compare


def _isclose(u, v, rtol, atol, equal_nan) -> torch.Tensor:
    """torch.isclose after promoting both sides to one type, as NumPy and
    JAX do, on the device of the side that holds packed values."""
    dev = (u if isinstance(u, torch.Tensor) and u.ndim else v).device
    u = torch.as_tensor(u, device=dev)
    v = torch.as_tensor(v, device=dev)
    ct = torch.result_type(u, v)
    return torch.isclose(u.to(ct), v.to(ct), rtol=rtol, atol=atol,
                         equal_nan=equal_nan)


def allclose(a, b, rtol=1e-5, atol=1e-8, equal_nan=False) -> bool:
    """Closeness over independent components: the same as a dense
    allclose, since every dense element equals some stored component."""
    if isinstance(a, SymmetricTensor) and isinstance(b, SymmetricTensor):
        a, b = _flat_of(a), _flat_of(b)
        if (a.rank, a.dim) != (b.rank, b.dim):
            return False
        return bool(_isclose(a.data, b.data, rtol, atol, equal_nan).all())
    if isinstance(a, SymmetricTensor) and _is_scalar(b):
        return bool(_isclose(_flat_of(a).data, b, rtol, atol, equal_nan).all())
    if isinstance(b, SymmetricTensor) and _is_scalar(a):
        return bool(_isclose(a, _flat_of(b).data, rtol, atol, equal_nan).all())
    raise TypeError("allclose needs SymmetricTensor or scalar operands")


def isclose(a, b, rtol=1e-5, atol=1e-8, equal_nan=False):
    """Elementwise isclose over independent components, as a boolean flat
    tensor."""
    if isinstance(a, SymmetricTensor) and isinstance(b, SymmetricTensor):
        a, b = _flat_of(a), _flat_of(b)
        if (a.rank, a.dim) != (b.rank, b.dim):
            raise ValueError("rank/dim mismatch")
        return FlatSymmetricTensor._raw(
            a.rank, a.dim, _isclose(a.data, b.data, rtol, atol, equal_nan)
        )
    if isinstance(a, SymmetricTensor) and _is_scalar(b):
        return _map(a, lambda u: _isclose(u, b, rtol, atol, equal_nan))
    if isinstance(b, SymmetricTensor) and _is_scalar(a):
        return _map(b, lambda v: _isclose(a, v, rtol, atol, equal_nan))
    raise TypeError("isclose needs SymmetricTensor or scalar operands")


def array_equal(a, b) -> bool:
    if isinstance(a, SymmetricTensor) and isinstance(b, SymmetricTensor):
        a, b = _flat_of(a), _flat_of(b)
        if (a.rank, a.dim) != (b.rank, b.dim):
            return False
        return bool((a.data == b.data).all())
    raise TypeError("array_equal needs SymmetricTensor operands")
