"""Elementwise algebra on symmetric tensors.

The counterpart of ``symtensor_tpu/ops/elementwise.py``.
Elementwise ops map independent components to independent components, so
each is one torch op per storage leaf: the packed values of a flat
tensor, the dense array of a dense one, each σ-class leaf of a permcls
one (a 0-d scalar-compressed leaf broadcasts against a vector leaf).
Scalars (Python numbers, 0-d NumPy arrays and 0-d tensors) and rank-0
tensors broadcast; any other array must be wrapped with ``from_dense``
first.

Format promotion, as in the JAX package: operands of different formats go
to the more compressed one (dense < permcls < flat), and the result keeps
it. A decomp tensor stays decomposed under the ops its structure supports
exactly (± another decomp tensor, scaling by a scalar, a scalar shift:
c·1⃗^⊗r is itself decomp); a sparse one stays sparse under scaling by a
scalar and ± another sparse tensor. Under any other op either is expanded
to flat first, which ``utils/profiling.count_fallback`` counts as
``elementwise.decomp_to_flat`` where two tensors meet (and the sparse
``toflat`` as ``sparse_flat.densify_storage``).
"""

from __future__ import annotations

import numbers
import operator
from typing import Callable

import numpy as np
import torch

from ..core.base import SymmetricTensor, require_local

_FNS = {
    "add": operator.add,
    "subtract": operator.sub,
    "multiply": operator.mul,
    "divide": operator.truediv,
    "power": operator.pow,
}

_PRIORITY = {"dense": 0, "permcls": 1, "flat": 2}
# formats that elementwise ops expand to flat unless their structure is kept
_EXPANDED = ("decomp", "sparse_flat")


def _is_scalar(x) -> bool:
    if isinstance(x, numbers.Number):
        return True
    return isinstance(x, (np.ndarray, np.generic, torch.Tensor)) and x.ndim == 0


def _scalar(x, device: torch.device):
    """A scalar operand as torch takes it: Python numbers as they are
    (weakly typed), arrays as 0-d tensors on the other operand's device."""
    if isinstance(x, numbers.Number):
        return x
    return torch.as_tensor(x, device=device)


def _promote(a: SymmetricTensor, b: SymmetricTensor):
    """Bring both operands to a common format; return (a, b)."""
    from ..utils.profiling import count_fallback

    if a.format in _EXPANDED:
        count_fallback("elementwise.decomp_to_flat", "(operand expanded)")
        a = a.toflat()
    if b.format in _EXPANDED:
        count_fallback("elementwise.decomp_to_flat", "(operand expanded)")
        b = b.toflat()
    if a.format == b.format:
        return a, b
    target = max(a.format, b.format, key=lambda f: _PRIORITY[f])
    if target == "flat":
        return a.toflat(), b.toflat()
    return a.topermcls(), b.topermcls()


def _map_leaves(t: SymmetricTensor, fn: Callable) -> SymmetricTensor:
    """Apply an elementwise fn to each storage leaf, keeping the format:
    every dense element equals its representative's stored value."""
    if t.format in _EXPANDED:
        t = t.toflat()
    if t.format == "permcls":
        return type(t)._raw(t.rank, t.dim, {k: fn(v) for k, v in t.data.items()})
    return type(t)._raw(t.rank, t.dim, fn(t.data))


def _zip_leaves(a: SymmetricTensor, b: SymmetricTensor, fn: Callable):
    if a.format == "permcls":
        return type(a)._raw(a.rank, a.dim, {k: fn(a.data[k], b.data[k]) for k in a.data})
    return type(a)._raw(a.rank, a.dim, fn(a.data, b.data))


def unary(fn: Callable, t: SymmetricTensor) -> SymmetricTensor:
    require_local("elementwise", t)
    return _map_leaves(t, fn)


def binary(op_name: str, a, b, reverse: bool = False):
    fn = _FNS[op_name]
    require_local(op_name, a, b)
    if reverse:
        a, b = b, a
    a_sym = isinstance(a, SymmetricTensor)
    b_sym = isinstance(b, SymmetricTensor)

    # Decomp stays decomposed for the ops its structure supports exactly.
    decomp_result = _try_decomp_binary(op_name, a, b, a_sym, b_sym)
    if decomp_result is not NotImplemented:
        return decomp_result

    # Sparse storage stays sparse under scaling and sparse ± sparse.
    sparse_result = _try_sparse_binary(op_name, a, b, a_sym, b_sym)
    if sparse_result is not NotImplemented:
        return sparse_result

    if a_sym and b_sym:
        # rank-0 operands broadcast as scalars
        if a.rank == 0 and b.rank != 0:
            return binary(op_name, a.toflat().data.reshape(()), b)
        if b.rank == 0 and a.rank != 0:
            return binary(op_name, a, b.toflat().data.reshape(()))
        if (a.rank, a.dim) != (b.rank, b.dim):
            raise ValueError(
                f"shape mismatch: rank/dim ({a.rank},{a.dim}) vs "
                f"({b.rank},{b.dim})"
            )
        return _zip_leaves(*_promote(a, b), fn)

    if a_sym and _is_scalar(b):
        s = _scalar(b, a.device)
        return _map_leaves(a, lambda x: fn(x, s))
    if b_sym and _is_scalar(a):
        s = _scalar(a, b.device)
        return _map_leaves(b, lambda x: fn(s, x))

    other = a if not a_sym else b
    raise TypeError(
        f"cannot apply '{op_name}' between a SymmetricTensor and "
        f"{type(other).__name__}; wrap array operands with from_dense() "
        "(only scalars broadcast implicitly)"
    )


def _try_decomp_binary(op_name, a, b, a_sym, b_sym):
    """Structure-preserving decomp arithmetic; NotImplemented sends the
    operands on to the generic path."""
    a_dec = a_sym and a.format == "decomp"
    b_dec = b_sym and b.format == "decomp"
    if not (a_dec or b_dec):
        return NotImplemented

    def shift(t, s):
        """s·1⃗^⊗r, the constant tensor of t's shape, as decomp."""
        ones = torch.ones((t.dim,), dtype=t.dtype, device=t.device)
        return type(t).from_vector(ones, t.rank).scale(s)

    if a_dec and b_dec and op_name in ("add", "subtract"):
        return a.add_decomp(b.scale(-1.0) if op_name == "subtract" else b)
    if a_dec and _is_scalar(b):
        if op_name in ("add", "subtract") and a.rank == 0:
            return NotImplemented
        s = _scalar(b, a.device)
        if op_name == "multiply":
            return a.scale(s)
        if op_name == "divide":
            return a.scale(1.0 / s)
        if op_name in ("add", "subtract"):
            return a.add_decomp(shift(a, -s if op_name == "subtract" else s))
    if b_dec and _is_scalar(a):
        if op_name in ("add", "subtract") and b.rank == 0:
            return NotImplemented
        s = _scalar(a, b.device)
        if op_name == "multiply":
            return b.scale(s)
        if op_name == "add":
            return b.add_decomp(shift(b, s))
        if op_name == "subtract":  # a − B
            return shift(b, s).add_decomp(b.scale(-1.0))
    return NotImplemented


def _try_sparse_binary(op_name, a, b, a_sym, b_sym):
    """Structure-preserving sparse arithmetic; NotImplemented sends the
    operands on to the generic path."""
    a_sp = a_sym and a.format == "sparse_flat"
    b_sp = b_sym and b.format == "sparse_flat"
    if not (a_sp or b_sp):
        return NotImplemented
    if a_sp and b_sp and op_name in ("add", "subtract"):
        return a.add_sparse(b.scale(-1.0) if op_name == "subtract" else b)
    if a_sp and _is_scalar(b):
        s = _scalar(b, a.device)
        if op_name == "multiply":
            return a.scale(s)
        if op_name == "divide":
            return a.scale(1.0 / s)
    if b_sp and _is_scalar(a) and op_name == "multiply":
        return b.scale(_scalar(a, b.device))
    return NotImplemented


# ---------------------------------------------------------------- compare


def _isclose(u, v, rtol, atol, equal_nan) -> torch.Tensor:
    """torch.isclose after promoting both sides to one type, as NumPy and
    JAX do, on the device of the tensor side of most dimensions."""
    dev = max((x for x in (u, v) if isinstance(x, torch.Tensor)),
              key=lambda x: x.ndim).device
    u = torch.as_tensor(u, device=dev)
    v = torch.as_tensor(v, device=dev)
    ct = torch.result_type(u, v)
    return torch.isclose(u.to(ct), v.to(ct), rtol=rtol, atol=atol,
                         equal_nan=equal_nan)


def _packed(t: SymmetricTensor) -> torch.Tensor:
    require_local("comparison", t)
    return t.toflat().data


def allclose(a, b, rtol=1e-5, atol=1e-8, equal_nan=False) -> bool:
    """Closeness over independent components: the same as a dense
    allclose, since every dense element equals some stored component."""
    if isinstance(a, SymmetricTensor) and isinstance(b, SymmetricTensor):
        if (a.rank, a.dim) != (b.rank, b.dim):
            return False
        return bool(_isclose(_packed(a), _packed(b), rtol, atol, equal_nan).all())
    if isinstance(a, SymmetricTensor) and _is_scalar(b):
        return bool(_isclose(_packed(a), b, rtol, atol, equal_nan).all())
    if isinstance(b, SymmetricTensor) and _is_scalar(a):
        return bool(_isclose(a, _packed(b), rtol, atol, equal_nan).all())
    raise TypeError("allclose needs SymmetricTensor or scalar operands")


def isclose(a, b, rtol=1e-5, atol=1e-8, equal_nan=False):
    """Elementwise isclose over independent components, as a boolean
    tensor in the promoted format."""

    def close(u, v):
        return _isclose(u, v, rtol, atol, equal_nan)

    if isinstance(a, SymmetricTensor) and isinstance(b, SymmetricTensor):
        if (a.rank, a.dim) != (b.rank, b.dim):
            raise ValueError("rank/dim mismatch")
        return _zip_leaves(*_promote(a, b), close)
    if isinstance(a, SymmetricTensor) and _is_scalar(b):
        return _map_leaves(a, lambda u: close(u, b))
    if isinstance(b, SymmetricTensor) and _is_scalar(a):
        return _map_leaves(b, lambda v: close(a, v))
    raise TypeError("isclose needs SymmetricTensor or scalar operands")


def array_equal(a, b) -> bool:
    if isinstance(a, SymmetricTensor) and isinstance(b, SymmetricTensor):
        if (a.rank, a.dim) != (b.rank, b.dim):
            return False
        return bool((_packed(a) == _packed(b)).all())
    raise TypeError("array_equal needs SymmetricTensor operands")
