"""Carry symmetric tensors across between the JAX package and this one.

Both packages store each format the same way (flat: one 1-D gflat-ordered
array; permcls: a dict from σ-class count tuples to a scalar or the
class's values in storage order; dense: the full array; decomp: the
weights, the factors and the multiplicities; sparse: the values and their
multi-indices), so the values cross over unchanged, and so do the
flagship model's parameters:

    A_torch = flat_from_numpy(6, 100, np.asarray(A_jax.data), device="cuda")
    data = flat_to_numpy(A_torch)    # → FlatSymmetricTensor(6, 100, data)
    P_torch = permcls_from_numpy(
        6, 200, {k: np.asarray(v) for k, v in P_jax.data.items()}, device="cuda")
    D_torch = dense_from_numpy(np.asarray(D_jax.data), device="cuda")
    C_torch = decomp_from_numpy(
        C_jax.rank, C_jax.dim, np.asarray(C_jax.weights),
        np.asarray(C_jax.factors), C_jax.multiplicities, device="cuda")
    S_torch = sparse_from_numpy(
        S_jax.rank, S_jax.dim, np.asarray(S_jax.bcoo.data),
        np.asarray(S_jax.rep), device="cuda")
    model = polynomial_from_numpy(
        {"bias": np.asarray(params["bias"]),
         "terms": {k: np.asarray(t.data) for k, t in params["terms"].items()}},
        device="cuda")    # params of symtensor_tpu.models.polynomial.init

NumPy has no bfloat16 of its own; the JAX package's bfloat16 arrays (an
``ml_dtypes`` dtype) are taken bit for bit and come back as float32.
"""

from __future__ import annotations

import numpy as np
import torch

from .core.base import host
from .core.decomp import DecompSymmetricTensor
from .core.dense import DenseSymmetricTensor
from .core.flat import FlatSymmetricTensor
from .core.permcls import PermClsSymmetricTensor
from .core.sparse_flat import SparseFlatSymmetricTensor
from .utils import combinatorics as comb


def _tensor(data, device, dtype=None) -> torch.Tensor:
    """A copy of NumPy values on `device` (a JAX array's host view is
    read-only)."""
    arr = np.array(data, copy=True, order="C")
    if arr.dtype.name == "bfloat16":
        t = torch.from_numpy(arr.view(np.uint16)).view(torch.bfloat16)
    else:
        t = torch.from_numpy(arr)
    return t.to(device=device, dtype=dtype)


def flat_from_numpy(
    rank: int, dim: int, data, *, device, dtype=None
) -> FlatSymmetricTensor:
    """A ``FlatSymmetricTensor`` on `device` from packed NumPy values."""
    return FlatSymmetricTensor(rank=rank, dim=dim, data=_tensor(data, device, dtype))


def flat_to_numpy(A) -> np.ndarray:
    """The packed values as a NumPy array on the host."""
    return host(A.toflat().data)


def permcls_from_numpy(
    rank: int, dim: int, data: dict, *, device, dtype=None
) -> PermClsSymmetricTensor:
    """A ``PermClsSymmetricTensor`` on `device` from a dict of σ-class
    count tuples (or labels) to NumPy scalars or per-class arrays. The
    values keep their type unless `dtype` is given."""
    leaves = {k: _tensor(v, device, dtype) for k, v in data.items()}
    dtype = dtype or next(iter(leaves.values())).dtype
    return PermClsSymmetricTensor(rank, dim, leaves, dtype=dtype, device=device)


def permcls_to_numpy(A: PermClsSymmetricTensor) -> dict:
    """{count tuple: NumPy 0-d or 1-d array} of the per-class storage."""
    return {k: host(v) for k, v in A.data.items()}


def dense_from_numpy(data, *, device, dtype=None, check: bool = True
                     ) -> DenseSymmetricTensor:
    """A ``DenseSymmetricTensor`` on `device` from a dense NumPy array."""
    return DenseSymmetricTensor(data=_tensor(data, device, dtype), check=check)


def dense_to_numpy(A: DenseSymmetricTensor) -> np.ndarray:
    return host(A.todense())


def decomp_from_numpy(
    rank: int, dim: int, weights, factors, multiplicities, *, device, dtype=None
) -> DecompSymmetricTensor:
    """A ``DecompSymmetricTensor`` on `device` from NumPy weights and
    factors. The leaves keep the weights' type unless `dtype` is given."""
    w = _tensor(weights, device, dtype)
    return DecompSymmetricTensor(
        rank, dim, w, _tensor(factors, device, dtype), multiplicities,
        dtype=w.dtype, device=device,
    )


def decomp_to_numpy(A: DecompSymmetricTensor):
    """(weights, factors, multiplicities), the leaves as NumPy arrays."""
    return host(A.weights), host(A.factors), A.multiplicities


def sparse_from_numpy(
    rank: int, dim: int, values, indices, *, device, dtype=None
) -> SparseFlatSymmetricTensor:
    """A ``SparseFlatSymmetricTensor`` on `device` from NumPy values (nnz,)
    and multi-indices (nnz, rank); the values keep their type unless
    `dtype` is given."""
    vals = _tensor(values, device, dtype)
    idx = torch.as_tensor(np.asarray(indices, dtype=np.int64), device=device)
    return SparseFlatSymmetricTensor.from_entries(rank, dim, idx, vals)


def sparse_to_numpy(A: SparseFlatSymmetricTensor):
    """(values, indices): the stored values and their (ascending)
    multi-indices (nnz, rank) as NumPy arrays."""
    return host(A.vals), A.rep.cpu().numpy()


def _dim_of(rank: int, n: int) -> int:
    """The dim at which a rank-`rank` tensor has n packed values."""
    dim = 1
    while comb.indep_size(rank, dim) < n:
        dim += 1
    if comb.indep_size(rank, dim) != n:
        raise ValueError(f"{n} values fit no rank-{rank} tensor")
    return dim


def polynomial_from_numpy(params: dict, *, device, dtype=None, dim=None):
    """A ``models.polynomial.SymmetricPolynomial`` on `device` from the JAX
    package's parameters as NumPy arrays: {"bias": 0-d, "terms":
    {"rank{r}": packed values}}. `dim` is read from the sizes of the terms
    unless given (a model of rank-0 terms only needs it)."""
    from .models.polynomial import SymmetricPolynomial

    terms = {int(k[4:]): _tensor(v, device, dtype) for k, v in params["terms"].items()}
    if dim is None:
        sized = [(r, v.numel()) for r, v in terms.items() if r > 0]
        if not sized:
            raise ValueError("pass dim= for a model whose terms are all rank 0")
        dim = _dim_of(*sized[0])
    bias = _tensor(params["bias"], device, dtype)
    model = SymmetricPolynomial(list(terms), dim, dtype=bias.dtype, device=device)
    with torch.no_grad():
        model.bias.copy_(bias)
        for r, v in terms.items():
            model.terms[f"rank{r}"].copy_(v)
    return model


def polynomial_to_numpy(model) -> dict:
    """The model's parameters as NumPy arrays in the JAX package's layout
    ({"bias", "terms": {"rank{r}": packed values}})."""
    return {"bias": host(model.bias),
            "terms": {k: host(p) for k, p in model.terms.items()}}
