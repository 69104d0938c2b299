"""Domain contractions on packed storage.

The counterpart of ``symtensor_tpu/ops/contract.py:96-148, 200-250``:
``contract_all_indices_with_vector`` and its batched form, for the flat
format. On packed storage the full contraction Σ A_{i1..ir} x_{i1}…x_{ir}
is r!·⟨vals, W⟩ with W the EGF-weighted monomial vector; the production
route evaluates it group by group without building W
(``kernels/poly_eval.py``), and ``_contract_vec_flat_simple`` builds W
in full as the oracle.

The other formats (permcls, dense, decomp, sparse) are not ported yet and
raise ``NotImplementedError`` naming their ROADMAP item.
"""

from __future__ import annotations

import math

import torch

from ..core.base import SymmetricTensor
from ..core.flat import FlatSymmetricTensor
from ..utils.precision import full_fp32_matmul

# The ROADMAP queue 1 item (by title) that ports each remaining format.
_NOT_PORTED = {
    "permcls": "PermCls and Dense",
    "dense": "PermCls and Dense",
    "decomp": "Decomp format",
    "sparse_flat": "Sparse format",
}


def require_ported(A: SymmetricTensor) -> None:
    """Raise ``NotImplementedError`` naming its ROADMAP item unless A's
    format is ported (only the flat format is, so far)."""
    if A.format != "flat":
        item = _NOT_PORTED.get(A.format, "the ROADMAP's queues")
        raise NotImplementedError(
            f"the {A.format!r} format is not ported yet (ROADMAP queue 1: "
            f"{item})"
        )


def _check_format(A) -> None:
    if not isinstance(A, SymmetricTensor):
        raise TypeError("first operand must be a SymmetricTensor")
    require_ported(A)


def _egf_weights(t, x: torch.Tensor, rank: int) -> torch.Tensor:
    """W[m] = ∏_v x_v^{c_v}/c_v! over all rank-`rank` multisets, in colex
    order."""
    w = torch.ones((1,), dtype=x.dtype, device=x.device)
    for par, mx, run in t.mono_tables_weighted(rank):
        w = w[par] * x[mx] / run.to(x.dtype)
    return w


def _contract_vec_flat_simple(A: FlatSymmetricTensor, x) -> torch.Tensor:
    """Reference-grade EGF path: builds the full weighted monomial vector
    (O(n) extra tables and intermediates). The oracle for the grouped
    route."""
    x = torch.as_tensor(x, device=A.device)
    r = A.rank
    if r == 0:
        return A.data[0]
    with full_fp32_matmul():
        if r == 1:
            return torch.dot(A.data, x.to(A.dtype))
        t = A.tables
        w = _egf_weights(t, x, r)
        # The EGF recursion enumerates multisets in colex order; reorder to
        # the gflat storage order through the static permutation.
        w = w[t.colex_perm]
        return float(math.factorial(r)) * torch.dot(A.data, w.to(A.dtype))


def _contract_vec_flat(A: FlatSymmetricTensor, x) -> torch.Tensor:
    from ..kernels.poly_eval import poly_eval_flat_fast

    x = torch.as_tensor(x, device=A.device)
    if A.rank > 0 and tuple(x.shape) != (A.dim,):
        raise ValueError(
            f"vector length {tuple(x.shape)} must match dim {A.dim} "
            "(reference symalg.py:517)"
        )
    return poly_eval_flat_fast(A, x)


def contract_all_indices_with_vector(symtensor, x) -> torch.Tensor:
    """Σ_{i1…ir} A_{i1…ir} x_{i1}…x_{ir}, as a 0-d tensor on the tensor's
    device. A CUDA flat tensor of rank ≥ 3 goes through the hand-written
    group-pass kernel."""
    _check_format(symtensor)
    return _contract_vec_flat(symtensor.toflat(), x)


def contract_all_indices_with_vector_batched(symtensor, xs) -> torch.Tensor:
    """Batched polynomial evaluation: xs (B, dim) → (B,), through per-group
    GEMMs."""
    from ..kernels.poly_eval import poly_eval_flat_batched

    A = symtensor
    _check_format(A)
    xs = torch.as_tensor(xs, device=A.device)
    if xs.ndim != 2:
        raise ValueError(f"xs must be (batch, dim); got {tuple(xs.shape)}")
    if A.rank > 0 and xs.shape[1] != A.dim:
        raise ValueError(
            f"xs second axis {xs.shape[1]} must equal dim {A.dim}"
        )
    return poly_eval_flat_batched(A.toflat(), xs)
