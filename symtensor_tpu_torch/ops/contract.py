"""Domain contractions on symmetric storage.

The counterpart of ``symtensor_tpu/ops/contract.py:47-274``:
``contract_all_indices_with_vector`` and its batched form, for the flat,
permcls and dense formats.

- Flat: the full contraction Σ A_{i1..ir} x_{i1}…x_{ir} is r!·⟨vals, W⟩
  with W the EGF-weighted monomial vector; the production route evaluates
  it group by group without building W (``kernels/poly_eval.py``, the
  group-pass kernel on the card), and ``_contract_vec_flat_simple`` builds
  W in full as the oracle.
- Permcls: a scalar-compressed class λ adds γ_λ·c·m_λ(x), the monomial
  symmetric polynomial from power sums in O(r·d) whatever its size, so
  rank 6 dim 200 (BASELINE C3) evaluates without any table. The vector
  classes are scattered into one packed tensor and evaluated by the flat
  route. The scatter's class positions come from ``rep_np`` under the
  table guard (n·r entries): past it, ``MemoryError``, as in the JAX
  package, whose ``class_rep`` route and its ``toflat()`` fallback
  (``contract.py:151-197``) need the same table.
- Dense: r matrix-vector products.

The batched op computes what ``jax.vmap`` of the single-input op computes:
flat tensors and the vector classes of permcls ones through per-group
GEMMs, scalar classes and dense tensors by the same arithmetic on a
leading batch axis. The decomp and sparse formats are not ported yet and
raise ``NotImplementedError`` naming their ROADMAP item.
"""

from __future__ import annotations

import math
from collections import Counter

import torch

from ..core.base import SymmetricTensor
from ..core.flat import FlatSymmetricTensor
from ..utils import combinatorics as comb
from ..utils.precision import full_fp32_matmul

# The ROADMAP queue 1 item (by title) that ports each remaining format.
_NOT_PORTED = {
    "decomp": "Decomp format",
    "sparse_flat": "Sparse format",
}


def require_ported(A: SymmetricTensor) -> None:
    """Raise ``NotImplementedError`` naming its ROADMAP item if A's format
    is not ported yet (decomp and sparse)."""
    if A.format in _NOT_PORTED:
        raise NotImplementedError(
            f"the {A.format!r} format is not ported yet (ROADMAP queue 1: "
            f"{_NOT_PORTED[A.format]})"
        )


def _check_format(A) -> None:
    if not isinstance(A, SymmetricTensor):
        raise TypeError("first operand must be a SymmetricTensor")
    require_ported(A)


# ---------------------------------------------------------------------------
# Monomial symmetric polynomials via power sums (scalar-class path)
# ---------------------------------------------------------------------------


def power_sums(x: torch.Tensor, kmax: int) -> dict:
    """{k: Σ_i x_i^k} for k = 1..kmax, summed over the last axis."""
    x = torch.as_tensor(x)
    p = {}
    xk = x
    for k in range(1, kmax + 1):
        p[k] = xk.sum(-1)
        if k < kmax:
            xk = xk * x
    return p


def monomial_symmetric(counts, x) -> torch.Tensor:
    """m_λ(x) = Σ over the index classes of σ-class λ of ∏ x^λ, in
    O(r·d + #partitions) from power sums by the augmented-monomial
    recursion m̃_{λ∪μ} = m̃_λ·p_μ − Σ_t m̃_{λ with λ_t+μ}. x may carry
    leading batch axes."""
    x = torch.as_tensor(x)
    lam = tuple(sorted(comb.as_class_counts(counts), reverse=True))
    r = sum(lam)
    if r == 0:
        return torch.ones(x.shape[:-1], dtype=x.dtype, device=x.device)
    p = power_sums(x, r)
    memo = {}

    def aug(t):
        if not t:
            return 1.0
        if t in memo:
            return memo[t]
        rest, last = t[:-1], t[-1]
        val = aug(rest) * p[last]
        for i in range(len(rest)):
            merged = tuple(
                sorted(rest[:i] + (rest[i] + last,) + rest[i + 1:],
                       reverse=True)
            )
            val = val - aug(merged)
        memo[t] = val
        return val

    denom = 1
    for m in Counter(lam).values():
        denom *= math.factorial(m)
    return aug(lam) / denom


# ---------------------------------------------------------------------------
# contract_all_indices_with_vector
# ---------------------------------------------------------------------------


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


def _contract_vec_permcls(A, x: torch.Tensor) -> torch.Tensor:
    """Per-σ-class evaluation over x of shape (dim,) or (B, dim): scalar
    classes from power sums, reading no table; the vector classes packed
    into one flat tensor (zeros at the scalar classes' positions) through
    the flat route, the group-pass kernel on the card."""
    from ..kernels.poly_eval import poly_eval_flat_batched, poly_eval_flat_fast

    ct = torch.promote_types(A.dtype, x.dtype)
    total = torch.zeros(x.shape[:-1], dtype=ct, device=x.device)
    vector = {}
    for cnts, leaf in A.data.items():
        if leaf.ndim:
            vector[cnts] = leaf
            continue
        gamma = comb.class_multiplicity(cnts) if A.rank else 1
        total = total + leaf * gamma * monomial_symmetric(cnts, x)
    if vector:
        flat = type(A)._raw(A.rank, A.dim, vector).toflat()
        ev = poly_eval_flat_fast if x.ndim == 1 else poly_eval_flat_batched
        total = total + ev(flat, x).to(ct)
    return total


def _contract_vec_dense(A, x: torch.Tensor) -> torch.Tensor:
    """r contractions of the dense data with x of shape (..., dim): one
    GEMM against all inputs, then r − 1 batched contractions."""
    x = x.to(A.dtype)
    if A.rank == 0:
        return A.data.expand(x.shape[:-1])
    d = A.dim
    xt = x.movedim(-1, 0).reshape(d, -1)  # (d, inputs)
    with full_fp32_matmul():
        out = A.data.reshape(-1, d) @ xt  # (d^(r-1), inputs)
        for _ in range(A.rank - 1):
            out = torch.einsum("mib,ib->mb", out.reshape(-1, d, xt.shape[1]), xt)
    return out.reshape(x.shape[:-1])


def contract_all_indices_with_vector(symtensor, x) -> torch.Tensor:
    """Σ_{i1…ir} A_{i1…ir} x_{i1}…x_{ir}, as a 0-d tensor on the tensor's
    device. A CUDA flat tensor of rank ≥ 3 goes through the hand-written
    group-pass kernel."""
    from ..kernels.poly_eval import poly_eval_flat_fast

    A = symtensor
    _check_format(A)
    x = torch.as_tensor(x, device=A.device)
    if A.rank > 0 and tuple(x.shape) != (A.dim,):
        raise ValueError(
            f"vector length {tuple(x.shape)} must match dim {A.dim} "
            "(reference symalg.py:517)"
        )
    if A.format == "permcls":
        return _contract_vec_permcls(A, x)
    if A.format == "dense":
        return _contract_vec_dense(A, x)
    return poly_eval_flat_fast(A.toflat(), x)


def contract_all_indices_with_vector_batched(symtensor, xs) -> torch.Tensor:
    """Batched polynomial evaluation: xs (B, dim) → (B,). Flat tensors go
    through per-group GEMMs."""
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
    if A.format == "permcls":
        return _contract_vec_permcls(A, xs)
    if A.format == "dense":
        return _contract_vec_dense(A, xs)
    return poly_eval_flat_batched(A.toflat(), xs)
