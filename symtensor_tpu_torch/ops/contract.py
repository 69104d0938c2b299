"""Domain contractions on symmetric storage.

The counterpart of ``symtensor_tpu/ops/contract.py``:
``contract_all_indices_with_vector`` and its batched form and
``contract_tensor_list`` and ``contract_all_indices_with_matrix`` for the
flat, permcls, dense and decomp formats.

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
- Decomp: Σ_a w[a]·∏_t (f_{a_t}·x)^{m_t}, O(num_factors·dim) plus the
  weights (``DecompSymmetricTensor.contract_all_indices_with_vector``).

The batched op computes what ``jax.vmap`` of the single-input op computes:
flat tensors and the vector classes of permcls ones through per-group
GEMMs, scalar classes, dense and decomp tensors by the same arithmetic on
a leading batch axis.

``contract_all_indices_with_matrix`` (basis change) is one factor matmul
on a decomp tensor and r tensordots on a dense one; flat and permcls
tensors go through the packed basis change of ``ops/basis_change.py`` (a
permcls tensor by way of ``toflat()`` and back): its whole-level route
where the levels fit, its blocked route past that.

``contract_tensor_list`` contracts n indices of A against a list of
tensors χ_i, on packed values in plain torch, as the JAX package computes
it in XLA: one gather through ``Tables.insert_table`` and one GEMM for
n = 1, then the subset combine. For n ≥ 2 it peels one index at a time:
a Python loop over the contracted values i with one accumulator, each
step a recursive n − 1 call and one ``symmetric_outer`` with χ_i, which
on a CUDA tensor is one launch of the gather-combine kernel (the JAX
package runs the same loop as ``jax.vmap`` at n = 2 and ``lax.scan``
above; the sum's order differs from vmap's, so the two agree to
rounding).

- Sparse: Σ over the stored entries of γ_I·v_I·∏_k x[rep_I[k]], in
  O(nnz·r) (``SparseFlatSymmetricTensor.contract_all_indices_with_vector``),
  batched over blocks of entries. The other contractions take its
  ``toflat()``.
"""

from __future__ import annotations

import math
from collections import Counter
from typing import Sequence

import torch

from ..core.base import SymmetricTensor, require_local
from ..core.dense import DenseSymmetricTensor
from ..core.flat import FlatSymmetricTensor
from ..utils import combinatorics as comb
from ..utils.precision import full_fp32_matmul


def _check_format(A, sharded_ok: bool = False) -> None:
    if not isinstance(A, SymmetricTensor):
        raise TypeError("first operand must be a SymmetricTensor")
    if not sharded_ok:
        require_local("contraction", A)


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
    if A.format in ("decomp", "sparse_flat"):
        return A.contract_all_indices_with_vector(x)
    if A.format == "permcls":
        return _contract_vec_permcls(A, x)
    if A.format == "dense":
        return _contract_vec_dense(A, x)
    return poly_eval_flat_fast(A.toflat(), x)


def contract_all_indices_with_vector_batched(symtensor, xs) -> torch.Tensor:
    """Batched polynomial evaluation: xs (B, dim) → (B,). Flat tensors go
    through per-group GEMMs, sparse ones over blocks of entries."""
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
    if A.format == "decomp":
        return A.contract_all_indices_with_vector(xs)
    if A.format == "sparse_flat":
        return A.contract_all_indices_with_vector_batched(xs)
    if A.format == "permcls":
        return _contract_vec_permcls(A, xs)
    if A.format == "dense":
        return _contract_vec_dense(A, xs)
    return poly_eval_flat_batched(A.toflat(), xs)


# ---------------------------------------------------------------------------
# contract_all_indices_with_matrix (basis change)
# ---------------------------------------------------------------------------


def contract_all_indices_with_matrix(symtensor, W, **kw):
    """C_{j1…jr} = Σ_{i1…ir} A_{i1…ir} W_{i1 j1} … W_{ir jr}. A rectangular
    W changes the dimension. Contracting every index of a symmetric tensor
    gives a symmetric tensor, so nothing is symmetrized, and the result
    keeps the operand's format. Decomp: one factor matmul; dense: r
    tensordots. Flat and permcls tensors run the packed basis change
    (``ops/basis_change.basis_change_packed``), which takes the keywords
    `store_dtype`, `acc_dtype`, `block_elems`, `transient_elems`,
    `onthefly_above`, `donate_root`, `mesh` and `tp_axis`: its whole-level
    route where the levels and tables fit, its blocked route past that and
    whenever one of `block_elems` … `donate_root` is named, and under a
    device mesh the sharded blocked route of the parallel layer (A may then
    be ``parallel.shard_flat``)."""
    A = symtensor
    _check_format(A, sharded_ok=kw.get("mesh") is not None)
    if A.format == "decomp":
        return A.contract_all_indices_with_matrix(W)
    if A.format == "dense":
        W = torch.as_tensor(W, device=A.device).to(A.dtype)
        out = A.data
        with full_fp32_matmul():
            for _ in range(A.rank):
                # contract the leading original axis; the new axis goes last
                out = torch.tensordot(out, W, dims=([0], [0]))
        return DenseSymmetricTensor._raw(
            A.rank, W.shape[1] if A.rank else A.dim, out
        )
    from .basis_change import basis_change_packed

    flat = basis_change_packed(A.toflat(), W, **kw)
    if A.format == "permcls":
        return flat.topermcls()
    return flat


# ---------------------------------------------------------------------------
# contract_tensor_list
# ---------------------------------------------------------------------------


def _stack_flat(tensor_list) -> torch.Tensor:
    return torch.stack([chi.toflat().data for chi in tensor_list])  # (d, n_m)


def _combine_bilinear(T: torch.Tensor, ra: int, rb: int, dim: int):
    """out_K = (1/C(r, ra)) Σ_S T[posA(K_S), posB(K_∖S)] for a joint matrix
    T of shape (n_ra, n_rb): the generalized symmetric outer."""
    from . import outer as outer_mod

    ta, tb = outer_mod._subset_tables(ra, rb, dim, T.device)
    n_sub = ta.shape[0]
    acc = None
    for s in range(n_sub):
        term = T[ta[s].long(), tb[s].long()]
        acc = term if acc is None else acc + term
    if ra + rb == 0:
        return FlatSymmetricTensor._raw(0, 1, (acc / n_sub).reshape(1))
    return FlatSymmetricTensor._raw(ra + rb, dim, acc / n_sub)


def contract_tensor_list(
    symtensor,
    tensor_list: Sequence[SymmetricTensor],
    n_times: int = 1,
    rule: str = "all",
):
    """B = Symmetrize[ Σ_{i1…in} A[i1,…,in, …] ⊗ χ_{i1} ⊗ … ⊗ χ_{in} ].
    `tensor_list` stands for the first index of a quasi-symmetric χ; the
    result, a flat tensor, has rank (r − n) + n·m.

    `rule` = 'all' contracts every index value, 'second_half' only the
    values ≥ ⌈d/2⌉."""
    from . import outer as outer_mod

    A = symtensor
    _check_format(A)
    tensor_list = list(tensor_list)
    if n_times > A.rank:
        raise ValueError(
            f"n_times={n_times} exceeds tensor rank {A.rank}"
        )
    if len(tensor_list) != A.dim:
        raise ValueError(
            f"tensor_list length {len(tensor_list)} must equal dim {A.dim}"
        )
    ranks = {chi.rank for chi in tensor_list}
    dims = {chi.dim for chi in tensor_list}
    if len(ranks) > 1 or len(dims) > 1:
        raise ValueError("tensor_list entries must all have the same shape")
    m = ranks.pop()
    if dims.pop() != A.dim:
        raise ValueError("tensor_list entries must match symtensor's dim")

    d = A.dim
    if rule == "second_half":
        values = list(range(math.ceil(d / 2), d))
    elif rule == "all":
        values = list(range(d))
    else:
        raise ValueError(f"unknown rule {rule!r}")

    Af = A.toflat()
    X = _stack_flat(tensor_list).to(Af.dtype)  # (d, n_m)

    def masked(coeff):
        """Zero the columns (last axis, the contracted value) that the
        rule leaves out."""
        if rule == "all":
            return coeff
        mask = torch.zeros(d, dtype=coeff.dtype, device=coeff.device)
        mask[values] = 1
        return coeff * mask

    # rank-1 path: B = Σ_i A_i χ_i
    if A.rank == 1 and n_times == 1:
        with full_fp32_matmul():
            return FlatSymmetricTensor._raw(m, d, masked(Af.data) @ X)

    ins = Af.tables.insert_table(A.rank - 1)  # (N_{r-1}, d)
    if n_times == 1:
        # T[I, J] = Σ_i A[sort(I∪i)] χ_i[J]: one matmul, then the subset
        # combine.
        MA = masked(Af.data[ins])  # (N_{r-1}, d)
        with full_fp32_matmul():
            T = MA @ X  # (N_{r-1}, n_m)
        return _combine_bilinear(T, A.rank - 1, m, d)

    # n ≥ 2: peel one contraction index and recurse,
    # B = Σ_i sym( contract_tensor_list(A[i,…], χ, n−1) ⊗ χ_i ):
    # the nested symmetrizations collapse into the outer one, so the sum
    # over ordered i is exact. One accumulator keeps the peak at one
    # output vector.
    A_parts = Af.data[ins.T]  # (d, N_{r-1}): every partial A[i, …]
    chis = [FlatSymmetricTensor._raw(m, d, X[i]) for i in range(d)]
    total = None
    for i in values:
        Ai = FlatSymmetricTensor._raw(A.rank - 1, d, A_parts[i])
        Ci = contract_tensor_list(Ai, chis, n_times=n_times - 1, rule=rule)
        term = outer_mod.symmetric_outer(Ci, chis[i]).data
        total = term if total is None else total + term
    out_rank = (A.rank - n_times) + n_times * m
    if total is None:  # dim 1 under 'second_half': nothing is contracted
        total = torch.zeros(comb.indep_size(out_rank, d), dtype=Af.dtype,
                            device=Af.device)
    return FlatSymmetricTensor._raw(out_rank, d, total)
