"""Basis change  C = A · W ⊗ … ⊗ W  on packed storage, whole-level route.

The counterpart of the whole-op route of ``symtensor_tpu/ops/basis_change.py``
(``_basis_change_small`` behind ``basis_change_packed``); the blocked
depth-first recursion that the JAX package takes past the gate is not
ported yet, and a shape past the gate raises ``NotImplementedError``.

Algorithm
---------
Output multisets β (sorted ascending) are built level by level, appending
their max element b. The level-t state rows are partial contractions

    U_t[β₁…β_t, α] = Σ_{i₁…i_t} A[{i₁…i_t} ∪ α] · W[i₁,β₁] ⋯ W[i_t,β_t]

over all size-(r−t) original multisets α (gflat storage order). One step:

    U_{t+1}[(β, b), j] = Σ_i U_t[β, insert_k(j, i)] · W[i, b]     (k = r−t−1)

which is exact with no multiplicity bookkeeping because the slots are
contracted in order and A is symmetric; evaluating at sorted β gives every
independent component of the (automatically symmetric) result. Rows are
kept in colex order of β: the children with new element b have as parents
the colex prefix of length C(b + t, t), so a level is a gather through
``Tables.insert_table(k)``, one GEMM against a column window of W, and a
row pick through ``Tables.mono_tables(t + 1)``; ``colex_perm`` puts the
last level into storage order.

This route holds whole levels on the device: the parent level (P_t × N_{r−t}),
the child level, and transients bounded by an element budget (the gathered
rows of a chunk, the product of a window, a picked segment). It is plain
torch (gathers, ``einsum`` in full float32, index picks), so autograd
differentiates through it with respect to both the values and W; under
autograd every level stays alive for the backward pass, and the residency
reckoned here is the forward pass's alone.
"""

from __future__ import annotations

import os
from typing import List, Optional, Tuple

import torch

from ..config import config
from ..core.flat import FlatSymmetricTensor
from ..utils import combinatorics as comb
from ..utils.precision import full_fp32_matmul
from ..utils.tables import tables

# Element budget of one transient (the gathered rows of a row chunk, the
# product of a window of W's columns): 1 GiB in float32. On an NVIDIA H100
# 80GB HBM3 (700 W) the packed change ran 11.50 ms at rank 5 dim 60 and
# 5.49 ms at rank 6 dim 32 under this budget against 13.18 and 6.88 ms
# under 2**26, for 0.72 and 0.07 GB more peak memory
# (tools/basis_change_probe.py); rank 4 dim 100 is one chunk a level under
# either.
_SMALL_BUDGET = 2**28

# Default of $SYMTENSOR_BASIS_SMALL_ELEMS, the gate on the projected peak
# residency in elements of the accumulation type. 2**32 elements are 17 GB
# in float32 and 34 GB in float64; the static tables add at most about 5 GB
# under the default ``config.max_table_entries``, so a gated call stays
# under half of an 80 GB card. On that card ``max_memory_allocated`` over a
# call stayed at or under the projection: 0.592 GB against 0.575 GB
# projected at rank 4 dim 100 (the result's 18 MB is the difference), 1.16
# against 1.26 GB at rank 5 dim 60, 0.89 against 1.00 GB at rank 6 dim 32
# (budget 2**26; chip_smoke.py phases 19-20). Under the default table guard
# the guard trips first: the largest shapes it lets through (rank 6 dim 38)
# project under 1e9 elements.
_SMALL_ELEMS = 2**32

_NEXT = "ROADMAP queue 1: Basis change, blocked recursion"


def _n_cols(k: int, d: int) -> int:
    """Columns of a level whose rows still carry k original indices."""
    return comb.indep_size(k, d) if k >= 1 else 1


def _window_chunks(t: int, N_k: int, d_out: int, budget: int) -> List[Tuple[int, int]]:
    """Greedy windows [b0, b1) of new max elements: the product of a
    window, (parents of b1 − 1) × N_k × (b1 − b0), stays under `budget`
    (a window of one column is always taken)."""
    chunks = []
    b0 = 0
    while b0 < d_out:
        b1 = b0 + 1
        while (b1 < d_out
               and comb.multiset_count(b1 + 1, t) * N_k * (b1 + 1 - b0) <= budget):
            b1 += 1
        chunks.append((b0, b1))
        b0 = b1
    return chunks


def _row_chunk(mm: int, N_k: int, d: int, budget: int) -> int:
    """Parent rows gathered at a time: (rows × N_k × d) under `budget`."""
    return max(1, min(mm, budget // (N_k * d)))


def _small_peak_elems(r: int, d: int, d_out: int, budget: int) -> int:
    """Projected peak residency of the whole-level route, in elements of
    the accumulation type, following the allocations of
    ``_basis_change_levels``: at level t the parent level, the child level
    (allocated once and filled window by window; with a single window the
    picked rows are the child level), the window's product, and the larger
    of (one row chunk's gathered rows and, when the rows are chunked, its
    product) and (the window's picked segment on its way into the child
    level)."""
    peak = 0
    for t in range(r):
        k = r - t - 1
        N_k = _n_cols(k, d)
        parent = comb.multiset_count(d_out, t) * comb.indep_size(k + 1, d)
        child = comb.multiset_count(d_out, t + 1) * N_k
        chunks = _window_chunks(t, N_k, d_out, budget)
        for b0, b1 in chunks:
            mm = comb.multiset_count(b1, t)
            width = b1 - b0
            product = mm * N_k * width
            gathered = 0
            if k >= 1:
                rows = _row_chunk(mm, N_k, d, budget)
                gathered = rows * N_k * d
                if rows < mm:
                    gathered += rows * N_k * width
            segment = 0
            if len(chunks) > 1:
                segment = (comb.multiset_count(b1, t + 1)
                           - comb.multiset_count(b0, t + 1)) * N_k
            peak = max(peak, parent + child + product + max(gathered, segment))
    return peak


def _small_table_entries(r: int, d: int, d_out: int) -> List[Tuple[str, int]]:
    """(name, entries) of every static table the route builds, as
    ``utils/tables.py`` guards them against ``config.max_table_entries``:
    the insert tables of the operand's dim (int64 on the device: 8 bytes an
    entry of N_k · d, guarded at N_k · d · (k + 1) for the host sort), the
    colex levels and the storage order of the result's dim."""
    out = [(f"insert_table({k}) at dim {d}",
            comb.indep_size(k, d) * d * (k + 1)) for k in range(1, r)]
    out += [(f"mono_tables({s}) at dim {d_out}", comb.multiset_count(d_out, s))
            for s in range(1, r + 1)]
    out.append((f"rep_indices of rank {r} dim {d_out}",
                comb.indep_size(r, d_out) * r))
    return out


def _extend(U_pref: torch.Tensor, tbl: Optional[torch.Tensor], Wslice: torch.Tensor,
            budget: int) -> torch.Tensor:
    """H[p, j, b] = Σ_i U_pref[p, insert(j, i)] · W[i, b] for a prefix of
    parent rows and a window of W's columns: (mm, N_k, width). Rows are
    gathered `_row_chunk` at a time, the last chunk ragged."""
    mm, d, width = U_pref.shape[0], Wslice.shape[0], Wslice.shape[1]
    if tbl is None:  # k = 0: the rows are the last original index
        return torch.einsum("pji,ib->pjb", U_pref.reshape(mm, 1, d), Wslice)
    N_k = tbl.shape[0]
    rows = _row_chunk(mm, N_k, d, budget)
    if rows >= mm:
        return torch.einsum("pji,ib->pjb", U_pref[:, tbl], Wslice)
    H = torch.empty((mm, N_k, width), dtype=U_pref.dtype, device=U_pref.device)
    for p0 in range(0, mm, rows):
        H[p0:p0 + rows] = torch.einsum(
            "pji,ib->pjb", U_pref[p0:p0 + rows][:, tbl], Wslice)
    return H


def _basis_change_levels(data: torch.Tensor, W: torch.Tensor, r: int, d: int,
                         d_out: int, store_dtype: torch.dtype,
                         acc_dtype: torch.dtype, budget: int) -> torch.Tensor:
    """The whole-level route on packed values of rank r ≥ 2: returns the
    packed values of the result over d_out, in `store_dtype`. The levels
    live in `acc_dtype`; `store_dtype` only casts the result. `budget`
    bounds each transient in elements; any budget gives the same values up
    to the GEMMs' rounding."""
    t_in = tables(r, d, data.device)
    t_out = tables(r, d_out, data.device)
    U = data.to(acc_dtype).reshape(1, -1)
    Wc = W.to(acc_dtype)
    with full_fp32_matmul():
        for t in range(r):
            k = r - t - 1
            tbl = t_in.insert_table(k) if k >= 1 else None  # (N_k, d)
            N_k = _n_cols(k, d)
            par, mx = t_out.mono_tables(t + 1)  # colex level t + 1 over d_out
            chunks = _window_chunks(t, N_k, d_out, budget)
            child = None
            for b0, b1 in chunks:
                # parents of the children with max element < b1: a colex prefix
                mm = comb.multiset_count(b1, t)
                H = _extend(U[:mm], tbl, Wc[:, b0:b1], budget)
                o0 = comb.multiset_count(b0, t + 1)
                o1 = comb.multiset_count(b1, t + 1)
                seg = H[par[o0:o1], :, mx[o0:o1] - b0]  # (o1 − o0, N_k)
                del H
                if len(chunks) == 1:
                    child = seg
                else:
                    if child is None:
                        child = torch.empty((par.shape[0], N_k), dtype=U.dtype,
                                            device=U.device)
                    child[o0:o1] = seg
                del seg
            U = child  # the parent level is freed here
    # U: (P_r, 1) in colex order of the output multisets → storage order
    return U[:, 0][t_out.colex_perm].to(store_dtype)


def _check_gate(r: int, d: int, d_out: int, budget: int) -> None:
    """Raise ``NotImplementedError`` for a shape that the whole-level route
    does not reach, before any table is built."""
    small_elems = int(os.environ.get("SYMTENSOR_BASIS_SMALL_ELEMS", _SMALL_ELEMS))
    peak = _small_peak_elems(r, d, d_out, budget)
    if peak > small_elems:
        raise NotImplementedError(
            f"basis change of rank {r} dim {d} -> {d_out}: the whole-level "
            f"route would hold {peak:,} elements (> "
            f"$SYMTENSOR_BASIS_SMALL_ELEMS = {small_elems:,}), and the blocked "
            f"recursion for larger shapes is not ported yet ({_NEXT})"
        )
    for name, entries in _small_table_entries(r, d, d_out):
        if entries > config.max_table_entries:
            raise NotImplementedError(
                f"basis change of rank {r} dim {d} -> {d_out}: the whole-level "
                f"route needs the static table {name} of {entries:,} entries "
                f"(> config.max_table_entries = {config.max_table_entries:,}), "
                "and the blocked recursion with on-the-fly ranking for larger "
                f"shapes is not ported yet ({_NEXT})"
            )


def basis_change_packed(A: FlatSymmetricTensor, W, *, store_dtype=None,
                        acc_dtype=None) -> FlatSymmetricTensor:
    """C = A · W ⊗ … ⊗ W of a packed symmetric tensor: a flat tensor of
    A's rank over W's second dimension, on A's device (W is moved there).

    store_dtype: type of the result (default A.dtype). The levels live in
      `acc_dtype`, so bfloat16 storage saves no residency on this route.
    acc_dtype: type of the levels and products (default float32, or
      float64 when the data is float64). float32 products run in full
      float32 (TF32 off).

    A shape whose projected residency exceeds $SYMTENSOR_BASIS_SMALL_ELEMS,
    or that needs a static table over ``config.max_table_entries``, raises
    ``NotImplementedError``: the blocked recursion that serves it is not
    ported yet, and nothing falls back to a dense or host route."""
    r, d = A.rank, A.dim
    W = torch.as_tensor(W, device=A.device)
    if W.ndim != 2 or W.shape[0] != d:
        raise ValueError(
            f"W must be (dim, d_out) = ({d}, ·); got {tuple(W.shape)} "
            "(reference symalg.py:481)"
        )
    d_out = int(W.shape[1])
    store_dt = store_dtype or A.dtype
    acc_dt = acc_dtype or (
        torch.float64 if A.dtype == torch.float64 else torch.float32)
    if r == 0:
        return FlatSymmetricTensor._raw(0, 1, A.data.to(store_dt))
    if r == 1:
        with full_fp32_matmul():
            out = A.data.to(acc_dt) @ W.to(acc_dt)
        return FlatSymmetricTensor._raw(1, d_out, out.to(store_dt))
    _check_gate(r, d, d_out, _SMALL_BUDGET)
    return FlatSymmetricTensor._raw(r, d_out, _basis_change_levels(
        A.data, W, r, d, d_out, store_dt, acc_dt, _SMALL_BUDGET))
