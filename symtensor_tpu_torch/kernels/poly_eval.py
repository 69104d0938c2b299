"""Grouped polynomial evaluation on packed storage.

The counterpart of ``symtensor_tpu/kernels/poly_eval.py``. It computes

    Σ_{i1…ir} A_{i1…ir} x_{i1}…x_{ir} = r!·Σ_I vals_I·W_I

with W_I = ∏_v x_v^{c_v}/c_v! (EGF weights). Every gflat component is
(head ≤ j, j, tail pair ≥ j), so the sum factorizes into d GEMVs, one per
group j, against contiguous slices of a triangle-monomial vector, plus
per-head corrections for tails that touch j:

    result = r!·Σ_j Σ_h M̃_h · [ c1(q)·⟨V_h, TRI_j⟩
                               + c2(q)·⟨V_h[:d−j], TRI_row_j⟩
                               + c3(q)·V_h[0]·TRI_cell_j ]

M̃ are the EGF head monomials and q is the head's trailing run of j.

Entry points:

- ``poly_eval_flat_fast`` — the public op's route for rank ≥ 3: one
  ``group_pass`` (the hand-written kernel on a CUDA tensor) over all
  groups, then the epilogue above vectorised over all rows at once.
- ``poly_eval_flat`` — the plain per-group loop, the twin of the JAX
  package's ``poly_eval_flat``.
- ``poly_eval_flat_batched`` — per-group ``torch.matmul`` GEMMs for a batch
  of inputs (never a Pallas kernel in the JAX package either).

A group block is the zero-copy view ``vals[goff:goff+P*T].view(P, T)``.
Three parts of the JAX module exist only for the TPU and are left behind:
the transposed narrow groups, the optimization barriers and the view
copies. The premultiplied form waits (ROADMAP).
"""

from __future__ import annotations

import math
from functools import lru_cache

import numpy as np
import torch

from ..core.flat import FlatSymmetricTensor
from ..utils import combinatorics as comb
from ..utils.precision import full_fp32_matmul
from .group_pass import acc_dtype, group_pass, row_offsets


@lru_cache(maxsize=None)
def _grouped_static(rank: int, dim: int):
    """Static per-(rank, dim) data for the grouped evaluation."""
    lay = comb.gflat_layout(rank, dim)
    P = [int(v) for v in lay.P]
    T = [int(v) for v in lay.T]
    goff = [int(v) for v in lay.group_off]
    toff = [int(v) for v in lay.tri_off]
    return P, T, goff, toff


def _compute_dtype(vals: torch.Tensor, x: torch.Tensor) -> torch.dtype:
    """The evaluation's type: the promotion of values and input, at least
    float32 (bfloat16 values accumulate in float32)."""
    ct = torch.promote_types(vals.dtype, x.dtype)
    if not ct.is_floating_point or ct in (torch.bfloat16, torch.float16):
        ct = torch.promote_types(ct, torch.float32)
    return ct


def _tri(t, x: torch.Tensor) -> torch.Tensor:
    """Triangle monomials x_a·x_b over a ≤ b, diagonal cells halved
    (x_u²/2!). x may carry leading batch axes."""
    ta, tb = t.tri_pairs
    tri = x[..., ta] * x[..., tb]
    return tri * torch.where(ta == tb, 0.5, 1.0).to(x.dtype)


def _head_runs(t, rank: int):
    """(maxel, maxrun) int64 per head (colex): each head's largest value
    and its run length, which give the head's trailing run q of j."""
    if rank == 3:  # the empty head: no value equals any j
        return (
            torch.full((1,), -1, dtype=torch.int64, device=t.device),
            torch.zeros((1,), dtype=torch.int64, device=t.device),
        )
    _, maxel, maxrun = t.mono_tables_weighted(rank - 3)[-1]
    return maxel, maxrun


def _head_weights(t, x: torch.Tensor, rank: int):
    """EGF head monomials M̃ (colex, size N_{r-3}; x may carry leading
    batch axes) plus the (maxel, maxrun) tables of ``_head_runs``."""
    w = torch.ones((*x.shape[:-1], 1), dtype=x.dtype, device=x.device)
    if rank > 3:
        for par, mx, run in t.mono_tables_weighted(rank - 3):
            w = w[..., par] * x[..., mx] / run.to(x.dtype)
    return (w, *_head_runs(t, rank))


def _corrections(q: torch.Tensor, xj: torch.Tensor):
    """(c1, c2, c3) for trailing run q and input value x_j."""
    c1 = xj / (q + 1)
    c2 = c1 * (1.0 / (q + 2) - 1.0)
    c3 = c1 * (2.0 / ((q + 2) * (q + 3)) - 1.0 / (q + 2))
    return c1, c2, c3


def _low_rank(vals: torch.Tensor, x: torch.Tensor, r: int, t, ct):
    """Ranks 0-2 in plain torch (no groups to pass over)."""
    if r == 0:
        return vals[0].to(ct)
    with full_fp32_matmul():
        if r == 1:
            return torch.dot(vals.to(ct), x)
        return 2.0 * torch.dot(vals.to(ct), _tri(t, x))


def _prepare(A: FlatSymmetricTensor, x):
    x = torch.as_tensor(x, device=A.device)
    ct = _compute_dtype(A.data, x)
    return x.to(ct), ct


def poly_eval_flat(A: FlatSymmetricTensor, x) -> torch.Tensor:
    """Single-input full contraction, plain per-group loop."""
    r, d = A.rank, A.dim
    x, ct = _prepare(A, x)
    vals = A.data
    t = A.tables
    if r < 3:
        return _low_rank(vals, x, r, t, ct)
    tri = _tri(t, x)
    M, maxel, maxrun = _head_weights(t, x, r)
    P, T, goff, toff = _grouped_static(r, d)
    total = torch.zeros((), dtype=ct, device=vals.device)
    with full_fp32_matmul():
        for j in range(d):
            Pj, Tj = P[j], T[j]
            V = vals[goff[j] : goff[j] + Pj * Tj].view(Pj, Tj)
            if V.dtype != ct:  # bfloat16 storage: accumulate in float32
                V = V.to(ct)
            tri_j = tri[toff[j] : toff[j] + Tj]
            rl = d - j
            u_full = torch.mv(V, tri_j)
            u_row = torch.mv(V[:, :rl], tri_j[:rl])
            u_cell = V[:, 0] * tri_j[0]
            q = torch.where(maxel[:Pj] == j, maxrun[:Pj], 0).to(ct)
            c1, c2, c3 = _corrections(q, x[j])
            total = total + torch.dot(
                M[:Pj], c1 * u_full + c2 * u_row + c3 * u_cell
            )
    return float(math.factorial(r)) * total


def _row_maps(t):
    """Static per-row data of the group pass's output columns, on the
    tables' device: group j and head index p (int64), and the correction
    weights (c1, c2, c3) / x_j of each row's trailing run q, as one
    (3, ΣP_j) float64 tensor."""

    def build():
        P = t.layout.P
        rg = np.repeat(np.arange(len(P), dtype=np.int64), P)
        rh = np.arange(int(P.sum()), dtype=np.int64)
        rh -= np.repeat(row_offsets(t.layout), P)
        maxel, maxrun = (v.cpu().numpy() for v in _head_runs(t, t.rank))
        q = np.where(maxel[rh] == rg, maxrun[rh], 0).astype(np.float64)
        w = torch.stack(_corrections(torch.from_numpy(q), 1.0))
        return (
            torch.as_tensor(rg, device=t.device),
            torch.as_tensor(rh, device=t.device),
            w.to(t.device),
        )

    return t.memo("group_pass_rows", build)


def poly_eval_flat_fast(A: FlatSymmetricTensor, x) -> torch.Tensor:
    """Single-input full contraction through one ``group_pass`` (the CUDA
    kernel on a CUDA tensor) and an epilogue vectorised over all rows.

    The epilogue sums in float64 whatever the storage type: the three
    correction weights of a row cancel (c1 + c2 + c3 = c1/15 at q = 3),
    which costs float32 a few bits, and the ΣP_j rows are few next to
    the n values."""
    r = A.rank
    x, ct = _prepare(A, x)
    t = A.tables
    if r < 3:
        return _low_rank(A.data, x, r, t, ct)
    u = group_pass(A.data, _tri(t, x.to(acc_dtype(A.dtype))), t.layout)
    x64 = x.to(torch.float64)
    M, _, _ = _head_weights(t, x64, r)
    rg, rh, w = _row_maps(t)
    per_row = (w * u.to(torch.float64)).sum(0)
    total = torch.dot(M[rh] * x64[rg], per_row)
    return (float(math.factorial(r)) * total).to(ct)


def poly_eval_flat_batched(A: FlatSymmetricTensor, xs) -> torch.Tensor:
    """Batched contraction: xs (B, d) → (B,). The per-group GEMVs become
    GEMMs (B, T_j) @ (T_j, P_j), in full float32 for float32 operands."""
    r, d = A.rank, A.dim
    xs, ct = _prepare(A, xs)
    vals = A.data
    B = xs.shape[0]
    if r == 0:
        return vals[0].to(ct).expand(B)
    t = A.tables
    with full_fp32_matmul():
        if r == 1:
            return xs @ vals.to(ct)
        tri = _tri(t, xs)  # (B, Ttri)
        if r == 2:
            return 2.0 * (tri @ vals.to(ct))
        M, maxel, maxrun = _head_weights(t, xs, r)
        P, T, goff, toff = _grouped_static(r, d)
        total = torch.zeros((B,), dtype=ct, device=vals.device)
        for j in range(d):
            Pj, Tj = P[j], T[j]
            V = vals[goff[j] : goff[j] + Pj * Tj].view(Pj, Tj)
            if V.dtype != ct:
                V = V.to(ct)
            tri_j = tri[:, toff[j] : toff[j] + Tj]
            rl = d - j
            u_full = tri_j @ V.T  # (B, Pj)
            u_row = tri_j[:, :rl] @ V[:, :rl].T
            u_cell = tri_j[:, :1] * V[None, :, 0]
            q = torch.where(maxel[:Pj] == j, maxrun[:Pj], 0).to(ct)
            c1, c2, c3 = _corrections(q[None, :], xs[:, j : j + 1])
            total = total + torch.einsum(
                "bp,bp->b", M[:, :Pj], c1 * u_full + c2 * u_row + c3 * u_cell
            )
    return float(math.factorial(r)) * total
