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

- ``poly_eval_flat_fast`` — the public op's route for rank ≥ 3. Without a
  gradient it is one ``group_eval``: the hand-written kernel (on a CUDA
  tensor) passes over all groups and weights each row's three sums by
  the epilogue above in float64 as it goes, leaving one scalar. With a
  gradient, one ``group_pass`` writes the rows' sums and the epilogue,
  vectorised over all rows at once, weights them
  (``_poly_eval_flat_unfused``).
- ``poly_eval_flat`` — the plain per-group loop, the twin of the JAX
  package's ``poly_eval_flat``.
- ``poly_eval_flat_batched`` — a batch of inputs. For float32 values on a
  CUDA tensor each rank ≥ 3 is one launch of the hand-written
  ``batched_eval`` kernel (``kernels/batched_eval.py``,
  ``csrc/batched_fold.cu``); the JAX package leaves this route to XLA's
  matmul, one per group, and so does the kernel's plain twin
  ``_batched_forward``, which CPU tensors and other types run.

The batched route folds each group's three corrections into the values,
Ṽ_j = V_j ⊙ ω_j, so one product gives the corrected row sums: w1·u_full +
w2·u_row + w3·u_cell = tri_j·Ṽ_jᵀ. The twin makes Ṽ_j as a transient
(P_j, T_j) copy (``_folded``) and runs one full-float32 GEMM a group; the
kernel weights each value tile as it loads it and weights the (b, p) sums
by M̃·x_j in registers, over all groups in one launch.

Gradients. ``poly_eval_flat_fast`` is differentiable in the values and in
x through its unfused route: ``group_pass`` carries its own backward
(``kernels/group_pass.py``) and so does the float64 epilogue
(``_Epilogue``), whose tensors have ΣP_j or d·N entries, not n.
``poly_eval_flat_batched`` runs rank ≥ 3 through ``_BatchedEval``, whose
forward (the kernel or its twin) runs without a graph and whose backward
(``batched_backward``, inside the span ``batched.backward.r<rank>``)
recomputes group by group in plain torch: with H_j[b, p] =
g_b·x_bj·M̃[b, p], dV_j = (H_jᵀ·tri_j) ⊙ the fold's weights and dtri_j =
H_j·Ṽ_j, GEMMs in full float32. It saves only its inputs, so nothing of size B × ΣP_j outlives a
group, and each dV_j is written into its slice of one n-sized buffer.
Those backwards are once differentiable: under ``create_graph=True``
they raise. ``poly_eval_flat`` is plain torch and autograd differentiates it
as it stands, to any order (a slower oracle: each group's view backward
adds a zero tensor of the whole leaf's size).

A group block is the zero-copy view ``vals[goff:goff+P*T].view(P, T)``.
Three parts of the JAX module exist only for the TPU and are left behind:
the transposed narrow groups, the optimization barriers and the plain
view copies.

The premultiplied form. The corrections are linear in x_j, c(q, x_j) =
x_j·c(q, 1), so ``group_views_premul`` folds the rows' weights c(q, 1)
(``row_weights``, as ``_fold_scales`` puts them on a row's columns) into
one copy of the values (the fold's Ṽ_j, kept), made once and cached on the
tensor: evaluation is one GEMV (``views_eval_premul``) or one GEMM
(``views_eval_batched_premul``) a group, with the weights M̃·x_j. The
cache costs a second copy of the values; ``_cached`` keys it to the
storage's address and version counter (an optimizer that steps the values
in place invalidates it) and never caches values that need a gradient.
``poly_eval_flat_batched`` takes the views for bfloat16 values that need
no gradient and for no other values: where the JAX package reads a cache
that already exists on the tensor, the port's fold runs float32 values
faster on the H100 than the cached views do (PERF.md). It routes eligible
tensors to ``cell_gemm.poly_eval_cell_batched`` under
``SYMTENSOR_BATCHED_CELL=1``. The single-input route stays the group pass,
which reads each value once for all three sums.
"""

from __future__ import annotations

import math
import os
import weakref
from functools import lru_cache
from typing import NamedTuple

import torch

from ..core.flat import FlatSymmetricTensor
from ..utils import combinatorics as comb
from ..utils.precision import compute_dtype, full_fp32_matmul
from ..utils.profiling import span, spanned
from ..utils.tables import tables
from .batched_eval import batched_eval, padded_batch
from .group_pass import (
    acc_dtype, corrections, group_eval, group_pass, head_runs,
    once_differentiable, row_offsets, row_maps, row_weights,
)


@lru_cache(maxsize=None)
def _grouped_static(rank: int, dim: int):
    """Static per-(rank, dim) data for the grouped evaluation."""
    lay = comb.gflat_layout(rank, dim)
    P = [int(v) for v in lay.P]
    T = [int(v) for v in lay.T]
    goff = [int(v) for v in lay.group_off]
    toff = [int(v) for v in lay.tri_off]
    return P, T, goff, toff


def _tri(t, x: torch.Tensor) -> torch.Tensor:
    """Triangle monomials x_a·x_b over a ≤ b, diagonal cells halved
    (x_u²/2!). x may carry leading batch axes."""
    ta, tb = t.tri_pairs
    tri = x[..., ta] * x[..., tb]
    return tri * torch.where(ta == tb, 0.5, 1.0).to(x.dtype)


def _head_weights(t, x: torch.Tensor, rank: int):
    """EGF head monomials M̃ (colex, size N_{r-3}; x may carry leading
    batch axes) plus the (maxel, maxrun) tables of ``head_runs``."""
    w = torch.ones((*x.shape[:-1], 1), dtype=x.dtype, device=x.device)
    if rank > 3:
        for par, mx, run in t.mono_tables_weighted(rank - 3):
            w = w[..., par] * x[..., mx] / run.to(x.dtype)
    return (w, *head_runs(t))


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
    ct = compute_dtype(A.data, x)
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
            c1, c2, c3 = corrections(q, x[j])
            total = total + torch.dot(
                M[:Pj], c1 * u_full + c2 * u_row + c3 * u_cell
            )
    return float(math.factorial(r)) * total


def _row_maps(t):
    """Static per-row data of the group pass's output columns, on the
    tables' device: each row's group j and head p (``row_maps``), and the
    correction weights (c1, c2, c3) / x_j of each row as one (3, ΣP_j)
    float64 tensor (``row_weights``, the evaluation mode's own decoding)."""
    rg, rh = row_maps(t.layout, t.device)
    return rg, rh, row_weights(t.layout, t.device).T


class _Epilogue(torch.autograd.Function):
    """Σ_rows M̃[p]·x_j·per_row over the ΣP_j rows (group j, head p): one
    ``dot`` forward. The backward sums through a (d, N) staircase U of the
    rows (N heads: the last group has them all; every cell is one row), so
    that ∂/∂M̃ = g·xᵀU and ∂/∂x = g·U·M̃ are two matrix-vector products
    where the rows' gathers would scatter-add into N and d entries."""

    @staticmethod
    def forward(ctx, per_row, M, x, rg, rh):
        ctx.save_for_backward(per_row, M, x, rg, rh)
        return torch.dot(M[rh] * x[rg], per_row)

    @staticmethod
    @once_differentiable
    def backward(ctx, g):
        per_row, M, x, rg, rh = ctx.saved_tensors
        need_row, need_M, need_x = ctx.needs_input_grad[:3]
        d_row = g * (M[rh] * x[rg]) if need_row else None
        dM = dx = None
        if need_M or need_x:
            U = per_row.new_zeros((x.shape[0], M.shape[0])).index_put_((rg, rh), per_row)
            dM = g * (x @ U) if need_M else None
            dx = g * (U @ M) if need_x else None
        return d_row, dM, dx, None, None


def poly_eval_flat_fast(A: FlatSymmetricTensor, x) -> torch.Tensor:
    """Single-input full contraction through the group-pass kernel (on a
    CUDA tensor; its twin on a CPU tensor); differentiable in the values
    and in x.

    Without a gradient (grad mode off, or neither the values nor x
    requiring one) it is one ``group_eval``: the kernel weights each row's
    three sums and reduces them to the float64 result in the same pass.
    With one, ``group_pass`` writes the rows and ``_poly_eval_flat_unfused``
    weights them in a differentiable epilogue. Either way the weighting
    sums in float64 whatever the storage type: the three correction weights
    of a row cancel (c1 + c2 + c3 = c1/15 at q = 3), which costs float32 a
    few bits."""
    r = A.rank
    if r >= 3 and not (torch.is_grad_enabled() and (
            A.data.requires_grad or getattr(x, "requires_grad", False))):
        return spanned("eval.single", _poly_eval_flat_fused, A, x)
    x, ct = _prepare(A, x)
    if r < 3:
        return _low_rank(A.data, x, r, A.tables, ct)
    with span("eval.single.unfused"):
        return _poly_eval_flat_unfused(A, x, ct)


def _poly_eval_flat_fused(A: FlatSymmetricTensor, x) -> torch.Tensor:
    """Rank ≥ 3 without a gradient: the head monomials M̃ and tri, then
    one ``group_eval``."""
    x, ct = _prepare(A, x)
    t = A.tables
    x64 = x.to(torch.float64).contiguous()  # x may be a strided view
    M = spanned("eval.single.heads", _head_weights, t, x64, A.rank)[0]
    tri = spanned("eval.single.tri", _tri, t, x.to(acc_dtype(A.dtype)))
    return group_eval(A.data, tri, M, x64, t.layout).to(ct)


def _poly_eval_flat_unfused(A: FlatSymmetricTensor, x: torch.Tensor, ct) -> torch.Tensor:
    """Rank ≥ 3, x already in the compute type ct (``_prepare``): one
    ``group_pass`` writes the (3, ΣP_j) rows, and an epilogue vectorised
    over them weights and sums them (``_Epilogue``: differentiable, one
    ``dot`` forward)."""
    r, t = A.rank, A.tables
    u = group_pass(A.data, _tri(t, x.to(acc_dtype(A.dtype))), t.layout)
    x64 = x.to(torch.float64)
    M, _, _ = _head_weights(t, x64, r)
    rg, rh, w = _row_maps(t)
    per_row = (w * u.to(torch.float64)).sum(0)
    total = _Epilogue.apply(per_row, M, x64, rg, rh)
    return (float(math.factorial(r)) * total).to(ct)


def _folded(V, w, rl: int) -> torch.Tensor:
    """Ṽ[p, t] = V[p, t]·(w1[p] + w2[p]·[t < rl] + w3[p]·[t = 0]), with
    (w1, w2, w3) = c(q_p, 1): the group's three corrected row sums as one
    product, w1·u_full + w2·u_row + w3·u_cell = tri_j·Ṽᵀ."""
    Vf = V * w[0][:, None]
    Vf[:, :rl] += V[:, :rl] * w[1][:, None]
    Vf[:, 0] += V[:, 0] * w[2]
    return Vf


def _fold_scales(w) -> torch.Tensor:
    """(3, rows, 1): each row's w1, w1 + w2 and w1 + w2 + w3, the factors
    ``_folded`` puts on the columns past the row, on the row and on the
    cell."""
    w12 = w[0] + w[1]
    return torch.stack([w[0], w12, w12 + w[2]])[..., None]


def _scale_folded(G, s, rl: int) -> torch.Tensor:
    """G ⊙ the weight pattern of ``_folded``, in place; s is the group's
    slice of ``_fold_scales``."""
    G[:, rl:].mul_(s[0])
    G[:, 1:rl].mul_(s[1])
    G[:, :1].mul_(s[2])
    return G


def _batched_forward(vals, xs, t, r: int, d: int, ct) -> torch.Tensor:
    """Σ_j Σ_p M̃[b, p]·x_bj·S_j[b, p] (the corrections are linear in
    x_j: c(q, x_j) = x_j·c(q, 1)), scaled by r!."""
    with span("batched.heads"):
        tri = _tri(t, xs)  # (B, Ttri)
        M, _, _ = _head_weights(t, xs, r)
    P, T, goff, toff = _grouped_static(r, d)
    wall, prow = _row_maps(t)[2].to(ct), row_offsets(t.layout)
    total = torch.zeros((xs.shape[0],), dtype=ct, device=vals.device)
    for j in range(d):
        Pj, Tj = P[j], T[j]
        V = vals[goff[j] : goff[j] + Pj * Tj].view(Pj, Tj)
        if V.dtype != ct:
            V = V.to(ct)
        w = wall[:, prow[j] : prow[j] + Pj]  # c(q_p, 1) of the group's rows
        S = tri[:, toff[j] : toff[j] + Tj] @ _folded(V, w, d - j).T  # (B, Pj)
        total += xs[:, j] * torch.einsum("bp,bp->b", M[:, :Pj], S)
    return float(math.factorial(r)) * total


def _batched_kernel_inputs(xs, t, r: int, d: int) -> tuple:
    """What ``batched_eval`` reads besides the values: tri transposed to
    (Ttri, Bp), zero past the batch, M̃ and xs, contiguous, each entry as
    ``_batched_forward`` computes it."""
    B = xs.shape[0]
    Bp = padded_batch(B, t.layout)
    tri_t = torch.nn.functional.pad(_tri(t, xs).T, (0, Bp - B)).contiguous()
    M, _, _ = _head_weights(t, xs, r)
    return tri_t, M.contiguous(), xs.contiguous()


class _BatchedEval(torch.autograd.Function):
    """Rank ≥ 3 batched evaluation; see the module docstring. The forward
    is one ``batched_eval`` launch for float32 values and compute type on a
    CUDA tensor, else ``_batched_forward``, its plain twin; on both routes
    the span ``batched.fold.r<rank>`` holds the whole fold, tri and M̃
    under ``batched.heads`` inside it."""

    @staticmethod
    def forward(ctx, vals, xs, t, r, d, ct):
        ctx.t, ctx.r, ctx.d, ctx.ct = t, r, d, ct
        ctx.save_for_backward(vals, xs)
        if vals.device.type == "cuda" and vals.dtype == ct == torch.float32:
            with span("batched.fold.r", r):
                with span("batched.heads"):
                    inputs = _batched_kernel_inputs(xs, t, r, d)
                return batched_eval(vals, *inputs, t.layout)
        with full_fp32_matmul(), span("batched.fold.r", r):
            return _batched_forward(vals, xs, t, r, d, ct)

    @staticmethod
    @once_differentiable
    def backward(ctx, gy):
        vals, xs = ctx.saved_tensors
        need_vals, need_x = ctx.needs_input_grad[:2]
        with span("batched.backward.r", ctx.r):
            dvals, dx = batched_backward(vals, xs, gy, ctx.t, ctx.r, ctx.d, ctx.ct,
                                         need_vals, need_x)
        return dvals, dx, None, None, None, None


def batched_backward(vals, xs, gy, t, r: int, d: int, ct, need_vals: bool, need_x: bool):
    """(dvals, dx) of ``_BatchedEval`` at the output gradient gy (B,), each
    None where not needed: tri and M̃ recomputed, then per group j one
    full-float32 GEMM dV_j = H_jᵀ·tri_j scaled by the fold's weights
    (``_scale_folded``), written into its slice of one n-sized buffer, and
    the products of dtri, dM and dx where x needs a gradient. Adds one to
    ``batched_backward.products`` for each dV_j."""
    g = gy.to(ct) * float(math.factorial(r))  # (B,)
    with torch.enable_grad():
        xg = xs.detach().requires_grad_(need_x)
        tri = _tri(t, xg)
        M, _, _ = _head_weights(t, xg, r)
    P, T, goff, toff = _grouped_static(r, d)
    wall, prow = _row_maps(t)[2].to(ct), row_offsets(t.layout)
    scales = _fold_scales(wall)
    gxs = xs * g[:, None]  # (B, d): g_b·x_bj
    dvals = (torch.empty(vals.shape, dtype=ct, device=vals.device)
             if need_vals else None)
    if need_x:
        dtri, dM = torch.zeros_like(tri), torch.zeros_like(M)
        dx = torch.zeros_like(xs)
    tri_d, M_d = tri.detach(), M.detach()
    with full_fp32_matmul():
        for j in range(d):
            Pj, Tj, to, po = P[j], T[j], toff[j], prow[j]
            rl = d - j
            tri_j = tri_d[:, to : to + Tj]
            gx = gxs[:, j]
            H = M_d[:, :Pj] * gx[:, None]  # (B, Pj): g_b·x_bj·M̃[b, p]
            if need_vals:
                dV = dvals[goff[j] : goff[j] + Pj * Tj].view(Pj, Tj)
                _scale_folded(torch.mm(H.T, tri_j, out=dV), scales[:, po : po + Pj], rl)
                batched_backward.products += 1
            if need_x:
                V = vals[goff[j] : goff[j] + Pj * Tj].view(Pj, Tj)
                if V.dtype != ct:
                    V = V.to(ct)
                Vf = _folded(V, wall[:, po : po + Pj], rl)
                dtri[:, to : to + Tj] += H @ Vf
                S = tri_j @ Vf.T
                dx[:, j] += g * torch.einsum("bp,bp->b", M_d[:, :Pj], S)
                dM[:, :Pj] += S.mul_(gx[:, None])
                del Vf, S
            del H
    if need_vals and dvals.dtype != vals.dtype:
        dvals = dvals.to(vals.dtype)
    if need_x:
        # M of rank 3 is the constant empty head
        outs, grads = zip(*[(o, go) for o, go in ((tri, dtri), (M, dM))
                            if o.requires_grad])
        dx = dx + torch.autograd.grad(outs, xg, grads)[0]
    return dvals, (dx if need_x else None)


batched_backward.products = 0


def _cache_hit(A, name: str):
    """What A keeps under `name` if it was built from A.data in its present
    state, else None: the entry is keyed to the data tensor itself, its
    storage address and its version counter, which every in-place write
    bumps (an optimizer's step)."""
    vals, hit = A.data, A.__dict__.get(name)
    if (hit is None or vals.requires_grad or hit[1]() is not vals
            or hit[0] != (vals.data_ptr(), vals._version)):
        return None
    return hit[2]


def _cached(A, name: str, build):
    """``build(A.data)``, kept on A under `name` until the values change
    (``_cache_hit``). Values that need a gradient are built in the graph on
    every call and never cached."""
    vals = A.data
    if vals.requires_grad:
        return build(vals)
    out = _cache_hit(A, name)
    if out is None:
        A.__dict__.pop(name, None)  # free a stale copy before building anew
        out = build(vals)
        A.__dict__[name] = ((vals.data_ptr(), vals._version), weakref.ref(vals), out)
    return out


class GroupViews(NamedTuple):
    """Per-group (P_j, T_j) value blocks of a rank-`rank` tensor."""

    rank: int
    blocks: tuple


def _premul_blocks(vals: torch.Tensor, r: int, d: int) -> GroupViews:
    """One copy of the values, row p of group j scaled as ``_folded``
    weights it (``_scale_folded``: w1 + w2 + w3 in column 0, w1 + w2 in
    columns 1..d−j−1, w1 beyond), the factors ``_fold_scales`` of the
    float64 ``row_weights`` rounded once to the storage type, as per-group
    views into it: tri_j·Ṽ_jᵀ gives the corrected row sums of ``_folded``
    whatever x."""
    P, T, goff, _ = _grouped_static(r, d)
    t = tables(r, d, vals.device)
    scales = _fold_scales(_row_maps(t)[2]).to(vals.dtype)
    prow = row_offsets(t.layout)
    buf = vals.clone()
    blocks = []
    for j in range(d):
        V = buf[goff[j] : goff[j] + P[j] * T[j]].view(P[j], T[j])
        blocks.append(_scale_folded(V, scales[:, prow[j] : prow[j] + P[j]], d - j))
    return GroupViews(r, tuple(blocks))


def group_views_premul(A: FlatSymmetricTensor) -> GroupViews:
    """Per-group (P_j, T_j) blocks of A's values with the correction
    weights folded in, in A's storage type: one GEMV a group evaluates A.
    Cached on A (``_cached``); a second copy of the values. The JAX
    package's views leave c1 = 1/(q+1) to the evaluation; here it is
    folded too, so the batched epilogue has no (B, P_j) pass of its own."""
    return _cached(A, "_group_views_premul",
                   lambda vals: _premul_blocks(vals, A.rank, A.dim))


def _premul_setup(views: GroupViews, x):
    """(x in the compute type, the type, the tables) of an evaluation over
    premultiplied views."""
    V0 = views.blocks[0]
    x = torch.as_tensor(x, device=V0.device)
    ct = compute_dtype(V0, x)
    return x.to(ct), ct, tables(views.rank, len(views.blocks), V0.device)


def views_eval_premul(views: GroupViews, x) -> torch.Tensor:
    """Single-input contraction over premultiplied views: per group one
    GEMV and one weighted dot (the counterpart of the JAX package's
    ``poly_eval_flat_fast``)."""
    r, d = views.rank, len(views.blocks)
    x, ct, t = _premul_setup(views, x)
    tri = _tri(t, x)
    M, _, _ = _head_weights(t, x, r)
    P, T, _, toff = _grouped_static(r, d)
    total = torch.zeros((), dtype=ct, device=x.device)
    with full_fp32_matmul():
        for j, V in enumerate(views.blocks):
            u = torch.mv(V.to(ct), tri[toff[j] : toff[j] + T[j]])
            total = total + x[j] * torch.dot(M[: P[j]], u)
    return float(math.factorial(r)) * total


def views_eval_batched_premul(views: GroupViews, xs) -> torch.Tensor:
    """Batched contraction xs (B, d) → (B,) over premultiplied views: one
    GEMM a group, in full float32 for float32 operands (bfloat16 blocks
    are upcast first); autograd differentiates it in xs."""
    r, d = views.rank, len(views.blocks)
    xs, ct, t = _premul_setup(views, xs)
    tri = _tri(t, xs)  # (B, Ttri)
    M, _, _ = _head_weights(t, xs, r)
    P, T, _, toff = _grouped_static(r, d)
    total = torch.zeros((xs.shape[0],), dtype=ct, device=xs.device)
    with full_fp32_matmul():
        for j, V in enumerate(views.blocks):
            u = tri[:, toff[j] : toff[j] + T[j]] @ V.to(ct).T  # (B, P_j)
            total = total + xs[:, j] * torch.einsum("bp,bp->b", M[:, : P[j]], u)
    return float(math.factorial(r)) * total


def poly_eval_flat_batched(A: FlatSymmetricTensor, xs) -> torch.Tensor:
    """Batched contraction: xs (B, d) → (B,). The per-group GEMVs become
    products (B, T_j) @ (T_j, P_j), in full float32 for float32 operands
    (one ``batched_eval`` launch a rank on a CUDA tensor); differentiable
    in the values and in xs.

    Routes at rank ≥ 3: under ``SYMTENSOR_BATCHED_CELL=1`` (read at call
    time) an eligible tensor takes the cell-major GEMMs
    (``cell_gemm.poly_eval_cell_batched``); bfloat16 values that need no
    gradient take the premultiplied views (ahead of the fold on the H100;
    PERF.md), whether or not A caches them yet; everything else
    ``_BatchedEval``."""
    r, d = A.rank, A.dim
    xs, ct = _prepare(A, xs)
    vals = A.data
    B = xs.shape[0]
    if r == 0:
        return vals[0].to(ct).expand(B)
    t = A.tables
    if r >= 3:
        if os.environ.get("SYMTENSOR_BATCHED_CELL") == "1":
            from .cell_gemm import cell_eligible, poly_eval_cell_batched

            if cell_eligible(r, d):
                with span("batched.cell"):
                    return poly_eval_cell_batched(A, xs)
        if not vals.requires_grad and vals.dtype == torch.bfloat16:
            with span("batched.premul"):
                return views_eval_batched_premul(group_views_premul(A), xs)
        return _BatchedEval.apply(vals, xs, t, r, d, ct)
    with full_fp32_matmul():
        if r == 1:
            return xs @ vals.to(ct)
        return 2.0 * (_tri(t, xs) @ vals.to(ct))
