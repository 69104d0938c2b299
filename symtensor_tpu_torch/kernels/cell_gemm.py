"""Cell-major prefix-GEMM batched polynomial evaluation.

The counterpart of ``symtensor_tpu/kernels/cell_gemm.py``. Each packed
component is reparametrised by its two LARGEST indices, the cell
(t1, t2), and the r−2 smallest, a colex monomial g with max(g) ≤ t1:

    I = (g_1 .. g_{r-2}, t1, t2)     ascending
    W_I = M2[g] · x_{t1} · x_{t2} · s(g, t1, t2)

where M2 is the level-(r−2) EGF-weighted monomial vector and the collision
factor

    s = 1/(a+1)            for t1 < t2
    s = 1/((a+1)(a+2))     for t1 == t2,     a = multiplicity of t1 in g

does not depend on the input, so it premultiplies into the stored values.
Colex order makes {g : max(g) ≤ t1} a PREFIX of size N(t1+1), so a block of
rows ra ≤ t1 < rb is ONE GEMM with K = N(rb),

    G = V_block @ M2ᵀ[:K]      # (NC, K) @ (K, B) -> (NC, B)

against premultiplied values (zero where max(g) > t1), then the epilogue
Σ_cells x_{t1}·x_{t2}·G. The greedy row blocks keep the zero padding under
about 12 % of the useful entries.

The GEMMs run in full float32 for float32 operands
(``utils/precision.full_fp32_matmul``; bfloat16 blocks are upcast first):
the JAX package's ``precision=None`` truncates them to bfloat16 on the TPU,
which the port does not copy. The views are cached on the tensor as the
premultiplied group views are (``poly_eval._cached``), and built in the
graph when the values need a gradient; autograd differentiates the route
in the values and in xs. ``poly_eval_flat_batched`` routes eligible
tensors here under ``SYMTENSOR_BATCHED_CELL=1``.
"""

from __future__ import annotations

import math
from functools import lru_cache

import numpy as np
import torch

from ..core.flat import FlatSymmetricTensor
from ..utils import combinatorics as comb
from ..utils.precision import full_fp32_matmul
from .poly_eval import _cached, _compute_dtype

# Eligibility: the level-(r−2) monomial table must stay modest, both for
# the (B, N2) batched weight build and the host-side index tables.
_MAX_LEVEL2 = 65536
# Chunk the batch so the (N2, B_c) weight table stays under 2**25 elements.
_MAX_WEIGHT_ELEMS = 1 << 25


def cell_eligible(rank: int, dim: int) -> bool:
    return rank >= 3 and comb.multiset_count(dim, rank - 2) <= _MAX_LEVEL2


@lru_cache(maxsize=None)
def _cell_blocks_static(rank: int, dim: int):
    """Host-side row blocks of the cell-major layout, each
    (K, t1s, t2s, idx, scale): K = N(rb) the prefix length, t1s/t2s (NC,)
    int32 cells, idx (K·NC,) int64 gather positions into the packed values
    and scale (K·NC,) float64 collision factors (0 where max(g) > t1), both
    in (K, NC) order."""
    r, d = rank, dim
    if r < 3:
        raise ValueError("cell-major layout needs rank >= 3")
    lay = comb.gflat_layout(r, d)
    gs = comb.multisets_colex(d, r - 2)  # (N2, r-2) ascending rows, colex
    gmax = gs[:, -1]
    grun = (gs == gmax[:, None]).sum(axis=1)  # run of the max element
    Npref = np.array(
        [comb.multiset_count(m, r - 2) for m in range(d + 1)], np.int64
    )

    # Greedy row blocks: grow while the triangular zero padding stays a
    # small fraction of the useful entries.
    bounds = []
    ra = 0
    while ra < d:
        rb = ra + 1
        useful = int((d - ra) * Npref[ra + 1])
        while rb < d:
            add_useful = int((d - rb) * Npref[rb + 1])
            # growing the block to include row rb raises K to N(rb+1)
            new_K = int(Npref[rb + 1])
            new_waste = sum((new_K - int(Npref[t1 + 1])) * (d - t1)
                            for t1 in range(ra, rb + 1))
            if new_waste > 0.12 * (useful + add_useful) + 4096:
                break
            rb += 1
            useful += add_useful
        bounds.append((ra, rb))
        ra = rb

    blocks = []
    total_valid = 0
    for ra, rb in bounds:
        K = int(Npref[rb])
        t1s = np.asarray([t1 for t1 in range(ra, rb) for _ in range(t1, d)],
                         np.int32)
        t2s = np.asarray([t2 for t1 in range(ra, rb) for t2 in range(t1, d)],
                         np.int32)
        NC = t1s.shape[0]
        # (K, NC) validity: g (colex rank < N(t1+1)) may pair with the cell
        valid = np.arange(K, dtype=np.int64)[:, None] < Npref[t1s + 1][None, :]
        # collision factor: a = count of t1 in g (nonzero iff max(g) == t1)
        a = np.where(gmax[:K, None] == t1s[None, :].astype(np.int64),
                     grun[:K, None], 0).astype(np.float64)
        scale = 1.0 / (a + 1.0)
        scale = np.where((t1s == t2s)[None, :], scale / (a + 2.0), scale)
        scale = np.where(valid, scale, 0.0)
        # gather positions of I = (g..., t1, t2); an invalid g becomes the
        # all-zeros monomial so rows stay ascending (its scale is 0)
        rows = np.empty((K, NC, r), np.int64)
        rows[:, :, : r - 2] = np.where(valid[:, :, None], gs[:K, None, :], 0)
        rows[:, :, r - 2] = t1s[None, :]
        rows[:, :, r - 1] = t2s[None, :]
        pos = lay.position_array(rows.reshape(K * NC, r))
        blocks.append((K, t1s, t2s, pos.astype(np.int64), scale.reshape(-1)))
        total_valid += int(valid.sum())
    if total_valid != lay.n:
        raise AssertionError(f"cell blocks cover {total_valid} of {lay.n} values")
    return tuple(blocks)


def _device_blocks(t):
    """Per block (NC, K, idx, scale, t1s, t2s) on the tables' device, idx
    and the float64 scale in (NC, K) order; memoized on the tables."""

    def build():
        out = []
        for K, t1s, t2s, idx, scale in _cell_blocks_static(t.rank, t.dim):
            NC = len(t1s)
            out.append((
                NC, K,
                torch.as_tensor(idx.reshape(K, NC).T.copy(), device=t.device).view(-1),
                torch.as_tensor(scale.reshape(K, NC).T.copy(), device=t.device).view(-1),
                torch.as_tensor(t1s.astype(np.int64), device=t.device),
                torch.as_tensor(t2s.astype(np.int64), device=t.device),
            ))
        return tuple(out)

    return t.memo("cell_blocks", build)


def cell_views(A: FlatSymmetricTensor):
    """Premultiplied value blocks of A: per block a (NC, K) matrix in A's
    storage type and the cell index vectors (t1s, t2s). Cached on A for its
    values' present state (``poly_eval._cached``), built in the graph when
    the values need a gradient."""

    def build(vals):
        return tuple(
            ((vals[idx] * scale.to(vals.dtype)).view(NC, K), t1s, t2s)
            for NC, K, idx, scale, t1s, t2s in _device_blocks(A.tables)
        )

    return _cached(A, "_cell_views", build)


def _level_weights_batched_T(t, xsT: torch.Tensor, size: int, ct) -> torch.Tensor:
    """(N_size, B) EGF-weighted monomials of xsT (d, B), the batch on the
    trailing axis: the recursion's gathers pick whole rows."""
    M = torch.ones((1, xsT.shape[1]), dtype=ct, device=xsT.device)
    if size == 0:
        return M
    for par, mx, run in t.mono_tables_weighted(size):
        M = M[par] * xsT[mx] / run[:, None].to(ct)
    return M


def _cell_eval(views, xs: torch.Tensor, t, rank: int, ct) -> torch.Tensor:
    xsT = xs.T.contiguous()  # (d, B)
    M2T = _level_weights_batched_T(t, xsT, rank - 2, ct)  # (N2, B)
    total = torch.zeros((xs.shape[0],), dtype=ct, device=xs.device)
    for V, t1s, t2s in views:  # V: (NC, K)
        G = V.to(ct) @ M2T[: V.shape[1]]  # (NC, B)
        total = total + (G * (xsT[t1s] * xsT[t2s])).sum(0)
    return float(math.factorial(rank)) * total


def poly_eval_cell_batched(A: FlatSymmetricTensor, xs) -> torch.Tensor:
    """Batched contraction xs (B, d) → (B,) through the cell-major GEMMs,
    the batch chunked so that the (N2, B) weight table stays under
    ``_MAX_WEIGHT_ELEMS``. The caller checks ``cell_eligible``."""
    xs = torch.as_tensor(xs, device=A.device)
    ct = _compute_dtype(A.data, xs)
    xs = xs.to(ct)
    views = cell_views(A)
    t = A.tables
    chunk = max(16, _MAX_WEIGHT_ELEMS // comb.multiset_count(A.dim, A.rank - 2))
    with full_fp32_matmul():
        if xs.shape[0] <= chunk:
            return _cell_eval(views, xs, t, A.rank, ct)
        return torch.cat([_cell_eval(views, xs[i : i + chunk], t, A.rank, ct)
                          for i in range(0, xs.shape[0], chunk)])
