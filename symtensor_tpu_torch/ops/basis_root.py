"""Case-decomposed root pass of the blocked basis change.

The counterpart of ``symtensor_tpu/ops/basis_root.py``. For one packed
parent of rank k + 1 (the tensor itself at level 0, or one row of a level
block) and a window of W's columns it computes, for every size-k child
multiset j in storage order,

    child[b, j] = Σ_i parent[pos(sort(j ∪ {i}))] · W[i, b]

without an insert table of the parent's size and without a table of the
children's representatives: at rank 6 dim 100 the first is 9.2e9 entries
and the second 4.6e8, both past ``config.max_table_entries``.

With the child j = [head (size kh = k − 3) | g | ta, tb] and the inserted
value i, the gflat layout gives two cases:

- **i ≥ g**: the parent is [head, g | sorted(ta, tb, i)], so its head
  [head, g] is fixed. The parent rows with that head across the parent
  groups G ≥ g form a "row bundle" (rows hpb_g + h of every group-G block,
  hpb_g = C(g + kh, kh + 1)), and

      child[b, h, (ta, tb)] += Σ_{i ≥ g} Bundle[h, τ3(ta, tb, i)] · W[i, b]

  where τ3, the bundle-local rank of the sorted triple, depends on
  ((ta, tb), i) alone: one index shared by all heads (``bundle_table``).
- **i < g**: the parent is [sort(head ∪ {i}) | g | ta, tb]; the tail
  triangle rides along unchanged, so the read is whole rows of the parent's
  group-g block, chosen by the head-level insert table
  ``head_insert_table`` (IH[h, i] = colex rank of sort(head_h ∪ {i})).

Both reads are row slices and shared-index gathers of the parent's group
blocks, which are views of the flat parent (``narrow`` + ``view``): nothing
is copied to split it. The two tables are about 4 MB each at dim 100. The
products run transposed, (window, ·) = Wᵀ · gatheredᵀ, so a window's result
is already the (rows, N_k) child block of the recursion.
"""

from __future__ import annotations

from functools import lru_cache
from typing import Optional, Tuple

import numpy as np
import torch

from ..utils import combinatorics as comb
from ..utils.tables import tables


@lru_cache(maxsize=None)
def _tri_table(d: int) -> np.ndarray:
    """(T_0, 2) int64 of the (a ≤ b) pairs of tri(d) in row-major order."""
    rows = []
    for a in range(d):
        blk = np.empty((d - a, 2), dtype=np.int64)
        blk[:, 0] = a
        blk[:, 1] = np.arange(a, d)
        rows.append(blk)
    return np.concatenate(rows, axis=0)


def _tri_sizes(d: int) -> np.ndarray:
    """T_G = C(d − G + 1, 2), the tail-triangle size of each group."""
    side = d - np.arange(d, dtype=np.int64)
    return side * (side + 1) // 2


@lru_cache(maxsize=None)
def bundle_table(d: int) -> np.ndarray:
    """J[(a, b) tri-rank, i] = bundle offset (from group 0) of the parent
    element holding sorted(a, b, i): S[x] + tri_rank(y − x, z − x, d − x)
    for (x, y, z) = sorted(a, b, i), S[x] = Σ_{G<x} T_G. (T_0, d) int64.

    The table of child group g is the contiguous sub-block
    J[T_0 − T_g:, g:] − S[g]: child tails with min ≥ g are the last T_g
    tri rows, inserts i ≥ g a column suffix."""
    S = np.concatenate(([0], np.cumsum(_tri_sizes(d))))
    tri = _tri_table(d)
    a, b = tri[:, 0][:, None], tri[:, 1][:, None]
    i = np.arange(d, dtype=np.int64)[None, :]
    x = np.minimum(np.minimum(a, b), i)
    z = np.maximum(np.maximum(a, b), i)
    y = a + b + i - x - z
    return S[x] + comb.tri_rank(y - x, z - x, d - x)


@lru_cache(maxsize=None)
def head_insert_table(kh: int, d: int) -> np.ndarray:
    """IH[h, i] = colex rank of sort(head_h ∪ {i}) over size-(kh + 1)
    multisets, for head_h the h-th size-kh multiset in colex order:
    (C(d + kh − 1, kh), d) int64, (1, d) for kh = 0.

    The table of child group g is the contiguous prefix IH[:nh_g, :g]
    (heads ≤ g are a colex prefix of length C(g + kh, kh))."""
    heads = comb.multisets_colex(d, kh)  # (Nh, kh) ascending
    Nh = heads.shape[0]
    ins = np.empty((Nh, d, kh + 1), dtype=np.int64)
    ins[:, :, :kh] = heads[:, None, :]
    ins[:, :, kh] = np.arange(d)[None, :]
    ins.sort(axis=2)
    return comb.colex_rank_array(ins.reshape(Nh * d, kh + 1)).reshape(Nh, d)


def group_shapes(k: int, d: int):
    """(nhp_G, T_G) of the parent's (rank k + 1) gflat group blocks."""
    T = _tri_sizes(d)
    return [(comb.multiset_count(G + 1, k - 2), int(T[G])) for G in range(d)]


def root_tables(k: int, d: int, device) -> Tuple[torch.Tensor, torch.Tensor]:
    """(IH, J) on the device, memoized with the tables of (k, d)."""
    T = tables(k, d, device)
    return T.memo("root_tables", lambda: (
        T._dev(head_insert_table(k - 3, d)), T._dev(bundle_table(d))))


def tile_rows(k: int, d: int, g: int, tile_elems: int) -> int:
    """Tail-triangle rows of child group g taken at a time: the gathered
    (nh_g, rows, d) elements of both cases stay under `tile_elems` (one
    row is always taken)."""
    nh = comb.multiset_count(g + 1, k - 3)
    return max(1, min(comb.tri_size(d - g), tile_elems // (nh * d)))


def root_pass_peak_elems(k: int, d: int, width: int, tile_elems: int) -> int:
    """Most elements ``root_pass`` holds at once beside its parent and its
    result: the row bundle of a group, one tile's gathered elements, that
    tile's two products and a copy of the window."""
    T = _tri_sizes(d)
    S = np.concatenate(([0], np.cumsum(T)))
    peak = 0
    for g in range(d):
        nh = comb.multiset_count(g + 1, k - 3)
        tl = tile_rows(k, d, g, tile_elems)
        peak = max(peak, nh * int(S[d] - S[g]) + nh * tl * d + 2 * width * nh * tl)
    return peak + width * d


def root_pass(parent: torch.Tensor, Wc: torch.Tensor, k: int, d: int,
              tile_elems: int, out_dtype: torch.dtype,
              cols: Optional[Tuple[int, int]] = None) -> torch.Tensor:
    """The (width, N_k) child block of one flat parent of rank k + 1 ≥ 4
    under the window Wc = W[:, b_lo:b_hi] of shape (d, width).

    parent: (N_{k+1},) values; they enter the products in Wc's type, which
    is also the products' type. `tile_elems` bounds the gathered elements
    of a tile of the tail-triangle axis; any tiling gives the same values
    up to the products' rounding. The result is in `out_dtype`. `cols` =
    (c0, c1) keeps the child columns [c0, c1) alone, (width, c1 − c0): only
    the child groups that hold them are computed (a group the range cuts,
    whole, then sliced)."""
    if k < 3:
        raise ValueError("the case-decomposed root pass needs child rank >= 3")
    kh = k - 3
    lay_c, lay_p = comb.gflat_layout(k, d), comb.gflat_layout(k + 1, d)
    S = np.concatenate(([0], np.cumsum(_tri_sizes(d))))
    IH, J = root_tables(k, d, parent.device)
    nh = [comb.multiset_count(g + 1, kh) for g in range(d)]
    # pieces[G][g]: the rows of the parent's group-G block whose head ends
    # in g, rows [hpb_g, hpb_g + nh_g) with hpb_g = C(g + kh, kh + 1): one
    # split a block, so a pass makes its d(d + 1)/2 views in d calls
    blocks = [parent.narrow(0, int(lay_p.group_off[G]), nhp * T).view(nhp, T)
              for G, (nhp, T) in enumerate(group_shapes(k, d))]
    pieces = [blocks[G].split(nh[:G + 1]) for G in range(d)]
    WT = Wc.T  # (width, d)
    width = Wc.shape[1]
    c0, c1 = cols if cols is not None else (0, lay_c.n)
    child = torch.empty((width, c1 - c0), dtype=out_dtype, device=parent.device)
    for g in range(d):
        T = blocks[g].shape[1]
        off, size = int(lay_c.group_off[g]), nh[g] * T
        lo, hi = max(off, c0), min(off + size, c1)
        if lo >= hi:
            continue
        whole = (lo, hi) == (off, off + size)
        out = (child[:, off - c0:off - c0 + size] if whole
               else torch.empty((width, size), dtype=out_dtype, device=parent.device))
        _child_group(out.view(-1, nh[g], T),
                     [pieces[G][g] for G in range(g, d)], blocks[g],
                     J[int(S[1]) - T:, g:] - int(S[g]), IH[:nh[g], :g].T.reshape(-1),
                     WT[:, :g], WT[:, g:], tile_rows(k, d, g, tile_elems))
        if not whole:
            child[:, lo - c0:hi - c0] = out[:, lo - off:hi - off]
    return child


def _child_group(out_g, bundle_rows, block, Jg, rows_D, W_lo, W_hi, rows_per) -> None:
    """Child group g of ``root_pass`` into out_g (width, nh, T): the
    inserts i ≥ g through the row bundle and Jg (T, d − g) against W_hi
    (width, d − g), the inserts i < g through the rows `rows_D` of the
    parent's group-g block against W_lo (width, g), `rows_per` tail rows
    at a time."""
    width, nh, T = out_g.shape
    g, n = W_lo.shape[1], W_hi.shape[1]
    bundle = torch.cat(bundle_rows, dim=1)  # (nh, L_g)
    for t0 in range(0, T, rows_per):
        t1 = min(t0 + rows_per, T)
        tl = t1 - t0
        G2 = bundle.index_select(1, Jg[t0:t1].reshape(-1)).to(W_hi.dtype)
        G2 = G2.view(nh * tl, n)
        if g > 0:
            G1 = block[:, t0:t1].index_select(0, rows_D).to(W_lo.dtype)
            o = torch.addmm(W_lo @ G1.view(g, nh * tl), W_hi, G2.T)
            del G1
        else:
            o = W_hi @ G2.T  # (width, nh · tl)
        del G2
        out_g[:, :, t0:t1] = o.view(width, nh, tl)
        del o


def root_pass_oracle(A_np: np.ndarray, W_np: np.ndarray, k: int, d: int,
                     b_lo: int, width: int) -> np.ndarray:
    """Direct NumPy evaluation of the root step through the layout's
    ``position_array``: what ``root_pass`` is held to."""
    lay_c, lay_p = comb.gflat_layout(k, d), comb.gflat_layout(k + 1, d)
    reps = lay_c.rep_indices()
    out = np.zeros((width, reps.shape[0]), dtype=np.float64)
    for i in range(d):
        ins = np.concatenate([reps, np.full((len(reps), 1), i)], axis=1)
        ins.sort(axis=1)
        out += np.outer(W_np[i, b_lo:b_lo + width], A_np[lay_p.position_array(ins)])
    return out
