"""Basis change  C = A · W ⊗ … ⊗ W  on packed storage.

The counterpart of ``symtensor_tpu/ops/basis_change.py``: the whole-level
route (its ``_basis_change_small``) for shapes whose levels fit on the
card, and the blocked depth-first recursion (its ``process``) for the rest,
with the case-decomposed root pass of ``ops/basis_root.py``.

Algorithm
---------
Output multisets β (sorted ascending) are built level by level, appending
their max element b. The level-t state rows are partial contractions

    U_t[β₁…β_t, α] = Σ_{i₁…i_t} A[{i₁…i_t} ∪ α] · W[i₁,β₁] ⋯ W[i_t,β_t]

over all size-(r−t) original multisets α (gflat storage order). One step:

    U_{t+1}[(β, b), j] = Σ_i U_t[β, insert_k(j, i)] · W[i, b]     (k = r−t−1)

which is exact with no multiplicity bookkeeping because the slots are
contracted in order and A is symmetric; evaluating at sorted β gives every
independent component of the (automatically symmetric) result. The insert
positions insert_k(j, i) come from ``Tables.insert_table(k)`` where that
table passes ``config.max_table_entries``, and are otherwise ranked on the
device, a column segment at a time, from the level-k representatives
(``Tables.position_insert_T``).

Whole-level route
-----------------
Rows are kept in colex order of β: the children with new element b have as
parents the colex prefix of length C(b + t, t), so a level is a gather
through the insert positions, one GEMM against a column window of W, and a
row pick through ``Tables.mono_tables(t + 1)``; ``colex_perm`` puts the
last level into storage order. It holds whole levels on the device: the
parent level (P_t × N_{r−t}), the child level, and transients bounded by an
element budget. A call with default arguments takes it when its projected
residency passes ``$SYMTENSOR_BASIS_SMALL_ELEMS`` and its tables pass
``config.max_table_entries``.

Blocked route
-------------
Every other call, and every call that names `block_elems`,
`transient_elems`, `onthefly_above` or `donate_root`, runs depth-first over
blocks of at most R_t rows a level (``_row_budgets``), so that no level is
ever held whole: rank 6 dim 100 has levels of 2.9e10 elements. Three facts
carry it:

- the children of a row with max element m are (row, b) for every b ≥ m;
- in a block whose rows are sorted by max element, the parents of the
  children with new element b are a prefix of the block, so a chunk of
  children is one gather of that prefix, one GEMM against W[:, b_lo:b_hi]
  computed transposed, (window, prefix · columns), and one gather of whole
  contiguous rows of the product;
- a finished leaf's storage position is ``position_base_T(rep) + b``, so
  the last step writes its products straight into the result.

Level 0 at rank ≥ 4, and the rows of a level whose insert positions are too
many to rank again for every chunk, go through ``basis_root.root_pass``.

Both routes are plain torch (gathers, GEMMs in full float32, index picks
and writes), so autograd differentiates through either with respect to the
values and W; under autograd every block stays alive for the backward
pass, and the residency reckoned here is the forward pass's alone.
"""

from __future__ import annotations

import os
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from ..config import config
from ..core.base import is_sharded, require_local
from ..core.flat import FlatSymmetricTensor
from ..utils import combinatorics as comb
from ..utils.precision import full_fp32_matmul
from ..utils.tables import tables
from . import basis_root

# Element budget of one transient of the whole-level route (the gathered
# rows of a row chunk, the product of a window of W's columns): 1 GiB in
# float32. On an NVIDIA H100 80GB HBM3 (700 W) the packed change ran 11.50
# ms at rank 5 dim 60 and 5.49 ms at rank 6 dim 32 under this budget
# against 13.18 and 6.88 ms under 2**26, for 0.72 and 0.07 GB more peak
# memory (the probe in `tools/` at commit 08183a6: `git show
# 08183a6:symtensor_tpu_torch/tools/`); rank 4 dim 100 is one chunk a
# level under either.
_SMALL_BUDGET = 2**28

# Default of $SYMTENSOR_BASIS_SMALL_ELEMS, the gate on the projected peak
# residency in elements of the accumulation type. 2**32 elements are 17 GB
# in float32 and 34 GB in float64; the static tables add at most about 5 GB
# under the default ``config.max_table_entries``, so a gated call stays
# under half of an 80 GB card. On that card ``max_memory_allocated`` over a
# call stayed at or under the projection: 0.592 GB against 0.575 GB
# projected at rank 4 dim 100 (the result's 18 MB is the difference), 1.16
# against 1.26 GB at rank 5 dim 60, 0.89 against 1.00 GB at rank 6 dim 32
# (budget 2**26; chip_smoke.py phases 19-20).
_SMALL_ELEMS = 2**32

# Defaults of $SYMTENSOR_BASIS_BLOCK_ELEMS (all resident level blocks
# together) and $SYMTENSOR_BASIS_TRANSIENT_ELEMS (one chunk's gathered
# rows, product and pick) of the blocked route, in elements. On an NVIDIA
# H100 80GB HBM3 (700 W), float32 (the probe at commit 08183a6, sections
# "sweep" and "full"): rank 6 dim 50 ran 350-504 ms a call under 2**26 block
# elements, 169-203 ms under 2**28, 89-121 ms under 2**30 and 105-125 ms
# under 2**32 (every level whole), and under each the 2**24 transient was
# the slowest but once; rank 6 dim 100 ran 7.65 s under 2**32 block elements
# (peak 34.1 GB) and 7.75 s under 2**33 (45.4 GB).
_BLOCK_ELEMS = 2**32
_TRANSIENT_ELEMS = 2**28

# Int64 planes of (columns, dim) that ``Tables.position_insert_T`` holds at
# once, reckoned in elements of the transient budget (two to a plane).
_FLY_ELEMS = 12

# A level whose rows each need N_k · dim insert positions at or above this
# is swept row by row through the root pass, not by the generic step that
# ranks those positions again for every chunk of children. On an NVIDIA
# H100 80GB HBM3 (700 W), float32, level 1 of rank 6
# (the probe at commit 08183a6, sections "rowpass" and "full"): at dim 50
# (1.46e7 positions a row) the generic step took 145-177 ms, 106-137 ms of
# it the ranking, and the 50 row passes 669 ms; at dim 100 (4.4e8 positions
# a row) the generic step took 10.8 s, 6.8 s of it the ranking, and the 100
# row passes 3.0-3.3 s.
_ROW_PASS_INCID = 100_000_000
_ROW_PASS_MAX_ROWS = 128

# What the last call of ``basis_change_packed`` did: its route, and for the
# blocked route the rows per level, chunk counts and projected residency.
last_call: Dict[str, object] = {}


def _env_int(name: str, default: int) -> int:
    return int(os.environ.get(name, default))


def _n_cols(k: int, d: int) -> int:
    """Columns of a level whose rows still carry k original indices."""
    return comb.indep_size(k, d) if k >= 1 else 1


def _on_the_fly(k: int, d: int, onthefly_above: Optional[int]) -> bool:
    """Whether the insert positions of the level-k multisets are ranked on
    the device: by default where ``insert_table(k)`` would pass the tables'
    guard, else where N_k · dim passes `onthefly_above`."""
    entries = comb.indep_size(k, d) * d
    if onthefly_above is None:
        return entries * (k + 1) > config.max_table_entries
    return entries > onthefly_above


class _InsertMap:
    """The insert positions of the level-k multisets over dim d, a column
    segment at a time: rows of ``insert_table(k)``, or ranked from the
    level-k representatives."""

    def __init__(self, r: int, k: int, d: int, device, onthefly_above: Optional[int]):
        self.fly = _on_the_fly(k, d, onthefly_above)
        if self.fly:
            self.rep_T = tables(k, d, device).rep_T  # (k, N_k)
            self.ranker = tables(k + 1, d, device)
        else:
            self.table = tables(r, d, device).insert_table(k)  # (N_k, d)

    def positions(self, c0: int, c1: int) -> torch.Tensor:
        """(c1 − c0, d) int64 positions in the rank-(k + 1) layout."""
        if self.fly:
            return self.ranker.position_insert_T(self.rep_T[:, c0:c1])
        return self.table[c0:c1]


# ---------------------------------------------------------------------------
# whole-level route
# ---------------------------------------------------------------------------


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


def _fly_cols(N_k: int, d: int, budget: int) -> int:
    """Columns ranked at a time on the whole-level route: the ranking's
    planes stay under `budget`."""
    return max(1, min(N_k, budget // (_FLY_ELEMS * d)))


def _small_peak_elems(r: int, d: int, d_out: int, budget: int,
                      onthefly_above: Optional[int] = None) -> int:
    """Projected peak residency of the whole-level route, in elements of
    the accumulation type, following the allocations of
    ``_basis_change_levels``: at level t the parent level, the child level
    (allocated once and filled window by window; with a single window the
    picked rows are the child level), the window's product, and the larger
    of (one row chunk's gathered rows and, when the rows or columns are
    chunked, its product; with the ranking's planes where the positions
    are ranked on the device) and (the window's picked segment on its way
    into the child level)."""
    peak = 0
    for t in range(r):
        k = r - t - 1
        N_k = _n_cols(k, d)
        fly = k >= 1 and _on_the_fly(k, d, onthefly_above)
        cols = _fly_cols(N_k, d, budget) if fly else N_k
        parent = comb.multiset_count(d_out, t) * comb.indep_size(k + 1, d)
        child = comb.multiset_count(d_out, t + 1) * N_k
        chunks = _window_chunks(t, N_k, d_out, budget)
        for b0, b1 in chunks:
            mm = comb.multiset_count(b1, t)
            width = b1 - b0
            product = mm * N_k * width
            gathered = 0
            if k >= 1:
                rows = _row_chunk(mm, cols, d, budget)
                gathered = rows * cols * d
                if rows < mm or cols < N_k:
                    gathered += rows * cols * width
                if fly:
                    gathered += _FLY_ELEMS * d * cols
            segment = 0
            if len(chunks) > 1:
                segment = (comb.multiset_count(b1, t + 1)
                           - comb.multiset_count(b0, t + 1)) * N_k
            peak = max(peak, parent + child + product + max(gathered, segment))
    return peak


def _small_table_entries(r: int, d: int, d_out: int,
                         onthefly_above: Optional[int] = None) -> List[Tuple[str, int]]:
    """(name, entries) of every static table the whole-level route builds,
    as ``utils/tables.py`` guards them against ``config.max_table_entries``:
    the insert tables of the operand's dim (int64 on the device: 8 bytes an
    entry of N_k · d, guarded at N_k · d · (k + 1) for the host sort) or,
    where the positions are ranked on the device, the level's
    representatives; the colex levels and the storage order of the
    result's dim."""
    out = []
    for k in range(1, r):
        if _on_the_fly(k, d, onthefly_above):
            out.append((f"rep_indices of rank {k} dim {d}",
                        comb.indep_size(k, d) * k))
        else:
            out.append((f"insert_table({k}) at dim {d}",
                        comb.indep_size(k, d) * d * (k + 1)))
    out += [(f"mono_tables({s}) at dim {d_out}", comb.multiset_count(d_out, s))
            for s in range(1, r + 1)]
    out.append((f"rep_indices of rank {r} dim {d_out}",
                comb.indep_size(r, d_out) * r))
    return out


def _whole_level_fits(r: int, d: int, d_out: int, budget: int) -> bool:
    """Whether a call with default arguments takes the whole-level route:
    its projected residency is within $SYMTENSOR_BASIS_SMALL_ELEMS (0
    closes the route) and each of its tables within the tables' guard.
    Builds nothing."""
    small_elems = _env_int("SYMTENSOR_BASIS_SMALL_ELEMS", _SMALL_ELEMS)
    if _small_peak_elems(r, d, d_out, budget) > small_elems:
        return False
    return all(entries <= config.max_table_entries
               for _, entries in _small_table_entries(r, d, d_out))


def _extend(U_pref: torch.Tensor, ins: Optional[_InsertMap], Wslice: torch.Tensor,
            N_k: int, budget: int) -> torch.Tensor:
    """H[p, j, b] = Σ_i U_pref[p, insert(j, i)] · W[i, b] for a prefix of
    parent rows and a window of W's columns: (mm, N_k, width). Rows are
    gathered `_row_chunk` at a time, the last chunk ragged; positions
    ranked on the device are made `_fly_cols` columns at a time."""
    mm, d, width = U_pref.shape[0], Wslice.shape[0], Wslice.shape[1]
    if ins is None:  # k = 0: the rows are the last original index
        return torch.einsum("pji,ib->pjb", U_pref.reshape(mm, 1, d), Wslice)
    cols = _fly_cols(N_k, d, budget) if ins.fly else N_k
    rows = _row_chunk(mm, cols, d, budget)
    if rows >= mm and cols >= N_k:
        return torch.einsum("pji,ib->pjb", U_pref[:, ins.positions(0, N_k)], Wslice)
    H = torch.empty((mm, N_k, width), dtype=U_pref.dtype, device=U_pref.device)
    for c0 in range(0, N_k, cols):
        tbl = ins.positions(c0, c0 + cols)
        for p0 in range(0, mm, rows):
            H[p0:p0 + rows, c0:c0 + cols] = torch.einsum(
                "pji,ib->pjb", U_pref[p0:p0 + rows][:, tbl], Wslice)
    return H


def _basis_change_levels(data: torch.Tensor, W: torch.Tensor, r: int, d: int,
                         d_out: int, store_dtype: torch.dtype,
                         acc_dtype: torch.dtype, budget: int,
                         onthefly_above: Optional[int] = None) -> torch.Tensor:
    """The whole-level route on packed values of rank r ≥ 2: returns the
    packed values of the result over d_out, in `store_dtype`. The levels
    live in `acc_dtype`; `store_dtype` only casts the result. `budget`
    bounds each transient in elements; any budget gives the same values up
    to the GEMMs' rounding."""
    t_out = tables(r, d_out, data.device)
    U = data.to(acc_dtype).reshape(1, -1)
    Wc = W.to(acc_dtype)
    with full_fp32_matmul():
        for t in range(r):
            k = r - t - 1
            ins = (_InsertMap(r, k, d, data.device, onthefly_above)
                   if k >= 1 else None)
            N_k = _n_cols(k, d)
            par, mx = t_out.mono_tables(t + 1)  # colex level t + 1 over d_out
            chunks = _window_chunks(t, N_k, d_out, budget)
            child = None
            for b0, b1 in chunks:
                # parents of the children with max element < b1: a colex prefix
                mm = comb.multiset_count(b1, t)
                H = _extend(U[:mm], ins, Wc[:, b0:b1], N_k, budget)
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


# ---------------------------------------------------------------------------
# blocked route
# ---------------------------------------------------------------------------


def _row_budgets(r: int, d_out: int, widths: List[int], total_elems: int,
                 leaf_rows: int) -> List[Optional[int]]:
    """Rows per level 1 … r under the element budget of the resident
    blocks (``symtensor_tpu/ops/basis_change.py:714-747``).

    Waterfill: levels that fit whole (R_t = P_t rows) are granted first,
    the cheapest first, while each takes at most 0.9 of what is left: a
    whole level is one chunk, and every further chunk of level t sweeps its
    parent block again. What is left is split: half to the shallowest
    level that is not whole (each of its chunks sweeps the largest
    parent), the rest evenly. The leaves are written as they are made, so
    level r holds `leaf_rows` children a chunk."""
    R: List[Optional[int]] = [None] + [0] * r
    caps = [None] + [comb.multiset_count(d_out, t) for t in range(1, r + 1)]
    remaining = total_elems
    full = set()
    for t in sorted(range(1, r), key=lambda t: caps[t] * widths[t]):
        need = caps[t] * widths[t]
        if need <= remaining * 0.9:
            R[t] = caps[t]
            full.add(t)
            remaining -= need
    unfull = [t for t in range(1, r) if t not in full]
    for i, t in enumerate(unfull):
        if len(unfull) == 1:
            share = remaining
        elif i == 0:
            share = remaining / 2
        else:
            share = remaining / 2 / (len(unfull) - 1)
        R[t] = int(min(caps[t], max(1, share // widths[t])))
    R[r] = max(1, min(caps[r], leaf_rows))
    for part in os.environ.get("SYMTENSOR_BASIS_ROWS", "").split(","):
        # per-level overrides, e.g. SYMTENSOR_BASIS_ROWS=1:20,3:2000
        if ":" in part:
            lev, rows = (int(x) for x in part.split(":", 1))
            if 1 <= lev <= r:
                R[lev] = max(1, min(rows, caps[lev]))
    return R


def _use_root_pass(r: int) -> bool:
    """Level 0 goes through the case-decomposed root pass at rank ≥ 4
    (child rank k = r − 1 ≥ 3)."""
    return r >= 4


def _root_step_fits(r: int, d: int, onthefly_above: Optional[int]) -> bool:
    """Whether level 0's insert map (k = r − 1: ``insert_table(k)``, or the
    level-k representatives where the positions are ranked on the device)
    passes ``config.max_table_entries``: the sharded route's masked root
    step needs it; rank 6 dim 100 (4.6e8 representatives) does not fit."""
    k = r - 1
    n_k = comb.indep_size(k, d)
    fly = _on_the_fly(k, d, onthefly_above)
    return (n_k * k if fly else n_k * d * (k + 1)) <= config.max_table_entries


def _use_row_pass(r: int, t: int, d: int, rows: int) -> bool:
    """Whether a block of `rows` rows at level t ≥ 1 is swept row by row
    through the root pass."""
    k = r - t - 1
    return (k >= 3 and rows <= _ROW_PASS_MAX_ROWS
            and comb.indep_size(k, d) * d >= _ROW_PASS_INCID)


def _column_elems(npref: int, nsel: int, d: int, width: int, fly: bool) -> int:
    """Transient elements one column of a chunk costs: the gathered prefix
    (npref, d), its product (width, npref), the picked rows (nsel) and,
    where the positions are ranked on the device, the ranking's planes."""
    return npref * (d + width) + nsel + (_FLY_ELEMS * d if fly else 0)


def _segment_cols(n_k: int, column_elems: int, transient: int) -> int:
    """Columns of a chunk taken at a time under `transient` elements (one
    column is always taken)."""
    return max(1, min(n_k, transient // column_elems))


def _blocked_peak_elems(r: int, d: int, d_out: int, R: List[Optional[int]],
                        transient: int, onthefly_above: Optional[int] = None,
                        root_copy: bool = False) -> int:
    """Projected peak residency of the blocked route in elements (an int64
    plane counts two to a value): the result, the root's copy where the
    storage type differs from A's, one block a level with its
    representatives, and the largest transient of a chunk: of the generic
    step one column segment's gathered prefix, product and picked rows
    with the ranking's planes and the chunk's selectors; of the root pass
    its bundle, tile and products; of the leaf step its product and the
    positions of its children."""
    n_out = comb.indep_size(r, d_out)
    blocks = sum(R[t] * (comb.indep_size(r - t, d) + t) for t in range(1, r))
    peak = 0
    for t in range(r):
        k = r - t - 1
        rows = R[t] if t else 1
        width = min(d_out, R[t + 1])
        if k == 0:
            grid = max(min(transient, rows * d_out), rows)
            step = 2 * grid + 11 * R[r]
        elif (t == 0 and _use_root_pass(r)) or (t and _use_row_pass(r, t, d, rows)):
            step = basis_root.root_pass_peak_elems(k, d, width, transient)
        else:
            n_k = comb.indep_size(k, d)
            fly = _on_the_fly(k, d, onthefly_above)
            per_col = _column_elems(rows, R[t + 1], d, width, fly)
            step = _segment_cols(n_k, per_col, transient) * per_col + 10 * R[t + 1]
        peak = max(peak, step)
    return n_out + (comb.indep_size(r, d) if root_copy else 0) + blocks + peak


class _Block:
    """One resident block of level-t rows, sorted by max element: the
    values (rows, N_{r−t}), the number of rows per max element (host), and
    the rows' representative multisets (t, rows) int32; at the last level
    also the rows' base positions in the result, made at the first emit."""

    __slots__ = ("U", "per_max", "reps", "base")

    def __init__(self, U: torch.Tensor, per_max: np.ndarray, reps: torch.Tensor):
        self.U = U
        self.per_max = per_max
        self.reps = reps
        self.base = None


class _Blocked:
    """One call of the blocked route: the budgets, W in the products' type,
    the result buffer and the counts of what was run."""

    def __init__(self, r, d, d_out, W, store_dtype, acc_dtype, R, transient,
                 onthefly_above, device):
        self.r, self.d, self.d_out = r, d, d_out
        self.store, self.R, self.transient = store_dtype, R, transient
        self.onthefly_above, self.device = onthefly_above, device
        # bfloat16 blocks feed the tensor cores as they are (float32
        # accumulation inside the GEMM); every other block is cast to the
        # accumulation type, float32 products in full float32
        self.mm = (torch.bfloat16 if store_dtype == torch.bfloat16
                   and acc_dtype == torch.float32 else acc_dtype)
        self.acc = acc_dtype
        self.WT = W.to(self.mm).T.contiguous()  # (d_out, d)
        self.t_out = tables(r, d_out, device)
        self.out = torch.zeros(comb.indep_size(r, d_out), dtype=store_dtype,
                               device=device)
        self.maps: Dict[int, _InsertMap] = {}
        self.stats = {"chunks": 0, "segments": 0, "emits": 0,
                      "root_windows": 0, "row_windows": 0}

    # Hooks of the sharded route (``_ShardedBlocked``), where a block holds
    # a slice of its columns; on one device a block is whole.
    root_whole = True

    def whole(self, U: torch.Tensor, t: int) -> torch.Tensor:
        """Rows of a level-t block with all their columns."""
        return U

    def padded(self, U: torch.Tensor, t: int) -> torch.Tensor:
        """This device's columns of rows of a level-t block as it stores
        them."""
        return U

    def my_cols(self, t: int) -> Tuple[int, int]:
        """The columns [lo, hi) of a level-t block that this device computes."""
        return 0, _n_cols(self.r - t, self.d)

    def write(self, pos: torch.Tensor, vals: torch.Tensor) -> None:
        """Finished leaves into the result."""
        self.out.index_put_((pos,), vals)

    def insert_map(self, k: int) -> _InsertMap:
        if k not in self.maps:
            self.maps[k] = _InsertMap(self.r, k, self.d, self.device,
                                      self.onthefly_above)
        return self.maps[k]

    # ------------------------------------------------------------- schedule

    def process(self, t: int, blk: _Block) -> None:
        """Produce, and recurse into, every child block of `blk` (level t)."""
        r, d_out = self.r, self.d_out
        k = r - t - 1
        Rc = self.R[t + 1]
        rows = blk.U.shape[0]
        if t == 0 and _use_root_pass(r) and self.root_whole:
            for b_lo in range(0, d_out, Rc):
                self.stats["root_windows"] += 1
                self.pass_window(t, blk, 0, b_lo, min(b_lo + Rc, d_out))
            return
        if t and _use_row_pass(r, t, self.d, rows):
            maxels = np.repeat(np.arange(d_out), blk.per_max)
            for p in range(rows):
                for b_lo in range(int(maxels[p]), d_out, Rc):
                    self.stats["row_windows"] += 1
                    self.pass_window(t, blk, p, b_lo, min(b_lo + Rc, d_out))
            return
        # parents of the children with new max element b: a prefix
        counts = np.cumsum(blk.per_max)
        leaf = k == 0
        b = int(np.argmax(counts > 0))
        while b < d_out:
            b_lo, cnts, nsel = b, [], 0
            while b < d_out and nsel < Rc:
                c = int(counts[b])
                if c > Rc and nsel == 0:
                    # one group over the row budget: parent-prefix pieces
                    for p0 in range(0, c, Rc):
                        self.chunk(t, blk, b, b + 1, p0, [min(p0 + Rc, c) - p0])
                    b += 1
                    b_lo = b
                    continue
                if nsel + c > Rc or (
                        leaf and nsel and c * (b + 1 - b_lo) > self.transient):
                    break
                cnts.append(c)
                nsel += c
                b += 1
            if nsel:
                self.chunk(t, blk, b_lo, b, 0, cnts)

    def pass_window(self, t: int, blk: _Block, p: int, b_lo: int, b_hi: int) -> None:
        """The children (row p, b) for b in [b_lo, b_hi) through the root
        pass of that row; then their subtree."""
        k = self.r - t - 1
        self.stats["chunks"] += 1
        U = self.padded(basis_root.root_pass(
            self.whole(blk.U[p:p + 1], t)[0], self.WT[b_lo:b_hi].T, k,
            self.d, self.transient, self.store, self.my_cols(t + 1)), t + 1)
        new = torch.arange(b_lo, b_hi, dtype=torch.int32, device=self.device)
        reps = torch.cat([blk.reps[:, p:p + 1].expand(t, b_hi - b_lo), new[None]])
        per_max = np.zeros(self.d_out, dtype=np.int64)
        per_max[b_lo:b_hi] = 1
        self.process(t + 1, _Block(U, per_max, reps))

    def chunk(self, t: int, blk: _Block, b_lo: int, b_hi: int, row0: int,
              cnts: List[int]) -> None:
        """The children (row0 + p, b) for b in [b_lo, b_hi) and p under
        cnts[b − b_lo], ordered by (b, p): one block of level t + 1 and its
        subtree, or, at the last level, values written into the result."""
        dev = self.device
        self.stats["chunks"] += 1
        nsel, npref, width = sum(cnts), max(cnts), b_hi - b_lo
        # made on the device from the window's running counts, the
        # chunk's only upload (16 bytes a column)
        ends = torch.tensor(np.cumsum(cnts), device=dev)
        slot = torch.arange(nsel, device=dev)
        col = torch.bucketize(slot, ends, right=True)
        sel_p = slot - (ends - torch.tensor(cnts, device=dev))[col]
        sel_b = col + b_lo
        sel_rows = col * npref + sel_p
        parents = blk.U[row0:row0 + npref]
        if t + 1 == self.r:
            self.emit(t, blk, parents, row0, b_lo, b_hi, sel_p, sel_b, sel_rows)
            return
        U = self.step(t, parents, b_lo, b_hi, sel_rows, nsel)
        reps = torch.cat([blk.reps[:, row0:row0 + npref].index_select(1, sel_p),
                          sel_b[None].to(torch.int32)])
        per_max = np.zeros(self.d_out, dtype=np.int64)
        per_max[b_lo:b_hi] = cnts
        del parents, sel_p, sel_b, sel_rows
        self.process(t + 1, _Block(U, per_max, reps))

    # ---------------------------------------------------------------- steps

    def step(self, t: int, parents: torch.Tensor, b_lo: int, b_hi: int,
             sel_rows: torch.Tensor, nsel: int) -> torch.Tensor:
        """(npref, N_{k+1}) parents → the (nsel, N_k) child block (this
        device's columns of it)."""
        full = self.whole(parents, t)
        lo, hi = self.my_cols(t + 1)
        return self.padded(self.columns(t, lambda pos: full.index_select(1, pos),
                                        full.shape[0], b_lo, b_hi, sel_rows, nsel,
                                        lo, hi), t + 1)

    def columns(self, t: int, gather: Callable, npref: int, b_lo: int, b_hi: int,
                sel_rows: torch.Tensor, nsel: int, c_lo: int, c_hi: int,
                out: Optional[torch.Tensor] = None) -> torch.Tensor:
        """The child columns [c_lo, c_hi) of a chunk, (nsel, c_hi − c_lo),
        written into `out` where given; `gather(pos)` reads the parents'
        values at flat column positions, (npref, len(pos)). The product of
        a column segment is computed transposed, (window, npref · columns),
        so that the children (b, p) are whole contiguous rows of it: the
        pick is one row gather."""
        if out is None and c_hi <= c_lo:
            return torch.empty((nsel, 0), dtype=self.store, device=self.device)
        d, k = self.d, self.r - t - 1
        width = b_hi - b_lo
        ins = self.insert_map(k)
        cols = _segment_cols(c_hi - c_lo,
                             _column_elems(npref, nsel, d, width, ins.fly),
                             self.transient)
        Wt = self.WT[b_lo:b_hi]  # (width, d)
        for c0 in range(c_lo, c_hi, cols):
            c1 = min(c0 + cols, c_hi)
            self.stats["segments"] += 1
            pos = ins.positions(c0, c1).reshape(-1)
            G = gather(pos).to(self.mm)
            H = Wt @ G.view(npref * (c1 - c0), d).T  # (width, npref · cols)
            picked = H.view(width * npref, c1 - c0).index_select(0, sel_rows)
            if out is None and c1 - c0 == c_hi - c_lo:
                return picked.to(self.store)
            if out is None:
                out = torch.empty((nsel, c_hi - c_lo), dtype=self.store,
                                  device=self.device)
            out[:, c0 - c_lo:c1 - c_lo] = picked
        return out

    def emit(self, t, blk, parents, row0, b_lo, b_hi, sel_p, sel_b, sel_rows) -> None:
        """The last step fused with the write: one product (window, npref),
        the children's values picked from it, their positions
        ``position_base_T(rep) + b``."""
        self.stats["emits"] += 1
        H = self.WT[b_lo:b_hi] @ self.whole(parents, t).to(self.mm).T
        vals = H.view(-1).index_select(0, sel_rows)
        if blk.base is None:
            blk.base = self.t_out.position_base_T(blk.reps)
        pos = blk.base.index_select(0, sel_p + row0) + sel_b
        self.write(pos, vals.to(self.store))


class _ShardedBlocked(_Blocked):
    """The blocked route over a mesh axis of `tp` devices (``_axis`` of
    ``parallel/sharding.py``): every level block holds a slice of its
    original-multiset columns, ceil(N/tp) of them zero-padded a device, and
    each step all-gathers its parents once (``whole``) and computes its own
    slice of the children's columns; a row pass gathers its row and
    computes the child groups that hold its slice. The root stays sharded:
    at t = 0 each device gathers from its own shard, masked (in pieces of
    at most ``$SYMTENSOR_GATHER_MAX_BYTES`` of the shard), and the children
    are summed over the axis, one owner's columns at a time. Where the root
    pass takes level 0 (rank ≥ 4) and the masked step's tables pass no
    guard (``_root_step_fits``; rank 6 dim 100), the root is all-gathered
    instead and each device runs the root pass on its own columns. The
    leaves are computed on every device, each keeping those of its part of
    the result (ceil(n_out/tp) values and one dump slot). At tp = 1 it is
    the blocked route itself."""

    def __init__(self, *args, tp, root_whole: bool):
        super().__init__(*args)
        self.tp = tp
        self.root_whole = root_whole
        self.Lo = -(-self.out.shape[0] // tp.size)
        self.out = torch.zeros(self.Lo + 1, dtype=self.store, device=self.device)
        self.gmax = _env_int("SYMTENSOR_GATHER_MAX_BYTES", (1 << 31) - (1 << 27))

    def width(self, t: int) -> Tuple[int, int]:
        """(N, padded slice width) of a level-t block."""
        N = _n_cols(self.r - t, self.d)
        return N, -(-N // self.tp.size)

    def my_cols(self, t: int) -> Tuple[int, int]:
        N, L = self.width(t)
        lo = min(self.tp.index * L, N)
        return lo, min(lo + L, N)

    def whole(self, U: torch.Tensor, t: int) -> torch.Tensor:
        from ..parallel.sharding import all_gather

        if self.tp.size == 1 or (t == 0 and self.root_whole):
            return U
        N, L = self.width(t)
        rows = U.shape[0]
        g = all_gather(U.contiguous().view(-1), self.tp)
        return g.view(self.tp.size, rows, L).transpose(0, 1).reshape(rows, -1)[:, :N]

    def padded(self, U: torch.Tensor, t: int) -> torch.Tensor:
        L = self.width(t)[1]
        if U.shape[1] == L:
            return U
        return torch.nn.functional.pad(U, (0, L - U.shape[1]))

    def step(self, t, parents, b_lo, b_hi, sel_rows, nsel):
        if t == 0 and not self.root_whole:
            return self.root_step(parents, b_lo, b_hi, sel_rows, nsel)
        return super().step(t, parents, b_lo, b_hi, sel_rows, nsel)

    def root_step(self, root, b_lo, b_hi, sel_rows, nsel):
        """The children of the sharded root: each owner's columns summed
        over the axis, the owner keeping them."""
        from ..parallel.sharding import all_reduce

        shard = root[0]
        off = self.tp.index * shard.shape[0]
        per = max(1, self.gmax // shard.element_size())
        pieces = [(p0, shard[p0:p0 + per]) for p0 in range(0, shard.shape[0], per)]

        def gather(pos):  # positions outside this device's shard read zero
            loc = pos - off
            G = torch.zeros(pos.shape, dtype=shard.dtype, device=shard.device)
            for p0, piece in pieces:
                inside = (loc >= p0) & (loc < p0 + piece.shape[0])
                G += torch.where(inside, piece[(loc - p0).clamp(0, piece.shape[0] - 1)], 0)
            return G[None]

        N, L = self.width(1)
        mine = None
        for o in range(self.tp.size):
            lo = min(o * L, N)
            part = torch.zeros((nsel, L), dtype=self.acc, device=self.device)
            self.columns(0, gather, 1, b_lo, b_hi, sel_rows, nsel, lo, min(lo + L, N),
                         out=part)
            all_reduce(part, self.tp)
            if o == self.tp.index:
                mine = part.to(self.store)
        return mine

    def write(self, pos, vals):
        if self.tp.size == 1:
            return super().write(pos, vals)
        loc = pos - self.tp.index * self.Lo
        loc = torch.where((loc >= 0) & (loc < self.Lo), loc, self.Lo)  # the dump slot
        self.out.index_put_((loc,), vals)


def _basis_change_sharded(A: FlatSymmetricTensor, W: torch.Tensor, d_out: int,
                          store_dtype, acc_dtype, block_elems: int,
                          transient_elems: int, onthefly_above: Optional[int],
                          mesh, tp_axis: str):
    """The blocked route under a mesh: the result's packed values as a
    ``DTensor`` split over `tp_axis` (``Shard(0)``, ceil(n_out/tp) a
    device). The block budget is the axis' devices' together."""
    from ..parallel.sharding import _axis, _placements, _sharded_values, full_values

    r, d = A.rank, A.dim
    tp = _axis(mesh, tp_axis)
    n = comb.indep_size(r, d)
    Lr = -(-n // tp.size)
    if is_sharded(A.data):
        if tuple(A.data.placements) != _placements(mesh, tp_axis):
            raise TypeError(f"A's values are sharded as {A.data.placements}; the "
                            f"sharded basis change keeps Shard(0) on '{tp_axis}'")
        root = A.data.to_local()
    else:
        root = A.data[tp.index * Lr:(tp.index + 1) * Lr]  # a view of A's values
        if root.shape[0] < Lr:
            root = torch.nn.functional.pad(root, (0, Lr - root.shape[0]))
    device = root.device
    n_out = comb.indep_size(r, d_out)
    if r <= 1:
        with full_fp32_matmul():
            full = full_values(A.data)
            out = full.to(store_dtype) if r == 0 else (full.to(acc_dtype) @ W.to(acc_dtype))
        Lo = -(-n_out // tp.size)
        local = out.to(store_dtype)[tp.index * Lo:(tp.index + 1) * Lo]
        return _sharded_values(local, n_out, mesh, tp_axis)
    widths = [comb.indep_size(r - t, d) for t in range(r + 1)]
    R = _row_budgets(r, d_out, widths, block_elems * tp.size, transient_elems)
    gathered = (tp.size > 1 and _use_root_pass(r)
                and not _root_step_fits(r, d, onthefly_above))
    if gathered:
        root = full_values(_sharded_values(root[:max(0, min(Lr, n - tp.index * Lr))],
                                           n, mesh, tp_axis))
    run = _ShardedBlocked(r, d, d_out, W, store_dtype, acc_dtype, R, transient_elems,
                          onthefly_above, device, tp=tp,
                          root_whole=tp.size == 1 or gathered)
    per_max = np.zeros(d_out, dtype=np.int64)
    per_max[0] = 1
    reps = torch.empty((0, 1), dtype=torch.int32, device=device)
    with torch.no_grad(), full_fp32_matmul():
        run.process(0, _Block(root.to(store_dtype).reshape(1, -1), per_max, reps))
    last_call.update(run.stats, rows=R[1:], tp=tp.size, root=n, out_shard=run.Lo,
                     root_shard=root.shape[0], root_gathered=gathered)
    local = run.out[:run.Lo][:max(0, min(run.Lo, n_out - tp.index * run.Lo))]
    return _sharded_values(local, n_out, mesh, tp_axis)


def _basis_change_blocked(A_data: torch.Tensor, W: torch.Tensor, r: int, d: int,
                          d_out: int, store_dtype: torch.dtype,
                          acc_dtype: torch.dtype, block_elems: int,
                          transient_elems: int, onthefly_above: Optional[int],
                          donate_root: bool) -> torch.Tensor:
    """The blocked route on packed values of rank r ≥ 2: the packed values
    of the result over d_out, in `store_dtype`."""
    widths = [comb.indep_size(r - t, d) for t in range(r + 1)]
    R = _row_budgets(r, d_out, widths, block_elems, transient_elems)
    device = A_data.device
    root = A_data.to(store_dtype)
    copied = root.data_ptr() != A_data.data_ptr()
    if donate_root and copied and not A_data.requires_grad:
        A_data.set_()  # the cast copy is all that is read from here on
    run = _Blocked(r, d, d_out, W, store_dtype, acc_dtype, R, transient_elems,
                   onthefly_above, device)
    per_max = np.zeros(d_out, dtype=np.int64)
    per_max[0] = 1  # the empty multiset is a parent of every b
    reps = torch.empty((0, 1), dtype=torch.int32, device=device)
    with full_fp32_matmul():
        run.process(0, _Block(root.reshape(1, -1), per_max, reps))
    last_call.update(run.stats, rows=R[1:], projected_elems=_blocked_peak_elems(
        r, d, d_out, R, transient_elems, onthefly_above, copied))
    return run.out


def basis_change_packed(A: FlatSymmetricTensor, W, *,
                        block_elems: Optional[int] = None,
                        transient_elems: Optional[int] = None,
                        store_dtype=None, acc_dtype=None,
                        onthefly_above: Optional[int] = None,
                        donate_root: bool = False, mesh=None,
                        tp_axis: str = "tp") -> FlatSymmetricTensor:
    """C = A · W ⊗ … ⊗ W of a packed symmetric tensor: a flat tensor of
    A's rank over W's second dimension, on A's device (W is moved there).

    block_elems: element budget of all resident level blocks of the
      blocked route together (default $SYMTENSOR_BASIS_BLOCK_ELEMS or
      2**32).
    transient_elems: element budget of one chunk's gathered rows, product
      and pick (default $SYMTENSOR_BASIS_TRANSIENT_ELEMS or 2**28).
    store_dtype: type of the result and, on the blocked route, of the
      level blocks (default A.dtype; bfloat16 halves their residency). The
      whole-level route keeps its levels in `acc_dtype`.
    acc_dtype: type of the products (default float32, or float64 when the
      data is float64). float32 products run in full float32 (TF32 off);
      bfloat16 blocks enter the GEMMs as they are, accumulated in float32.
    onthefly_above: rank the insert positions of a level on the device
      where N_k · dim passes this (default: where ``insert_table(k)``
      would pass ``config.max_table_entries``).
    donate_root: on the blocked route, drop A's values once they have been
      copied: only a `store_dtype` other than A's copies them, and only
      then is the caller's tensor emptied (``A.data`` is left with no
      elements); otherwise this does nothing (the route reads A in place).
    mesh, tp_axis: a ``torch.distributed`` device mesh
      (``parallel.make_mesh``) and its axis: the blocked route with every
      level block split over `tp_axis` along its original-multiset columns
      (``_ShardedBlocked``), the block budget that of the axis' devices
      together; A's values stay sharded, and the result's values are a
      ``DTensor`` with ``Shard(0)`` on `tp_axis`. A may be unsharded (the
      same values on every device) or ``parallel.shard_flat`` over the
      axis. Collective: every device of the mesh calls it alike. No
      gradient under a mesh.

    A call that names none of `block_elems`, `transient_elems`,
    `onthefly_above`, `donate_root` (nor sets their environment variables)
    takes the whole-level route when its projected residency is within
    $SYMTENSOR_BASIS_SMALL_ELEMS and its tables within
    ``config.max_table_entries``; every other call runs the blocked route.
    ``last_call`` says which. Nothing falls back further: a table that the
    chosen route needs and that passes the guard raises the tables'
    ``MemoryError``, and a result or block the card cannot hold raises
    torch's out-of-memory error. Autograd follows either route."""
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
    last_call.clear()
    if mesh is not None:
        last_call["route"] = "blocked, sharded"
        return FlatSymmetricTensor._raw(r, d_out, _basis_change_sharded(
            A, W, d_out, store_dt, acc_dt,
            block_elems or _env_int("SYMTENSOR_BASIS_BLOCK_ELEMS", _BLOCK_ELEMS),
            transient_elems or _env_int("SYMTENSOR_BASIS_TRANSIENT_ELEMS",
                                        _TRANSIENT_ELEMS),
            onthefly_above, mesh, tp_axis))
    require_local("basis_change_packed without a mesh", A)
    if r == 0:
        return FlatSymmetricTensor._raw(0, 1, A.data.to(store_dt))
    if r == 1:
        with full_fp32_matmul():
            out = A.data.to(acc_dt) @ W.to(acc_dt)
        return FlatSymmetricTensor._raw(1, d_out, out.to(store_dt))
    all_default = (block_elems is None and transient_elems is None
                   and onthefly_above is None and not donate_root
                   and "SYMTENSOR_BASIS_BLOCK_ELEMS" not in os.environ
                   and "SYMTENSOR_BASIS_TRANSIENT_ELEMS" not in os.environ)
    if all_default and _whole_level_fits(r, d, d_out, _SMALL_BUDGET):
        last_call["route"] = "whole-level"
        return FlatSymmetricTensor._raw(r, d_out, _basis_change_levels(
            A.data, W, r, d, d_out, store_dt, acc_dt, _SMALL_BUDGET))
    last_call["route"] = "blocked"
    return FlatSymmetricTensor._raw(r, d_out, _basis_change_blocked(
        A.data, W, r, d, d_out, store_dt, acc_dt,
        block_elems or _env_int("SYMTENSOR_BASIS_BLOCK_ELEMS", _BLOCK_ELEMS),
        transient_elems or _env_int("SYMTENSOR_BASIS_TRANSIENT_ELEMS",
                                    _TRANSIENT_ELEMS),
        onthefly_above, donate_root))
