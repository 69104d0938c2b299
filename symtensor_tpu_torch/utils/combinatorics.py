"""Host-side combinatorics for symmetric tensors.

A plain copy of ``symtensor_tpu/utils/combinatorics.py``: importing that
module through its package would import jax, and this package must not.
``tests/test_torch_combinatorics.py`` holds the two copies equal.

Pure Python/NumPy, exact integer arithmetic. Everything here runs before
any tensor op and produces *static* quantities: σ-class enumerations,
sizes, multiplicities, and the closed-form addressing of the packed ("gflat")
storage layout. No torch imports — this module stays importable host-side.

Reference parity (the upstream ``symtensor`` library, cited for behavioral
equivalence, not implementation): σ-class label/count conventions follow
``symtensor/utils.py:699-776`` (``'iijk'`` ↔ ``(2,1,1)``); the two identities
``Σ s_σ·γ_σ = d^r`` and ``Σ s_σ = C(d+r-1,r)`` (``symtensor/base.py:140-145``)
are the test oracles.

Layout design (new, TPU-first — no reference equivalent):

**gflat layout.** Independent components of a rank-``r`` dim-``d`` symmetric
tensor are multisets ``i1 ≤ i2 ≤ … ≤ ir``. We store them in a single packed
1-D array ordered by the key

    (j, colexrank(head), trirank(tail))        for r ≥ 3
    trirank(i1, i2)                            for r == 2

where ``j = i_{r-2}`` (third-largest index), ``head = (i1 … i_{r-3})`` is a
multiset over ``{0..j}`` in *colexicographic* order, and
``tail = (i_{r-1}, i_r)`` lives in the row-major upper triangle of side
``d - j``. This makes ``contract_all_indices_with_vector`` a sequence of ``d``
static-shape GEMVs (one per ``j`` group) against contiguous slices of a
triangle-monomial vector — no per-element gather tables — so the op is
bound by one read of the value stream.
"""

from __future__ import annotations

import itertools
import math
from functools import lru_cache
from typing import Iterator, Sequence, Tuple

import numpy as np

# Index letters used for σ-class labels ('iij' etc.). Same alphabet order as
# the reference (symtensor/utils.py:699) so labels round-trip identically.
INDEX_LETTERS = "ijklmnabcdefghopqrstuvwxyzABCDEFGHIJKLMNOPQRSTUVWXYZ"

SigmaClass = Tuple[int, ...]  # counts, sorted descending, e.g. (2, 1, 1)


# ---------------------------------------------------------------------------
# Exact small-number combinatorics
# ---------------------------------------------------------------------------

def binom(n: int, k: int) -> int:
    """Exact binomial coefficient; 0 for out-of-range arguments."""
    if k < 0 or n < 0 or k > n:
        return 0
    return math.comb(n, k)


def multinom(n: int, counts: Sequence[int]) -> int:
    """Exact multinomial coefficient n! / ∏ counts!.

    Behavioral parity with reference ``utils.multinom``
    (symtensor/utils.py:207).
    """
    if sum(counts) != n:
        raise ValueError(f"counts {counts} must sum to n={n}")
    out = math.factorial(n)
    for c in counts:
        out //= math.factorial(c)
    return out


def multiset_count(num_values: int, size: int) -> int:
    """Number of multisets of `size` elements from `num_values` values."""
    if size == 0:
        return 1
    return binom(num_values + size - 1, size)


# ---------------------------------------------------------------------------
# σ-classes (permutation classes)
# ---------------------------------------------------------------------------

@lru_cache(maxsize=None)
def perm_classes(rank: int) -> Tuple[SigmaClass, ...]:
    """All σ-classes of a given rank: integer partitions of `rank`,
    parts descending, enumerated largest-first.

    >>> perm_classes(3)
    ((3,), (2, 1), (1, 1, 1))

    Parity: reference ``utils._perm_classes`` (symtensor/utils.py:1000).
    """
    if rank == 0:
        return ((),)

    def _parts(n: int, maxpart: int) -> Iterator[Tuple[int, ...]]:
        if n == 0:
            yield ()
            return
        for first in range(min(n, maxpart), 0, -1):
            for rest in _parts(n - first, first):
                yield (first,) + rest

    return tuple(_parts(rank, rank))


def class_label(counts: SigmaClass) -> str:
    """Counts → string label: (2,1,1) → 'iijk'.

    Parity: reference ``utils.permclass_counts_to_label``
    (symtensor/utils.py:728).
    """
    return "".join(s * c for s, c in zip(INDEX_LETTERS, counts))


def class_counts(label: str) -> SigmaClass:
    """String label → counts: 'iijk' → (2,1,1).

    Parity: reference ``utils.permclass_label_to_counts``
    (symtensor/utils.py:744).
    """
    return tuple(sorted((label.count(s) for s in set(label)), reverse=True))


def as_class_counts(cls) -> SigmaClass:
    """Normalize a σ-class given as label or counts to a counts tuple."""
    if isinstance(cls, str):
        return class_counts(cls)
    counts = tuple(int(c) for c in cls)
    if tuple(sorted(counts, reverse=True)) != counts:
        raise ValueError(f"σ-class counts must be sorted descending: {cls}")
    return counts


def class_of_index(idx: Sequence[int]) -> SigmaClass:
    """σ-class (counts, descending) of a multi-index.

    >>> class_of_index((5, 0, 1, 0))
    (2, 1, 1)

    Parity: reference ``utils._get_permclass`` (symtensor/utils.py:878).
    """
    from collections import Counter

    return tuple(sorted(Counter(idx).values(), reverse=True))


def class_multiplicity(counts: SigmaClass) -> int:
    """γ_σ: number of distinct permutations of an index in this class,
    = rank! / ∏ counts!.

    Parity: reference ``utils.get_permclass_multiplicity``
    (symtensor/utils.py:760).
    """
    return multinom(sum(counts), counts)


def class_size(counts: SigmaClass, dim: int) -> int:
    """s_σ: number of index classes (independent components) in this σ-class
    for dimension `dim`: d·(d−1)···(d−L+1) / ∏_n m_n!  where L = #distinct
    values and m_n = #counts equal to n.

    Parity: reference ``utils._get_permclass_size`` (symtensor/utils.py:925).
    """
    L = len(counts)
    if L > dim:
        return 0
    num = 1
    for t in range(L):
        num *= dim - t
    from collections import Counter

    for m in Counter(counts).values():
        num //= math.factorial(m)
    return num


def indep_size(rank: int, dim: int) -> int:
    """Number of independent components C(d+r−1, r)."""
    return multiset_count(dim, rank)


# ---------------------------------------------------------------------------
# Multiset ranking (colex) — closed-form addressing
# ---------------------------------------------------------------------------

def colex_rank(sorted_idx: Sequence[int]) -> int:
    """Colexicographic rank of a multiset given as a sorted (ascending)
    tuple: rank = Σ_t C(i_t + t − 1, t), t = 1-based position.

    Colex order is the canonical per-size multiset order used throughout the
    gflat layout: multisets with max element ≤ m form a contiguous prefix of
    length C(m+k, k), which is what makes monomial vectors and head tables
    recursively sliceable.
    """
    return sum(binom(v + t, t + 1) for t, v in enumerate(sorted_idx))


def colex_unrank(rank_: int, size: int) -> Tuple[int, ...]:
    """Inverse of `colex_rank` for multisets of the given size."""
    idx = []
    r = rank_
    for t in range(size, 0, -1):
        # Largest v with C(v + t - 1, t) <= r
        v = 0
        while binom(v + t, t) <= r:
            v += 1
        idx.append(v)
        r -= binom(v + t - 1, t)
    return tuple(reversed(idx))


def colex_rank_array(sorted_idx: np.ndarray) -> np.ndarray:
    """Vectorized colex rank. `sorted_idx`: (N, k) ascending rows → (N,)."""
    n, k = sorted_idx.shape
    out = np.zeros(n, dtype=np.int64)
    for t in range(k):
        out += _binom_array(sorted_idx[:, t].astype(np.int64) + t, t + 1)
    return out


def _binom_array(n: np.ndarray, k: int) -> np.ndarray:
    """Vectorized exact C(n, k) for small fixed k (int64; caller guards
    against overflow via table sizes < 2**63)."""
    n = n.astype(np.int64)
    out = np.ones_like(n)
    for t in range(k):
        out = out * (n - t)
    return out // math.factorial(k)


def multisets_colex(num_values: int, size: int) -> np.ndarray:
    """All multisets of `size` elements over {0..num_values-1} in colex
    order, as an (N, size) int64 array of ascending rows. Vectorized build
    via the recursive colex-prefix structure."""
    if size == 0:
        return np.zeros((1, 0), dtype=np.int64)
    prev = multisets_colex(num_values, size - 1)
    blocks = []
    for i in range(num_values):
        cnt = multiset_count(i + 1, size - 1)
        blk = np.empty((cnt, size), dtype=np.int64)
        blk[:, : size - 1] = prev[:cnt]
        blk[:, size - 1] = i
        blocks.append(blk)
    return np.concatenate(blocks, axis=0)


def mono_recursion_tables(dim: int, size: int) -> Tuple[np.ndarray, np.ndarray]:
    """Static tables (parent, maxel) for building the colex monomial vector
    Mono_size from Mono_{size-1}:  Mono_k[p] = Mono_{k-1}[parent[p]] * x[maxel[p]].

    Entries with max element i occupy colex positions
    [C(i+k−1, k), C(i+k, k)); their parents are the colex prefix
    0..C(i+k−2, k−1)−1 of Mono_{k-1}, in order.
    """
    parents = []
    maxels = []
    for i in range(dim):
        cnt = multiset_count(i + 1, size - 1)
        parents.append(np.arange(cnt, dtype=np.int64))
        maxels.append(np.full(cnt, i, dtype=np.int64))
    return np.concatenate(parents), np.concatenate(maxels)


# ---------------------------------------------------------------------------
# gflat layout
# ---------------------------------------------------------------------------

def tri_size(side: int) -> int:
    """Number of (a ≤ b) pairs in the upper triangle of the given side."""
    return side * (side + 1) // 2


def tri_rank(a, b, side):
    """Row-major rank of pair (a ≤ b), 0 ≤ a ≤ b < side. Works on scalars
    and NumPy arrays alike."""
    return a * (2 * side - a + 1) // 2 + (b - a)


class GflatLayout:
    """Static addressing data of the gflat layout for one (rank, dim).

    Attributes (NumPy, host-side; device copies live in tables.py):
      groups      — j values 0..d-1 (r ≥ 3) or [0] (r == 2)
      P           — heads per group, P[j] = C(j + r − 3, r − 3)
      T           — tail triangle size per group, T[j] = C(d − j + 1, 2)
      group_off   — start offset of each group in the packed array
      tri_off     — offset of row j in the full d-triangle monomial vector
      n           — total independent components C(d + r − 1, r)
    """

    def __init__(self, rank: int, dim: int):
        if rank < 2:
            raise ValueError("GflatLayout requires rank ≥ 2")
        self.rank = rank
        self.dim = dim
        self.n = indep_size(rank, dim)
        if rank == 2:
            self.groups = np.array([0], dtype=np.int64)
            self.P = np.array([1], dtype=np.int64)
            self.T = np.array([tri_size(dim)], dtype=np.int64)
        else:
            j = np.arange(dim, dtype=np.int64)
            self.groups = j
            self.P = _binom_array(j + rank - 3, rank - 3)
            self.T = (dim - j) * (dim - j + 1) // 2
        sizes = self.P * self.T
        self.group_off = np.concatenate(
            ([0], np.cumsum(sizes)[:-1])
        ).astype(np.int64)
        assert int(sizes.sum()) == self.n, (rank, dim, sizes.sum(), self.n)
        d = dim
        rows = d - np.arange(d, dtype=np.int64)
        self.tri_off = np.concatenate(([0], np.cumsum(rows)[:-1])).astype(np.int64)

    # -- positions ----------------------------------------------------------

    def position(self, sorted_idx: Sequence[int]) -> int:
        """Packed position of one multiset (ascending tuple). O(r)."""
        r, d = self.rank, self.dim
        if len(sorted_idx) != r:
            raise ValueError(f"index length {len(sorted_idx)} != rank {r}")
        if r == 2:
            a, b = sorted_idx
            return tri_rank(a, b, d)
        j = sorted_idx[r - 3]  # i_{r-2}
        head = sorted_idx[: r - 3]
        a, b = sorted_idx[r - 2] - j, sorted_idx[r - 1] - j
        return int(
            self.group_off[j]
            + colex_rank(head) * self.T[j]
            + tri_rank(a, b, d - j)
        )

    def position_array(self, sorted_idx: np.ndarray) -> np.ndarray:
        """Vectorized `position`. (N, r) ascending rows → (N,) int64."""
        r, d = self.rank, self.dim
        if r == 2:
            return tri_rank(sorted_idx[:, 0], sorted_idx[:, 1], d)
        j = sorted_idx[:, r - 3]
        head_rank = colex_rank_array(sorted_idx[:, : r - 3])
        a = sorted_idx[:, r - 2] - j
        b = sorted_idx[:, r - 1] - j
        return (
            self.group_off[j]
            + head_rank * self.T[j]
            + tri_rank(a, b, d - j)
        )

    # -- enumeration --------------------------------------------------------

    def rep_indices(self) -> np.ndarray:
        """All independent multisets as an (n, rank) int64 array of
        ascending rows, in gflat storage order. O(n·r) memory — only call
        for sizes where that is acceptable (guarded by callers)."""
        r, d = self.rank, self.dim
        if r == 2:
            rows = []
            for i in range(d):
                blk = np.empty((d - i, 2), dtype=np.int64)
                blk[:, 0] = i
                blk[:, 1] = np.arange(i, d)
                rows.append(blk)
            return np.concatenate(rows, axis=0)
        heads_all = multisets_colex(d, r - 3)  # colex-prefix sliceable
        blocks = []
        for j in range(d):
            Pj = int(self.P[j])
            Tj = int(self.T[j])
            heads = heads_all[:Pj]
            side = d - j
            tails = np.empty((Tj, 2), dtype=np.int64)
            pos = 0
            for a in range(side):
                ln = side - a
                tails[pos : pos + ln, 0] = a + j
                tails[pos : pos + ln, 1] = np.arange(a + j, d)
                pos += ln
            blk = np.empty((Pj * Tj, r), dtype=np.int64)
            blk[:, : r - 3] = np.repeat(heads, Tj, axis=0)
            blk[:, r - 3] = j
            blk[:, r - 2 :] = np.tile(tails, (Pj, 1))
            blocks.append(blk)
        return np.concatenate(blocks, axis=0)


@lru_cache(maxsize=None)
def gflat_layout(rank: int, dim: int) -> GflatLayout:
    return GflatLayout(rank, dim)


# ---------------------------------------------------------------------------
# Per-row pattern helpers (vectorized)
# ---------------------------------------------------------------------------

def row_multiplicities(sorted_rows: np.ndarray) -> np.ndarray:
    """γ for each multiset row: r!/∏ counts!. Rows must be ascending.

    Uses the running-run-length trick: if l_t is the length of the run of
    equal values ending at position t, then ∏_t l_t = ∏_runs (len!)."""
    n, r = sorted_rows.shape
    if r == 0:
        return np.ones(n, dtype=np.int64)
    l = np.ones((n, r), dtype=np.int64)
    for t in range(1, r):
        eq = sorted_rows[:, t] == sorted_rows[:, t - 1]
        l[:, t] = np.where(eq, l[:, t - 1] + 1, 1)
    denom = l.prod(axis=1)
    return math.factorial(r) // denom  # array division is exact here

def row_class_counts(sorted_rows: np.ndarray) -> np.ndarray:
    """Per-row σ-class pattern as an (N, r) array of counts sorted
    descending, zero-padded. Rows must be ascending."""
    n, r = sorted_rows.shape
    l = np.ones((n, r), dtype=np.int64)
    for t in range(1, r):
        eq = sorted_rows[:, t] == sorted_rows[:, t - 1]
        l[:, t] = np.where(eq, l[:, t - 1] + 1, 1)
    # A position t is the end of a run iff t == r-1 or row[t+1] != row[t].
    end = np.ones((n, r), dtype=bool)
    end[:, :-1] = sorted_rows[:, 1:] != sorted_rows[:, :-1]
    counts = np.where(end, l, 0)
    counts = -np.sort(-counts, axis=1)
    return counts


def class_id_of_rows(sorted_rows: np.ndarray, rank: int) -> np.ndarray:
    """Map each multiset row to its σ-class id (index into perm_classes(rank))."""
    classes = perm_classes(rank)
    padded = {
        tuple(list(c) + [0] * (rank - len(c))): i for i, c in enumerate(classes)
    }
    counts = row_class_counts(sorted_rows)
    # Encode each padded-count row as a single integer key (counts ≤ rank ≤ 60)
    base = rank + 1
    keys = np.zeros(len(counts), dtype=np.int64)
    for t in range(rank):
        keys = keys * base + counts[:, t]
    lut = {}
    for tup, i in padded.items():
        k = 0
        for c in tup:
            k = k * base + c
        lut[k] = i
    out = np.empty(len(counts), dtype=np.int64)
    # Few distinct keys (≤ #partitions(rank)); map via dictionary on uniques.
    uniq, inv = np.unique(keys, return_inverse=True)
    mapped = np.array([lut[int(k)] for k in uniq], dtype=np.int64)
    out = mapped[inv]
    return out


# ---------------------------------------------------------------------------
# Index-permutation helpers
# ---------------------------------------------------------------------------

def distinct_permutations(idx: Sequence[int]) -> Iterator[Tuple[int, ...]]:
    """All distinct permutations of a multi-index (γ of them).

    Parity: reference ``utils.symmetrize_index`` (symtensor/utils.py:647).
    """
    seen = set()
    for p in itertools.permutations(idx):
        if p not in seen:
            seen.add(p)
            yield p


def class_representative(idx: Sequence[int]) -> Tuple[int, ...]:
    """Canonical representative of an index class: values sorted ascending
    (the gflat convention; the reference's permcls format uses
    count-major order instead — symtensor/permcls_symtensor.py:375 — but any
    fixed convention is equivalent; ours matches the packed layout)."""
    return tuple(sorted(int(i) for i in idx))
