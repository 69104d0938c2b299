"""Static index tables, cached per (rank, dim, device).

The counterpart of ``symtensor_tpu/utils/tables.py``. Host layout data is
built with NumPy; device tables are int64 ``torch`` tensors made on the
device the ``Tables`` object is keyed by, built on first use and memoized.
``position_T`` and ``position_insert_T`` rank multisets on the device by
the closed form. int64 throughout: at rank 6, dim 110 a packed position
already exceeds 2**31, where the JAX package's int32 tables raise.

``rep_np`` and ``class_ids_np`` (with γ) come from the native generator
(``native.py``, C++ built with g++ at first use), as the JAX package's do
(``symtensor_tpu/utils/tables.py:335, 354``), and from NumPy when it is
unavailable or ``SYMTENSOR_NO_NATIVE=1``; the two are tested bit for bit.
``dense_gather`` and ``insert_table_np`` stay NumPy builds although the JAX
package calls the generator there (``:423, 512``): its ``st_position``
rebuilds the group offsets for every entry, and on the H100's host it
took 1.5-1.6× NumPy's time for the rank-6 dim-21 ``dense_gather`` and
3.0-4.3× for ``insert_table(4)`` at dim 60 (PERF.md).
"""

from __future__ import annotations

from functools import lru_cache
from typing import Tuple

import numpy as np
import torch

from .. import native
from ..config import config
from . import combinatorics as comb
from .profiling import build_span

# row_stats's γ is float32, exact while rank! < 2**24.
_NATIVE_GAMMA_MAX_RANK = 10


def _check_table(entries: int, what: str) -> None:
    if entries > config.max_table_entries:
        raise MemoryError(
            f"static table '{what}' would need {entries:,} entries "
            f"(> config.max_table_entries = {config.max_table_entries:,}); "
            "use the streaming/blocked path or raise the limit"
        )


class Tables:
    """Lazily-built static tables for one (rank, dim) on one device."""

    def __init__(self, rank: int, dim: int, device: torch.device):
        self.rank = rank
        self.dim = dim
        self.device = device
        self.n = comb.indep_size(rank, dim)
        self.layout = comb.gflat_layout(rank, dim) if rank >= 2 else None
        self._cache: dict = {}

    # ------------------------------------------------------------------ util

    def memo(self, key, builder):
        """Build once per key and keep the result; kernel modules cache
        their launch tables here, so they live as long as these tables.
        Each build is timed as the span ``tables.<key>`` (a tuple key by
        its first element)."""
        if key not in self._cache:
            name = key[0] if isinstance(key, tuple) else key
            with build_span(f"tables.{name}"):
                self._cache[key] = builder()
        return self._cache[key]

    def _dev(self, x: np.ndarray) -> torch.Tensor:
        return torch.as_tensor(np.ascontiguousarray(x, dtype=np.int64),
                               device=self.device)

    # --------------------------------------------------------------- scalars

    @property
    def perm_classes(self) -> Tuple[comb.SigmaClass, ...]:
        """All σ-classes of this rank, in canonical enumeration order,
        including classes that are empty at this dim."""
        return comb.perm_classes(self.rank)

    # ------------------------------------------------------- device layout

    @property
    def pascal(self) -> torch.Tensor:
        """Pascal triangle C(n, k) for n ≤ dim+rank+1, k ≤ rank+1 (int64)."""

        def build():
            N = self.dim + self.rank + 2
            K = self.rank + 2
            p = np.zeros((N, K), dtype=np.int64)
            p[:, 0] = 1
            for nn in range(1, N):
                for kk in range(1, K):
                    p[nn, kk] = p[nn - 1, kk - 1] + p[nn - 1, kk]
            return self._dev(p)

        return self.memo("pascal", build)

    @property
    def group_off(self) -> torch.Tensor:
        return self.memo("group_off", lambda: self._dev(self.layout.group_off))

    @property
    def group_T(self) -> torch.Tensor:
        return self.memo("group_T", lambda: self._dev(self.layout.T))

    @property
    def tri_off(self) -> torch.Tensor:
        return self.memo("tri_off", lambda: self._dev(self.layout.tri_off))

    # ---------------------------------------------------- on-device position

    def position_T(self, sorted_idx_T: torch.Tensor) -> torch.Tensor:
        """gflat positions of ascending multisets whose components lie on
        the LEADING axis: (rank, ...) → (...,) int64, computed on the
        tables' device by the closed form (Pascal-table head rank, group
        offset, tail triangle). The counterpart of ``position_jnp_T``
        (``symtensor_tpu/utils/tables.py:139-160``), in int64 where the JAX
        one is int32 and wraps past 2**31 positions."""
        r, d = self.rank, self.dim
        idx = sorted_idx_T.to(torch.int64)
        if r == 0:
            return torch.zeros(idx.shape[1:], dtype=torch.int64, device=idx.device)
        if r == 1:
            return idx[0]
        if r == 2:
            a, b = idx[0], idx[1]
            return a * (2 * d - a + 1) // 2 + (b - a)
        j = idx[r - 3]
        hrank = torch.zeros_like(j)
        for t in range(r - 3):
            hrank = hrank + self.pascal[idx[t] + t, t + 1]
        a = idx[r - 2] - j
        b = idx[r - 1] - j
        side = d - j
        tri = a * (2 * side - a + 1) // 2 + (b - a)
        return self.group_off[j] + hrank * self.group_T[j] + tri

    def position(self, sorted_idx: torch.Tensor) -> torch.Tensor:
        """``position_T`` for multisets whose components lie on the
        TRAILING axis: (..., rank) → (...,) int64 (the counterpart of
        ``position_jnp``, ``symtensor_tpu/utils/tables.py:113-137``)."""
        return self.position_T(torch.movedim(sorted_idx, -1, 0))

    def position_base_T(self, rep_T: torch.Tensor) -> torch.Tensor:
        """Base positions of the leaf emit: for an ascending representative
        of rank − 1 components, the gflat position of sort(rep ∪ {b}) for
        any b ≥ max(rep) is exactly ``base + b``, because the children of
        one parent fill consecutive slots of a tail-triangle row.
        rep_T: (rank − 1, N) int → (N,) int64.

        The counterpart of ``position_base_jnp_T``
        (``symtensor_tpu/utils/tables.py:176-204``), in int64 and with the
        head ranks read from the Pascal table."""
        r, d = self.rank, self.dim
        rep = rep_T.to(torch.int64)
        if r == 1:
            return torch.zeros(rep.shape[1:], dtype=torch.int64, device=rep.device)
        if r == 2:
            a = rep[0]
            return a * (2 * d - a + 1) // 2 - a
        g = rep[r - 3]
        hrank = torch.zeros_like(g)
        for t in range(r - 3):
            hrank = hrank + self.pascal[rep[t] + t, t + 1]
        a = rep[r - 2] - g
        side = d - g
        tri_base = a * (2 * side - a + 1) // 2 - a - g
        return self.group_off[g] + hrank * self.group_T[g] + tri_base

    def position_insert_T(self, rep_T: torch.Tensor) -> torch.Tensor:
        """gflat positions of sort(rep ∪ {i}) for every i ∈ [0, dim),
        without sorting. rep_T: (rank − 1, seg) int, columns ascending.
        Returns (seg, dim) int64.

        The counterpart of ``position_insert_jnp_T``
        (``symtensor_tpu/utils/tables.py:206-307``), case for case: the
        insertion slot cnt = #{rep_s ≤ i} fixes the merged multiset's head,
        group element and tail triangle, so a position is per-rep prefix
        sums of Pascal terms plus masked multiply-adds over (seg, dim)."""
        K, d = self.rank, self.dim
        rep = rep_T.to(torch.int64)  # (K − 1, seg)
        seg = rep.shape[1]
        i_row = torch.arange(d, dtype=torch.int64, device=rep.device)[None, :]
        if K == 1:  # empty rep: the merged multiset is just (i)
            return i_row.expand(seg, d).clone()
        cnt = (rep[:, :, None] <= i_row[None, :, :]).sum(0)  # (seg, d)

        if K == 2:
            a = torch.minimum(rep[0][:, None], i_row)
            b = torch.maximum(rep[0][:, None], i_row)
            return a * (2 * d - a + 1) // 2 + (b - a)

        q = K - 3  # head size of the merged multiset
        pas, goff, gT = self.pascal, self.group_off, self.group_T

        def tri(a, b, g):
            aa, bb, side = a - g, b - g, d - g
            return aa * (2 * side - aa + 1) // 2 + (bb - aa)

        # P0[s] = C(j_s + s, s + 1): rep element s at head slot s
        P0 = [pas[rep[s] + s, s + 1] for s in range(q)]
        H0 = sum(P0) if q else torch.zeros(seg, dtype=torch.int64, device=rep.device)
        jq = rep[q][:, None]  # group element when i lands past the head
        jq1 = rep[q + 1][:, None]  # first tail element
        i0 = i_row[0]

        # case B (cnt == q): i is the group element; C, D (cnt == q + 1,
        # q + 2): i enters the tail triangle of group jq
        pos = (cnt == q) * (
            goff[i0][None, :] + H0[:, None] * gT[i0][None, :] + tri(jq, jq1, i_row)
        )
        base_CD = goff[rep[q]][:, None] + H0[:, None] * gT[rep[q]][:, None]
        pos = pos + (cnt == q + 1) * (base_CD + tri(i_row, jq1, jq))
        pos = pos + (cnt == q + 2) * (base_CD + tri(jq1, i_row, jq))

        if q > 0:
            # case A (cnt ≤ q − 1): i enters the head; the group element and
            # tail become rep[q − 1], rep[q], rep[q + 1]. Head rank at slot
            # t = Σ_{s<t} P0[s] + C(i + t, t + 1) + Σ_{s=t}^{q−2} S0[s], with
            # S0[s] = C(j_s + s + 1, s + 2) (rep element s shifted up a slot)
            S0 = [pas[rep[s] + s + 1, s + 2] for s in range(q - 1)]
            jm1 = rep[q - 1]
            baseA = (goff[jm1] + tri(rep[q], rep[q + 1], jm1))[:, None]
            TA = gT[jm1][:, None]
            hrank = torch.zeros((seg, d), dtype=torch.int64, device=rep.device)
            for t in range(q):
                before = sum(P0[:t]) if t else 0
                after = sum(S0[t:]) if t < q - 1 else 0
                head = before + after + torch.zeros(seg, dtype=torch.int64, device=rep.device)
                hrank = hrank + (cnt == t) * (head[:, None] + pas[i0 + t, t + 1][None, :])
            pos = pos + (cnt <= q - 1) * (baseA + hrank * TA)
        return pos

    # ------------------------------------------------------------ big tables

    def rep_np(self) -> np.ndarray:
        """(n, rank) host int64: the representative (ascending) multiset at
        each packed position, in storage order."""

        def build():
            _check_table(self.n * max(self.rank, 1), "rep_indices")
            if self.rank == 0:
                return np.zeros((1, 0), dtype=np.int64)
            if self.rank == 1:
                return np.arange(self.dim, dtype=np.int64)[:, None]
            rep = native.gflat_rep(self.rank, self.dim)
            if rep is not None:
                return rep.astype(np.int64)
            return self.layout.rep_indices()

        return self.memo("rep_np", build)

    @property
    def rep(self) -> torch.Tensor:
        """(n, rank) int32 on the device: ``rep_np`` in storage order, the
        JAX package's ``Tables.rep``; (1, 0) at rank 0."""
        return self.memo("rep", lambda: torch.as_tensor(
            self.rep_np().astype(np.int32), device=self.device))

    @property
    def rep_T(self) -> torch.Tensor:
        """(rank, n) int64 on the device: ``rep_np`` with the components on
        the leading axis, the input form of ``position_T``."""
        return self.memo("rep_T", lambda: self._dev(self.rep_np().T))

    def _native_row_stats(self):
        """(γ float32, σ-class id int32) per position from one pass of the
        native generator, or None without it."""
        return self.memo("native_row_stats", lambda: native.row_stats(
            self.rep_np(), self.rank, self.perm_classes))

    @property
    def multiplicity(self) -> torch.Tensor:
        """(n,) float64 on the device: γ = r!/∏counts! per packed position
        (the JAX package keeps it in float32; every γ is an integer). The
        native γ is taken where its float32 is exact."""

        def build():
            got = self._native_row_stats() if self.rank else None
            if got is not None and self.rank <= _NATIVE_GAMMA_MAX_RANK:
                gamma = got[0].astype(np.float64)
            else:
                gamma = comb.row_multiplicities(self.rep_np()).astype(np.float64)
            return torch.as_tensor(gamma, device=self.device)

        return self.memo("multiplicity", build)

    @property
    def class_ids_np(self) -> np.ndarray:
        """(n,) host int64: σ-class id (index into perm_classes) per
        position."""

        def build():
            if self.rank == 0:
                return np.zeros(1, dtype=np.int64)
            got = self._native_row_stats()
            if got is not None:
                return got[1].astype(np.int64)
            return comb.class_id_of_rows(self.rep_np(), self.rank)

        return self.memo("class_ids_np", build)

    def class_positions_np(self, class_counts: comb.SigmaClass) -> np.ndarray:
        """Host int64 positions (in storage order) of one σ-class."""
        cid = self.perm_classes.index(tuple(class_counts))
        return self.memo(
            ("class_pos", cid), lambda: np.nonzero(self.class_ids_np == cid)[0]
        )

    def class_positions(self, class_counts: comb.SigmaClass) -> torch.Tensor:
        cid = self.perm_classes.index(tuple(class_counts))
        return self.memo(
            ("class_pos_dev", cid),
            lambda: self._dev(self.class_positions_np(class_counts)),
        )

    @property
    def dense_ravel(self) -> torch.Tensor:
        """(n,) int64: the C-order offset in the dense tensor of each packed
        position's representative index, so compressing a dense tensor is
        one gather through it (``FlatSymmetricTensor.from_dense``)."""
        return self.memo("dense_ravel", lambda: self._dev(np.ravel_multi_index(
            tuple(self.rep_np().T), (self.dim,) * self.rank)))

    @property
    def dense_gather(self) -> torch.Tensor:
        """(dim**rank,) int64: packed position of sort(I) for every dense
        index I in C-order. todense() is a single gather through this."""

        def build():
            dn = self.dim**self.rank
            if dn > config.max_dense_elements:
                raise MemoryError(
                    f"dense size {dn:,} exceeds config.max_dense_elements"
                )
            _check_table(dn, "dense_gather")
            if self.rank == 0:
                return self._dev(np.zeros(1, dtype=np.int64))
            shape = (self.dim,) * self.rank
            grids = np.indices(shape).reshape(self.rank, -1).T  # (d^r, r)
            grids.sort(axis=1)
            if self.rank == 1:
                pos = grids[:, 0]
            else:
                pos = self.layout.position_array(grids)
            return self._dev(pos)

        return self.memo("dense_gather", build)

    # ----------------------------------------------- monomial recursion data

    def mono_tables(self, size: int) -> Tuple[torch.Tensor, torch.Tensor]:
        """(parent, maxel) int64 device tables of the colex level `size`
        over {0..dim-1}: the multiset at colex position p is its parent (a
        size − 1 multiset, by colex position) with maxel[p] appended."""

        def build():
            par, mx = comb.mono_recursion_tables(self.dim, size)
            _check_table(len(par), f"mono_tables({size})")
            return (self._dev(par), self._dev(mx))

        return self.memo(("mono", size), build)

    def mono_tables_weighted(
        self, size: int
    ) -> Tuple[Tuple[torch.Tensor, torch.Tensor, torch.Tensor], ...]:
        """Per level k = 1..size, (parent, maxel, runlen) int64 tables of the
        *EGF-weighted* monomial recursion

            W_k[p] = W_{k-1}[parent[p]] * x[maxel[p]] / runlen[p]

        yielding W_k[multiset m] = ∏_v x_v^{c_v} / c_v! in colex order.
        Multiplying by k! recovers γ·monomial, the summand of the full
        contraction (Σ_I-tuples A ∏x = r! Σ_multisets W·A). runlen is the
        run length of each multiset's max element."""

        def build():
            pars, mxs, runs = [], [], []
            prev_mx = np.zeros(1, dtype=np.int64)  # level 0: empty multiset
            prev_run = np.zeros(1, dtype=np.int64)
            for k in range(1, size + 1):
                par, mx = comb.mono_recursion_tables(self.dim, k)
                run = np.where(prev_mx[par] == mx, prev_run[par] + 1, 1)
                pars.append(par)
                mxs.append(mx)
                runs.append(run)
                prev_mx, prev_run = mx, run
            _check_table(sum(len(p) for p in pars), f"mono_weighted({size})")
            return tuple(
                (self._dev(p), self._dev(m), self._dev(r))
                for p, m, r in zip(pars, mxs, runs)
            )

        return self.memo(("mono_weighted", size), build)

    @property
    def colex_perm(self) -> torch.Tensor:
        """(n,) int64: colex rank of the multiset at each gflat position.
        Reorders colex-enumerated vectors into storage order:
        storage_vec = colex_vec[colex_perm]."""

        def build():
            if self.rank <= 1:
                return self._dev(np.arange(max(self.n, 1), dtype=np.int64))
            return self._dev(comb.colex_rank_array(self.rep_np()))

        return self.memo("colex_perm", build)

    def insert_table_np(self, k: int) -> np.ndarray:
        """Host int64 ``insert_table``, memoized: built with NumPy, one
        sort and one ranking of all N_k rows per inserted value."""

        def build():
            tk = tables(k, self.dim, self.device)
            _check_table(tk.n * self.dim * (k + 1), f"insert_table({k})")
            rep = tk.rep_np()  # (N_k, k)
            d = self.dim
            out = np.empty((tk.n, d), dtype=np.int64)
            cols = np.empty((tk.n, k + 1), dtype=np.int64)
            for i in range(d):
                cols[:, :k] = rep
                cols[:, k] = i
                srt = np.sort(cols, axis=1)
                if k == 0:
                    out[:, i] = srt[:, 0]
                else:
                    out[:, i] = comb.gflat_layout(k + 1, d).position_array(srt)
            return out

        return self.memo(("insert_np", k), build)

    def insert_table(self, k: int) -> torch.Tensor:
        """(N_k, dim) int64 on the device: the position in the rank-(k+1)
        layout of sort(J ∪ {i}) for every size-k multiset J (storage order)
        and every value i. The gather map of single-index contraction
        steps."""
        return self.memo(("insert", k), lambda: self._dev(self.insert_table_np(k)))

    @property
    def tri_pairs(self) -> Tuple[torch.Tensor, torch.Tensor]:
        """(a_idx, b_idx) int64 of the full d-triangle in row-major order;
        the triangle monomial vector is x[a_idx] * x[b_idx]."""

        def build():
            d = self.dim
            a = np.concatenate([np.full(d - i, i, np.int64) for i in range(d)])
            b = np.concatenate([np.arange(i, d, dtype=np.int64) for i in range(d)])
            return (self._dev(a), self._dev(b))

        return self.memo("tri_pairs", build)


def _canon_device(device) -> torch.device:
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    return device


@lru_cache(maxsize=None)
def _tables(rank: int, dim: int, device: torch.device) -> Tables:
    return Tables(rank, dim, device)


def tables(rank: int, dim: int, device="cpu") -> Tables:
    """The cached ``Tables`` of one (rank, dim) on one device."""
    if rank < 0 or dim < 1:
        raise ValueError(f"invalid (rank, dim) = ({rank}, {dim})")
    return _tables(int(rank), int(dim), _canon_device(device))
