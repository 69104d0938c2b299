"""Static index tables, cached per (rank, dim, device).

The counterpart of ``symtensor_tpu/utils/tables.py``. Host layout data is
built with NumPy; device tables are int64 ``torch`` tensors made on the
device the ``Tables`` object is keyed by, built on first use and memoized.
int64 throughout: at rank 6, dim 110 a packed position already exceeds
2**31, where the JAX package's int32 tables raise.

The JAX package accelerates ``rep_np``/``dense_gather`` with a native table
generator (``symtensor_tpu/native``); that module imports jax through its
package, so the NumPy builds, which it is tested bit-identical to, stand
here alone.
"""

from __future__ import annotations

from functools import lru_cache
from typing import Tuple

import numpy as np
import torch

from ..config import config
from . import combinatorics as comb


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
        their launch tables here, so they live as long as these tables."""
        if key not in self._cache:
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
            return self.layout.rep_indices()

        return self.memo("rep_np", build)

    @property
    def class_ids_np(self) -> np.ndarray:
        """(n,) host int64: σ-class id (index into perm_classes) per
        position."""

        def build():
            if self.rank == 0:
                return np.zeros(1, dtype=np.int64)
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
