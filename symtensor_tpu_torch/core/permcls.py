"""PermClsSymmetricTensor — per-σ-class storage with scalar compression.

The counterpart of ``symtensor_tpu/core/permcls.py``: one 1-D tensor *or a
0-d tensor* per permutation class, keyed by the class's count tuple in the
canonical σ-class order (classes empty at this dim are left out). A 0-d
leaf is a scalar-compressed class: "c₁ on the diagonal, c₂ elsewhere"
costs O(#classes) memory whatever the dim, and
``contract_all_indices_with_vector`` evaluates such classes from power
sums without any table (BASELINE C3, rank 6 dim 200).

Values within a class follow the gflat storage order restricted to the
class, so permcls ↔ flat conversions are one gather or scatter per class
through ``Tables.class_positions``. Every leaf lives on one device.
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from ..utils import combinatorics as comb
from .base import SymmetricTensor, default_dtype, leaf_device
from .flat import FlatSymmetricTensor


class PermClsSymmetricTensor(SymmetricTensor):
    format = "permcls"

    def __init__(
        self,
        rank: Optional[int] = None,
        dim: Optional[int] = None,
        data=None,
        dtype: Optional[torch.dtype] = None,
        device=None,
    ):
        """`data` may be:
        - None: every class scalar-compressed to 0;
        - a scalar: every class scalar-compressed to that value;
        - a dict {σ-label or counts: scalar or (s_σ,) values};
        - a dense array (symmetry checked); use `from_dense` for options.

        Values take `dtype`, by default ``config.default_dtype``, as in the
        JAX package. Leaves go to `device`; without it, to the device of
        the ``torch.Tensor`` values given (which must agree), else to
        ``config.default_device``."""
        if rank is None or dim is None:
            if isinstance(data, (np.ndarray, torch.Tensor)) and data.ndim > 0:
                rank, dim = data.ndim, data.shape[0]
            else:
                raise ValueError("need rank and dim")
        rank, dim = int(rank), int(dim)
        dtype = dtype or default_dtype()
        keys = _class_keys(rank, dim)

        if isinstance(data, dict):
            given = {comb.as_class_counts(k): v for k, v in data.items()}
            for k in given:
                if k not in keys:
                    raise ValueError(
                        f"σ-class {comb.class_label(k)} invalid for rank "
                        f"{rank} dim {dim}"
                    )
            dev = leaf_device(given.values(), device)
            store = {}
            for k in keys:
                v = torch.as_tensor(given.get(k, 0), dtype=dtype, device=dev)
                s = comb.class_size(k, dim)
                if v.ndim != 0 and tuple(v.shape) != (s,):
                    raise ValueError(
                        f"class {comb.class_label(k)} needs a scalar or "
                        f"shape ({s},); got {tuple(v.shape)}"
                    )
                store[k] = v
        elif data is None or np.ndim(data) == 0:
            dev = leaf_device([data], device)
            v = torch.as_tensor(0 if data is None else data, dtype=dtype, device=dev)
            store = {k: v.reshape(()) for k in keys}
        else:
            dev = leaf_device([data], device)
            arr = torch.as_tensor(data, dtype=dtype, device=dev)
            if arr.ndim != rank or (rank and arr.shape[0] != dim):
                raise ValueError(
                    f"dense data shape {tuple(arr.shape)} incompatible with "
                    f"rank {rank} dim {dim}"
                )
            store = PermClsSymmetricTensor.from_dense(arr).data

        self.rank = rank
        self.dim = dim
        self.data = store

    @classmethod
    def _raw(cls, rank: int, dim: int, data: Dict) -> "PermClsSymmetricTensor":
        """Wrap a class → leaf dict without copying or checking it."""
        obj = object.__new__(cls)
        obj.rank, obj.dim, obj.data = int(rank), int(dim), data
        return obj

    # ------------------------------------------------------------ creation

    @classmethod
    def from_dense(
        cls, arr, symmetrize: bool = False, check: bool = True
    ) -> "PermClsSymmetricTensor":
        """Compress a dense tensor (a ``torch.Tensor`` keeps its device;
        other data goes to ``config.default_device``)."""
        flat = FlatSymmetricTensor.from_dense(
            arr, symmetrize=symmetrize, check=check
        )
        return cls.from_flat(flat)

    @classmethod
    def from_flat(cls, flat: FlatSymmetricTensor) -> "PermClsSymmetricTensor":
        """One gather per class out of the packed values."""
        rank, dim = flat.rank, flat.dim
        return cls._raw(rank, dim, {
            k: (flat.data.reshape(()) if rank == 0
                else flat.data[flat.tables.class_positions(k)])
            for k in _class_keys(rank, dim)
        })

    @classmethod
    def zeros(
        cls, rank: int, dim: int, dtype=None, device=None
    ) -> "PermClsSymmetricTensor":
        """Every class scalar-compressed to 0 on `device`, by default
        ``config.default_device``."""
        return cls(rank=rank, dim=dim, dtype=dtype, device=device)

    # ----------------------------------------------------------- structure

    @property
    def size(self) -> int:
        """Independent components; with scalar compression fewer are
        stored (``memory_footprint``)."""
        return self.indep_size

    @property
    def dtype(self) -> torch.dtype:
        return next(iter(self.data.values())).dtype

    @property
    def device(self) -> torch.device:
        return next(iter(self.data.values())).device

    def keys(self):
        """σ-class count tuples of the per-class storage."""
        return self.data.keys()

    def values(self):
        return iter(self.data.values())

    @property
    def scalar_classes(self) -> Tuple[str, ...]:
        """Labels of the scalar-compressed classes."""
        return tuple(
            comb.class_label(k) for k, v in self.data.items() if v.ndim == 0
        )

    def _map(self, fn) -> "PermClsSymmetricTensor":
        return self._raw(self.rank, self.dim,
                         {k: fn(v) for k, v in self.data.items()})

    def astype(self, dtype) -> "PermClsSymmetricTensor":
        return self._map(lambda v: v.to(dtype))

    def to(self, device) -> "PermClsSymmetricTensor":
        return self._map(lambda v: v.to(device))

    def expand(self, cls=None) -> "PermClsSymmetricTensor":
        """Expand scalar-compressed classes (all, or one) to full vectors."""
        targets = [comb.as_class_counts(cls)] if cls is not None else list(self.data)
        store = dict(self.data)
        for k in targets:
            if store[k].ndim == 0:
                store[k] = store[k].expand(comb.class_size(k, self.dim))
        return self._raw(self.rank, self.dim, store)

    def compress(self, cls=None, rtol: float = 0.0, atol: float = 0.0
                 ) -> "PermClsSymmetricTensor":
        """Scalar-compress classes (all, or one) whose values are all equal
        within the tolerance; the inverse of `expand`."""
        targets = [comb.as_class_counts(cls)] if cls is not None else list(self.data)
        store = dict(self.data)
        for k in targets:
            v = store[k]
            if v.ndim and v.numel() and torch.allclose(
                v, v[0].expand_as(v), rtol=rtol, atol=atol
            ):
                store[k] = v[0].clone()
        return self._raw(self.rank, self.dim, store)

    # ------------------------------------------------------------- content

    def toflat(self) -> FlatSymmetricTensor:
        """One scatter per class into the packed values; the classes'
        positions cover every packed position exactly once."""
        if self.rank == 0:
            return FlatSymmetricTensor._raw(
                0, 1, next(iter(self.data.values())).reshape(1)
            )
        t = self.tables
        out = torch.zeros(self.indep_size, dtype=self.dtype, device=self.device)
        for k, v in self.data.items():
            pos = t.class_positions(k)
            out.index_put_((pos,), v.expand(pos.shape))
        return FlatSymmetricTensor._raw(self.rank, self.dim, out)

    def todense(self) -> torch.Tensor:
        return self.toflat().todense()

    def topermcls(self) -> "PermClsSymmetricTensor":
        return self

    # ----------------------------------------------------------- indexing

    def class_values(self, cls) -> torch.Tensor:
        """The class's leaf: 0-d for a scalar-compressed class."""
        counts = comb.as_class_counts(cls)
        if counts not in self.data:
            if sum(counts) != self.rank:
                raise ValueError(
                    f"σ-class {cls!r} has rank {sum(counts)}, tensor rank "
                    f"{self.rank}"
                )
            raise KeyError(
                f"σ-class {comb.class_label(counts)} is empty at dim {self.dim}"
            )
        return self.data[counts]

    def _local(self, idx: Tuple[int, ...]) -> int:
        """Position of a canonical full index within its class's leaf."""
        srt = tuple(sorted(idx))
        gpos = srt[0] if self.rank == 1 else self.tables.layout.position(srt)
        cpos = self.tables.class_positions_np(comb.class_of_index(idx))
        return int(cpos.searchsorted(gpos))

    def element(self, idx: Sequence[int]) -> torch.Tensor:
        if self.rank == 0:
            return next(iter(self.data.values())).reshape(())
        idx = self._full_index(idx)
        leaf = self.data[comb.class_of_index(idx)]
        if leaf.ndim == 0:
            return leaf
        return leaf[self._local(idx)]

    def _partial(self, idx: Tuple[int, ...]) -> "PermClsSymmetricTensor":
        return self.toflat()._partial(idx).topermcls()

    # ------------------------------------------------------------ updates

    def set_class(self, cls, value) -> "PermClsSymmetricTensor":
        """A scalar keeps (or makes) the class scalar-compressed."""
        counts = comb.as_class_counts(cls)
        if counts not in self.data:
            raise KeyError(
                f"σ-class {comb.class_label(counts)} invalid/empty for rank "
                f"{self.rank} dim {self.dim}"
            )
        v = torch.as_tensor(value, dtype=self.dtype, device=self.device)
        s = comb.class_size(counts, self.dim)
        if v.ndim != 0 and tuple(v.shape) != (s,):
            raise ValueError(
                f"class {comb.class_label(counts)} needs scalar or ({s},); "
                f"got {tuple(v.shape)}"
            )
        store = dict(self.data)
        store[counts] = v
        return self._raw(self.rank, self.dim, store)

    def set_element(self, idx, value) -> "PermClsSymmetricTensor":
        """A write into a scalar-compressed class expands it first."""
        if self.rank == 0:
            return self.set_class((), value)
        idx = self._full_index(idx)
        counts = comb.class_of_index(idx)
        leaf = self.data[counts]
        if leaf.ndim == 0:
            leaf = leaf.expand(comb.class_size(counts, self.dim))
        local = torch.tensor([self._local(idx)], device=self.device)
        value = torch.as_tensor(value, dtype=self.dtype, device=self.device)
        store = dict(self.data)
        store[counts] = leaf.index_put((local,), value.reshape(1))
        return self._raw(self.rank, self.dim, store)


def _class_keys(rank: int, dim: int) -> Tuple[comb.SigmaClass, ...]:
    """Non-empty σ-classes in canonical order."""
    return tuple(
        c for c in comb.perm_classes(rank) if comb.class_size(c, dim) > 0
    )
