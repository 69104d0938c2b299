"""FlatSymmetricTensor — the packed workhorse format.

The counterpart of ``symtensor_tpu/core/flat.py:24-219``: one contiguous
1-D ``torch`` tensor of the C(d+r−1, r) independent components in gflat
order (see utils/combinatorics.py). Closed-form O(r) addressing gives
element access; the grouped layout is what lets
``contract_all_indices_with_vector`` read the values in one pass.

Partial indexing returns the lazy ``FlatSymmetricTensorSlice``
(``flat.py:222-318``); ``set_class``/``set_element`` write through
``torch.index_put`` out of place, so a tensor is never changed in place.
There is no pytree registration: autograd follows the data tensor.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch

from ..utils import combinatorics as comb
from .base import (
    SymmetricTensor,
    _check_dense_size,
    default_device,
    default_dtype,
    require_local,
)


class FlatSymmetricTensor(SymmetricTensor):
    format = "flat"

    def __init__(
        self,
        rank: Optional[int] = None,
        dim: Optional[int] = None,
        data=None,
        dtype: Optional[torch.dtype] = None,
        device=None,
    ):
        """Create from packed data (length C(d+r−1, r)) or zeros.

        Data that is a ``torch.Tensor`` keeps its device unless `device` is
        given; zeros and other data go to `device`, by default
        ``config.default_device`` (the card). To create from a dense
        tensor use `from_dense`."""
        if data is None:
            if rank is None or dim is None:
                raise ValueError("need rank and dim when no data is given")
            n = comb.indep_size(rank, dim)
            data = torch.zeros(
                (n,), dtype=dtype or default_dtype(),
                device=device if device is not None else default_device(),
            )
        else:
            if device is None and not isinstance(data, torch.Tensor):
                device = default_device()
            data = torch.as_tensor(data, dtype=dtype, device=device)
            if rank is None or dim is None:
                raise ValueError(
                    "packed data is ambiguous without rank and dim"
                )
            n = comb.indep_size(rank, dim)
            if data.ndim != 1 or data.shape[0] != n:
                raise ValueError(
                    f"packed data must have shape ({n},) for rank {rank} "
                    f"dim {dim}; got {tuple(data.shape)}"
                )
        self.rank = int(rank)
        self.dim = int(dim)
        self.data = data

    @classmethod
    def _raw(cls, rank: int, dim: int, data: torch.Tensor) -> "FlatSymmetricTensor":
        """Wrap packed data without copying or checking it."""
        obj = object.__new__(cls)
        obj.rank, obj.dim, obj.data = int(rank), int(dim), data
        return obj

    # ------------------------------------------------------------ creation

    @classmethod
    def from_dense(
        cls,
        arr,
        symmetrize: bool = False,
        check: bool = True,
        rtol: float = 1e-5,
        atol: float = None,  # dtype-aware default, see ops.symmetrize
    ) -> "FlatSymmetricTensor":
        """Compress a dense tensor. With `symmetrize=True` the symmetric part
        is taken; otherwise (by default) non-symmetric input raises. A
        ``torch.Tensor`` keeps its device; other data (NumPy arrays, lists)
        goes to ``config.default_device``."""
        from ..ops.symmetrize import is_symmetric as _is_symmetric
        from ..ops.symmetrize import symmetrize as _symmetrize
        from ..utils.tables import tables

        if not isinstance(arr, torch.Tensor):
            arr = torch.as_tensor(arr, device=default_device())
        rank, dim = arr.ndim, (arr.shape[0] if arr.ndim else 1)
        if any(s != dim for s in arr.shape):
            raise ValueError(
                f"dense data must be hypercubic; got {tuple(arr.shape)}"
            )
        if symmetrize:
            arr = _symmetrize(arr)
        elif check:
            if not _is_symmetric(arr, rtol=rtol, atol=atol):
                raise ValueError(
                    "data is not symmetric (pass symmetrize=True to project)"
                )
        if rank == 0:
            return cls._raw(0, 1, arr.reshape(1))
        if rank == 1:
            return cls._raw(1, dim, arr.contiguous())
        gather = tables(rank, dim, arr.device).dense_ravel
        return cls._raw(rank, dim, arr.reshape(-1)[gather])

    @classmethod
    def zeros(
        cls, rank: int, dim: int, dtype=None, device=None
    ) -> "FlatSymmetricTensor":
        """Zeros on `device`, by default ``config.default_device``."""
        return cls(rank=rank, dim=dim, dtype=dtype, device=device)

    # ----------------------------------------------------------- structure

    @property
    def size(self) -> int:
        return self.indep_size

    @property
    def dtype(self) -> torch.dtype:
        return self.data.dtype

    @property
    def device(self) -> torch.device:
        return self.data.device

    def astype(self, dtype) -> "FlatSymmetricTensor":
        return self._raw(self.rank, self.dim, self.data.to(dtype))

    def to(self, device) -> "FlatSymmetricTensor":
        return self._raw(self.rank, self.dim, self.data.to(device))

    # ------------------------------------------------------------- content

    def todense(self) -> torch.Tensor:
        if self.rank == 0:
            return self.data.reshape(())
        if self.rank == 1:
            return self.data
        _check_dense_size(self.rank, self.dim)
        return self.data[self.tables.dense_gather].reshape(self.shape)

    def toflat(self) -> "FlatSymmetricTensor":
        return self

    # ----------------------------------------------------------- indexing

    def class_values(self, cls) -> torch.Tensor:
        counts = comb.as_class_counts(cls)
        if sum(counts) != self.rank:
            raise ValueError(
                f"σ-class {cls!r} has rank {sum(counts)}, tensor has rank "
                f"{self.rank}"
            )
        if self.rank == 0:
            return self.data.reshape(())
        return self.data[self.tables.class_positions(counts)]

    def _position(self, idx: Sequence[int]) -> int:
        """Packed position of a canonical (in-range) full index."""
        if self.rank == 0:
            return 0
        srt = tuple(sorted(idx))
        if self.rank == 1:
            return srt[0]
        return comb.gflat_layout(self.rank, self.dim).position(srt)

    def element(self, idx: Sequence[int]) -> torch.Tensor:
        return self.data[self._position(self._full_index(idx))]

    def _materialize_partial(self, idx: Tuple[int, ...]) -> "FlatSymmetricTensor":
        """The rank−k sub-tensor A[idx, ...] as packed data: one gather
        through the positions of sort(idx ∪ J) for every output multiset
        J (the output's ``rep_T``, under the table guard)."""
        from ..utils.tables import tables

        out_rank = self.rank - len(idx)
        rep_out = tables(out_rank, self.dim, self.device).rep_T  # (out_rank, n_out)
        fixed = torch.as_tensor(idx, dtype=torch.int64, device=self.device)
        fixed = fixed[:, None].expand(len(idx), rep_out.shape[1])
        full = torch.sort(torch.cat([fixed, rep_out]), dim=0).values
        pos = self.tables.position_T(full)
        return FlatSymmetricTensor._raw(out_rank, self.dim, self.data[pos])

    def _partial(self, idx: Tuple[int, ...]) -> "FlatSymmetricTensorSlice":
        """Partial indexing returns an O(1) lazy view; the gather happens
        on first access to the sub-tensor's packed data."""
        return FlatSymmetricTensorSlice(self, idx)

    # ------------------------------------------------------------ updates

    def set_class(self, cls, value) -> "FlatSymmetricTensor":
        counts = comb.as_class_counts(cls)
        value = torch.as_tensor(value, dtype=self.dtype, device=self.device)
        if self.rank == 0:
            return self._raw(0, 1, value.reshape(1))
        pos = self.tables.class_positions(counts)
        return self._raw(
            self.rank, self.dim,
            self.data.index_put((pos,), value.expand(pos.shape)),
        )

    def set_element(self, idx, value) -> "FlatSymmetricTensor":
        require_local("set_element", self)
        pos = torch.tensor([self._position(self._full_index(idx))],
                           device=self.device)
        value = torch.as_tensor(value, dtype=self.dtype, device=self.device)
        return self._raw(
            self.rank, self.dim, self.data.index_put((pos,), value.reshape(1))
        )


class FlatSymmetricTensorSlice(SymmetricTensor):
    """O(1) lazy view of a partial index into a ``FlatSymmetricTensor``.

    Holds the parent and the fixed leading indices; nothing is gathered
    until the sub-tensor's packed data is needed (``data``, ``toflat``,
    ``todense``, class access). A single element is read from the parent
    through the closed-form position of sort(fixed ∪ idx): O(rank), no
    table. Updates materialize first and return a flat tensor."""

    format = "flat"  # storage-compatible with flat (the alignment key)

    def __init__(self, parent: FlatSymmetricTensor, fixed: Tuple[int, ...]):
        self._parent = parent
        self._fixed = tuple(int(i) for i in fixed)
        self.rank = parent.rank - len(self._fixed)
        self.dim = parent.dim
        self._cache = None

    @classmethod
    def _raw(cls, rank, dim, data) -> FlatSymmetricTensor:
        # ops that rebuild "the same format" from packed data get a plain
        # flat tensor: a slice's identity is its parent and fixed indices
        return FlatSymmetricTensor._raw(rank, dim, data)

    @property
    def parent(self) -> FlatSymmetricTensor:
        return self._parent

    @property
    def fixed(self) -> Tuple[int, ...]:
        return self._fixed

    @property
    def dtype(self) -> torch.dtype:
        return self._parent.dtype

    @property
    def device(self) -> torch.device:
        return self._parent.device

    @property
    def size(self) -> int:
        return self.indep_size

    def toflat(self) -> FlatSymmetricTensor:
        if self._cache is None:
            self._cache = self._parent._materialize_partial(self._fixed)
        return self._cache

    @property
    def data(self) -> torch.Tensor:
        return self.toflat().data

    def todense(self) -> torch.Tensor:
        return self.toflat().todense()

    def astype(self, dtype) -> FlatSymmetricTensor:
        return self.toflat().astype(dtype)

    def to(self, device) -> FlatSymmetricTensor:
        return self.toflat().to(device)

    def element(self, idx) -> torch.Tensor:
        return self._parent.element(self._fixed + self._full_index(idx))

    def class_values(self, cls) -> torch.Tensor:
        return self.toflat().class_values(cls)

    def _partial(self, idx: Tuple[int, ...]) -> "FlatSymmetricTensorSlice":
        # deepen the view: still O(1)
        return FlatSymmetricTensorSlice(self._parent, self._fixed + tuple(idx))

    def set_class(self, cls, value) -> FlatSymmetricTensor:
        return self.toflat().set_class(cls, value)

    def set_element(self, idx, value) -> FlatSymmetricTensor:
        return self.toflat().set_element(idx, value)

    def __repr__(self):
        return (
            f"FlatSymmetricTensorSlice(rank={self.rank}, dim={self.dim}, "
            f"fixed={self._fixed}, lazy={self._cache is None})"
        )
