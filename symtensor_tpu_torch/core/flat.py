"""FlatSymmetricTensor — the packed workhorse format.

The counterpart of ``symtensor_tpu/core/flat.py:24-219``: one contiguous
1-D ``torch`` tensor of the C(d+r−1, r) independent components in gflat
order (see utils/combinatorics.py). Closed-form O(r) addressing gives
element access; the grouped layout is what lets
``contract_all_indices_with_vector`` read the values in one pass.

There is no pytree registration: autograd follows the data tensor. The
lazy slice view and the ``set_*`` updates are not ported yet (ROADMAP
queue 1: "Rest of the tables and the flat format").
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch

from ..utils import combinatorics as comb
from .base import SymmetricTensor, _check_dense_size, default_dtype


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

        To create from a dense tensor use `from_dense`."""
        if data is None:
            if rank is None or dim is None:
                raise ValueError("need rank and dim when no data is given")
            n = comb.indep_size(rank, dim)
            data = torch.zeros(
                (n,), dtype=dtype or default_dtype(), device=device
            )
        else:
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
        is taken; otherwise (by default) non-symmetric input raises."""
        from ..ops.symmetrize import is_symmetric as _is_symmetric
        from ..ops.symmetrize import symmetrize as _symmetrize
        from ..utils.tables import tables

        arr = torch.as_tensor(arr)
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
        rep = tables(rank, dim).rep_np()
        ravel = np.ravel_multi_index(tuple(rep.T), tuple(arr.shape))
        gather = torch.as_tensor(ravel, dtype=torch.int64, device=arr.device)
        return cls._raw(rank, dim, arr.reshape(-1)[gather])

    @classmethod
    def zeros(
        cls, rank: int, dim: int, dtype=None, device=None
    ) -> "FlatSymmetricTensor":
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
        idx = self._canon_index(idx)
        if len(idx) != self.rank:
            raise IndexError(
                f"element needs {self.rank} indices; got {len(idx)}"
            )
        return self.data[self._position(idx)]
