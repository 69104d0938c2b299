"""DenseSymmetricTensor — full d^r storage, the oracle format.

The counterpart of ``symtensor_tpu/core/dense.py``: symmetry is checked
at construction, and zeros are guarded by ``config.max_dense_elements``.
Class and element updates go through the packed form, where an update
reaches the whole index class by construction; dense tensors are small
by the guard, so the O(d^r) gather keeps one code path.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from .base import (
    SymmetricTensor,
    _check_dense_size,
    default_dtype,
    host,
    leaf_device,
)
from .flat import FlatSymmetricTensor


class DenseSymmetricTensor(SymmetricTensor):
    format = "dense"

    def __init__(
        self,
        rank: Optional[int] = None,
        dim: Optional[int] = None,
        data=None,
        dtype: Optional[torch.dtype] = None,
        symmetrize: bool = False,
        check: bool = True,
        device=None,
    ):
        """Zeros of (rank, dim), or dense `data` (checked symmetric unless
        ``check=False``; projected with ``symmetrize=True``). A
        ``torch.Tensor`` keeps its device unless `device` is given; zeros
        and other data go to `device`, by default
        ``config.default_device``."""
        from ..ops.symmetrize import is_symmetric as _is_symmetric
        from ..ops.symmetrize import symmetrize as _symmetrize

        if data is None:
            if rank is None or dim is None:
                raise ValueError("need rank and dim when no data is given")
            _check_dense_size(rank, dim, "DenseSymmetricTensor")
            data = torch.zeros((dim,) * rank, dtype=dtype or default_dtype(),
                               device=leaf_device([], device))
        else:
            data = torch.as_tensor(data, dtype=dtype,
                                   device=leaf_device([data], device))
            if rank is not None and data.ndim != rank:
                raise ValueError(f"data rank {data.ndim} != rank {rank}")
            if data.ndim and any(s != data.shape[0] for s in data.shape):
                raise ValueError(
                    f"data must be hypercubic; got {tuple(data.shape)}"
                )
            if dim is not None and data.ndim and data.shape[0] != dim:
                raise ValueError(f"data dim {data.shape[0]} != dim {dim}")
            if symmetrize:
                data = _symmetrize(data)
            elif check and not _is_symmetric(data):
                raise ValueError(
                    "data is not symmetric (pass symmetrize=True to project)"
                )
        self.rank = int(data.ndim)
        self.dim = int(data.shape[0]) if data.ndim else int(dim or 1)
        self.data = data

    @classmethod
    def _raw(cls, rank: int, dim: int, data: torch.Tensor) -> "DenseSymmetricTensor":
        """Wrap dense data without copying or checking it."""
        obj = object.__new__(cls)
        obj.rank, obj.dim, obj.data = int(rank), int(dim), data
        return obj

    @classmethod
    def from_dense(cls, arr, symmetrize=False, check=True) -> "DenseSymmetricTensor":
        return cls(data=arr, symmetrize=symmetrize, check=check)

    @classmethod
    def zeros(cls, rank: int, dim: int, dtype=None, device=None) -> "DenseSymmetricTensor":
        return cls(rank=rank, dim=dim, dtype=dtype, device=device)

    # ----------------------------------------------------------- structure

    @property
    def size(self) -> int:
        return self.dense_size

    @property
    def dtype(self) -> torch.dtype:
        return self.data.dtype

    @property
    def device(self) -> torch.device:
        return self.data.device

    def astype(self, dtype) -> "DenseSymmetricTensor":
        return self._raw(self.rank, self.dim, self.data.to(dtype))

    def to(self, device) -> "DenseSymmetricTensor":
        return self._raw(self.rank, self.dim, self.data.to(device))

    # ------------------------------------------------------------- content

    def todense(self) -> torch.Tensor:
        return self.data

    def toflat(self) -> FlatSymmetricTensor:
        return FlatSymmetricTensor.from_dense(self.data, check=False)

    @property
    def flat(self):
        """C-order values: dense storage matches NumPy's ``flat``."""
        return iter(host(self.data).reshape(-1))

    @property
    def flat_index(self):
        return (
            tuple(int(v) for v in np.unravel_index(i, self.shape))
            for i in range(self.dense_size)
        )

    # ----------------------------------------------------------- indexing

    def class_values(self, cls) -> torch.Tensor:
        return self.toflat().class_values(cls)

    def element(self, idx: Sequence[int]) -> torch.Tensor:
        return self.data[self._full_index(idx)]

    def _partial(self, idx: Tuple[int, ...]) -> "DenseSymmetricTensor":
        return self._raw(self.rank - len(idx), self.dim, self.data[tuple(idx)])

    # ------------------------------------------------------------ updates

    def _via_flat(self, fn) -> "DenseSymmetricTensor":
        return self._raw(self.rank, self.dim, fn(self.toflat()).todense())

    def set_class(self, cls, value) -> "DenseSymmetricTensor":
        return self._via_flat(lambda f: f.set_class(cls, value))

    def set_element(self, idx, value) -> "DenseSymmetricTensor":
        return self._via_flat(lambda f: f.set_element(idx, value))
