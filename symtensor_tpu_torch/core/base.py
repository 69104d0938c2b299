"""Abstract base for symmetric tensors over ``torch`` tensors.

The counterpart of ``symtensor_tpu/core/base.py``, for the attribute and
indexing contract: ``rank``, ``dim``, ``shape``, ``ndim``, ``indep_size``,
``dense_size``, ``tables``, ``dtype``, ``device``, full-index element
access, ``todense``/``toflat``/``astype``/``to``, and the arithmetic and
comparison operators (``base.py:337-411``: ``+ - * / **`` with scalars and
rank-0 broadcasting, ``allclose``, ``array_equal``, and ``==``/``!=``
refused). A tensor's data lives on one device, and its tables are made on
that device.

Not ported yet (ROADMAP queue 1: "Rest of the tables and the flat
format", "Interop surface"): partial indexing and the lazy slice view, the
functional ``.at[...]`` updates, iterators, and the NumPy/pydantic interop
hooks.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import numpy as np
import torch

from ..config import config
from ..utils import combinatorics as comb
from ..utils.tables import Tables, tables


def default_dtype() -> torch.dtype:
    return getattr(torch, config.default_dtype)


class SymmetricTensor:
    """Common API of all storage formats."""

    # Subclasses set this to a short format name.
    format: str = "abstract"

    rank: int
    dim: int

    # ------------------------------------------------------------ structure

    @property
    def tables(self) -> Tables:
        return tables(self.rank, self.dim, self.device)

    @property
    def shape(self) -> Tuple[int, ...]:
        return (self.dim,) * self.rank

    @property
    def ndim(self) -> int:
        return self.rank

    @property
    def dense_size(self) -> int:
        return self.dim**self.rank

    @property
    def indep_size(self) -> int:
        """Number of independent components C(d+r−1, r)."""
        return comb.indep_size(self.rank, self.dim)

    @property
    def perm_classes(self) -> Tuple[str, ...]:
        """σ-class labels, largest multiplicity first ('iii', 'iij', …)."""
        return tuple(comb.class_label(c) for c in comb.perm_classes(self.rank))

    @property
    def size(self) -> int:
        """Number of stored elements (format-specific)."""
        raise NotImplementedError

    @property
    def dtype(self) -> torch.dtype:
        raise NotImplementedError

    @property
    def device(self) -> torch.device:
        raise NotImplementedError

    # ------------------------------------------------------------- content

    def todense(self) -> torch.Tensor:
        """Materialize the full d^r dense tensor. Guarded by
        config.max_dense_elements."""
        raise NotImplementedError

    def toflat(self) -> "FlatSymmetricTensor":  # noqa: F821
        raise NotImplementedError

    def astype(self, dtype) -> "SymmetricTensor":
        raise NotImplementedError

    def to(self, device) -> "SymmetricTensor":
        raise NotImplementedError

    # ----------------------------------------------------------- indexing

    def class_values(self, cls) -> torch.Tensor:
        """Values of one σ-class as a 1-D tensor in storage order."""
        raise NotImplementedError

    def _canon_index(self, idx) -> Tuple[int, ...]:
        """Normalize a multi-index: negative entries wrap NumPy-style,
        out-of-range entries raise IndexError."""
        out = []
        for k in idx:
            if isinstance(k, torch.Tensor) and k.ndim == 0:
                k = int(k)
            if not isinstance(k, (int, np.integer)):
                raise TypeError(f"index entries must be integers; got {k!r}")
            kk = int(k)
            if kk < 0:
                kk += self.dim
            if not 0 <= kk < self.dim:
                raise IndexError(f"index {int(k)} out of range for dim {self.dim}")
            out.append(kk)
        return tuple(out)

    def element(self, idx: Sequence[int]) -> torch.Tensor:
        """One element by full multi-index, as a 0-d tensor."""
        raise NotImplementedError

    def __getitem__(self, key):
        if isinstance(key, str):
            return self.class_values(key)
        if isinstance(key, (int, np.integer)) or (
            isinstance(key, torch.Tensor) and key.ndim == 0
        ):
            key = (key,)
        if isinstance(key, tuple):
            if len(key) > self.rank:
                raise IndexError(
                    f"too many indices ({len(key)}) for rank {self.rank}"
                )
            if len(key) < self.rank:
                raise NotImplementedError(
                    "partial indexing is not ported yet (ROADMAP queue 1: "
                    "Rest of the tables and the flat format); index with "
                    "all rank entries"
                )
            return self.element(self._canon_index(key))
        if key is Ellipsis or (isinstance(key, slice) and key == slice(None)):
            return self
        raise IndexError(f"unsupported index {key!r}")

    # --------------------------------------------------------- arithmetic

    def _binary(self, other, op_name: str, reverse: bool = False):
        from ..ops import elementwise

        return elementwise.binary(op_name, self, other, reverse=reverse)

    def __add__(self, other):
        return self._binary(other, "add")

    def __radd__(self, other):
        return self._binary(other, "add", reverse=True)

    def __sub__(self, other):
        return self._binary(other, "subtract")

    def __rsub__(self, other):
        return self._binary(other, "subtract", reverse=True)

    def __mul__(self, other):
        return self._binary(other, "multiply")

    def __rmul__(self, other):
        return self._binary(other, "multiply", reverse=True)

    def __truediv__(self, other):
        return self._binary(other, "divide")

    def __rtruediv__(self, other):
        return self._binary(other, "divide", reverse=True)

    def __pow__(self, other):
        return self._binary(other, "power")

    def __rpow__(self, other):
        return self._binary(other, "power", reverse=True)

    def __neg__(self):
        from ..ops import elementwise

        return elementwise.unary(torch.neg, self)

    def __pos__(self):
        return self

    def __abs__(self):
        from ..ops import elementwise

        return elementwise.unary(torch.abs, self)

    # -------------------------------------------------------- comparisons

    def allclose(self, other, rtol=1e-5, atol=1e-8) -> bool:
        from ..ops import elementwise

        return elementwise.allclose(self, other, rtol=rtol, atol=atol)

    def array_equal(self, other) -> bool:
        from ..ops import elementwise

        return elementwise.array_equal(self, other)

    def __eq__(self, other):
        """`==` is refused: the reference treats comparison elementwise
        while Python's default would silently compare object identity; an
        error is safer than either surprise."""
        raise TypeError(
            "elementwise `==` on SymmetricTensor is not supported; use "
            "A.array_equal(B) for exact equality, A.allclose(B) for "
            "tolerance, or symalg.isclose(A, B) for an elementwise result"
        )

    def __ne__(self, other):
        raise TypeError(
            "elementwise `!=` on SymmetricTensor is not supported; use "
            "`not A.array_equal(B)` or symalg.isclose(A, B)"
        )

    def __repr__(self):
        return (
            f"{type(self).__name__}(rank={self.rank}, dim={self.dim}, "
            f"dtype={self.dtype}, device={self.device}, size={self.size})"
        )

    __hash__ = None  # type: ignore[assignment]


def _check_dense_size(rank: int, dim: int, what: str = "todense") -> None:
    if dim**rank > config.max_dense_elements:
        raise MemoryError(
            f"{what}: dense size {dim}^{rank} = {dim**rank:,} exceeds "
            f"config.max_dense_elements = {config.max_dense_elements:,}"
        )
