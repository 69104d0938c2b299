"""SparseFlatSymmetricTensor — packed storage restricted to its support.

The counterpart of ``symtensor_tpu/core/sparse_flat.py:31-261``. Where the
JAX package keeps a BCOO leaf over the packed independent-component axis,
this one keeps four dense torch tensors on one device:

- ``vals`` (nnz,): the stored values;
- ``positions`` (nnz,) int32: each entry's gflat position;
- ``rep`` (nnz, rank) int32: each entry's representative (ascending)
  multi-index;
- ``gamma`` (nnz,) float32: each entry's multiplicity r!/∏counts!.

``rep`` and ``gamma`` let the full contraction run in O(nnz·r) without any
table over the packed axis, so a tensor whose C(d+r−1, r) is itself huge
can be built (``from_entries``) and evaluated. Duplicate positions are
allowed and mean summation, as in BCOO: ``toflat`` scatters with
``index_add_`` and ``add_sparse`` only concatenates.

Ops closed on sparse storage stay sparse (scalar scaling, negation,
sparse ± sparse, the contractions with a vector); everything else goes
through ``toflat()``, which ``utils/profiling.count_fallback`` counts and
warns about once per site.
"""

from __future__ import annotations

import math
from typing import Sequence

import numpy as np
import torch

from ..utils import combinatorics as comb
from ..utils.precision import compute_dtype, full_fp32_matmul
from .base import SymmetricTensor, default_dtype, leaf_device
from .flat import FlatSymmetricTensor

# Elements of the (entries, B) monomial block the batched contraction
# holds at once.
BATCH_BLOCK_ELEMS = 2**26


def _row_multiplicities(rows: torch.Tensor) -> torch.Tensor:
    """γ = r!/∏counts! of ascending rows (nnz, r), as float32: the product
    of the running run lengths is ∏ counts! (``comb.row_multiplicities``)."""
    n, r = rows.shape
    run = torch.ones(n, dtype=torch.int64, device=rows.device)
    denom = torch.ones_like(run)
    for t in range(1, r):
        run = torch.where(rows[:, t] == rows[:, t - 1], run + 1, 1)
        denom = denom * run
    return (math.factorial(r) // denom).to(torch.float32)  # exact integers


class SparseFlatSymmetricTensor(SymmetricTensor):
    format = "sparse_flat"

    def __init__(self, rank, dim, vals, positions, rep, gamma):
        n = comb.indep_size(rank, dim)
        nnz = vals.shape[0]
        if not (vals.ndim == positions.ndim == gamma.ndim == 1
                and positions.shape[0] == gamma.shape[0] == rep.shape[0] == nnz
                and rep.ndim == 2 and rep.shape[1] == rank):
            raise ValueError(
                f"sparse leaves must be vals (nnz,), positions (nnz,), rep "
                f"(nnz, {rank}) and gamma (nnz,); got {tuple(vals.shape)}, "
                f"{tuple(positions.shape)}, {tuple(rep.shape)}, "
                f"{tuple(gamma.shape)}"
            )
        leaf_device([vals, positions, rep, gamma])
        self.rank = int(rank)
        self.dim = int(dim)
        self._n = n
        self.vals, self.positions, self.rep, self.gamma = vals, positions, rep, gamma

    @classmethod
    def _raw(cls, rank, dim, vals, positions, rep, gamma):
        """Wrap the four leaves without copying or checking them."""
        obj = object.__new__(cls)
        obj.rank, obj.dim, obj._n = int(rank), int(dim), comb.indep_size(rank, dim)
        obj.vals, obj.positions, obj.rep, obj.gamma = vals, positions, rep, gamma
        return obj

    def _with_vals(self, vals) -> "SparseFlatSymmetricTensor":
        return self._raw(self.rank, self.dim, vals, self.positions, self.rep,
                         self.gamma)

    # ----------------------------------------------------------- creation

    @classmethod
    def from_flat(
        cls, flat: FlatSymmetricTensor, threshold: float = 0.0
    ) -> "SparseFlatSymmetricTensor":
        """Keep the packed values with |v| > threshold. The representatives
        come from the host table ``rep_np`` under its guard, as in the JAX
        package."""
        from ..utils.tables import tables

        flat = flat.toflat()
        data = flat.data
        mag = data if data.dtype == torch.bool else data.abs()
        idx = torch.nonzero(mag > threshold).reshape(-1)
        dev = data.device
        if flat.rank == 0:
            rows = np.zeros((idx.shape[0], 0), dtype=np.int64)
        else:
            rows = tables(flat.rank, flat.dim).rep_np()[idx.cpu().numpy()]
        rep = torch.as_tensor(rows.astype(np.int32), device=dev)
        gamma = torch.as_tensor(
            comb.row_multiplicities(rows).astype(np.float32), device=dev)
        return cls._raw(flat.rank, flat.dim, data[idx],
                        idx.to(torch.int32), rep, gamma)

    @classmethod
    def from_entries(
        cls,
        rank: int,
        dim: int,
        indices: Sequence[Sequence[int]],
        values,
        dtype=None,
        device=None,
    ) -> "SparseFlatSymmetricTensor":
        """Build from (multi-index, value) pairs without materializing the
        packed axis. `indices` (nnz, rank) may be any order within a row;
        rows are sorted, ranked by the closed-form position on the device
        and checked against [0, dim). Values keep their type unless `dtype`
        is given (NumPy and list data: ``config.default_dtype``); leaves go
        to `device`, else the tensors', else ``config.default_device``."""
        from ..utils.tables import tables

        dev = leaf_device([indices, values], device)
        if not isinstance(indices, torch.Tensor):
            indices = torch.from_numpy(np.asarray(indices, dtype=np.int64))
        rows = indices.to(device=dev, dtype=torch.int64)
        if rows.ndim != 2 or rows.shape[1] != rank:
            raise ValueError(
                f"indices must be (nnz, {rank}); got {tuple(rows.shape)}"
            )
        rows = torch.sort(rows, dim=1).values
        if rows.numel() and bool((rows.min() < 0) | (rows.max() >= dim)):
            raise IndexError("entry index out of range")
        if dtype is None and not isinstance(values, torch.Tensor):
            dtype = default_dtype()
        vals = torch.as_tensor(values, device=dev).to(dtype or values.dtype).reshape(-1)
        if vals.shape[0] != rows.shape[0]:
            raise ValueError(
                f"{rows.shape[0]} indices but {vals.shape[0]} values"
            )
        pos = tables(rank, dim, dev).position_T(rows.T)
        n = comb.indep_size(rank, dim)
        return cls._raw(rank, dim, vals,
                        pos.to(torch.int32 if n < 2**31 else torch.int64),
                        rows.to(torch.int32), _row_multiplicities(rows))

    # ---------------------------------------------------------- structure

    @property
    def dtype(self) -> torch.dtype:
        return self.vals.dtype

    @property
    def device(self) -> torch.device:
        return self.vals.device

    def keys(self):
        """Storage-leaf names (sparse storage has no σ-class layout)."""
        return dict.fromkeys(["values", "indices"]).keys()

    def values(self):
        return iter([self.vals, self.positions])

    @property
    def nnz(self) -> int:
        return int(self.vals.shape[0])

    @property
    def size(self) -> int:
        return self.nnz

    def astype(self, dtype) -> "SparseFlatSymmetricTensor":
        return self._with_vals(self.vals.to(dtype))

    def to(self, device) -> "SparseFlatSymmetricTensor":
        return self._raw(self.rank, self.dim, *(
            v.to(device) for v in (self.vals, self.positions, self.rep, self.gamma)))

    def copy(self) -> "SparseFlatSymmetricTensor":
        return self._raw(self.rank, self.dim, *(
            v.clone() for v in (self.vals, self.positions, self.rep, self.gamma)))

    # ------------------------------------------------------------ content

    def toflat(self) -> FlatSymmetricTensor:
        """The packed values, duplicates summed (``index_add_``)."""
        from ..utils.profiling import count_fallback

        count_fallback(
            "sparse_flat.densify_storage", "(op not closed on sparse storage)"
        )
        out = torch.zeros(self._n, dtype=self.dtype, device=self.device)
        out.index_add_(0, self.positions.to(torch.int64), self.vals)
        return FlatSymmetricTensor._raw(self.rank, self.dim, out)

    def todense(self) -> torch.Tensor:
        return self.toflat().todense()

    # ----------------------------------------------------------- indexing

    def element(self, idx) -> torch.Tensor:
        """One element: the closed-form position, then an O(nnz) masked
        sum over the entries (absent entries read as zero)."""
        idx = self._full_index(idx)
        if self.rank == 0:
            return self.vals.sum()
        srt = tuple(sorted(idx))
        pos = srt[0] if self.rank == 1 else comb.gflat_layout(
            self.rank, self.dim).position(srt)
        hit = self.positions == pos
        return torch.where(hit, self.vals, torch.zeros((), dtype=self.dtype,
                                                       device=self.device)).sum()

    def class_values(self, cls) -> torch.Tensor:
        return self.toflat().class_values(cls)

    def _partial(self, idx):
        return self.toflat()._partial(idx)

    def set_element(self, idx, value):
        return self.toflat().set_element(idx, value)

    def set_class(self, cls, value):
        return self.toflat().set_class(cls, value)

    # --------------------------------------------------- sparse-closed ops

    def scale(self, s) -> "SparseFlatSymmetricTensor":
        return self._with_vals(
            self.vals * torch.as_tensor(s, dtype=self.dtype, device=self.device))

    def __neg__(self):
        return self.scale(-1.0)

    def add_sparse(
        self, other: "SparseFlatSymmetricTensor"
    ) -> "SparseFlatSymmetricTensor":
        """Sparse + sparse by concatenating entries: duplicate positions
        mean summation, and every consumer here is additive over
        entries. Values and positions take the promoted type of the two
        operands' (as ``jnp.concatenate`` does), in either order."""
        if (self.rank, self.dim) != (other.rank, other.dim):
            raise ValueError("rank/dim mismatch")

        def cat(a, b):
            ct = torch.promote_types(a.dtype, b.dtype)
            return torch.cat([a.to(ct), b.to(device=a.device, dtype=ct)])

        return self._raw(self.rank, self.dim, *(
            cat(a, b) for a, b in ((self.vals, other.vals),
                                   (self.positions, other.positions),
                                   (self.rep, other.rep),
                                   (self.gamma, other.gamma))))

    def _weights(self, ct) -> torch.Tensor:
        """γ_I·v_I of every entry in the evaluation type."""
        return self.vals.to(ct) * self.gamma.to(ct)

    def contract_all_indices_with_vector(self, x) -> torch.Tensor:
        """Σ A·x⊗…⊗x in O(nnz·r): each entry contributes
        γ_I·v_I·∏_k x[rep_I[k]]."""
        x = torch.as_tensor(x, device=self.device)
        if self.rank == 0:
            return self.vals.sum()
        ct = compute_dtype(self.vals, x)
        x = x.to(ct)
        mono = x[self.rep[:, 0].long()]
        for k in range(1, self.rank):
            mono = mono * x[self.rep[:, k].long()]
        return torch.dot(self._weights(ct), mono)

    def contract_all_indices_with_vector_batched(self, xs) -> torch.Tensor:
        """xs (B, dim) → (B,), over blocks of entries: each block gathers
        its (entries, B) monomials from xsᵀ and adds one GEMV, so no
        (B, nnz) tensor is ever held."""
        xs = torch.as_tensor(xs, device=self.device)
        B = xs.shape[0]
        if self.rank == 0:
            return self.vals.sum().expand(B)
        ct = compute_dtype(self.vals, xs)
        xT = xs.to(ct).T.contiguous()  # (dim, B): gathered rows are contiguous
        w = self._weights(ct)
        out = torch.zeros(B, dtype=ct, device=self.device)
        step = max(1, BATCH_BLOCK_ELEMS // max(B, 1))
        with full_fp32_matmul():
            for s in range(0, self.nnz, step):
                rep = self.rep[s : s + step].long()
                mono = xT[rep[:, 0]]
                for k in range(1, self.rank):
                    mono *= xT[rep[:, k]]
                out += w[s : s + step] @ mono
        return out

    def __repr__(self):
        return (
            f"SparseFlatSymmetricTensor(rank={self.rank}, dim={self.dim}, "
            f"nnz={self.nnz}, dtype={self.dtype}, device={self.device})"
        )
