"""DecompSymmetricTensor — outer-product (CP-style) format.

The counterpart of ``symtensor_tpu/core/decomp.py``:

    T = Symmetrize( Σ_{a1…ak} w[a1…ak] · f_{a1}^{⊗m1} ⊗ … ⊗ f_{ak}^{⊗mk} )

with weights ``w`` (a rank-k tensor over the factor index), factors ``f``
(num_factors × dim) and multiplicities ``(m1…mk)``; symmetrization is
lazy, done on retrieval. Basis change is one factor matmul, polynomial
evaluation is O(num_factors·dim), and sums, outer products and tensordots
of decomp tensors stay decomposed (block-embedded weights over the
concatenated factors).

Everything here is plain torch: the JAX package computes this format with
XLA einsums, outside any Pallas kernel. Where it hands a generated
einsum spec to ``jnp.einsum``, whose optimizer picks the contraction
order, this module fixes the order itself (``_contract_groups``,
``_expand_groups``, ``_couple_table``): ``torch.einsum`` contracts left to
right, which would keep a weight letter alive across several factor
operands and build F^k·d^m intermediates. Matrix products on values run
in full float32 (``utils/precision.full_fp32_matmul``).

Weights and factors live on one device. A tensor built without tensor data
goes to ``config.default_device`` (the card) and raises without CUDA.
There is no pytree registration and no traced branch: autograd follows
the two leaves.
"""

from __future__ import annotations

import itertools
import numbers
from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from ..utils import combinatorics as comb
from ..utils.precision import full_fp32_matmul
from .base import SymmetricTensor, default_dtype, host, leaf_device
from .flat import FlatSymmetricTensor


def _contract_groups(w: torch.Tensor, us: Sequence[torch.Tensor]) -> torch.Tensor:
    """out[n] = Σ_{a1…ak} w[a1…ak] · ∏_t us[t][a_t, n], one weight axis at a
    time: a GEMM against the first axis, then a batched product per
    further axis. us[t]: (F, N). The largest intermediate has N·F^(k−1)
    elements. Returns (N,)."""
    F, N = us[0].shape
    with full_fp32_matmul():
        acc = us[0].T @ w.reshape(F, -1)  # (N, F^(k−1))
        for u in us[1:]:
            acc = torch.einsum("naf,an->nf", acc.reshape(N, F, -1), u)
    return acc.reshape(N)


def _expand_groups(w: torch.Tensor, factors: torch.Tensor,
                   multiplicities: Sequence[int]) -> torch.Tensor:
    """The unsymmetrized (dim,)**rank coefficient tensor
    Σ_a w[a1…ak] ⊗_t f_{a_t}^{⊗m_t}: each weight axis in turn is
    contracted against the product of its group's factor copies
    (F, dim**m_t), so no intermediate carries a weight axis beside the
    slots that axis has already produced. The largest intermediate has
    max_t F^(k−t−1)·dim^(m_1+…+m_t) elements."""
    F, d = factors.shape
    with full_fp32_matmul():
        for m in multiplicities:
            block = factors
            for _ in range(m - 1):
                block = (block[:, :, None] * factors[:, None, :]).reshape(F, -1)
            # contract the leading (next unprocessed) weight axis; its
            # group's slots go to the end, after the earlier groups'
            w = torch.tensordot(w, block.reshape((F,) + (d,) * m), dims=([0], [0]))
    return w


class DecompSymmetricTensor(SymmetricTensor):
    format = "decomp"

    def __init__(
        self,
        rank: Optional[int] = None,
        dim: Optional[int] = None,
        weights=None,
        factors=None,
        multiplicities: Optional[Tuple[int, ...]] = None,
        dtype: Optional[torch.dtype] = None,
        device=None,
    ):
        """weights: (num_factors,)**k, factors: (num_factors, dim),
        multiplicities: k positive integers summing to rank (default: one
        group of multiplicity rank). Both leaves take `dtype`, by default
        ``config.default_dtype``, as in the JAX package. They go to
        `device`; without it, to the device of the ``torch.Tensor`` leaves
        given (which must agree), else to ``config.default_device``. No
        leaves at all gives the zero tensor (one zero factor)."""
        if rank is None or dim is None:
            raise ValueError("need rank and dim")
        rank, dim = int(rank), int(dim)
        dtype = dtype or default_dtype()
        if multiplicities is None:
            multiplicities = (rank,) if rank > 0 else ()
        multiplicities = tuple(int(m) for m in multiplicities)
        if sum(multiplicities) != rank:
            raise ValueError(
                f"multiplicities {multiplicities} must sum to rank {rank}"
            )
        if any(m <= 0 for m in multiplicities):
            raise ValueError("multiplicities must be positive")
        k = len(multiplicities)
        dev = leaf_device([weights, factors], device)
        if weights is None and factors is None:
            # empty decomposition == zero tensor with one zero factor
            factors = torch.zeros((1, dim), dtype=dtype, device=dev)
            weights = torch.zeros((1,) * k, dtype=dtype, device=dev)
        weights = torch.as_tensor(weights, dtype=dtype, device=dev)
        factors = torch.as_tensor(factors, dtype=dtype, device=dev)
        if factors.ndim != 2 or factors.shape[1] != dim:
            raise ValueError(
                f"factors must be (num_factors, {dim}); got {tuple(factors.shape)}"
            )
        F = factors.shape[0]
        if tuple(weights.shape) != (F,) * k:
            raise ValueError(
                f"weights must be {(F,) * k} for {k} independent factors; "
                f"got {tuple(weights.shape)}"
            )
        self.rank, self.dim = rank, dim
        self.weights, self.factors = weights, factors
        self.multiplicities = multiplicities

    @classmethod
    def _raw(cls, rank, dim, weights, factors, multiplicities):
        """Wrap the two leaves without copying or checking them."""
        obj = object.__new__(cls)
        obj.rank, obj.dim = int(rank), int(dim)
        obj.weights, obj.factors = weights, factors
        obj.multiplicities = tuple(multiplicities)
        return obj

    # ------------------------------------------------------------ creation

    @classmethod
    def from_vector(cls, v, rank: int, device=None) -> "DecompSymmetricTensor":
        """T = v^⊗rank."""
        v = torch.as_tensor(v, device=leaf_device([v], device))
        return cls._raw(
            rank,
            v.shape[0],
            torch.ones((1,), dtype=v.dtype, device=v.device),
            v[None, :],
            (rank,),
        )

    @classmethod
    def from_matrix(
        cls, mat, cutoff: float = 1e-12, top_k: Optional[int] = None,
        device=None,
    ) -> "DecompSymmetricTensor":
        """Rank-2 tensor from a symmetric matrix by eigendecomposition
        (``torch.linalg.eigh``), dropping eigenvalues of magnitude ≤
        `cutoff` and keeping at most the `top_k` largest. The pruning reads
        the eigenvalues on the host: one device synchronisation a call.
        Eigenvector signs and the basis of a degenerate eigenspace are the
        solver's; the tensor they give is the same."""
        mat = torch.as_tensor(mat, device=leaf_device([mat], device))
        w, v = torch.linalg.eigh(mat)
        mag = np.abs(host(w))
        keep = mag > cutoff
        if top_k is not None:
            order = np.argsort(-mag)
            sel = np.zeros_like(keep)
            sel[order[:top_k]] = True
            keep = keep & sel
        if not keep.any():
            keep = np.zeros_like(keep)
            keep[int(np.argmax(mag))] = True
        idx = torch.as_tensor(np.nonzero(keep)[0], device=mat.device)
        return cls._raw(2, mat.shape[0], w[idx], v[:, idx].T, (2,))

    @classmethod
    def from_dense(
        cls,
        arr,
        symmetrize: bool = False,
        check: bool = True,
        rtol: float = 1e-5,
        atol: float = None,
    ) -> "DecompSymmetricTensor":
        """Exact dense import at any rank: rank ≤ 1 the one-factor form;
        rank 2 the eigendecomposition (fewest factors); rank ≥ 3 the
        standard-basis decomposition (weights = the dense coefficients,
        factors = identity, multiplicities all 1), the form
        ``reduce_factors`` normalizes to. A ``torch.Tensor`` keeps its
        device; other data goes to ``config.default_device``."""
        from ..ops.symmetrize import is_symmetric as _is_symmetric
        from ..ops.symmetrize import symmetrize as _symmetrize

        arr = torch.as_tensor(arr, device=leaf_device([arr]))
        rank, dim = arr.ndim, (arr.shape[0] if arr.ndim else 1)
        if any(s != dim for s in arr.shape):
            raise ValueError(
                f"dense data must be hypercubic; got {tuple(arr.shape)}"
            )
        if symmetrize:
            arr = _symmetrize(arr)
        elif check and rank > 1:
            if not _is_symmetric(arr, rtol=rtol, atol=atol):
                raise ValueError(
                    "data is not symmetric (pass symmetrize=True to project)"
                )
        if rank == 0:
            return cls._raw(
                0, 1, arr.reshape(()),
                torch.zeros((1, 1), dtype=arr.dtype, device=arr.device), (),
            )
        if rank == 1:
            return cls._raw(
                1, dim, torch.ones((1,), dtype=arr.dtype, device=arr.device),
                arr[None, :], (1,),
            )
        if rank == 2:
            return cls.from_matrix(arr, cutoff=0.0)
        return cls._raw(
            rank, dim, arr,
            torch.eye(dim, dtype=arr.dtype, device=arr.device), (1,) * rank,
        )

    @classmethod
    def zeros(
        cls, rank: int, dim: int, dtype=None, device=None
    ) -> "DecompSymmetricTensor":
        """The zero tensor on `device`, by default
        ``config.default_device``."""
        return cls(rank=rank, dim=dim, dtype=dtype, device=device)

    # ----------------------------------------------------------- structure

    @property
    def num_factors(self) -> int:
        return self.factors.shape[0]

    @property
    def num_indep_factors(self) -> int:
        return len(self.multiplicities)

    @property
    def num_arrangements(self) -> int:
        """Number of distinct orderings of the factor groups in the outer
        product: r!/∏ m_t!."""
        return comb.multinom(self.rank, self.multiplicities)

    @property
    def size(self) -> int:
        """Stored elements: the exact leaf count."""
        return int(self.weights.numel() + self.factors.numel())

    @property
    def dtype(self) -> torch.dtype:
        return self.weights.dtype

    @property
    def device(self) -> torch.device:
        return self.weights.device

    def keys(self):
        """Storage-leaf names (decomp has no σ-class layout; the leaves
        are the factor stack and its weights)."""
        return dict.fromkeys(["weights", "factors"]).keys()

    def values(self):
        return iter([self.weights, self.factors])

    def _with(self, weights, factors=None, multiplicities=None):
        return self._raw(
            self.rank, self.dim, weights,
            self.factors if factors is None else factors,
            self.multiplicities if multiplicities is None else multiplicities,
        )

    def astype(self, dtype) -> "DecompSymmetricTensor":
        return self._with(self.weights.to(dtype), self.factors.to(dtype))

    def to(self, device) -> "DecompSymmetricTensor":
        return self._with(self.weights.to(device), self.factors.to(device))

    def copy(self) -> "DecompSymmetricTensor":
        return self._with(self.weights.clone(), self.factors.clone())

    # --------------------------------------------------- multiplicity ops

    def split_factors(self, pos: int) -> "DecompSymmetricTensor":
        """Equivalent tensor with multiplicity `pos` split:
        (…, m_pos, …) → (…, m_pos−1, 1, …), by
        W'[a…, z, …] = W[a…]·δ_{a_pos z}."""
        m = self.multiplicities
        if m[pos] <= 1:
            raise ValueError("cannot split a multiplicity-1 factor")
        k = self.num_indep_factors
        F = self.num_factors
        eye = torch.eye(F, dtype=self.dtype, device=self.device)
        shape = [1] * (k + 1)
        shape[pos] = shape[pos + 1] = F
        new_w = self.weights.unsqueeze(pos + 1) * eye.reshape(shape)
        new_m = m[:pos] + (m[pos] - 1, 1) + m[pos + 1:]
        return self._with(new_w, multiplicities=new_m)

    def sort_multiplicities(self) -> "DecompSymmetricTensor":
        m = self.multiplicities
        order = tuple(
            int(i) for i in np.argsort([-v for v in m], kind="stable")
        )
        if order == tuple(range(len(m))):
            return self
        return self._with(
            self.weights.permute(order), multiplicities=tuple(m[i] for i in order)
        )

    def match_multiplicities(self, mult: Sequence[int]) -> "DecompSymmetricTensor":
        """Equivalent tensor with the given multiplicity pattern, reached
        by sorting and splitting."""
        mult = tuple(int(v) for v in mult)
        if sum(mult) != self.rank:
            raise ValueError("target multiplicities must sum to rank")
        out = self.sort_multiplicities()
        guard = 0
        while out.multiplicities != mult:
            if guard > self.rank + 1:
                raise ValueError(
                    f"cannot match {out.multiplicities} to {mult}"
                )
            guard += 1
            for i, target in enumerate(mult):
                cur = out.multiplicities
                if i >= len(cur) or cur[i] < target:
                    raise ValueError(
                        f"cannot match {self.multiplicities} to {mult}: "
                        "individual multiplicities can only decrease"
                    )
                if cur[i] > target:
                    out = out.split_factors(i)
                    break
        return out

    def find_common_multiplicities(self, other) -> Tuple[int, ...]:
        """The common refinement both operands can be split to."""
        a = sorted(self.multiplicities, reverse=True)
        b = sorted(other.multiplicities, reverse=True)
        if self.rank != other.rank:
            raise ValueError("ranks must match")
        # greedy common refinement of two partitions of rank
        out = []
        i = j = 0
        while i < len(a) and j < len(b):
            m = min(a[i], b[j])
            out.append(m)
            a[i] -= m
            b[j] -= m
            if a[i] == 0:
                i += 1
            if b[j] == 0:
                j += 1
        return tuple(out)

    # ------------------------------------------------------------- content

    def _subset_chains(self):
        """All ways to split the positions {0..r−1} into ordered groups of
        sizes `multiplicities`; with sorted index rows, averaging the
        product over these chains performs the lazy symmetrization exactly
        (the identity of ``ops/outer.py``)."""
        chains = [((), tuple(range(self.rank)))]
        for m in self.multiplicities:
            new = []
            for done, remaining in chains:
                for S in itertools.combinations(remaining, m):
                    rem = tuple(i for i in remaining if i not in S)
                    new.append((done + (S,), rem))
            chains = new
        return [done for done, rem in chains]

    def _chain_average(self, gather) -> torch.Tensor:
        """(1/#chains) Σ_chains Σ_a w[a] ∏_t ∏_{p∈S_t} gather(p)[a_t, n],
        with gather(p) the (F, N) factor components at index position p.
        All-ones multiplicities: the r! chains are the axis permutations
        of the weights, so the weights are symmetrized once and one
        contraction is left. Cost: chains · F^k · N."""
        r, k = self.rank, self.num_indep_factors
        if k == r:
            from ..ops.symmetrize import symmetrize as _symmetrize

            return _contract_groups(
                _symmetrize(self.weights), [gather(p) for p in range(r)]
            )
        chains = self._subset_chains()
        acc = None
        for chain in chains:
            us = []
            for S in chain:
                u = gather(S[0])
                for p in S[1:]:
                    u = u * gather(p)
                us.append(u)
            term = _contract_groups(self.weights, us)
            acc = term if acc is None else acc + term
        return acc / len(chains)

    def toflat(self) -> FlatSymmetricTensor:
        """The packed values: chains · F^k · n operations (an (F, n) gather
        per group per chain), so for small tensors or few factors."""
        if self.rank == 0:
            return FlatSymmetricTensor._raw(0, 1, self.weights.reshape(1))
        rep_T = self.tables.rep_T  # (r, n)
        vals = self._chain_average(lambda p: self.factors[:, rep_T[p]])
        return FlatSymmetricTensor._raw(self.rank, self.dim, vals)

    def todense(self) -> torch.Tensor:
        return self.toflat().todense()

    # ----------------------------------------------------------- indexing

    def class_values(self, cls) -> torch.Tensor:
        return self.toflat().class_values(comb.as_class_counts(cls))

    def element(self, idx: Sequence[int]) -> torch.Tensor:
        if self.rank == 0:
            return self.weights.reshape(())
        idx = self._full_index(idx)
        return self._chain_average(
            lambda p: self.factors[:, idx[p]][:, None]
        ).reshape(())

    def _partial(self, idx):
        return self.toflat()._partial(idx)

    def set_class(self, cls, value):
        raise TypeError(
            "DecompSymmetricTensor does not support item assignment "
            "(reference decomp_symmtensor.py:793); convert to another format"
        )

    set_element = set_class

    # --------------------------------------------------------- linear ops

    def scale(self, c) -> "DecompSymmetricTensor":
        """c·T: the weights scaled. A tensor `c` on another device raises
        rather than being copied across."""
        if isinstance(c, torch.Tensor):
            if c.device != self.device:
                raise ValueError(
                    f"scale factor on {c.device}, tensor on {self.device}"
                )
            c = c.to(self.dtype)
        elif not isinstance(c, numbers.Number):
            c = torch.as_tensor(np.asarray(c), device=self.device).to(self.dtype)
        return self._with(self.weights * c)

    def __neg__(self):
        return self.scale(-1.0)

    def _eye(self, dtype=None) -> torch.Tensor:
        return torch.eye(self.dim, dtype=dtype or self.dtype, device=self.device)

    def _to_standard_basis(self) -> "DecompSymmetricTensor":
        """Exact equivalent with factors = identity: the weights become
        the (dim,)**rank coefficient tensor (unsymmetrized: symmetrization
        stays lazy), multiplicities all 1. The normal form
        ``reduce_factors`` targets at rank ≥ 3, usable at any rank ≥ 1."""
        r = self.rank
        if r == 0 or (
            self.multiplicities == (1,) * r and self.num_factors == self.dim
        ):
            return self
        new_w = _expand_groups(self.weights, self.factors, self.multiplicities)
        return self._with(new_w, self._eye(), (1,) * r)

    def add_decomp(self, other: "DecompSymmetricTensor") -> "DecompSymmetricTensor":
        """Exact structural addition: match multiplicities, concatenate
        factors, block-embed weights.

        Auto-compaction: long add chains grow the block-embedded weights
        as (F_a+F_b)**k. When that exceeds
        ``config.decomp_autoreduce_elems`` and the exact standard-basis
        form (dim**rank coefficients) is smaller, the sum is returned in
        the standard basis; low-rank decompositions (dim**rank ≫ block
        size) are never touched."""
        if (self.rank, self.dim) != (other.rank, other.dim):
            raise ValueError("rank/dim mismatch")
        if self.rank == 0:
            return self._with(self.weights + other.weights)
        m = self.find_common_multiplicities(other)
        from ..config import config

        w_dt = torch.promote_types(self.dtype, other.dtype)
        lim = config.decomp_autoreduce_elems
        block_elems = (self.num_factors + other.num_factors) ** len(m)
        std_elems = self.dim**self.rank
        if 0 < lim < block_elems and std_elems < block_elems:
            a_std = self._to_standard_basis()
            b_std = other._to_standard_basis()
            return self._with(
                a_std.weights + b_std.weights, a_std.factors.to(w_dt),
                a_std.multiplicities,
            )
        a = self.match_multiplicities(m)
        b = other.match_multiplicities(m)
        Fa, Fb = a.num_factors, b.num_factors
        k = len(m)
        factors = torch.cat([a.factors.to(w_dt), b.factors.to(w_dt)], dim=0)
        w = torch.zeros((Fa + Fb,) * k, dtype=w_dt, device=self.device)
        w[(slice(0, Fa),) * k] = a.weights
        w[(slice(Fa, Fa + Fb),) * k] = b.weights
        return self._with(w, factors, m)

    def outer_decomp(self, other: "DecompSymmetricTensor") -> "DecompSymmetricTensor":
        """Symmetrized outer product, exact and lazy in this format:
        weights ⊗ weights padded to the concatenated factors,
        multiplicities concatenated."""
        if self.dim != other.dim:
            raise ValueError("dim mismatch")
        ka, kb = self.num_indep_factors, other.num_indep_factors
        Fa, Fb = self.num_factors, other.num_factors
        w = torch.tensordot(self.weights, other.weights, dims=0)
        factors = torch.cat([self.factors, other.factors], dim=0)
        big = torch.zeros((Fa + Fb,) * (ka + kb), dtype=w.dtype, device=w.device)
        big[(slice(0, Fa),) * ka + (slice(Fa, Fa + Fb),) * kb] = w
        return self._raw(
            self.rank + other.rank, self.dim, big, factors,
            self.multiplicities + other.multiplicities,
        )

    def tensordot_decomp(self, other: "DecompSymmetricTensor", axes: int = 1):
        """Symmetrized tensordot staying in decomposed form, exact for any
        multiplicity patterns and any number of contracted axes.

        The symmetrized operands are averages over factor-group
        arrangements, so contracting q slots pairs the contracted
        positions of A and B. Group the pairings by the pairing table
        n[t, s] = number of contracted slots drawn from A-group t and
        B-group s (row sums c, column sums e). With m/μ the multiplicity
        patterns,

            C = Σ_n  coef(n) · Σ_{a,b} W_A[a] W_B[b]
                     ∏_{t,s} (f_{a_t}·g_{b_s})^{n_ts}
                     ⊗_t f_{a_t}^{⊗(m_t−c_t)} ⊗_s g_{b_s}^{⊗(μ_s−e_s)}

            coef(n) = multinom(ra−q; m−c) · multinom(rb−q; μ−e)
                      · multinom(q; n) / (multinom(ra; m)·multinom(rb; μ))

        Each table contributes one decomp term; the terms combine by exact
        structural addition. A full contraction returns a 0-d tensor."""
        if self.dim != other.dim:
            raise ValueError("dim mismatch")
        if axes == 0:
            return self.outer_decomp(other)
        ra, rb = self.rank, other.rank
        q = int(axes)
        if q > min(ra, rb):
            raise ValueError("too many axes")
        w_dt = torch.promote_types(self.dtype, other.dtype)
        with full_fp32_matmul():
            G = self.factors.to(w_dt) @ other.factors.to(w_dt).T  # (Fa, Fb) Gram

        m, mu = self.multiplicities, other.multiplicities
        denom = comb.multinom(ra, m) * comb.multinom(rb, mu)
        terms = []
        scalar = None
        for table in _pairing_tables(m, mu, q):
            c = [0] * len(m)
            e = [0] * len(mu)
            for (t, s), p in table:
                c[t] += p
                e[s] += p
            coef = (
                comb.multinom(ra - q, tuple(mt - ct for mt, ct in zip(m, c)))
                * comb.multinom(rb - q, tuple(ms - es for ms, es in zip(mu, e)))
                * comb.multinom(q, tuple(p for _, p in table))
            ) / denom
            term = _couple_table(self, other, table, c, e, G, coef, w_dt)
            if isinstance(term, DecompSymmetricTensor):
                terms.append(term)
            else:
                scalar = term if scalar is None else scalar + term
        if ra + rb - 2 * q == 0:
            return scalar
        out = terms[0]
        for t in terms[1:]:
            out = out.add_decomp(t)
        return out

    # ----------------------------------------------- domain contractions

    def contract_all_indices_with_matrix(self, W) -> "DecompSymmetricTensor":
        """Basis change = one factor matmul."""
        W = torch.as_tensor(W, device=self.device).to(self.dtype)
        if W.shape[0] != self.dim:
            raise ValueError("W rows must equal dim")
        with full_fp32_matmul():
            factors = self.factors @ W
        return self._raw(
            self.rank, W.shape[1], self.weights, factors, self.multiplicities
        )

    def contract_all_indices_with_vector(self, x) -> torch.Tensor:
        """Σ_a w[a] · ∏_t (f_{a_t}·x)^{m_t}, for x of shape (dim,) (a 0-d
        result) or (B, dim) (a (B,) result)."""
        x = torch.as_tensor(x, device=self.device).to(self.dtype)
        if self.num_indep_factors == 0:
            return self.weights.reshape(()).expand(x.shape[:-1])
        with full_fp32_matmul():
            v = self.factors @ x.reshape(-1, x.shape[-1]).T  # (F, inputs)
        out = _contract_groups(self.weights, [v**m for m in self.multiplicities])
        return out.reshape(x.shape[:-1])

    def reduce_factors(self, cutoff: float = 1e-12, top_k=None):
        """Re-express the decomposition with at most `dim` factors.

        rank 1: the single vector. rank 2: eigendecomposition with
        zero-eigenvalue pruning (`cutoff`/`top_k` apply). rank ≥ 3: when
        num_factors > dim, contract the weights through the factors onto
        the standard basis (weights the (d,)*rank coefficient tensor,
        factors the identity, multiplicities all 1). Exact: the
        unsymmetrized product tensor is unchanged and symmetrization is
        lazy in this format."""
        r = self.rank
        if r == 0:
            return self
        if r == 1:
            vals = self.toflat().data  # (d,)
            return self._raw(
                1, self.dim,
                torch.ones((1,), dtype=self.dtype, device=self.device),
                vals[None, :], (1,),
            )
        if r == 2:
            return DecompSymmetricTensor.from_matrix(
                self.todense(), cutoff=cutoff, top_k=top_k
            )
        if self.num_factors <= self.dim:
            return self  # nothing to gain
        new_w = _expand_groups(self.weights, self.factors, self.multiplicities)
        return self._with(new_w, self._eye(), (1,) * r)


def _pairing_tables(m, mu, q):
    """All ways to draw the q contracted slot pairs from A-groups × B-groups:
    len(m)×len(mu) nonnegative integer tables with total q, row sums ≤ m,
    column sums ≤ mu. Yielded as tuples of ((t, s), count) with count > 0."""
    ka, kb = len(m), len(mu)
    cells = [(t, s) for t in range(ka) for s in range(kb)]
    rows, cols = [0] * ka, [0] * kb

    def rec(idx, remaining, cur):
        if remaining == 0:
            yield tuple(cur)
            return
        if idx == len(cells):
            return
        t, s = cells[idx]
        hi = min(remaining, m[t] - rows[t], mu[s] - cols[s])
        for v in range(hi, -1, -1):
            rows[t] += v
            cols[s] += v
            if v:
                cur.append(((t, s), v))
            yield from rec(idx + 1, remaining - v, cur)
            if v:
                cur.pop()
            rows[t] -= v
            cols[s] -= v

    yield from rec(0, q, [])


def _couple_table(A, B, table, c, e, G, coef, w_dt):
    """One pairing-table term of the general decomp tensordot: couple
    A-group t to B-group s through G**n_ts for every table entry, sum out
    the fully consumed groups, block-embed the surviving weights. The
    coupling keeps every weight axis, so it is an outer product of the two
    weight tensors times one broadcast G**n_ts per table entry."""
    ka, kb = A.num_indep_factors, B.num_indep_factors
    Fa, Fb = A.num_factors, B.num_factors
    w = torch.tensordot(A.weights.to(w_dt), B.weights.to(w_dt), dims=0)
    for (t, s), p in table:
        shape = [1] * (ka + kb)
        shape[t], shape[ka + s] = Fa, Fb
        w = w * (G**p).reshape(shape)
    w = w * coef
    mult_a = [A.multiplicities[t] - c[t] for t in range(ka)]
    mult_b = [B.multiplicities[s] - e[s] for s in range(kb)]
    dead = tuple(
        [t for t in range(ka) if mult_a[t] == 0]
        + [ka + s for s in range(kb) if mult_b[s] == 0]
    )
    if dead:
        w = w.sum(dim=dead)
    mult = tuple(v for v in mult_a + mult_b if v > 0)
    if not mult:
        return w.reshape(())
    n_a_out = sum(1 for v in mult_a if v > 0)
    factors = torch.cat([A.factors.to(w_dt), B.factors.to(w_dt)], dim=0)
    big = torch.zeros((Fa + Fb,) * len(mult), dtype=w.dtype, device=w.device)
    big[(slice(0, Fa),) * n_a_out
        + (slice(Fa, Fa + Fb),) * (len(mult) - n_a_out)] = w
    return DecompSymmetricTensor._raw(sum(mult), A.dim, big, factors, mult)
