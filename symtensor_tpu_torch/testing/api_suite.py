"""Reusable format-generic API battery, the torch counterpart of
``symtensor_tpu/testing/api_suite.py``.

Subclass ``SymTensorSuite``, set ``tensor_cls``, and get the API-contract
tests; ``tests/test_torch_api_suite.py`` binds all five formats (sparse
through a ``from_dense``/``zeros`` facade, as the JAX package binds it).
Inputs are made from a NumPy seed and go to ``config.default_device``
(the bindings ask for the CPU). The class name avoids the Test* prefix so
that pytest collects only bound subclasses. The JAX battery's ``jit`` case
has no eager-torch counterpart.
"""

from __future__ import annotations

import itertools

import numpy as np
import torch

from ..core.base import default_device, default_dtype, host
from ..ops.symmetrize import symmetrize
from ..utils import combinatorics as comb
from .utils import random_symmetric


def _sym(arr) -> np.ndarray:
    """The dense symmetrization oracle on NumPy data."""
    return symmetrize(torch.from_numpy(np.asarray(arr, dtype=np.float64))).numpy()


class SymTensorSuite:
    """Generic API contract. Subclass and set `tensor_cls` (and optionally
    `ranks_dims`, `atol`, `supports_updates`)."""

    tensor_cls = None  # must be set by subclasses
    ranks_dims = ((2, 3), (3, 4), (4, 3))
    atol = 1e-9
    # Formats without functional element/class updates (decomp) set this
    # False to skip the assignment tests.
    supports_updates = True

    # ------------------------------------------------------------ helpers

    def make(self, rank, dim, rng):
        dense = random_symmetric(rank, dim, rng)
        return self.from_numpy(dense), dense

    def from_numpy(self, arr):
        return self.tensor_cls.from_dense(
            torch.as_tensor(np.asarray(arr), device=default_device())
        )

    def _rng(self):
        return np.random.default_rng(1234)

    def sweep(self, rng, max_rank=4, max_dim=3):
        """Small (rank, dim) sweep."""
        for rank in range(1, max_rank + 1):
            for dim in range(2, max_dim + 1):
                yield self.make(rank, dim, rng)

    def _skip_if_readonly(self):
        if not self.supports_updates:
            import pytest

            pytest.skip("format does not support functional updates")

    # -------------------------------------------------------------- tests

    def test_perm_classes(self):
        rank, dim = self.ranks_dims[0]
        t, _ = self.make(rank, dim, self._rng())
        assert t.perm_classes == tuple(
            comb.class_label(c) for c in comb.perm_classes(rank)
        )
        assert t.indep_size == comb.indep_size(rank, dim)
        assert t.dense_size == dim**rank

    def test_roundtrip(self):
        rng = self._rng()
        for rank, dim in self.ranks_dims:
            t, dense = self.make(rank, dim, rng)
            np.testing.assert_allclose(host(t.todense()), dense, atol=self.atol)

    def test_element_access(self):
        rng = self._rng()
        rank, dim = self.ranks_dims[0]
        t, dense = self.make(rank, dim, rng)
        for idx in itertools.product(range(dim), repeat=rank):
            np.testing.assert_allclose(float(t[idx]), dense[idx], atol=self.atol)

    def test_class_values(self):
        rng = self._rng()
        rank, dim = self.ranks_dims[0]
        t, dense = self.make(rank, dim, rng)
        for label in t.perm_classes:
            vals = np.atleast_1d(host(t[label]))
            reps = list(t.permcls_indep_iter_repindex(label))
            assert len(vals) == len(reps)
            for v, rep in zip(vals, reps):
                np.testing.assert_allclose(v, dense[rep], atol=self.atol)

    def test_iterator_counts(self):
        rng = self._rng()
        rank, dim = self.ranks_dims[0]
        t, _ = self.make(rank, dim, rng)
        assert len(list(t.indep_iter())) == comb.indep_size(rank, dim)
        assert sum(t.permcls_multiplicity_iter()) == dim**rank

    def test_transpose_noop(self):
        t, _ = self.make(*self.ranks_dims[0], self._rng())
        assert t.transpose() is t and t.T is t

    def test_arithmetic(self):
        rng = self._rng()
        rank, dim = self.ranks_dims[0]
        a, da = self.make(rank, dim, rng)
        b, db = self.make(rank, dim, rng)
        np.testing.assert_allclose(host((a + b).todense()), da + db, atol=self.atol)
        np.testing.assert_allclose(host((a * 2.0).todense()), 2 * da, atol=self.atol)

    def test_comparisons(self):
        a, _ = self.make(*self.ranks_dims[0], self._rng())
        assert a.allclose(a)
        assert not a.allclose(a + 1.0)

    def test_np_dispatch_no_densify(self):
        """np.allclose/isclose/array_equal/result_type/all/any run on the
        packed storage: no densify warning."""
        from ..core.base import SymmetricTensor
        from .utils import does_not_warn

        rng = self._rng()
        rank, dim = self.ranks_dims[0]
        a, _ = self.make(rank, dim, rng)
        b, _ = self.make(rank, dim, rng)
        # decomp's and sparse's elementwise path warns once per site that
        # it expands to flat (still packed); only a densify warning fails
        with does_not_warn(match="densifying"):
            assert np.allclose(a, a)
            assert not np.allclose(a, a + 1.0)
            assert np.array_equal(a, a)
            assert not np.array_equal(a, b)
            assert np.result_type(a, np.float64) == np.float64
            close = np.isclose(a, a)
            assert np.all(close)
            far = np.isclose(a, a + 1e3)
            assert not np.any(far)
        assert isinstance(close, SymmetricTensor)

    def test_np_asarray_like_and_empty(self):
        """np.asarray(A, like=A) and np.empty(shape, like=A) stay packed."""
        import pytest

        from ..core.base import SymmetricTensor
        from .utils import does_not_warn

        rng = self._rng()
        rank, dim = self.ranks_dims[0]
        a, _ = self.make(rank, dim, rng)
        with does_not_warn(match="densifying"):
            assert np.asarray(a, like=a) is a
            empty = np.empty((dim,) * rank, like=a)
        assert isinstance(empty, SymmetricTensor)
        assert (empty.rank, empty.dim) == (rank, dim)
        assert not np.any(empty)
        with pytest.raises(ValueError):
            np.empty((dim, dim + 1), like=a)

    def test_dict_style_iteration(self):
        """keys()/values()/items() expose the storage layout; __iter__
        yields the dim rank-(r−1) sub-tensors."""
        rng = self._rng()
        rank, dim = self.ranks_dims[0]
        t, dense = self.make(rank, dim, rng)
        ks = list(t.keys())
        vs = list(t.values())
        assert len(ks) == len(vs) >= 1
        assert [k for k, _ in t.items()] == ks
        subs = list(t)
        assert len(subs) == dim
        if rank >= 2:
            np.testing.assert_allclose(
                host(subs[0].todense()), dense[0], atol=max(self.atol, 1e-5)
            )

    def test_outer(self):
        from .. import ops as symalg

        rng = self._rng()
        a, da = self.make(2, 3, rng)
        b, db = self.make(1, 3, rng)
        out = symalg.multiply.outer(a, b)
        np.testing.assert_allclose(
            host(out.todense()), _sym(np.multiply.outer(da, db)),
            atol=self.atol * 10,
        )

    def test_tensordot(self):
        from .. import ops as symalg

        rng = self._rng()
        a, da = self.make(2, 3, rng)
        b, db = self.make(2, 3, rng)
        out = symalg.tensordot(a, b, axes=1)
        np.testing.assert_allclose(
            host(out.todense()), _sym(np.tensordot(da, db, axes=1)),
            atol=self.atol * 10,
        )

    def test_contractions(self):
        from .. import ops as symalg

        rng = self._rng()
        rank, dim = self.ranks_dims[0]
        a, da = self.make(rank, dim, rng)
        x = rng.normal(size=dim)
        got = float(symalg.contract_all_indices_with_vector(a, x))
        expect = da
        for _ in range(rank):
            expect = expect @ x
        np.testing.assert_allclose(got, float(expect), rtol=1e-7)

    def test_serialization(self):
        from .. import serialization as ser

        a, _ = self.make(*self.ranks_dims[0], self._rng())
        b = ser.from_json(ser.to_json(a))
        assert type(b) is type(a)
        assert a.allclose(b)

    def test_creation_with_dtype(self):
        t = self.tensor_cls.zeros(3, 3)
        assert t.dtype == default_dtype()
        assert self.tensor_cls.zeros(3, 3, dtype=torch.int32).dtype == torch.int32
        assert self.tensor_cls.zeros(3, 3, dtype=torch.bool).dtype == torch.bool
        assert t.astype(torch.int32).dtype == torch.int32

    def test_illegal_initializations(self):
        import pytest

        with pytest.raises((TypeError, ValueError)):
            self.tensor_cls(rank=2)
        with pytest.raises((TypeError, ValueError)):
            self.tensor_cls(dim=2)
        # from_dense validates symmetry by default
        with pytest.raises((ValueError, NotImplementedError)):
            self.from_numpy(np.arange(9.0).reshape(3, 3))

    def test_elementwise_assignment_golden(self):
        """Assigning one index updates its whole index class."""
        self._skip_if_readonly()
        t = self.tensor_cls.zeros(3, 3)
        t = t.at[1, 2, 0].set(1.0)
        golden = np.zeros((3, 3, 3))
        for p in itertools.permutations((1, 2, 0)):
            golden[p] = 1.0
        np.testing.assert_array_equal(host(t.todense()), golden)

    def test_block_assignment(self):
        """Whole-tensor data round-trip (the functional analog of
        ``A[:] = data`` is construction)."""
        dense = _sym(np.arange(5.0**3).reshape((5,) * 3))
        t = self.from_numpy(dense)
        np.testing.assert_allclose(host(t.todense()), dense, atol=self.atol)

    def test_sigma_class_assignment(self):
        """σ-class indexing and assignment follow the iterators' order."""
        self._skip_if_readonly()
        dim = 5
        t = self.tensor_cls.zeros(3, dim)
        b = 0
        for label in t.perm_classes:
            size = comb.class_size(comb.as_class_counts(label), dim)
            if label == "iii":
                t = t.at[label].set(0.0)
            else:
                t = t.at[label].set(torch.arange(b, b + size, dtype=t.dtype))
            b += size
        assert all(float(t[i, i, i]) == 0 for i in range(dim))
        iij = np.atleast_1d(host(t["iij"]))
        reps = list(t.permcls_indep_iter_repindex("iij"))
        assert float(t[0, 0, 3]) == iij[reps.index((0, 0, 3))]
        assert float(t[2, 2, 3]) == iij[reps.index((2, 2, 3))]
        ijk = np.atleast_1d(host(t["ijk"]))
        reps = list(t.permcls_indep_iter_repindex("ijk"))
        assert float(t[1, 2, 3]) == ijk[reps.index((1, 2, 3))]

    def test_partial_indexing(self):
        rng = self._rng()
        for t, dense in self.sweep(rng, max_rank=3, max_dim=3):
            if t.rank < 2:
                continue
            for i in range(t.dim):
                np.testing.assert_allclose(
                    host(t[i].todense()), dense[i], atol=self.atol
                )
        t, dense = self.make(4, 3, rng)
        np.testing.assert_allclose(
            host(t[0, 1, :, :].todense()), dense[0, 1], atol=self.atol
        )
        assert t[0, 1, :, :].allclose(t[1, 0, :, :])
        assert t[0, 1, 1, :].allclose(t[1, 1, 0, :])
        sub = t[0, 0, 0, :]
        for i in range(3):
            np.testing.assert_allclose(
                float(sub[i]), float(t[0, 0, 0, i]), atol=self.atol
            )

    def test_negative_indices(self):
        """NumPy-style wraparound, uniform across formats."""
        import pytest

        rng = self._rng()
        rank, dim = self.ranks_dims[0]
        t, dense = self.make(rank, dim, rng)
        np.testing.assert_allclose(
            float(t[(-1,) + (0,) * (rank - 1)]),
            dense[(dim - 1,) + (0,) * (rank - 1)], atol=self.atol,
        )
        with pytest.raises(IndexError):
            t[(dim,) + (0,) * (rank - 1)]
        with pytest.raises(IndexError):
            t[(-dim - 1,) + (0,) * (rank - 1)]

    def test_correspondence_index_value_iterators(self):
        """flat count = d^r; indep count = C(d+r−1, r); values match
        indices."""
        rng = self._rng()
        rank, dim = self.ranks_dims[0]
        t, dense = self.make(rank, dim, rng)
        assert len(list(t.flat)) == dim**rank
        assert len(list(t.flat_index)) == dim**rank
        # flat zips with flat_index: the pairs rebuild the dense tensor
        rebuilt = np.zeros((dim,) * rank)
        seen = set()
        for idx, v in zip(t.flat_index, t.flat):
            assert idx not in seen, f"flat_index repeated {idx}"
            seen.add(idx)
            rebuilt[idx] = float(v)
        np.testing.assert_allclose(rebuilt, dense, atol=self.atol)
        vals = list(t.indep_iter())
        reps = list(t.indep_iter_repindex())
        assert len(vals) == len(reps) == t.indep_size
        for v, rep in zip(vals, reps):
            np.testing.assert_allclose(float(v), dense[rep], atol=self.atol)
        for adv, rep in zip(t.indep_iter_index(), reps):
            assert np.all(np.sort(np.stack(adv), axis=0)[:, 0] == np.sort(rep))

    def test_copy(self):
        t, _ = self.make(*self.ranks_dims[0], self._rng())
        before = np.array(host(t.todense()))
        c = t.copy()
        assert type(c) is type(t) and c.allclose(t)
        # the copy owns its storage: writes into it leave t unchanged
        for v in c.values():
            v.mul_(2).add_(1)
        np.testing.assert_array_equal(host(t.todense()), before)
        assert not c.allclose(t)

    def test_asarray_warns(self):
        """Implicit densification warns; explicit is ``todense()``."""
        import pytest

        t, dense = self.make(*self.ranks_dims[0], self._rng())
        with pytest.warns(UserWarning):
            arr = np.asarray(t)
        assert type(arr) is np.ndarray
        np.testing.assert_allclose(arr, dense, atol=self.atol)

    def test_eq_raises(self):
        """`==`/`!=` raise instead of silently comparing identity."""
        import pytest

        a, _ = self.make(*self.ranks_dims[0], self._rng())
        with pytest.raises(TypeError):
            a == a  # noqa: B015
        with pytest.raises(TypeError):
            a != a  # noqa: B015

    def test_arithmetic_ufuncs(self):
        """+/−/× with scalars and NumPy/symalg ufuncs, exp∘log identity."""
        from .. import ops as symalg

        rank, dim = self.ranks_dims[0]
        a, _ = self.make(rank, dim, self._rng())
        b = np.add(a, 1.0)  # NEP-13, stays packed
        assert not isinstance(b, np.ndarray)
        assert b.allclose(a + 1.0)
        assert (b - 1.0).allclose(a)
        assert np.multiply(np.multiply(b, -1.0), -1.0).allclose(b)
        assert symalg.log(symalg.exp(b)).allclose(b)
        assert np.log(np.exp(b)).allclose(b)
        # scalar ** tensor and tensor ** scalar both work
        assert (2.0**a).allclose(symalg.apply(lambda x: 2.0**x, a))
        assert (a**2.0).allclose(a * a)

    def test_unsymmetrized_outer_raises(self):
        """np.multiply.outer on symmetric tensors is refused: use
        symalg.multiply.outer."""
        import pytest

        rng = self._rng()
        a, _ = self.make(2, 3, rng)
        b, _ = self.make(1, 3, rng)
        with pytest.raises(TypeError):
            np.multiply.outer(a, b)

    def test_outer_product_cases(self):
        """Unit-vector outer and ones-tensor outer oracles."""
        from .. import ops as symalg

        e1 = self.from_numpy([1.0, 0.0])
        e2 = self.from_numpy([0.0, 1.0])
        prod = symalg.multiply.outer(e1, e2)
        assert float(prod[0, 0]) == 0 and float(prod[1, 1]) == 0
        assert float(np.atleast_1d(host(prod["ij"]))[0]) == 0.5
        rng = self._rng()
        for a, da in self.sweep(rng, max_rank=3, max_dim=2):
            ones = self.from_numpy(np.ones((a.dim,) * a.rank))
            out = symalg.multiply.outer(a, ones)
            oracle = _sym(np.multiply.outer(da, np.ones((a.dim,) * a.rank)))
            np.testing.assert_allclose(
                host(out.todense()), oracle, atol=self.atol * 10
            )

    def test_tensordot_sweep(self):
        """Pairwise sweep over small tensors, axes ∈ {0, 1, (0, 1), 2,
        ((0,1,2),(0,1,2))}, against the dense symmetrized oracle."""
        from .. import ops as symalg

        rng = self._rng()
        pool = list(self.sweep(rng, max_rank=4, max_dim=2))
        for (a, da), (b, db) in itertools.combinations(pool, 2):
            if a.dim != b.dim or a.rank + b.rank > 9:
                continue
            t0 = symalg.tensordot(a, b, axes=0)
            assert t0.allclose(symalg.multiply.outer(a, b), atol=1e-7)
            t1 = symalg.tensordot(a, b, axes=1)
            np.testing.assert_allclose(
                host(t1.todense()), _sym(np.tensordot(da, db, axes=1)), atol=1e-7
            )
            assert symalg.tensordot(a, b, axes=(0, 1)).allclose(t1, atol=1e-7)
            if a.rank >= 2 and b.rank >= 2:
                t2 = symalg.tensordot(a, b, axes=2)
                np.testing.assert_allclose(
                    host(t2.todense()), _sym(np.tensordot(da, db, axes=2)),
                    atol=1e-7,
                )
            if a.rank > 2 and b.rank > 2:
                t3 = host(symalg.tensordot(a, b, axes=((0, 1, 2), (0, 1, 2))).todense())
                for perm in ((0, 1, 2), (2, 1, 0), (2, 0, 1)):
                    o3 = _sym(np.tensordot(da, db, axes=((0, 1, 2), perm)))
                    np.testing.assert_allclose(t3, o3, atol=1e-7)

    def test_contract_all_indices_with_matrix(self):
        """Basis change against the dense einsum: square twice, chained on
        its own result, and a rectangular W that changes the dimension."""
        from .. import ops as symalg

        def oracle(dense, W):
            return _sym(np.einsum("abc,ai,bj,ck->ijk", dense, W, W, W))

        rng = self._rng()
        a, da = self.make(3, 3, rng)
        for _ in range(2):
            W = rng.normal(size=(3, 3))
            got = symalg.contract_all_indices_with_matrix(a, torch.from_numpy(W))
            np.testing.assert_allclose(host(got.todense()), oracle(da, W), atol=1e-7)
        C = symalg.contract_all_indices_with_matrix(
            a, torch.from_numpy(rng.normal(size=(3, 3))))
        W = rng.normal(size=(3, 3))
        got = symalg.contract_all_indices_with_matrix(C, torch.from_numpy(W))
        np.testing.assert_allclose(
            host(got.todense()), oracle(host(C.todense()), W), atol=1e-7)
        W = rng.normal(size=(3, 5))
        got = symalg.contract_all_indices_with_matrix(a, torch.from_numpy(W))
        assert got.dim == 5
        np.testing.assert_allclose(host(got.todense()), oracle(da, W), atol=1e-7)
        if a.format in ("flat", "permcls"):
            # the formats that go through the packed basis change: the
            # blocked route, forced by budgets of a few elements
            from ..ops import basis_change
            for budgets in ((17, 23), (64, 32)):
                got = symalg.contract_all_indices_with_matrix(
                    a, torch.from_numpy(W), block_elems=budgets[0],
                    transient_elems=budgets[1])
                assert basis_change.last_call["route"] == "blocked"
                assert got.format == a.format and got.dim == 5
                np.testing.assert_allclose(host(got.todense()), oracle(da, W),
                                           atol=1e-7)

    def test_contract_tensor_list(self):
        """One and two contracted indices against the dense einsum."""
        from .. import ops as symalg

        rng = self._rng()
        for dim in (2, 3, 4):
            t, td = self.make(3, dim, rng)
            chis, chi_dense = [], np.zeros((dim,) * 3)
            for i in range(dim):
                c, cd = self.make(2, dim, rng)
                chis.append(c)
                chi_dense[i] = cd
            c1 = symalg.contract_tensor_list(t, chis, n_times=1, rule="all")
            o1 = _sym(np.einsum("ija,akl->ijkl", td, chi_dense))
            np.testing.assert_allclose(host(c1.todense()), o1, atol=1e-7)
            c2 = symalg.contract_tensor_list(t, chis, n_times=2, rule="all")
            o2 = _sym(np.einsum("iab,ajk,blm->ijklm", td, chi_dense, chi_dense))
            np.testing.assert_allclose(host(c2.todense()), o2, atol=1e-7)

    def test_contract_all_indices_with_vector_cases(self):
        """Vector contraction, the zero vector included."""
        from .. import ops as symalg

        rng = self._rng()
        a, da = self.make(3, 3, rng)
        for x in (rng.normal(size=3), rng.normal(size=3), np.zeros(3)):
            got = float(symalg.contract_all_indices_with_vector(a, torch.from_numpy(x)))
            expect = float(np.einsum("abc,a,b,c->", da, x, x, x))
            np.testing.assert_allclose(got, expect, atol=1e-7)
