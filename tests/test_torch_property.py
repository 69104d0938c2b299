"""Property-based fuzzing of the port: the seven properties of
``tests/test_property.py``, run against ``symtensor_tpu_torch`` on the CPU
in float64.

Each property goes through every route the port has for it (the basis
change's whole-level and blocked routes and on-the-fly ranking, the batched
evaluation's fold, premultiplied views and cell GEMMs, the outer product's
table and streamed routes), against a dense float64 oracle built with
NumPy. Draws are derandomized, so every run tests the same examples and
the suite's count of passes does not move between runs.

The same properties run against the JAX package too, on a few fixed shapes
each (the ``*_matches_jax`` cases): JAX compiles a program for every new
shape, so it is not run on every draw.
"""

import itertools
import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings, strategies as st_

import symtensor_tpu as st
import symtensor_tpu_torch as stt
from symtensor_tpu.utils import combinatorics as jax_comb
from symtensor_tpu.utils.tables import tables as jax_tables
from symtensor_tpu_torch.config import config
from symtensor_tpu_torch.kernels import poly_eval as tpe
from symtensor_tpu_torch.ops import basis_change as bc
from symtensor_tpu_torch.utils import combinatorics as comb
from symtensor_tpu_torch.utils.tables import tables

symalg = stt.symalg


def fuzz(max_examples):
    """The battery's settings: a fixed set of draws, no time limit, and no
    example database, so the examples are the same on every run."""
    return settings(max_examples=max_examples, deadline=None,
                    derandomize=True, database=None)


@pytest.fixture(autouse=True, scope="module")
def _cpu_default_device():
    """Tensors go to the CPU (module scope: hypothesis runs many draws in
    one call of the test function)."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(config, "default_device", "cpu")
        yield


# ------------------------------------------------------------------ oracles


def np_symmetrize(a: np.ndarray) -> np.ndarray:
    """The mean of `a` over every permutation of its axes."""
    if a.ndim < 2:
        return a.copy()
    perms = list(itertools.permutations(range(a.ndim)))
    return sum(np.transpose(a, p) for p in perms) / len(perms)


def random_sym_dense(rank, dim, rng) -> np.ndarray:
    return np_symmetrize(rng.normal(size=(dim,) * rank))


def dense_chain(dense: np.ndarray, M: np.ndarray) -> np.ndarray:
    """Contract every index of `dense` with M (a vector or a matrix), one
    leading axis at a time."""
    out = dense
    for _ in range(dense.ndim):
        out = np.tensordot(out, M, axes=([0], [0]))
    return out


def flat(dense: np.ndarray):
    return stt.FlatSymmetricTensor.from_dense(torch.from_numpy(dense))


def nerr(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-300))


def sorted_index(data, rank, dim):
    return tuple(sorted(data.draw(st_.lists(
        st_.integers(0, dim - 1), min_size=rank, max_size=rank))))


# ------------------------------------------------------ 1. position round trip


def check_position_roundtrip(rank, dim, idx):
    lay = comb.gflat_layout(rank, dim)
    pos = lay.position(idx)
    assert 0 <= pos < lay.n
    assert tuple(lay.rep_indices()[pos]) == idx
    t = tables(rank, dim)
    assert tuple(t.rep[pos].tolist()) == idx
    assert tuple(t.rep_T[:, pos].tolist()) == idx
    assert int(t.position(torch.tensor([idx]))[0]) == pos
    return pos


@given(rank=st_.integers(2, 7), dim=st_.integers(1, 12), data=st_.data())
@fuzz(60)
def test_position_roundtrip(rank, dim, data):
    check_position_roundtrip(rank, dim, sorted_index(data, rank, dim))


@pytest.mark.parametrize("rank,dim", [(2, 5), (3, 7), (5, 4), (7, 3)])
def test_position_roundtrip_matches_jax(rank, dim):
    lay, jlay = comb.gflat_layout(rank, dim), jax_comb.gflat_layout(rank, dim)
    np.testing.assert_array_equal(lay.rep_indices(), jlay.rep_indices())
    np.testing.assert_array_equal(tables(rank, dim).rep.numpy(),
                                  np.asarray(jax_tables(rank, dim).rep))
    for idx in map(tuple, jlay.rep_indices()[:: max(1, lay.n // 17)]):
        assert check_position_roundtrip(rank, dim, idx) == jlay.position(idx)


# ------------------------------------------------ 2. element/class consistency


def check_element_class(A, idx):
    v0 = float(A[idx])
    assert v0 == float(A[tuple(reversed(idx))])
    assert v0 == float(A[tuple(sorted(idx))])
    label = comb.class_label(comb.class_of_index(idx))
    assert v0 in A[label].reshape(-1).tolist()
    return v0


def arange_flat(rank, dim):
    return stt.FlatSymmetricTensor(
        rank=rank, dim=dim,
        data=torch.arange(comb.indep_size(rank, dim), dtype=torch.float64))


@given(rank=st_.integers(1, 6), dim=st_.integers(1, 10), data=st_.data())
@fuzz(40)
def test_element_class_consistency(rank, dim, data):
    idx = tuple(data.draw(st_.lists(st_.integers(0, dim - 1),
                                    min_size=rank, max_size=rank)))
    check_element_class(arange_flat(rank, dim), idx)


@pytest.mark.parametrize("rank,dim,idx", [
    (1, 4, (3,)), (3, 5, (4, 0, 4)), (4, 6, (5, 1, 3, 1)),
    (6, 3, (2, 0, 1, 1, 2, 0))])
def test_element_class_consistency_matches_jax(rank, dim, idx):
    A = arange_flat(rank, dim)
    Aj = st.FlatSymmetricTensor(rank=rank, dim=dim, data=jnp.arange(
        comb.indep_size(rank, dim), dtype=jnp.float64))
    assert check_element_class(A, idx) == float(Aj[idx])
    label = comb.class_label(comb.class_of_index(idx))
    np.testing.assert_array_equal(A[label].numpy(), np.asarray(Aj[label]))


# ------------------------------------------------------- 3. colex rank/unrank


@given(rank=st_.integers(1, 5), dim=st_.integers(1, 8),
       seed=st_.integers(0, 2**31 - 1))
@fuzz(30)
def test_colex_rank_unrank(rank, dim, seed):
    idx = tuple(int(i) for i in sorted(
        np.random.default_rng(seed).integers(0, dim, size=rank)))
    assert comb.colex_unrank(comb.colex_rank(idx), rank) == idx


@pytest.mark.parametrize("rank,dim", [(1, 6), (3, 5), (5, 4)])
def test_colex_rank_unrank_matches_jax(rank, dim):
    sets = comb.multisets_colex(dim, rank)
    np.testing.assert_array_equal(sets, jax_comb.multisets_colex(dim, rank))
    ranks = [comb.colex_rank(tuple(s)) for s in sets]
    assert ranks == list(range(len(sets)))
    assert ranks == [jax_comb.colex_rank(tuple(s)) for s in sets]
    assert all(comb.colex_unrank(r, rank) == jax_comb.colex_unrank(r, rank)
               for r in ranks)


# ----------------------------------------- 4. basis change at dim_out ≠ dim

# the basis change's routes: whole-level (the default at these sizes), the
# blocked route under small budgets (several row chunks and windows), and
# on-the-fly ranking of the insert tables
BASIS_ROUTES = {
    "whole-level": ({}, "whole-level"),
    "blocked": ({"block_elems": 17, "transient_elems": 23}, "blocked"),
    "on the fly": ({"onthefly_above": 0}, "blocked"),
}


def basis_change_all_routes(dense, W):
    """{(format, route): C.todense()} of the basis change of `dense` by W,
    each route checked to have run."""
    out = {}
    A = flat(dense)
    for fmt, T in (("flat", A), ("permcls", A.topermcls())):
        for name, (kw, route) in BASIS_ROUTES.items():
            C = symalg.contract_all_indices_with_matrix(T, torch.from_numpy(W), **kw)
            assert bc.last_call["route"] == route
            assert C.format == fmt and C.dim == W.shape[1]
            out[fmt, name] = C.todense().numpy()
    return out


@given(rank=st_.integers(2, 4), dim=st_.integers(2, 5),
       dim_out=st_.integers(1, 5), seed=st_.integers(0, 2**31 - 1))
@fuzz(10)
def test_basis_change_oracle_fuzz(rank, dim, dim_out, seed):
    rng = np.random.default_rng(seed)
    dense = random_sym_dense(rank, dim, rng)
    W = rng.normal(size=(dim, dim_out))
    oracle = dense_chain(dense, W)
    for key, got in basis_change_all_routes(dense, W).items():
        np.testing.assert_allclose(got, oracle, atol=1e-9, err_msg=str(key))


@pytest.mark.parametrize("rank,dim,dim_out", [(2, 4, 3), (3, 3, 5), (4, 4, 2)])
def test_basis_change_matches_jax(rank, dim, dim_out):
    rng = np.random.default_rng([rank, dim, dim_out])
    dense = random_sym_dense(rank, dim, rng)
    W = rng.normal(size=(dim, dim_out))
    want = np.asarray(st.symalg.contract_all_indices_with_matrix(
        st.FlatSymmetricTensor.from_dense(jnp.asarray(dense)),
        jnp.asarray(W)).todense())
    np.testing.assert_allclose(want, dense_chain(dense, W), atol=1e-9)
    for key, got in basis_change_all_routes(dense, W).items():
        np.testing.assert_allclose(got, want, atol=1e-9, err_msg=str(key))


# -------------------------------------------------------------- 5. evaluation


def evaluate_all_routes(dense, x, xs):
    """The single-input contraction (the group pass's twin at rank ≥ 3) and
    {route: batched contraction} through the fold, the premultiplied views
    and, where the tensor is eligible, the cell GEMMs."""
    A = flat(dense)
    single = float(symalg.contract_all_indices_with_vector(A, torch.from_numpy(x)))
    xs_t = torch.from_numpy(xs)
    batched = {"fold": symalg.contract_all_indices_with_vector_batched(A, xs_t)}
    r, d = A.rank, A.dim
    if r >= 3:
        P = flat(dense)
        batched["premul"] = tpe.views_eval_batched_premul(tpe.group_views_premul(P), xs_t)
        from symtensor_tpu_torch.kernels.cell_gemm import cell_eligible

        if cell_eligible(r, d):
            with pytest.MonkeyPatch.context() as mp:
                mp.setenv("SYMTENSOR_BATCHED_CELL", "1")
                batched["cell"] = symalg.contract_all_indices_with_vector_batched(A, xs_t)
    return single, {k: v.numpy() for k, v in batched.items()}


@given(rank=st_.integers(1, 5), dim=st_.integers(1, 6),
       seed=st_.integers(0, 2**31 - 1))
@fuzz(10)
def test_poly_eval_oracle_fuzz(rank, dim, seed):
    rng = np.random.default_rng(seed)
    dense = random_sym_dense(rank, dim, rng)
    x, xs = rng.normal(size=dim), rng.normal(size=(5, dim))
    single, batched = evaluate_all_routes(dense, x, xs)
    np.testing.assert_allclose(single, float(dense_chain(dense, x)),
                               rtol=1e-8, atol=1e-8)
    oracle = np.array([dense_chain(dense, xi) for xi in xs])
    for route, got in batched.items():
        assert nerr(got, oracle) <= 1e-10, route


@pytest.mark.parametrize("rank,dim", [(1, 4), (3, 5), (4, 3), (5, 4)])
def test_poly_eval_matches_jax(rank, dim):
    rng = np.random.default_rng([5, rank, dim])
    dense = random_sym_dense(rank, dim, rng)
    x, xs = rng.normal(size=dim), rng.normal(size=(5, dim))
    Aj = st.FlatSymmetricTensor.from_dense(jnp.asarray(dense))
    want = float(st.symalg.contract_all_indices_with_vector(Aj, jnp.asarray(x)))
    want_b = np.asarray(st.symalg.contract_all_indices_with_vector_batched(
        Aj, jnp.asarray(xs)))
    single, batched = evaluate_all_routes(dense, x, xs)
    np.testing.assert_allclose(single, want, rtol=1e-10, atol=1e-12)
    for route, got in batched.items():
        assert nerr(got, want_b) <= 1e-10, route


# ----------------------------------------------------- 6. symmetric_outer


def outer_both_routes(da, db):
    """{route: symmetrized outer product, dense}: the table route (the
    gather kernel's twin here) and the streamed route over blocks of a few
    elements."""
    A, B = flat(da), flat(db)
    out = {"table": symalg.symmetric_outer(A, B, "multiply", stream=False)}
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("SYMTENSOR_STREAM_BLOCK_ELEMS", "7")
        out["streamed"] = symalg.symmetric_outer(A, B, "multiply", stream=True)
    assert symalg.multiply.outer(A, B).allclose(out["table"])
    return {k: v.todense().numpy() for k, v in out.items()}


@given(ra=st_.integers(1, 3), rb=st_.integers(1, 3), dim=st_.integers(2, 4),
       seed=st_.integers(0, 2**31 - 1))
@fuzz(8)
def test_symmetric_outer_oracle_fuzz(ra, rb, dim, seed):
    rng = np.random.default_rng(seed)
    da, db = random_sym_dense(ra, dim, rng), random_sym_dense(rb, dim, rng)
    oracle = np_symmetrize(np.multiply.outer(da, db))
    for route, got in outer_both_routes(da, db).items():
        np.testing.assert_allclose(got, oracle, atol=1e-10, err_msg=route)


@pytest.mark.parametrize("ra,rb,dim", [(1, 2, 4), (2, 2, 3), (3, 2, 3)])
def test_symmetric_outer_matches_jax(ra, rb, dim):
    rng = np.random.default_rng([6, ra, rb, dim])
    da, db = random_sym_dense(ra, dim, rng), random_sym_dense(rb, dim, rng)
    want = np.asarray(st.symalg.multiply.outer(
        st.FlatSymmetricTensor.from_dense(jnp.asarray(da)),
        st.FlatSymmetricTensor.from_dense(jnp.asarray(db))).todense())
    for route, got in outer_both_routes(da, db).items():
        np.testing.assert_allclose(got, want, atol=1e-10, err_msg=route)


# ------------------------------------------- 7. power sum / monomial identity


def newton_sides(x: np.ndarray):
    """(2·m_(1,1)(x) + m_(2)(x), p_1(x)²)."""
    xt = torch.from_numpy(x)
    m11 = float(symalg.monomial_symmetric((1, 1), xt)) if len(x) >= 2 else 0.0
    m2 = float(symalg.monomial_symmetric((2,), xt))
    return 2 * m11 + m2, float(x.sum()) ** 2


@given(dim=st_.integers(1, 20), seed=st_.integers(0, 2**31 - 1))
@fuzz(30)
def test_power_sum_monomial_identity(dim, seed):
    lhs, rhs = newton_sides(np.random.default_rng(seed).normal(size=dim))
    np.testing.assert_allclose(lhs, rhs, rtol=1e-9, atol=1e-9)


@pytest.mark.parametrize("dim", [2, 7, 20])
def test_monomials_match_jax(dim):
    x = np.random.default_rng([7, dim]).normal(size=dim)
    lhs, rhs = newton_sides(x)
    np.testing.assert_allclose(lhs, rhs, rtol=1e-9, atol=1e-9)
    for counts in ((2,), (1, 1), (3, 1), (2, 2), (2, 1, 1)):
        if len(counts) > dim:
            continue
        got = float(symalg.monomial_symmetric(counts, torch.from_numpy(x)))
        want = float(st.symalg.monomial_symmetric(counts, jnp.asarray(x)))
        np.testing.assert_allclose(got, want, rtol=1e-12, atol=1e-12)
        # m_λ(x) by its definition: the sum of ∏ x^λ over the distinct
        # assignments of λ's parts to distinct coordinates
        distinct = {tuple(sorted(zip(p, counts)))
                    for p in itertools.permutations(range(dim), len(counts))}
        direct = sum(math.prod(x[i] ** c for i, c in a) for a in distinct)
        np.testing.assert_allclose(got, direct, rtol=1e-10, atol=1e-12)
