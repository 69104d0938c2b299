"""The port's PermClsSymmetricTensor and its power-sum evaluation against
the JAX package's, on the CPU, on the same float64 inputs."""

import itertools
import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import symtensor_tpu as st
import symtensor_tpu_torch as stt
from symtensor_tpu_torch.config import config
from symtensor_tpu_torch.interop import permcls_from_numpy, permcls_to_numpy
from symtensor_tpu_torch.utils import combinatorics as comb
from symtensor_tpu_torch.utils.tables import Tables

SHAPES = [(2, 3), (3, 4), (4, 3), (6, 5)]
# BASELINE C3's classes (benchmarks/run_configs.py:81-83)
C3_CLASSES = {"iiiiii": 0.5, "iijjkk": -0.25, "ijklmn": 2.0}


@pytest.fixture(autouse=True)
def _cpu_default_device(monkeypatch):
    """This file builds tensors without naming a device: ask for the CPU."""
    monkeypatch.setattr(config, "default_device", "cpu")


def _classes(rank, dim, seed, scalar_every=2):
    """Per-class float64 NumPy data: every `scalar_every`-th class a
    scalar, the others vectors."""
    rng = np.random.default_rng(seed)
    keys = [c for c in comb.perm_classes(rank) if comb.class_size(c, dim)]
    return {
        k: (np.asarray(rng.normal()) if i % scalar_every == 0
            else rng.normal(size=comb.class_size(k, dim)))
        for i, k in enumerate(keys)
    }


def _pair(rank, dim, seed, scalar_every=2):
    data = _classes(rank, dim, seed, scalar_every)
    Aj = st.PermClsSymmetricTensor(
        rank, dim, {k: jnp.asarray(v) for k, v in data.items()}, dtype=jnp.float64
    )
    At = permcls_from_numpy(rank, dim, data, device="cpu")
    return Aj, At


def _same_leaves(At, Aj):
    assert isinstance(At, stt.PermClsSymmetricTensor)
    assert list(At.keys()) == list(Aj.keys())
    assert At.scalar_classes == Aj.scalar_classes
    for k, v in permcls_to_numpy(At).items():
        np.testing.assert_allclose(v, np.asarray(Aj.data[k]), rtol=1e-12, atol=1e-14)


def _same_flat(At, Aj):
    np.testing.assert_allclose(
        At.toflat().data.numpy(), np.asarray(Aj.toflat().data), rtol=1e-12, atol=1e-14
    )


@pytest.mark.parametrize("rank,dim", SHAPES)
def test_constructor_forms_match_jax(rank, dim):
    f64 = torch.float64
    _same_leaves(stt.PermClsSymmetricTensor(rank, dim, dtype=f64),
                 st.PermClsSymmetricTensor(rank, dim, dtype=jnp.float64))
    _same_leaves(stt.PermClsSymmetricTensor(rank, dim, 1.5, dtype=f64),
                 st.PermClsSymmetricTensor(rank, dim, 1.5, dtype=jnp.float64))
    Aj, At = _pair(rank, dim, rank * 10 + dim)
    _same_leaves(At, Aj)
    _same_flat(At, Aj)
    # labels as keys, missing classes default to 0
    first = next(iter(Aj.data))
    label = comb.class_label(first)
    _same_leaves(stt.PermClsSymmetricTensor(rank, dim, {label: 2.0}, dtype=f64),
                 st.PermClsSymmetricTensor(rank, dim, {label: 2.0}, dtype=jnp.float64))
    # a dense array, with and without rank and dim
    dense = np.array(Aj.todense())
    for args in ((rank, dim, dense), (None, None, dense)):
        got = stt.PermClsSymmetricTensor(*args[:2], torch.from_numpy(dense), dtype=f64)
        _same_leaves(got, st.PermClsSymmetricTensor(*args[:2], jnp.asarray(dense),
                                                    dtype=jnp.float64))
    # the default dtype, as the JAX package's
    assert stt.PermClsSymmetricTensor(rank, dim, {label: 2.0}).dtype == torch.float32


@pytest.mark.parametrize("rank,dim", SHAPES)
def test_expand_compress_and_round_trips_match_jax(rank, dim):
    Aj, At = _pair(rank, dim, 200 + rank)
    Ej, Et = Aj.expand(), At.expand()
    _same_leaves(Et, Ej)
    assert Et.scalar_classes == ()
    _same_leaves(Et.compress(), Ej.compress())
    assert Et.compress().scalar_classes == At.scalar_classes
    one = next(k for k in Aj.data if Aj.data[k].ndim == 0)
    _same_leaves(At.expand(one), Aj.expand(one))
    _same_leaves(At.expand().compress(one), Aj.expand().compress(one))
    # flat → permcls → flat, and permcls → flat → permcls
    flat = At.toflat()
    assert isinstance(flat, stt.FlatSymmetricTensor)
    _same_leaves(flat.topermcls(), Aj.toflat().topermcls())
    torch.testing.assert_close(flat.topermcls().toflat().data, flat.data, rtol=0, atol=0)
    _same_leaves(stt.PermClsSymmetricTensor.from_flat(flat), Aj.expand())
    assert At.topermcls() is At
    np.testing.assert_allclose(At.todense().numpy(), np.asarray(Aj.todense()),
                               rtol=1e-12, atol=1e-14)


def test_toflat_covers_every_position_once():
    """The classes' positions partition the packed positions, so a scatter
    of each class's ids leaves no zero and no overlap."""
    rank, dim = 4, 5
    keys = [c for c in comb.perm_classes(rank) if comb.class_size(c, dim)]
    A = stt.PermClsSymmetricTensor(
        rank, dim, {k: float(i + 1) for i, k in enumerate(keys)}, dtype=torch.float64
    )
    flat = A.toflat().data
    counts = torch.bincount(flat.long(), minlength=len(keys) + 1)
    assert int(counts[0]) == 0
    assert [int(c) for c in counts[1:]] == [comb.class_size(k, dim) for k in keys]


@pytest.mark.parametrize("rank,dim", SHAPES)
def test_element_and_partial_match_jax(rank, dim):
    Aj, At = _pair(rank, dim, 300 + rank)
    for idx in itertools.islice(itertools.product(range(dim), repeat=rank), 200):
        assert float(At.element(idx)) == float(Aj.element(idx))
        assert float(At[idx]) == float(Aj[idx])
    for label in At.perm_classes:
        if comb.class_size(comb.as_class_counts(label), dim):
            np.testing.assert_array_equal(At[label].numpy(), np.asarray(Aj[label]))
    sub_t, sub_j = At[dim - 1], Aj[dim - 1]
    assert isinstance(sub_t, stt.PermClsSymmetricTensor)
    _same_leaves(sub_t, sub_j)


@pytest.mark.parametrize("rank,dim", SHAPES)
def test_set_class_and_set_element_match_jax(rank, dim):
    Aj, At = _pair(rank, dim, 400 + rank)
    rng = np.random.default_rng(rank)
    for k in list(Aj.data)[:3]:
        s = comb.class_size(k, dim)
        vec = rng.normal(size=s)
        _same_leaves(At.set_class(k, torch.from_numpy(vec)), Aj.set_class(k, jnp.asarray(vec)))
        _same_leaves(At.set_class(k, 0.75), Aj.set_class(k, 0.75))
        _same_leaves(At.at[comb.class_label(k)].add(1.0), Aj.at[comb.class_label(k)].add(1.0))
    for idx in [(0,) * rank, tuple(range(min(rank, dim))) + (0,) * max(0, rank - dim),
                tuple(dim - 1 - (i % dim) for i in range(rank))]:
        got, want = At.set_element(idx, 9.0), Aj.set_element(idx, 9.0)
        _same_leaves(got, want)  # a scalar class expands on write
        _same_flat(At.at[idx].add(-2.0), Aj.at[idx].add(-2.0))
    with pytest.raises(KeyError):
        At.set_class((rank + 1,), 1.0)
    with pytest.raises(ValueError):
        At.set_class(next(iter(At.data)), torch.zeros(comb.indep_size(rank, dim) + 1))


def test_bad_input_raises_as_in_jax():
    cases = [
        lambda m, lib: m.PermClsSymmetricTensor(rank=2),
        lambda m, lib: m.PermClsSymmetricTensor(2, 3, {"iii": 1.0}),
        lambda m, lib: m.PermClsSymmetricTensor(2, 3, {"ij": lib.zeros(4)}),
        lambda m, lib: m.PermClsSymmetricTensor(2, 3, lib.zeros((3, 4))),
        lambda m, lib: m.PermClsSymmetricTensor(3, 2).class_values("ijk"),
        lambda m, lib: m.PermClsSymmetricTensor(3, 2).class_values("ij"),
    ]
    for case in cases:
        with pytest.raises(Exception) as ej:
            case(st, jnp)
        with pytest.raises(Exception) as et:
            case(stt, torch)
        assert type(et.value) is type(ej.value), (ej.value, et.value)


def test_leaves_share_one_device():
    A = stt.PermClsSymmetricTensor(2, 3, {"ii": torch.ones(3), "ij": 2.0})
    assert {v.device.type for v in A.values()} == {"cpu"}
    assert A.device == torch.device("cpu")
    with pytest.raises(ValueError, match="more than one device"):
        stt.PermClsSymmetricTensor(
            2, 3, {"ii": torch.ones(3), "ij": torch.ones(3, device="meta")}
        )
    B = stt.PermClsSymmetricTensor(2, 3, {"ii": torch.ones(3)}, device="meta")
    assert {v.device.type for v in B.values()} == {"meta"}
    assert A.to("meta").device.type == "meta"


def test_memory_footprint_counts_stored_leaves():
    A = stt.PermClsSymmetricTensor(3, 4, {"iij": torch.ones(12, dtype=torch.float64)},
                                   dtype=torch.float64)
    assert A.memory_footprint() == (1 + 12 + 1) * 8
    Aj = st.PermClsSymmetricTensor(3, 4, {"iij": jnp.ones(12)}, dtype=jnp.float64)
    assert A.memory_footprint() == Aj.memory_footprint()


# ------------------------------------------------------------- evaluation


@pytest.mark.parametrize("counts", [(1,), (2,), (1, 1), (3, 2, 1), (2, 2, 2),
                                    (1,) * 6, (6,), (4, 1, 1)])
@pytest.mark.parametrize("dim", [8, 200])
def test_power_sums_and_monomials_match_jax(counts, dim):
    x = np.random.default_rng(dim).normal(size=dim)
    r = sum(counts)
    want = st.symalg.power_sums(jnp.asarray(x), r)
    got = stt.symalg.power_sums(torch.from_numpy(x), r)
    for k in range(1, r + 1):
        np.testing.assert_allclose(float(got[k]), float(want[k]), rtol=1e-12)
    np.testing.assert_allclose(
        float(stt.symalg.monomial_symmetric(counts, torch.from_numpy(x))),
        float(st.symalg.monomial_symmetric(counts, jnp.asarray(x))), rtol=1e-10,
    )


def test_monomial_symmetric_by_brute_force():
    x = np.random.default_rng(1).normal(size=5)
    for counts in [(2, 1), (1, 1, 1), (3,), (2, 2)]:
        want = 0.0
        for rep in set(itertools.product(range(5), repeat=len(counts))):
            if len(set(rep)) == len(rep):
                want += np.prod([x[i] ** c for i, c in zip(rep, counts)])
        want /= np.prod([math.factorial(m) for m in
                         np.unique(counts, return_counts=True)[1]])
        got = float(stt.symalg.monomial_symmetric(counts, torch.from_numpy(x)))
        np.testing.assert_allclose(got, want, rtol=1e-12)


@pytest.mark.parametrize("dim", [8, 200])
def test_scalar_class_evaluation_builds_no_table(dim, monkeypatch):
    """BASELINE C3's tensor (rank 6; dim 200 has n·r ≈ 5.7e11 entries)
    evaluates in O(r·d): the tensor's table cache stays empty and rep_np
    is never called."""

    def refuse(self):
        raise AssertionError("rep_np called")

    monkeypatch.setattr(Tables, "rep_np", refuse)
    x = np.random.default_rng(dim + 1).normal(size=dim)
    At = stt.PermClsSymmetricTensor(6, dim, C3_CLASSES, dtype=torch.float64)
    Aj = st.PermClsSymmetricTensor(6, dim, C3_CLASSES, dtype=jnp.float64)
    got = stt.symalg.contract_all_indices_with_vector(At, torch.from_numpy(x))
    want = st.symalg.contract_all_indices_with_vector(Aj, jnp.asarray(x))
    assert got.shape == () and got.dtype == torch.float64
    np.testing.assert_allclose(float(got), float(want), rtol=1e-10)
    xs = np.random.default_rng(dim + 2).normal(size=(3, dim))
    got_b = stt.symalg.contract_all_indices_with_vector_batched(At, torch.from_numpy(xs))
    want_b = st.symalg.contract_all_indices_with_vector_batched(Aj, jnp.asarray(xs))
    np.testing.assert_allclose(got_b.numpy(), np.asarray(want_b), rtol=1e-10)
    assert At.tables._cache == {}


def test_c3_float32_holds_float64_by_normalised_error():
    """The power-sum recursion cancels; float32 stays within 1e-5 of
    float64 by max|Δ| / max|ref| over a batch of inputs."""
    xs = torch.from_numpy(np.random.default_rng(3).normal(size=(16, 200)))
    A64 = stt.PermClsSymmetricTensor(6, 200, C3_CLASSES, dtype=torch.float64)
    A32 = A64.astype(torch.float32)
    ref = stt.symalg.contract_all_indices_with_vector_batched(A64, xs)
    got = stt.symalg.contract_all_indices_with_vector_batched(A32, xs.float())
    assert got.dtype == torch.float32
    err = float((got.double() - ref).abs().max() / ref.abs().max())
    assert err <= 1e-5, err


@pytest.mark.parametrize("rank,dim", [(2, 3), (3, 4), (4, 5), (6, 5)])
@pytest.mark.parametrize("scalar_every", [1, 2, 10**9])
def test_evaluation_matches_jax_and_the_flat_route(rank, dim, scalar_every):
    Aj, At = _pair(rank, dim, 500 + rank, scalar_every)
    rng = np.random.default_rng(rank + dim)
    x, xs = rng.normal(size=dim), rng.normal(size=(4, dim))
    want = float(st.symalg.contract_all_indices_with_vector(Aj, jnp.asarray(x)))
    got = stt.symalg.contract_all_indices_with_vector(At, torch.from_numpy(x))
    np.testing.assert_allclose(float(got), want, rtol=1e-10)
    flat = stt.symalg.contract_all_indices_with_vector(At.toflat(), torch.from_numpy(x))
    np.testing.assert_allclose(float(flat), want, rtol=1e-10)
    np.testing.assert_allclose(
        stt.symalg.contract_all_indices_with_vector_batched(At, torch.from_numpy(xs)).numpy(),
        np.asarray(st.symalg.contract_all_indices_with_vector_batched(Aj, jnp.asarray(xs))),
        rtol=1e-10,
    )


def test_rank0_and_rank1_evaluation_match_jax():
    for rank, dim, data in ((0, 1, {(): 1.25}), (1, 4, {(1,): np.arange(4.0)})):
        Aj = st.PermClsSymmetricTensor(rank, dim, data, dtype=jnp.float64)
        At = stt.PermClsSymmetricTensor(rank, dim, data, dtype=torch.float64)
        x = np.linspace(-1, 1, dim)
        np.testing.assert_allclose(
            float(stt.symalg.contract_all_indices_with_vector(At, x)),
            float(st.symalg.contract_all_indices_with_vector(Aj, jnp.asarray(x))),
            rtol=1e-12,
        )


def test_vector_class_table_guard_raises_in_both_packages(monkeypatch):
    """Vector classes need their positions, built from rep_np (n·r
    entries); under a lowered guard both packages raise MemoryError.
    (rank 5, dim 7: n·r = 2 310; a shape no other test builds tables
    for.)"""
    rank, dim = 5, 7
    data = _classes(rank, dim, 7, scalar_every=10**9)
    x = np.ones(dim)
    monkeypatch.setattr(st.config, "max_table_entries", 2000)
    monkeypatch.setattr(config, "max_table_entries", 2000)
    Aj = st.PermClsSymmetricTensor(
        rank, dim, {k: jnp.asarray(v) for k, v in data.items()}, dtype=jnp.float64)
    At = permcls_from_numpy(rank, dim, data, device="cpu")
    with pytest.raises(MemoryError):
        st.symalg.contract_all_indices_with_vector(Aj, jnp.asarray(x))
    with pytest.raises(MemoryError, match="rep_indices"):
        stt.symalg.contract_all_indices_with_vector(At, torch.from_numpy(x))
    # scalar classes need no table under the same guard
    S = stt.PermClsSymmetricTensor(rank, dim, 1.0, dtype=torch.float64)
    np.testing.assert_allclose(
        float(stt.symalg.contract_all_indices_with_vector(S, torch.from_numpy(x))),
        float(dim) ** rank, rtol=1e-12,
    )
