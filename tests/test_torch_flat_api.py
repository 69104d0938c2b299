"""The rest of the port's flat API against the JAX package's, on the CPU:
partial indexing and the lazy slice view, ``at[...].set/add``, the
iterators and ``keys``/``values``/``items``."""

import itertools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import symtensor_tpu as st
import symtensor_tpu_torch as stt
from symtensor_tpu_torch.config import config
from symtensor_tpu_torch.interop import flat_from_numpy
from symtensor_tpu_torch.utils import combinatorics as comb

SHAPES = [(2, 4), (3, 4), (4, 3), (5, 3)]


@pytest.fixture(autouse=True)
def _cpu_default_device(monkeypatch):
    """This file builds tensors without naming a device: ask for the CPU."""
    monkeypatch.setattr(config, "default_device", "cpu")


def _pair(rank, dim, seed):
    data = np.random.default_rng(seed).normal(size=comb.indep_size(rank, dim))
    return (st.FlatSymmetricTensor(rank, dim, jnp.asarray(data)),
            flat_from_numpy(rank, dim, data, device="cpu"))


def _same(got, want):
    np.testing.assert_array_equal(got.toflat().data.numpy(), np.asarray(want.toflat().data))


@pytest.mark.parametrize("rank,dim", SHAPES)
def test_partial_indexing_is_a_lazy_view_matching_jax(rank, dim):
    Aj, At = _pair(rank, dim, rank)
    for k in range(1, rank):
        for idx in itertools.islice(itertools.product(range(dim), repeat=k), 12):
            sub_t, sub_j = At[idx], Aj[idx]
            assert isinstance(sub_t, stt.FlatSymmetricTensorSlice)
            assert (sub_t.rank, sub_t.fixed, sub_t.parent) == (rank - k, idx, At)
            assert "lazy=True" in repr(sub_t)
            # one element reads the parent, no gather
            tail = (0,) * (rank - k)
            assert float(sub_t[tail]) == float(sub_j[tail])
            assert "lazy=True" in repr(sub_t)
            _same(sub_t, sub_j)
            assert "lazy=False" in repr(sub_t)
            np.testing.assert_array_equal(sub_t.todense().numpy(), np.asarray(sub_j.todense()))
    # trailing full slices are ignored; deeper views stay views
    _same(At[(1,) + (slice(None),) * (rank - 1)], Aj[1])
    if rank >= 3:
        deeper = At[1][0]
        assert isinstance(deeper, stt.FlatSymmetricTensorSlice) and deeper.fixed == (1, 0)
        _same(deeper, Aj[1, 0])
    # elementwise ops on a view give plain flat tensors
    doubled = At[1] * 2.0
    assert type(doubled) is stt.FlatSymmetricTensor
    _same(doubled, Aj[1] * 2.0)
    assert At[1].to("cpu").device == torch.device("cpu")
    assert At[1].astype(torch.float32).dtype == torch.float32


def test_bad_slices_raise_as_in_jax():
    Aj, At = _pair(3, 3, 9)
    for key in [(slice(None), 0), (0, slice(1, 2)), (0, 0, 0, 0)]:
        with pytest.raises(IndexError):
            Aj[key]
        with pytest.raises(IndexError):
            At[key]
    assert At[...] is At and At[:] is At


@pytest.mark.parametrize("rank,dim", SHAPES)
def test_functional_updates_match_jax(rank, dim):
    Aj, At = _pair(rank, dim, 10 + rank)
    before = At.data.clone()
    for cls in At.perm_classes:
        counts = comb.as_class_counts(cls)
        s = comb.class_size(counts, dim)
        if not s:
            continue
        vec = np.arange(s, dtype=np.float64)
        _same(At.at[cls].set(torch.from_numpy(vec)), Aj.at[cls].set(jnp.asarray(vec)))
        _same(At.at[cls].set(2.5), Aj.at[cls].set(2.5))
        _same(At.at[cls].add(1.0), Aj.at[cls].add(1.0))
        _same(At.set_class(counts, -1.0), Aj.set_class(counts, -1.0))
    for idx in itertools.islice(itertools.product(range(dim), repeat=rank), 30):
        _same(At.at[idx].set(7.0), Aj.at[idx].set(7.0))
        _same(At.at[idx].add(0.5), Aj.at[idx].add(0.5))
    # a negative index wraps; the parent is never changed in place
    _same(At.at[(-1,) * rank].set(1.0), Aj.at[(-1,) * rank].set(1.0))
    torch.testing.assert_close(At.data, before, rtol=0, atol=0)
    # views materialize, then update
    _same(At[0].at[(0,) * (rank - 1)].set(4.0), Aj[0].at[(0,) * (rank - 1)].set(4.0))
    _same(At[0].set_class(At[0].perm_classes[0], 4.0),
          Aj[0].set_class(Aj[0].perm_classes[0], 4.0))


def test_update_errors_match_jax():
    Aj, At = _pair(3, 3, 20)
    for key in [(0, 1), Ellipsis, 1.5]:
        with pytest.raises(IndexError) as ej:
            Aj.at[key].set(1.0)
        with pytest.raises(IndexError) as et:
            At.at[key].set(1.0)
        assert str(et.value) == str(ej.value)


def test_rank0_updates():
    A = stt.FlatSymmetricTensor(0, 1, torch.tensor([1.0], dtype=torch.float64))
    assert float(A.set_class((), 3.0).data[0]) == 3.0
    assert float(A.at[()].set(4.0).data[0]) == 4.0
    assert float(A.set_element((), 5.0).data[0]) == 5.0


@pytest.mark.parametrize("rank,dim", SHAPES)
def test_iterators_match_jax(rank, dim):
    Aj, At = _pair(rank, dim, 30 + rank)
    assert list(At.indep_iter()) == list(Aj.indep_iter())
    assert list(At.indep_iter_repindex()) == list(Aj.indep_iter_repindex())
    for got, want in zip(At.indep_iter_index(), Aj.indep_iter_index()):
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g, w)
    assert list(At.permcls_indep_iter()) == list(Aj.permcls_indep_iter())
    assert list(At.permcls_indep_iter_repindex()) == list(Aj.permcls_indep_iter_repindex())
    for cls in At.perm_classes:
        assert list(At.permcls_indep_iter(cls)) == list(Aj.permcls_indep_iter(cls))
        assert (list(At.permcls_indep_iter_repindex(cls))
                == list(Aj.permcls_indep_iter_repindex(cls)))
    assert list(At.permcls_multiplicity_iter()) == list(Aj.permcls_multiplicity_iter())
    assert list(At.flat) == list(Aj.flat)
    assert list(At.flat_index) == list(Aj.flat_index)
    assert len(list(At)) == dim
    for sub_t, sub_j in zip(At, Aj):
        _same(sub_t, sub_j)


def test_storage_views_and_misc_match_jax():
    Aj, At = _pair(3, 4, 40)
    assert list(At.keys()) == list(Aj.keys()) == [()]
    (vt,), (vj,) = list(At.values()), list(Aj.values())
    np.testing.assert_array_equal(vt.numpy(), np.asarray(vj))
    assert [k for k, _ in At.items()] == [()]
    assert At.memory_footprint() == Aj.memory_footprint() == 20 * 8
    assert At.data_alignment == Aj.data_alignment == "flat"
    assert At.T is At and At.transpose(2, 0, 1) is At
    C = At.copy()
    assert C is not At and torch.equal(C.data, At.data)
    C.data[0] = 99.0  # the copy owns its storage
    assert float(At.data[0]) == float(Aj.data[0]) != 99.0
    Pj, Pt = Aj.topermcls(), At.topermcls()
    assert isinstance(Pt, stt.PermClsSymmetricTensor)
    assert list(Pt.keys()) == list(Pj.keys())
    assert Pt.memory_footprint() == Pj.memory_footprint()
    assert Pt.data_alignment == "permcls"


def test_copy_owns_its_storage_in_every_format():
    """torch tensors are mutable: an in-place write into a copy's data
    leaves the original unchanged, for a slice view and for a permcls
    tensor whose scalar classes share one 0-d tensor."""
    _, At = _pair(3, 4, 41)
    S = At[1]
    C = S.copy()
    assert type(C) is stt.FlatSymmetricTensor
    C.data.mul_(0)
    assert float(S.data.abs().sum()) > 0
    P = stt.PermClsSymmetricTensor(3, 4, 2.0, dtype=torch.float64)
    Q = P.copy()
    next(iter(Q.data.values())).fill_(5.0)
    assert all(float(v) == 2.0 for v in P.data.values())
    assert sorted(float(v) for v in Q.data.values()).count(2.0) == len(Q.data) - 1
    D = stt.DenseSymmetricTensor(data=At.todense())
    E = D.copy()
    E.data.zero_()
    assert torch.equal(D.data, At.todense())


def test_bfloat16_iterators_go_through_float32():
    A = stt.FlatSymmetricTensor(2, 2, torch.tensor([1.0, 2.0, 3.0], dtype=torch.bfloat16))
    assert [float(v) for v in A.indep_iter()] == [1.0, 2.0, 3.0]
    assert [float(v) for v in A.flat] == [1.0, 2.0, 2.0, 3.0]
