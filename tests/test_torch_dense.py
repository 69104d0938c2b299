"""The port's DenseSymmetricTensor against the JAX package's, on the CPU,
on the same float64 inputs."""

import itertools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import symtensor_tpu as st
import symtensor_tpu_torch as stt
from symtensor_tpu.ops.symmetrize import symmetrize as jsym
from symtensor_tpu_torch.config import config
from symtensor_tpu_torch.interop import dense_from_numpy, dense_to_numpy

SHAPES = [(0, 1), (1, 4), (2, 3), (3, 4), (4, 3)]


@pytest.fixture(autouse=True)
def _cpu_default_device(monkeypatch):
    """This file builds tensors without naming a device: ask for the CPU."""
    monkeypatch.setattr(config, "default_device", "cpu")


def _pair(rank, dim, seed):
    rng = np.random.default_rng(seed)
    dense = np.array(jsym(rng.normal(size=(dim,) * rank))) if rank else np.asarray(rng.normal())
    return st.DenseSymmetricTensor(data=jnp.asarray(dense)), dense_from_numpy(dense, device="cpu")


@pytest.mark.parametrize("rank,dim", SHAPES)
def test_construction_and_conversions_match_jax(rank, dim):
    Dj, Dt = _pair(rank, dim, 10 + rank)
    assert (Dt.rank, Dt.dim, Dt.size, Dt.format) == (Dj.rank, Dj.dim, Dj.size, Dj.format)
    assert Dt.dtype == torch.float64 and Dt.device == torch.device("cpu")
    np.testing.assert_array_equal(dense_to_numpy(Dt), np.asarray(Dj.data))
    np.testing.assert_array_equal(Dt.toflat().data.numpy(), np.asarray(Dj.toflat().data))
    P = Dt.topermcls()
    assert isinstance(P, stt.PermClsSymmetricTensor)
    for k, v in Dj.topermcls().data.items():
        np.testing.assert_array_equal(P.data[k].numpy(), np.asarray(v))
    if rank:
        assert Dt.astype(torch.float32).dtype == torch.float32
        assert list(Dt.flat) == list(np.asarray(Dj.data).reshape(-1))
        assert list(Dt.flat_index) == list(Dj.flat_index)
        for cls in Dt.perm_classes:
            np.testing.assert_array_equal(Dt.class_values(cls).numpy(),
                                          np.asarray(Dj.class_values(cls)))


def test_symmetry_check_and_projection():
    raw = np.random.default_rng(1).normal(size=(3, 3, 3))
    for lib, m in ((torch, stt), (jnp, st)):
        with pytest.raises(ValueError, match="not symmetric"):
            m.DenseSymmetricTensor(data=lib.asarray(raw))
    got = stt.DenseSymmetricTensor(data=torch.from_numpy(raw), symmetrize=True)
    want = st.DenseSymmetricTensor(data=jnp.asarray(raw), symmetrize=True)
    np.testing.assert_allclose(got.data.numpy(), np.asarray(want.data), rtol=1e-12)
    unchecked = stt.DenseSymmetricTensor(data=torch.from_numpy(raw), check=False)
    torch.testing.assert_close(unchecked.data, torch.from_numpy(raw), rtol=0, atol=0)
    assert stt.DenseSymmetricTensor.from_dense(got.data).allclose(got)


BAD = {
    "no rank": lambda m, lib: m.DenseSymmetricTensor(dim=3),
    "rank mismatch": lambda m, lib: m.DenseSymmetricTensor(rank=3, data=lib.zeros((3, 3))),
    "not hypercubic": lambda m, lib: m.DenseSymmetricTensor(data=lib.zeros((3, 4))),
    "dim mismatch": lambda m, lib: m.DenseSymmetricTensor(dim=4, data=lib.zeros((3, 3))),
    "index out of range": lambda m, lib: m.DenseSymmetricTensor.zeros(2, 3)[(0, 3)],
    "zeros past the guard": lambda m, lib: m.DenseSymmetricTensor.zeros(6, 30),
}


@pytest.mark.parametrize("case", sorted(BAD))
def test_bad_input_raises_as_in_jax(case):
    with pytest.raises(Exception) as ej:
        BAD[case](st, jnp)
    with pytest.raises(Exception) as et:
        BAD[case](stt, torch)
    assert type(et.value) is type(ej.value), (ej.value, et.value)
    if case == "zeros past the guard":
        assert str(et.value) == str(ej.value)


@pytest.mark.parametrize("rank,dim", SHAPES[1:])
def test_updates_and_indexing_match_jax(rank, dim):
    Dj, Dt = _pair(rank, dim, 20 + rank)
    for idx in itertools.islice(itertools.product(range(dim), repeat=rank), 50):
        assert float(Dt[idx]) == float(Dj[idx])
        got, want = Dt.at[idx].set(3.5), Dj.at[idx].set(3.5)
        assert isinstance(got, stt.DenseSymmetricTensor)
        np.testing.assert_allclose(got.data.numpy(), np.asarray(want.data), rtol=1e-12)
    for cls in Dt.perm_classes:
        got, want = Dt.at[cls].add(1.0), Dj.at[cls].add(1.0)
        np.testing.assert_allclose(got.data.numpy(), np.asarray(want.data), rtol=1e-12)
    if rank >= 2:
        sub = Dt[dim - 1]
        assert isinstance(sub, stt.DenseSymmetricTensor) and sub.rank == rank - 1
        np.testing.assert_array_equal(sub.data.numpy(), np.asarray(Dj[dim - 1].data))


@pytest.mark.parametrize("rank,dim", SHAPES)
def test_evaluation_matches_jax(rank, dim):
    Dj, Dt = _pair(rank, dim, 30 + rank)
    rng = np.random.default_rng(rank)
    x, xs = rng.normal(size=dim), rng.normal(size=(5, dim))
    got = stt.symalg.contract_all_indices_with_vector(Dt, torch.from_numpy(x))
    assert got.shape == () and got.dtype == torch.float64
    np.testing.assert_allclose(
        float(got), float(st.symalg.contract_all_indices_with_vector(Dj, jnp.asarray(x))),
        rtol=1e-10,
    )
    np.testing.assert_allclose(
        float(stt.symalg.contract_all_indices_with_vector(Dt.toflat(), torch.from_numpy(x))),
        float(got), rtol=1e-10,
    )
    got_b = stt.symalg.contract_all_indices_with_vector_batched(Dt, torch.from_numpy(xs))
    assert got_b.shape == (5,)
    np.testing.assert_allclose(
        got_b.numpy(),
        np.asarray(st.symalg.contract_all_indices_with_vector_batched(Dj, jnp.asarray(xs))),
        rtol=1e-10,
    )


def test_default_device_and_explicit_device(monkeypatch):
    D = stt.DenseSymmetricTensor.zeros(2, 3)
    assert D.device == torch.device("cpu") and D.dtype == torch.float32
    assert stt.DenseSymmetricTensor(data=np.eye(3)).device == torch.device("cpu")
    assert stt.DenseSymmetricTensor.zeros(2, 3, device="meta").device.type == "meta"
    monkeypatch.setattr(config, "default_device", "cuda")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="config.default_device"):
        stt.DenseSymmetricTensor.zeros(2, 3)
    with pytest.raises(RuntimeError, match="config.default_device"):
        stt.PermClsSymmetricTensor(2, 3)
    assert stt.DenseSymmetricTensor(data=torch.eye(3)).device == torch.device("cpu")
