"""The port's FlatSymmetricTensor against the JAX package's."""

import itertools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import symtensor_tpu as st
import symtensor_tpu_torch as stt
from symtensor_tpu_torch.interop import flat_from_numpy, flat_to_numpy

SHAPES = [(0, 1), (1, 4), (2, 5), (3, 4), (4, 3), (5, 3), (6, 2)]


def _pair(rank, dim, seed):
    rng = np.random.default_rng(seed)
    data = rng.normal(size=st.utils.indep_size(rank, dim))
    Aj = st.FlatSymmetricTensor(rank=rank, dim=dim, data=jnp.asarray(data))
    At = flat_from_numpy(rank, dim, np.asarray(Aj.data), device="cpu")
    return Aj, At


@pytest.mark.parametrize("rank,dim", SHAPES)
def test_carried_values_match_jax(rank, dim):
    Aj, At = _pair(rank, dim, 100 + rank)
    assert (At.rank, At.dim, At.shape, At.ndim) == (Aj.rank, Aj.dim, Aj.shape, Aj.ndim)
    assert At.indep_size == Aj.indep_size and At.dense_size == Aj.dense_size
    assert At.dtype == torch.float64 and At.device == torch.device("cpu")
    np.testing.assert_array_equal(At.todense().numpy(), np.asarray(Aj.todense()))
    np.testing.assert_array_equal(flat_to_numpy(At), np.asarray(Aj.data))
    for idx in itertools.islice(itertools.product(range(dim), repeat=rank), 40):
        assert float(At.element(idx)) == float(Aj.element(idx))
        assert float(At[idx]) == float(Aj[idx])
    for cls in At.perm_classes:
        np.testing.assert_array_equal(
            At.class_values(cls).numpy(), np.asarray(Aj.class_values(cls))
        )


@pytest.mark.parametrize("rank,dim", [(2, 4), (3, 3), (4, 3)])
def test_from_dense_round_trips(rank, dim):
    rng = np.random.default_rng(7 + rank)
    raw = rng.normal(size=(dim,) * rank)
    At = stt.FlatSymmetricTensor.from_dense(torch.from_numpy(raw), symmetrize=True)
    Aj = st.FlatSymmetricTensor.from_dense(jnp.asarray(raw), symmetrize=True)
    np.testing.assert_allclose(At.data.numpy(), np.asarray(Aj.data), rtol=1e-12)
    dense = At.todense()
    assert stt.symalg.is_symmetric(dense)
    back = stt.FlatSymmetricTensor.from_dense(dense)
    torch.testing.assert_close(back.data, At.data, rtol=0, atol=0)
    with pytest.raises(ValueError, match="not symmetric"):
        stt.FlatSymmetricTensor.from_dense(torch.from_numpy(raw))


def test_bfloat16_carries_bit_for_bit():
    rng = np.random.default_rng(3)
    Aj = st.FlatSymmetricTensor._raw(
        3, 4, jnp.asarray(rng.normal(size=20), jnp.bfloat16)
    )
    At = flat_from_numpy(3, 4, np.asarray(Aj.data), device="cpu")
    assert At.dtype == torch.bfloat16
    np.testing.assert_array_equal(
        flat_to_numpy(At), np.asarray(Aj.data.astype(jnp.float32))
    )


def test_zeros_astype_to_repr():
    A = stt.FlatSymmetricTensor.zeros(3, 4, dtype=torch.float64)
    assert A.data.shape == (20,) and float(A.data.abs().sum()) == 0.0
    assert A.astype(torch.float32).dtype == torch.float32
    assert A.to("cpu").device == torch.device("cpu")
    assert "rank=3, dim=4" in repr(A)
    assert stt.FlatSymmetricTensor(3, 4).dtype == torch.float32


def _raises_alike(fj, ft):
    with pytest.raises(Exception) as ej:
        fj()
    with pytest.raises(Exception) as et:
        ft()
    assert type(et.value) is type(ej.value), (ej.value, et.value)


BAD = {
    "short data": lambda m, lib: m.FlatSymmetricTensor(rank=3, dim=4, data=lib.zeros(19)),
    "2-d data": lambda m, lib: m.FlatSymmetricTensor(rank=3, dim=4, data=lib.zeros((4, 5))),
    "no rank": lambda m, lib: m.FlatSymmetricTensor(dim=4, data=lib.zeros(20)),
    "nothing": lambda m, lib: m.FlatSymmetricTensor(),
    "negative rank": lambda m, lib: m.utils.get_tables(-1, 3),
    "zero dim": lambda m, lib: m.utils.get_tables(2, 0),
    "not hypercubic": lambda m, lib: m.FlatSymmetricTensor.from_dense(lib.zeros((3, 4))),
    "index out of range": lambda m, lib: m.FlatSymmetricTensor(3, 4)[(0, 1, 4)],
    "too many indices": lambda m, lib: m.FlatSymmetricTensor(3, 4)[(0, 1, 2, 3)],
    "class of wrong rank": lambda m, lib: m.FlatSymmetricTensor(3, 4).class_values("iijj"),
}


@pytest.mark.parametrize("case", sorted(BAD))
def test_bad_input_raises_as_in_jax(case):
    _raises_alike(lambda: BAD[case](st, jnp), lambda: BAD[case](stt, torch))
