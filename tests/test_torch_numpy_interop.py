"""The port's NumPy dispatch hooks against the JAX package's, on the CPU.

NEP-13 ufuncs and the packed NEP-18 functions keep a tensor packed and on
its device; ``np.asarray(A)`` and the functions without a packed handler
densify with a warning; the results equal the JAX package's.
"""

import warnings

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import symtensor_tpu as st
import symtensor_tpu_torch as stt
from symtensor_tpu.utils.profiling import reset_counters as jax_reset_counters
from symtensor_tpu_torch.config import config
from symtensor_tpu_torch.core import base as tbase
from symtensor_tpu_torch.testing import does_not_warn
from symtensor_tpu_torch.utils.profiling import reset_counters


@pytest.fixture(autouse=True)
def _cpu_and_fresh_warnings(monkeypatch):
    monkeypatch.setattr(config, "default_device", "cpu")
    yield
    reset_counters()
    jax_reset_counters()


def _pair(rank=3, dim=4, seed=0, lo=0.2, hi=0.8):
    """A float64 flat tensor in both packages with values in [lo, hi), in
    every unary ufunc's domain."""
    rng = np.random.default_rng(seed)
    data = rng.uniform(lo, hi, size=st.utils.indep_size(rank, dim))
    return (st.FlatSymmetricTensor._raw(rank, dim, jnp.asarray(data)),
            stt.FlatSymmetricTensor._raw(rank, dim, torch.from_numpy(data)))


def _same(got, want, rtol=1e-12):
    assert isinstance(got, stt.SymmetricTensor) and got.format == want.format
    np.testing.assert_allclose(got.toflat().data.numpy(),
                               np.asarray(want.toflat().data), rtol=rtol, atol=1e-15)


@pytest.mark.parametrize("name", sorted(tbase._UNARY_UFUNCS))
def test_unary_ufuncs_match_jax(name):
    Aj, At = _pair(seed=len(name))
    if name in ("invert",):  # integer-only
        Aj, At = Aj.astype(jnp.int32), At.astype(torch.int32)
    if name == "arccosh":
        Aj, At = Aj + 1.0, At + 1.0
    ufunc = getattr(np, name)
    with does_not_warn(match="densifying"):
        got, want = ufunc(At), ufunc(Aj)
    np.testing.assert_array_equal(got.toflat().data.numpy().dtype,
                                  np.asarray(want.toflat().data).dtype)
    _same(got, want)


@pytest.mark.parametrize("name", ["add", "subtract", "multiply", "divide",
                                  "true_divide", "power"])
def test_binary_ufuncs_match_jax(name):
    (Aj, At), (Bj, Bt) = _pair(seed=1), _pair(seed=2)
    ufunc = getattr(np, name)
    with does_not_warn(match="densifying"):
        _same(ufunc(At, Bt), ufunc(Aj, Bj))
        _same(ufunc(At, 2.0), ufunc(Aj, 2.0))
        _same(ufunc(1.5, At), ufunc(1.5, Aj))
        _same(ufunc(np.float64(0.5), At), ufunc(np.float64(0.5), Aj))


def test_refused_and_unsupported_ufuncs():
    _, At = _pair()
    with pytest.raises(TypeError):
        np.multiply.outer(At, At)
    with pytest.raises(TypeError):
        np.add.reduce(At)
    with pytest.raises(TypeError, match="immutable"):
        np.exp(At, out=np.zeros(3))
    with pytest.raises(TypeError):
        np.cbrt(At)  # no torch counterpart: NotImplemented, NumPy raises
    with pytest.raises(TypeError):
        np.maximum(At, At)
    with pytest.raises(TypeError):
        np.add(At, np.ones(4))  # only scalars broadcast
    with pytest.raises(TypeError, match="symalg.tensordot"):
        np.tensordot(At, At)


def test_packed_functions_match_jax_and_never_densify():
    (Aj, At), (Bj, Bt) = _pair(seed=3), _pair(seed=4)
    with does_not_warn(match="densifying"):
        assert np.allclose(At, At) and np.allclose(At, At + 1e-12)
        assert not np.allclose(At, Bt)
        assert np.allclose(At, 0.5, atol=0.31)
        assert np.array_equal(At, At) and not np.array_equal(At, Bt)
        assert np.result_type(At, np.float32) == np.result_type(Aj, np.float32)
        assert np.result_type(At.astype(torch.bfloat16)) == np.float32
        close = np.isclose(At, Bt, atol=0.1)
        assert np.all(At) and np.any(close) == np.any(np.isclose(Aj, Bj, atol=0.1))
        assert not np.any(At - At) and not np.all(At - At)
    _same(close, np.isclose(Aj, Bj, atol=0.1))
    P = At.topermcls()
    with does_not_warn(match="densifying"):
        assert np.allclose(P, At) and np.array_equal(P, At)


def test_asarray_like_and_empty():
    _, At = _pair()
    with does_not_warn(match="densifying"):
        assert np.asarray(At, like=At) is At
        f32 = np.asarray(At, dtype=np.float32, like=At)
        empty = np.empty((4, 4), like=At)
        dense = np.asarray(np.eye(4), like=At)
    assert f32.dtype == torch.float32
    assert isinstance(empty, stt.FlatSymmetricTensor) and empty.rank == 2
    assert not np.any(empty)
    assert isinstance(dense, stt.FlatSymmetricTensor)
    np.testing.assert_allclose(dense.todense().numpy(), np.eye(4))
    with pytest.raises(ValueError):
        np.empty((4, 5), like=At)
    with pytest.raises(ValueError):
        np.asarray(np.ones((3, 3)), like=At)
    S = stt.SparseFlatSymmetricTensor.from_flat(At)
    empty = np.empty((4, 4, 4), like=S)
    assert isinstance(empty, stt.SparseFlatSymmetricTensor) and empty.nnz == 0


def test_asarray_densifies_with_a_warning_like_jax():
    Aj, At = _pair(seed=5)
    with pytest.warns(UserWarning, match="densifying"):
        arr = np.asarray(At)
    assert type(arr) is np.ndarray
    with pytest.warns(UserWarning):
        want = np.asarray(Aj)
    np.testing.assert_array_equal(arr, want)
    with pytest.warns(UserWarning):
        assert np.asarray(At, dtype=np.float32).dtype == np.float32
    with pytest.warns(UserWarning):
        b = np.asarray(At.astype(torch.bfloat16))
    assert b.dtype == np.float32  # NumPy has no bfloat16 of its own


def test_other_functions_densify_with_a_warning():
    Aj, At = _pair(seed=6)
    with pytest.warns(UserWarning, match="densifying"):
        got = np.sum(At, axis=0)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        want = np.sum(np.asarray(Aj), axis=0)
    np.testing.assert_allclose(got, want, rtol=1e-12)
    with pytest.warns(UserWarning):
        assert np.all(At, axis=0).shape == (4, 4)


def test_scalar_ufuncs_on_other_formats_keep_them():
    _, At = _pair(seed=7)
    for t in (At.topermcls(), stt.DenseSymmetricTensor._raw(3, 4, At.todense())):
        out = np.exp(t)
        assert out.format == t.format
        np.testing.assert_allclose(out.todense().numpy(), np.exp(At.todense().numpy()))
    S = stt.SparseFlatSymmetricTensor.from_flat(At)
    assert np.multiply(S, 2.0).format == "sparse_flat"
    assert np.exp(S).format == "flat"
