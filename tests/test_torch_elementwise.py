"""The port's elementwise algebra and comparisons against the JAX
package's, on the CPU, on the same float64 flat inputs."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import symtensor_tpu as st
import symtensor_tpu_torch as stt
from symtensor_tpu_torch.ops import elementwise as tew


def _pair(rank, dim, seed, positive=False):
    rng = np.random.default_rng(seed)
    data = rng.normal(size=stt.utils.indep_size(rank, dim))
    if positive:
        data = np.abs(data) + 0.5
    return (st.FlatSymmetricTensor._raw(rank, dim, jnp.asarray(data)),
            stt.FlatSymmetricTensor._raw(rank, dim, torch.from_numpy(data)))


def _close(got, want, rtol=1e-12):
    assert isinstance(got, stt.FlatSymmetricTensor)
    assert (got.rank, got.dim) == (want.rank, want.dim)
    np.testing.assert_allclose(got.data.numpy(), np.asarray(want.data), rtol=rtol,
                               atol=1e-14)


OPS = ["add", "subtract", "multiply", "divide", "power"]


@pytest.mark.parametrize("op", OPS)
@pytest.mark.parametrize("rank,dim", [(1, 4), (3, 3)])
def test_binary_tensor_tensor_and_scalars(op, rank, dim):
    (Aj, At), (Bj, Bt) = _pair(rank, dim, 1, True), _pair(rank, dim, 2, True)
    _close(tew.binary(op, At, Bt), st.ops.elementwise.binary(op, Aj, Bj))
    for s in (2.5, np.float64(0.5), np.asarray(3.0)):
        _close(tew.binary(op, At, s), st.ops.elementwise.binary(op, Aj, s))
        _close(tew.binary(op, s, At), st.ops.elementwise.binary(op, s, Aj))
        _close(tew.binary(op, At, s, reverse=True),
               st.ops.elementwise.binary(op, Aj, s, reverse=True))
    _close(tew.binary(op, At, torch.tensor(1.5, dtype=torch.float64)),
           st.ops.elementwise.binary(op, Aj, 1.5))


def test_dunders_match_jax():
    (Aj, At), (Bj, Bt) = _pair(3, 4, 3, True), _pair(3, 4, 4, True)
    pairs = [
        (At + Bt, Aj + Bj), (At - Bt, Aj - Bj), (At * Bt, Aj * Bj),
        (At / Bt, Aj / Bj), (At ** 2, Aj ** 2), (2.0 ** At, 2.0 ** Aj),
        (1.0 + At, 1.0 + Aj), (1.0 - At, 1.0 - Aj), (3.0 * At, 3.0 * Aj),
        (1.0 / At, 1.0 / Aj), (-At, -Aj), (abs(-At), abs(-Aj)),
    ]
    for got, want in pairs:
        _close(got, want)
    assert +At is At


def test_rank0_broadcasting():
    (Aj, At), (Sj, St) = _pair(2, 3, 5), _pair(0, 1, 6)
    for op in OPS[:3]:
        _close(tew.binary(op, At, St), st.ops.elementwise.binary(op, Aj, Sj))
        _close(tew.binary(op, St, At), st.ops.elementwise.binary(op, Sj, Aj))
    _close(St * St, Sj * Sj)


def test_named_unaries_and_apply():
    Aj, At = _pair(2, 4, 7, True)
    for name in ("exp", "expm1", "log", "log1p", "sqrt", "square", "reciprocal",
                 "negative", "absolute", "abs", "sign", "sin", "cos", "tanh"):
        _close(getattr(stt.symalg, name)(At), getattr(st.symalg, name)(Aj))
    _close(stt.symalg.apply(torch.sinh, At), st.symalg.apply(jnp.sinh, Aj))
    assert stt.symalg.transpose(At) is At


def test_symufunc_calls_elementwise():
    (Aj, At), (Bj, Bt) = _pair(2, 3, 8), _pair(2, 3, 9)
    for name in ("add", "subtract", "multiply"):
        _close(getattr(stt.symalg, name)(At, Bt), getattr(st.symalg, name)(Aj, Bj))
    assert repr(stt.symalg.add) == repr(st.symalg.add)


def test_allclose_isclose_array_equal_match_jax():
    (Aj, At), (Bj, Bt) = _pair(3, 3, 10), _pair(3, 3, 11)
    Cj = st.FlatSymmetricTensor._raw(3, 3, Aj.data + 1e-9)
    Ct = stt.FlatSymmetricTensor._raw(3, 3, At.data + 1e-9)
    for x, y, xj, yj in ((At, Bt, Aj, Bj), (At, Ct, Aj, Cj), (At, At, Aj, Aj)):
        assert stt.symalg.allclose(x, y) == st.symalg.allclose(xj, yj)
        assert x.allclose(y) == xj.allclose(yj)
        assert stt.symalg.array_equal(x, y) == st.symalg.array_equal(xj, yj)
        assert x.array_equal(y) == xj.array_equal(yj)
        got = stt.symalg.isclose(x, y, rtol=1e-6)
        assert got.dtype == torch.bool
        np.testing.assert_array_equal(got.data.numpy(),
                                      np.asarray(st.symalg.isclose(xj, yj, rtol=1e-6).data))
    # mixed types promote, as in NumPy and JAX
    assert stt.symalg.allclose(At, At.astype(torch.float32), rtol=1e-6)
    A32 = At.astype(torch.float32)
    assert stt.symalg.array_equal(A32, A32.astype(torch.float64))
    # scalars
    ones = stt.FlatSymmetricTensor._raw(2, 3, torch.ones(6, dtype=torch.float64))
    assert stt.symalg.allclose(ones, 1.0) and stt.symalg.allclose(1, ones)
    assert bool(stt.symalg.isclose(2.0, ones).data.any()) is False
    # shape mismatches
    Z = stt.FlatSymmetricTensor.zeros(2, 3, dtype=torch.float64)
    assert not stt.symalg.allclose(At, Z) and not stt.symalg.array_equal(At, Z)
    with pytest.raises(ValueError):
        stt.symalg.isclose(At, Z)


def test_errors_match_jax():
    (Aj, At), (Bj, Bt) = _pair(2, 3, 12), _pair(3, 3, 13)
    with pytest.raises(ValueError) as ej:
        Aj + Bj
    with pytest.raises(ValueError) as et:
        At + Bt
    assert str(et.value) == str(ej.value)
    with pytest.raises(TypeError) as ej:
        Aj + jnp.ones(6)
    with pytest.raises(TypeError) as et:
        At + torch.ones(6)
    assert str(et.value) == str(ej.value).replace("ArrayImpl", "Tensor")
    for fn in (stt.symalg.allclose, stt.symalg.isclose):
        with pytest.raises(TypeError):
            fn(torch.ones(3), torch.ones(3))
    with pytest.raises(TypeError):
        stt.symalg.array_equal(At, 1.0)


def test_equality_operators_raise():
    _, At = _pair(2, 3, 14)
    with pytest.raises(TypeError, match="array_equal"):
        At == At  # noqa: B015
    with pytest.raises(TypeError, match="isclose"):
        At != At  # noqa: B015
    with pytest.raises(TypeError):
        hash(At)


@pytest.mark.parametrize("fmt,item", [
    ("permcls", "PermCls and Dense"), ("dense", "PermCls and Dense"),
    ("decomp", "Decomp format"), ("sparse_flat", "Sparse format"),
])
def test_unported_formats_name_their_roadmap_item(fmt, item):
    class Other(stt.SymmetricTensor):
        format = fmt
        rank, dim = 2, 3

    _, At = _pair(2, 3, 15)
    for op in (lambda: Other() + At, lambda: At * Other(), lambda: 2.0 * Other(),
               lambda: -Other(), lambda: stt.symalg.exp(Other()),
               lambda: stt.symalg.allclose(Other(), At),
               lambda: stt.symalg.isclose(Other(), 1.0),
               lambda: stt.symalg.array_equal(At, Other())):
        with pytest.raises(NotImplementedError, match=item):
            op()
