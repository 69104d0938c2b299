"""The port's symmetrized outer product and tensordot against the JAX
package's, on the CPU, on the same float64 flat inputs.

Every route is forced in turn: the default, ``stream=False`` (the table
route, through the gather-combine twin for floating operands) and
``stream=True`` (the streamed route). The JAX references run on the CPU,
where the JAX package takes its own plain routes; the dense oracle
``symmetrize(np.<op>.outer(...))`` / ``symmetrize(np.tensordot(...))``
checks both.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import symtensor_tpu as st
import symtensor_tpu_torch as stt
from symtensor_tpu.ops.symmetrize import symmetrize as jsym
from symtensor_tpu_torch.kernels import gather_mm
from symtensor_tpu_torch.ops import outer as tou

ROUTES = [None, False, True]


def _sym(rank, dim, rng):
    if rank == 0:
        return np.asarray(rng.normal())
    return np.array(jsym(rng.normal(size=(dim,) * rank)))


def _pair(dense):
    Aj = st.FlatSymmetricTensor.from_dense(jnp.asarray(dense))
    At = stt.FlatSymmetricTensor.from_dense(torch.from_numpy(dense))
    return Aj, At


def _close(got, want, atol=1e-12):
    assert isinstance(got, stt.FlatSymmetricTensor)
    np.testing.assert_allclose(got.data.numpy(), np.asarray(want.data), rtol=0, atol=atol)


# ------------------------------------------------------------------ outer


@pytest.mark.parametrize("ra,rb,dim", [(1, 1, 4), (2, 1, 3), (2, 2, 3), (3, 2, 3), (1, 3, 2)])
@pytest.mark.parametrize("fn", ["multiply", "add", "subtract"])
def test_outer_matches_jax_by_every_route(ra, rb, dim, fn):
    rng = np.random.default_rng(10 * ra + rb + dim)
    da, db = _sym(ra, dim, rng), _sym(rb, dim, rng)
    (Aj, At), (Bj, Bt) = _pair(da), _pair(db)
    want = getattr(st.symalg, fn).outer(Aj, Bj)
    oracle = jsym(getattr(np, fn).outer(da, db))
    got = getattr(stt.symalg, fn).outer(At, Bt)
    assert (got.rank, got.dim) == (ra + rb, dim)
    _close(got, want)
    np.testing.assert_allclose(got.todense().numpy(), oracle, atol=1e-10)
    for stream in (False, True):
        _close(tou.symmetric_outer(At, Bt, fn, stream=stream), want)


def test_outer_with_scalars_vectors_and_raw_dense():
    rng = np.random.default_rng(1)
    da, v = _sym(2, 3, rng), rng.normal(size=3)
    Aj, At = _pair(da)
    for fn in ("multiply", "add", "subtract"):
        jf, tf = getattr(st.symalg, fn), getattr(stt.symalg, fn)
        _close(tf.outer(At, 2.0), jf.outer(Aj, 2.0))
        _close(tf.outer(3.0, At), jf.outer(3.0, Aj))
        _close(tf.outer(At, torch.from_numpy(v)), jf.outer(Aj, jnp.asarray(v)))
        # a raw dense operand is compressed first (and checked symmetric)
        _close(tf.outer(torch.from_numpy(da), At), jf.outer(jnp.asarray(da), Aj))
    np.testing.assert_allclose(
        stt.symalg.subtract.outer(2.0, At).todense().numpy(), 2.0 - da, atol=1e-12
    )
    with pytest.raises(ValueError, match="not symmetric"):
        stt.symalg.multiply.outer(torch.from_numpy(rng.normal(size=(3, 3))), At)


def test_outer_dim_mismatch_raises_like_jax():
    with pytest.raises(ValueError) as ej:
        st.symalg.multiply.outer(st.FlatSymmetricTensor.zeros(2, 3),
                                 st.FlatSymmetricTensor.zeros(1, 4))
    with pytest.raises(ValueError) as et:
        stt.symalg.multiply.outer(stt.FlatSymmetricTensor.zeros(2, 3),
                                  stt.FlatSymmetricTensor.zeros(1, 4))
    assert str(et.value) == str(ej.value)


def test_multiply_outer_routes_through_gather_combine(monkeypatch):
    rng = np.random.default_rng(2)
    _, At = _pair(_sym(3, 4, rng))
    calls = []
    real = gather_mm.gather_combine
    monkeypatch.setattr(gather_mm, "gather_combine",
                        lambda *a, **k: calls.append(a[2].shape) or real(*a, **k))
    stt.symalg.multiply.outer(At, At)
    assert calls == [(20, 84)]  # C(6, 3) subsets × C(9, 6) outputs
    stt.symalg.add.outer(At, At)  # add/subtract stay plain torch
    stt.symalg.multiply.outer(At, At.astype(torch.int64))  # promotes to float
    assert len(calls) == 2


def test_float16_operands_route_through_gather_combine(monkeypatch):
    """Every floating type takes the weighted combine, as the JAX gate
    does; float16 accumulates in float32 and returns float16."""
    rng = np.random.default_rng(3)
    # dim 5: the dim-4 tensordot tables must not be memoized before the
    # table-guard test below builds them
    da, db = _sym(3, 5, rng), _sym(2, 5, rng)
    (_, At), (_, Bt) = _pair(da), _pair(db)
    wants = (stt.symalg.multiply.outer(At, Bt),
             stt.symalg.tensordot(At, Bt, axes=1, stream=False))
    calls = []
    real = gather_mm.gather_combine
    monkeypatch.setattr(gather_mm, "gather_combine",
                        lambda *a, **k: calls.append(a[0].dtype) or real(*a, **k))
    A16, B16 = At.astype(torch.float16), Bt.astype(torch.float16)
    gots = (stt.symalg.multiply.outer(A16, B16),
            stt.symalg.tensordot(A16, B16, axes=1, stream=False))
    for got, want in zip(gots, wants):
        assert got.data.dtype == torch.float16
        err = (got.data.double() - want.data).abs().max() / want.data.abs().max()
        assert float(err) <= 2e-3  # float16 inputs and one float16 rounding
    assert calls == [torch.float16, torch.float16]


def test_outer_integer_dtype():
    """Integer tensors take the subset loop, not the weighted kernel (as
    ``tests/test_symalg.py:752``)."""
    A = stt.FlatSymmetricTensor._raw(1, 4, torch.arange(1, 5, dtype=torch.int32))
    before = gather_mm.gather_combine.launches
    out = stt.symalg.multiply.outer(A, A)
    dense = np.multiply.outer(np.arange(1, 5), np.arange(1, 5))
    np.testing.assert_allclose(out.todense().numpy(), dense, atol=1e-6)
    assert gather_mm.gather_combine.launches == before
    Aj = st.FlatSymmetricTensor._raw(1, 4, jnp.arange(1, 5, dtype=jnp.int32))
    for stream in (False, True):
        got = tou.symmetric_outer(A, A, "multiply", stream=stream)
        np.testing.assert_allclose(
            got.data.numpy(), np.asarray(st.symalg.multiply.outer(Aj, Aj).data)
        )
    td = stt.symalg.tensordot(A, A, axes=1)  # paired route, exact integer GEMM
    assert float(td.data[0]) == 30.0


def test_decomp_operands_name_their_roadmap_item():
    class Decomp(stt.SymmetricTensor):
        format = "decomp"
        rank, dim = 2, 3

    A = stt.FlatSymmetricTensor.zeros(2, 3)
    for op in (lambda: stt.symalg.multiply.outer(Decomp(), A),
               lambda: stt.symalg.tensordot(A, Decomp(), axes=1)):
        with pytest.raises(NotImplementedError, match="Decomp format"):
            op()


def test_outer_gradient_matches_jax_and_central_difference():
    """``tests/test_poly_eval.py:152-173``, through the port's autograd."""
    local = np.random.default_rng(42)
    dense = np.array(jsym(local.normal(size=(4, 4))))
    Aj, At = _pair(dense)

    def loss_j(A):
        return (st.symalg.multiply.outer(A, A).data ** 2).sum()

    def loss_t(data):
        A = stt.FlatSymmetricTensor._raw(2, 4, data)
        return (stt.symalg.multiply.outer(A, A).data ** 2).sum()

    want = np.asarray(jax.grad(loss_j)(Aj).data)
    data = At.data.clone().requires_grad_()
    loss_t(data).backward()
    np.testing.assert_allclose(data.grad.numpy(), want, rtol=1e-10, atol=1e-12)
    eps = 1e-5
    for i in (0, 1, 5):
        e = torch.zeros_like(At.data)
        e[i] = eps
        num = (loss_t(At.data + e) - loss_t(At.data - e)) / (2 * eps)
        np.testing.assert_allclose(float(num), float(data.grad[i]), rtol=1e-6)


# -------------------------------------------------------------- tensordot

TD_SHAPES = [
    # tests/test_symalg.py:111-122
    (1, 1, 1, 4), (2, 1, 1, 3), (2, 2, 1, 3), (2, 2, 2, 3), (3, 2, 1, 3),
    (3, 2, 2, 3), (3, 3, 2, 2), (4, 2, 2, 2),
    # tests/test_symalg.py:605-607
    (2, 2, 1, 4), (3, 3, 2, 3), (2, 1, 0, 4),
    # tests/test_symalg.py:787 (k ≥ 2 expands on the host; ka = 0)
    (3, 4, 2, 7), (2, 5, 2, 6), (3, 3, 3, 5),
]


@pytest.mark.parametrize("ra,rb,k,dim", TD_SHAPES)
def test_tensordot_matches_jax_by_every_route(ra, rb, k, dim):
    rng = np.random.default_rng(100 + 7 * ra + rb + k + dim)
    da, db = _sym(ra, dim, rng), _sym(rb, dim, rng)
    (Aj, At), (Bj, Bt) = _pair(da), _pair(db)
    want = st.symalg.tensordot(Aj, Bj, axes=k)
    oracle = np.asarray(jsym(np.tensordot(da, db, axes=k)))
    for stream in ROUTES:
        got = stt.symalg.tensordot(At, Bt, axes=k, stream=stream)
        assert got.rank == ra + rb - 2 * k
        _close(got, want)
        np.testing.assert_allclose(got.todense().numpy(), oracle, atol=1e-10)


def test_tensordot_default_route_is_paired_and_table_route_launches(monkeypatch):
    rng = np.random.default_rng(3)
    _, At = _pair(_sym(3, 5, rng))
    assert tou._paired_feasible(3, 3, 1, 5)
    calls = []
    real = gather_mm.gather_combine
    monkeypatch.setattr(gather_mm, "gather_combine",
                        lambda *a, **k: calls.append(a[2].shape) or real(*a, **k))
    stt.symalg.tensordot(At, At, axes=1)
    assert calls == []
    stt.symalg.tensordot(At, At, axes=1, stream=False)
    assert calls == [(6 * 5, 70)]  # R = C(4, 2)·5, n_out = C(8, 4)
    # the paired gate off: the default falls to the table route
    monkeypatch.setenv("SYMTENSOR_TENSORDOT_PAIRED", "0")
    stt.symalg.tensordot(At, At, axes=1)
    assert len(calls) == 2


def test_tensordot_route_gates_follow_the_table_guard(monkeypatch):
    from symtensor_tpu_torch.config import config

    rng = np.random.default_rng(4)
    (Aj, At), (Bj, Bt) = _pair(_sym(3, 4, rng)), _pair(_sym(2, 4, rng))
    want = st.symalg.tensordot(Aj, Bj, axes=1)
    monkeypatch.setenv("SYMTENSOR_TENSORDOT_PAIRED", "0")
    # gather tables (480 and 1 120 entries) past the guard, rep tables not
    monkeypatch.setattr(config, "max_table_entries", 300)
    _close(stt.symalg.tensordot(At, Bt, axes=1), want)  # streams
    _close(stt.symalg.multiply.outer(At, Bt), st.symalg.multiply.outer(Aj, Bj))
    with pytest.raises(MemoryError):
        stt.symalg.tensordot(At, Bt, axes=1, stream=False)


def test_tensordot_axes_forms_and_errors():
    rng = np.random.default_rng(5)
    (Aj, At), (Bj, Bt) = _pair(_sym(2, 3, rng)), _pair(_sym(2, 3, rng))
    r_int = stt.symalg.tensordot(At, Bt, axes=1)
    assert r_int.allclose(stt.symalg.tensordot(At, Bt, axes=([1], [0])))
    assert r_int.allclose(stt.symalg.tensordot(At, Bt, axes=(1, 0)))
    _close(stt.symalg.tensordot(At, Bt, axes=([0, 1], [1, 0])),
           st.symalg.tensordot(Aj, Bj, axes=([0, 1], [1, 0])))
    _close(stt.symalg.tensordot(At, Bt, axes=0), st.symalg.multiply.outer(Aj, Bj))
    for bad in (3, ([0], [0, 1])):
        with pytest.raises(ValueError) as ej:
            st.symalg.tensordot(Aj, Bj, axes=bad)
        with pytest.raises(ValueError) as et:
            stt.symalg.tensordot(At, Bt, axes=bad)
        assert str(et.value) == str(ej.value)
    with pytest.raises(ValueError, match="dim mismatch"):
        stt.symalg.tensordot(At, stt.FlatSymmetricTensor.zeros(2, 4), axes=1)


def test_tensordot_with_plain_vector():
    rng = np.random.default_rng(6)
    da, x = _sym(3, 3, rng), rng.normal(size=3)
    Aj, At = _pair(da)
    for stream in ROUTES:
        _close(stt.symalg.tensordot(At, torch.from_numpy(x), axes=1, stream=stream),
               st.symalg.tensordot(Aj, jnp.asarray(x), axes=1))


def test_tensordot_streamed_small_blocks(monkeypatch):
    """Many 64-element blocks, the last one partial, stay exact
    (``tests/test_symalg.py:638``)."""
    monkeypatch.setenv("SYMTENSOR_STREAM_BLOCK_ELEMS", "64")
    rng = np.random.default_rng(7)
    da, db = _sym(3, 4, rng), _sym(2, 4, rng)
    (Aj, At), (Bj, Bt) = _pair(da), _pair(db)
    want = st.symalg.tensordot(Aj, Bj, axes=1, stream=True)
    got = stt.symalg.tensordot(At, Bt, axes=1, stream=True)
    _close(got, want)
    np.testing.assert_allclose(got.todense().numpy(),
                               np.asarray(jsym(np.tensordot(da, db, axes=1))),
                               atol=1e-10)
    _close(tou.symmetric_outer(At, Bt, "multiply", stream=True),
           st.symalg.multiply.outer(Aj, Bj))
