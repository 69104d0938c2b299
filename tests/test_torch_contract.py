"""The port's public contraction ops against the JAX package's, on the CPU."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import symtensor_tpu as st
import symtensor_tpu_torch as stt
from symtensor_tpu.utils.profiling import reset_counters as jax_reset_counters
from symtensor_tpu_torch.interop import flat_from_numpy
from symtensor_tpu_torch.kernels.group_pass import group_pass
from symtensor_tpu_torch.ops.contract import _contract_vec_flat_simple

SHAPES = [(0, 1), (1, 5), (2, 4), (3, 6), (4, 4), (5, 3), (6, 3), (7, 2)]


@pytest.fixture(autouse=True)
def _fresh_jax_warnings():
    """Leave the JAX package's once-per-site warnings as a fresh process
    has them (its sparse operands expand to flat with a warning)."""
    yield
    jax_reset_counters()


def _pair(rank, dim, seed):
    rng = np.random.default_rng(seed)
    data = rng.normal(size=st.utils.indep_size(rank, dim))
    Aj = st.FlatSymmetricTensor(rank=rank, dim=dim, data=jnp.asarray(data))
    At = flat_from_numpy(rank, dim, np.asarray(Aj.data), device="cpu")
    return Aj, At, rng


@pytest.mark.parametrize("rank,dim", SHAPES)
def test_contract_matches_jax_float64(rank, dim):
    Aj, At, rng = _pair(rank, dim, 60 + rank)
    x = rng.normal(size=dim)
    want = float(st.symalg.contract_all_indices_with_vector(Aj, jnp.asarray(x)))
    before = group_pass.launches
    got = stt.symalg.contract_all_indices_with_vector(At, torch.from_numpy(x))
    assert group_pass.launches == before  # no kernel launch on the CPU
    assert got.shape == () and got.dtype == torch.float64
    np.testing.assert_allclose(float(got), want, rtol=1e-10)
    np.testing.assert_allclose(
        float(_contract_vec_flat_simple(At, torch.from_numpy(x))), want,
        rtol=1e-10,
    )
    # NumPy input goes through as well
    np.testing.assert_allclose(
        float(stt.symalg.contract_all_indices_with_vector(At, x)), want,
        rtol=1e-10,
    )


@pytest.mark.parametrize("rank,dim", SHAPES)
def test_contract_batched_matches_jax_float64(rank, dim):
    Aj, At, rng = _pair(rank, dim, 80 + rank)
    xs = rng.normal(size=(5, dim))
    want = np.asarray(
        st.symalg.contract_all_indices_with_vector_batched(Aj, jnp.asarray(xs))
    )
    before = group_pass.launches
    got = stt.symalg.contract_all_indices_with_vector_batched(
        At, torch.from_numpy(xs)
    )
    assert group_pass.launches == before
    assert got.shape == (5,)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-10)


def _same_error(fj, ft):
    with pytest.raises(Exception) as ej:
        fj()
    with pytest.raises(Exception) as et:
        ft()
    assert type(et.value) is type(ej.value)
    assert str(et.value) == str(ej.value)


@pytest.mark.parametrize("length", [3, 5])
def test_length_mismatch_errors_match_jax(length):
    Aj, At, _ = _pair(3, 4, 1)
    _same_error(
        lambda: st.symalg.contract_all_indices_with_vector(Aj, jnp.ones(length)),
        lambda: stt.symalg.contract_all_indices_with_vector(At, torch.ones(length)),
    )
    _same_error(
        lambda: st.symalg.contract_all_indices_with_vector_batched(
            Aj, jnp.ones((2, length))),
        lambda: stt.symalg.contract_all_indices_with_vector_batched(
            At, torch.ones(2, length)),
    )


def test_batched_needs_a_matrix_and_a_tensor():
    Aj, At, _ = _pair(3, 4, 2)
    _same_error(
        lambda: st.symalg.contract_all_indices_with_vector_batched(Aj, jnp.ones(4)),
        lambda: stt.symalg.contract_all_indices_with_vector_batched(At, torch.ones(4)),
    )
    with pytest.raises(TypeError):
        stt.symalg.contract_all_indices_with_vector(torch.ones(4, 4), torch.ones(4))


def test_unported_formats_name_their_roadmap_item():
    """Every format is ported now: a sparse tensor runs every contraction
    op and agrees with the JAX package's."""
    import symtensor_tpu_torch.ops.contract as tco

    assert not hasattr(tco, "_NOT_PORTED") and not hasattr(tco, "require_ported")
    rng = np.random.default_rng(97)
    idx, vals = rng.integers(0, 3, size=(7, 2)), rng.normal(size=7)
    Sj = st.SparseFlatSymmetricTensor.from_entries(2, 3, idx, vals, dtype=jnp.float64)
    St = stt.SparseFlatSymmetricTensor.from_entries(
        2, 3, torch.from_numpy(idx), torch.from_numpy(vals))
    x, xs, W = rng.normal(size=3), rng.normal(size=(4, 3)), rng.normal(size=(3, 3))
    np.testing.assert_allclose(
        float(stt.symalg.contract_all_indices_with_vector(St, torch.from_numpy(x))),
        float(st.symalg.contract_all_indices_with_vector(Sj, jnp.asarray(x))), rtol=1e-10)
    np.testing.assert_allclose(
        stt.symalg.contract_all_indices_with_vector_batched(St, torch.from_numpy(xs)).numpy(),
        np.asarray(st.symalg.contract_all_indices_with_vector_batched(Sj, jnp.asarray(xs))),
        rtol=1e-10)
    np.testing.assert_allclose(
        stt.symalg.contract_all_indices_with_matrix(St, torch.from_numpy(W)).todense().numpy(),
        np.asarray(st.symalg.contract_all_indices_with_matrix(Sj, jnp.asarray(W)).todense()),
        rtol=1e-10, atol=1e-12)
    np.testing.assert_allclose(
        stt.symalg.contract_tensor_list(St, [St, St, St]).todense().numpy(),
        np.asarray(st.symalg.contract_tensor_list(Sj, [Sj, Sj, Sj]).todense()),
        rtol=1e-10, atol=1e-12)
