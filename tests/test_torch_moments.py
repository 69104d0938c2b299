"""The port's Gaussian moment hierarchy against the JAX package's and the
dense Isserlis recursion, on the CPU, in float64. Moments pass through an
eigendecomposition of the covariance, so they are compared through
``todense()``."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import symtensor_tpu as st
import symtensor_tpu_torch as stt
from symtensor_tpu.models import moments as jmoments
from symtensor_tpu_torch.config import config
from symtensor_tpu_torch.models import moments


@pytest.fixture(autouse=True)
def _cpu_default_device(monkeypatch):
    """This file builds tensors without naming a device: ask for the CPU."""
    monkeypatch.setattr(config, "default_device", "cpu")


def _gaussian(seed, d):
    rng = np.random.default_rng(seed)
    mean = rng.normal(size=d)
    a = rng.normal(size=(d, d))
    return rng, mean, a @ a.T


def _oracle(mean, cov, r):
    """E[x^⊗r] by the Isserlis recursion on dense tensors."""
    ms = {0: np.ones(()), 1: np.array(mean), 2: np.array(cov) + np.outer(mean, mean)}
    for k in range(3, r + 1):
        t1 = np.multiply.outer(np.array(mean), ms[k - 1])
        t2 = np.multiply.outer(np.array(cov), ms[k - 2]) * (k - 1)
        ms[k] = np.asarray(st.symalg.symmetrize(t1 + t2))
    return ms[r]


@pytest.mark.parametrize("r", [1, 2, 3, 4, 5])
def test_gaussian_moments_match_jax_and_the_oracle(r):
    d = 3
    _, mean, cov = _gaussian(r, d)
    got = moments.gaussian_moments(torch.from_numpy(mean), torch.from_numpy(cov), r)
    want = jmoments.gaussian_moments(jnp.asarray(mean), jnp.asarray(cov), r)
    assert len(got) == len(want) == r
    for mt, mj in zip(got, want):
        assert mt.format == "decomp" and mt.dtype == torch.float64
        assert (mt.rank, mt.multiplicities, mt.num_factors) == (
            mj.rank, mj.multiplicities, mj.num_factors)
    np.testing.assert_allclose(got[-1].todense().numpy(),
                               np.asarray(want[-1].todense()), rtol=1e-8, atol=1e-10)
    np.testing.assert_allclose(got[-1].todense().numpy(), _oracle(mean, cov, r),
                               rtol=1e-8, atol=1e-10)


def test_gaussian_moments_factor_growth_and_compaction(monkeypatch):
    """m₂ has d+1 factors, m₃ 2d+3, m₄ 4d+5; past
    ``config.decomp_autoreduce_elems`` a moment lands in the standard
    basis (dim factors, all-ones multiplicities)."""
    d = 4
    _, mean, cov = _gaussian(6, d)
    monkeypatch.setattr(config, "decomp_autoreduce_elems", 0)
    ms = moments.gaussian_moments(torch.from_numpy(mean), torch.from_numpy(cov), 4)
    assert [m.num_factors for m in ms] == [1, d + 1, 2 * d + 3, 4 * d + 5]
    assert [m.multiplicities for m in ms] == [(1,), (2,), (2, 1), (2, 1, 1)]
    monkeypatch.setattr(config, "decomp_autoreduce_elems", 65536)
    ms2 = moments.gaussian_moments(torch.from_numpy(mean), torch.from_numpy(cov), 5)
    assert ms2[4].num_factors == d and ms2[4].multiplicities == (1,) * 5
    np.testing.assert_allclose(ms2[3].todense().numpy(), ms[3].todense().numpy(),
                               rtol=1e-10)


def test_moments_contract_to_scalar_gaussian_moments():
    """⟨m_r, x^⊗r⟩ is the r-th moment of the scalar Gaussian
    N(μ·x, xᵀΣx)."""
    d = 4
    rng, mean, cov = _gaussian(7, d)
    ms = moments.gaussian_moments(torch.from_numpy(mean), torch.from_numpy(cov), 5)
    xs = rng.normal(size=(3, d))
    m, v = xs @ mean, np.einsum("bi,ij,bj->b", xs, cov, xs)
    closed = [m, m**2 + v, m**3 + 3 * m * v, m**4 + 6 * m**2 * v + 3 * v**2,
              m**5 + 10 * m**3 * v + 15 * m * v**2]
    for mr, want in zip(ms, closed):
        got = stt.symalg.contract_all_indices_with_vector_batched(
            mr, torch.from_numpy(xs))
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-10)
        one = stt.symalg.contract_all_indices_with_vector(mr, torch.from_numpy(xs[0]))
        np.testing.assert_allclose(float(one), want[0], rtol=1e-10)


def test_gaussian_moments_cov_shape_and_numpy_inputs():
    with pytest.raises(ValueError) as ej:
        jmoments.gaussian_moments(jnp.ones(3), jnp.ones((3, 2)), 2)
    with pytest.raises(ValueError) as et:
        moments.gaussian_moments(torch.ones(3), torch.ones(3, 2), 2)
    assert str(et.value) == str(ej.value)
    _, mean, cov = _gaussian(8, 3)
    ms = moments.gaussian_moments(mean, cov, 2)  # NumPy: to config.default_device
    np.testing.assert_allclose(ms[1].todense().numpy(), cov + np.outer(mean, mean),
                               atol=1e-10)


def test_polynomial_expectation_matches_jax():
    d = 3
    rng, mean, cov = _gaussian(9, d)
    a2 = np.array(st.symalg.symmetrize(rng.normal(size=(d, d))))
    a3 = np.array(st.symalg.symmetrize(rng.normal(size=(d, d, d))))
    ms_t = moments.gaussian_moments(torch.from_numpy(mean), torch.from_numpy(cov), 3)
    ms_j = jmoments.gaussian_moments(jnp.asarray(mean), jnp.asarray(cov), 3)
    coeffs_t = [stt.FlatSymmetricTensor.from_dense(torch.from_numpy(a)) for a in (a2, a3)]
    coeffs_j = [st.FlatSymmetricTensor.from_dense(jnp.asarray(a)) for a in (a2, a3)]
    got = moments.polynomial_expectation(coeffs_t, ms_t)
    want = float(jmoments.polynomial_expectation(coeffs_j, ms_j))
    assert got.shape == () and got.dtype == torch.float64
    np.testing.assert_allclose(float(got), want, rtol=1e-9)
    expect = (np.einsum("ij,ij->", a2, ms_t[1].todense().numpy())
              + np.einsum("ijk,ijk->", a3, ms_t[2].todense().numpy()))
    np.testing.assert_allclose(float(got), expect, rtol=1e-9)
    # decomp coefficients contract structurally
    got = moments.polynomial_expectation([ms_t[1], ms_t[2]], ms_t)
    want = float(jmoments.polynomial_expectation([ms_j[1], ms_j[2]], ms_j))
    np.testing.assert_allclose(float(got), want, rtol=1e-9)
    with pytest.raises(ValueError, match="indexed by rank-1"):
        moments.polynomial_expectation([coeffs_t[1]], ms_t[:2] + [ms_t[1]])
    assert float(moments.polynomial_expectation([], ms_t)) == 0.0


def test_hierarchy_step_five_tensor_matches_jax():
    """``tests/test_models.py:101``: the BASELINE C4 shape at dim 5."""
    d = 5
    rng = np.random.default_rng(10)
    w, f = rng.normal(size=2), rng.normal(size=(2, d))
    At = stt.DecompSymmetricTensor(3, d, torch.from_numpy(w), torch.from_numpy(f),
                                   (3,), dtype=torch.float64)
    Aj = st.DecompSymmetricTensor(3, d, jnp.asarray(w), jnp.asarray(f), (3,),
                                  dtype=jnp.float64)
    mats = [(lambda m: (m + m.T) / 2)(rng.normal(size=(d, d))) for _ in range(d)]
    chis_t = [stt.DecompSymmetricTensor.from_matrix(torch.from_numpy(m)) for m in mats]
    chis_j = [st.DecompSymmetricTensor.from_matrix(jnp.asarray(m)) for m in mats]
    for n_times in (1, 2):
        got = moments.hierarchy_step(At, chis_t, n_times=n_times)
        want = jmoments.hierarchy_step(Aj, chis_j, n_times=n_times)
        assert got.rank == want.rank == 3 - n_times + 2 * n_times
        np.testing.assert_allclose(got.data.numpy(), np.asarray(want.data),
                                   rtol=1e-8, atol=1e-11)
    da = At.todense().numpy()
    acc = sum(np.multiply.outer(da[i], mats[i]) for i in range(d))
    got = moments.hierarchy_step(At, chis_t, n_times=1)
    np.testing.assert_allclose(got.todense().numpy(),
                               np.asarray(st.symalg.symmetrize(acc)), atol=1e-8)
