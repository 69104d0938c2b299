"""The port's ``contract_tensor_list`` against the JAX package's and the
dense einsum, on the CPU, in float64: A in every ported format, χ flat or
decomp, one to three contracted indices, both rules."""

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import symtensor_tpu as st
import symtensor_tpu_torch as stt
from symtensor_tpu_torch.config import config
from symtensor_tpu_torch.interop import decomp_from_numpy
from symtensor_tpu_torch.kernels import gather_mm
from symtensor_tpu_torch.ops import contract as tcontract


@pytest.fixture(autouse=True)
def _cpu_default_device(monkeypatch):
    """This file builds tensors without naming a device: ask for the CPU."""
    monkeypatch.setattr(config, "default_device", "cpu")


def _sym(rng, rank, dim):
    return np.array(st.symalg.symmetrize(rng.normal(size=(dim,) * rank)))


def _tensor_pair(fmt, dense, rng):
    """A in format `fmt` in both packages, from one dense array; decomp is
    a random two-group tensor of the same shape instead (returned with its
    own dense form)."""
    rank, dim = dense.ndim, dense.shape[0]
    if fmt == "decomp":
        mult = (rank - 1, 1) if rank > 1 else (1,)
        w = rng.normal(size=(2,) * len(mult))
        f = rng.normal(size=(2, dim))
        Aj = st.DecompSymmetricTensor(rank, dim, jnp.asarray(w), jnp.asarray(f),
                                      mult, dtype=jnp.float64)
        At = decomp_from_numpy(rank, dim, w, f, mult, device="cpu")
        return Aj, At, np.asarray(Aj.todense())
    cls = {"flat": "FlatSymmetricTensor", "permcls": "PermClsSymmetricTensor",
           "dense": "DenseSymmetricTensor"}[fmt]
    Aj = getattr(st, cls).from_dense(jnp.asarray(dense))
    At = getattr(stt, cls).from_dense(torch.from_numpy(dense))
    return Aj, At, dense


def _chi_lists(fmt, rng, m, dim):
    """dim tensors χ_i of rank m in both packages, and their stacked dense
    form (dim, dim, …)."""
    chis_j, chis_t, dense = [], [], []
    for _ in range(dim):
        cj, ct, cd = _tensor_pair(fmt, _sym(rng, m, dim), rng)
        chis_j.append(cj), chis_t.append(ct), dense.append(cd)
    return chis_j, chis_t, np.stack(dense)


def _oracle(A, chi, n, values):
    """Symmetrize[ Σ_{i1…in ∈ values} A[i1…in, …] ⊗ χ_{i1} ⊗ … ⊗ χ_{in} ]."""
    out = A
    for _ in range(n):
        # contract the leading index of `out` with χ's list index; the new
        # axes go last
        out = np.tensordot(out[values], chi[values], axes=([0], [0]))
    return np.asarray(st.symalg.symmetrize(out))


def _values(rule, dim):
    return list(range(math.ceil(dim / 2), dim)) if rule == "second_half" else list(range(dim))


@pytest.mark.parametrize("fmt", ["flat", "permcls", "dense", "decomp"])
@pytest.mark.parametrize("chi_fmt", ["flat", "decomp"])
@pytest.mark.parametrize("n_times", [1, 2, 3])
@pytest.mark.parametrize("rule", ["all", "second_half"])
def test_matches_jax_and_the_dense_oracle(fmt, chi_fmt, n_times, rule):
    rng = np.random.default_rng(100 * n_times + len(fmt) + len(chi_fmt))
    dim, rank, m = 3, 3, 2
    Aj, At, dense = _tensor_pair(fmt, _sym(rng, rank, dim), rng)
    chis_j, chis_t, chi = _chi_lists(chi_fmt, rng, m, dim)
    want = st.symalg.contract_tensor_list(Aj, chis_j, n_times=n_times, rule=rule)
    got = stt.symalg.contract_tensor_list(At, chis_t, n_times=n_times, rule=rule)
    assert got.format == "flat"
    assert (got.rank, got.dim) == (want.rank, want.dim) == (rank - n_times + n_times * m, dim)
    np.testing.assert_allclose(got.data.numpy(), np.asarray(want.toflat().data),
                               rtol=1e-10, atol=1e-12)
    np.testing.assert_allclose(got.todense().numpy(),
                               _oracle(dense, chi, n_times, _values(rule, dim)),
                               atol=1e-10)


@pytest.mark.parametrize("dim,rank,m,n_times", [(4, 2, 1, 1), (4, 2, 3, 2), (2, 4, 2, 2),
                                                (5, 3, 2, 1), (3, 4, 1, 3), (4, 3, 1, 2)])
@pytest.mark.parametrize("rule", ["all", "second_half"])
def test_other_shapes_match_jax(dim, rank, m, n_times, rule):
    rng = np.random.default_rng(dim + 10 * rank + 100 * m)
    Aj, At, dense = _tensor_pair("flat", _sym(rng, rank, dim), rng)
    chis_j, chis_t, chi = _chi_lists("flat", rng, m, dim)
    want = st.symalg.contract_tensor_list(Aj, chis_j, n_times=n_times, rule=rule)
    got = stt.symalg.contract_tensor_list(At, chis_t, n_times=n_times, rule=rule)
    assert (got.rank, got.dim) == (want.rank, want.dim)
    np.testing.assert_allclose(got.data.numpy(), np.asarray(want.data),
                               rtol=1e-10, atol=1e-12)
    np.testing.assert_allclose(got.todense().numpy(),
                               _oracle(dense, chi, n_times, _values(rule, dim)),
                               atol=1e-10)


@pytest.mark.parametrize("fmt", ["flat", "decomp"])
@pytest.mark.parametrize("rule", ["all", "second_half"])
def test_rank1_path(fmt, rule):
    rng = np.random.default_rng(7)
    dim, m = 5, 2
    Aj, At, dense = _tensor_pair(fmt, rng.normal(size=dim), rng)
    chis_j, chis_t, chi = _chi_lists("flat", rng, m, dim)
    want = st.symalg.contract_tensor_list(Aj, chis_j, rule=rule)
    got = stt.symalg.contract_tensor_list(At, chis_t, rule=rule)
    assert (got.rank, got.dim) == (m, dim)
    np.testing.assert_allclose(got.data.numpy(), np.asarray(want.data), rtol=1e-10,
                               atol=1e-12)
    np.testing.assert_allclose(got.todense().numpy(),
                               _oracle(dense, chi, 1, _values(rule, dim)), atol=1e-10)


def test_moment_hierarchy_shape_of_the_jax_tests():
    """``tests/test_decomp.py:285``: a decomp tensor against a list of
    rank-2 moments made with ``from_matrix``."""
    rng = np.random.default_rng(8)
    dim = 5
    w, f = rng.normal(size=2), rng.normal(size=(2, dim))
    At = decomp_from_numpy(2, dim, w, f, (2,), device="cpu")
    Aj = st.DecompSymmetricTensor(2, dim, jnp.asarray(w), jnp.asarray(f), (2,),
                                  dtype=jnp.float64)
    mats = [(lambda m: (m + m.T) / 2)(rng.normal(size=(dim, dim))) for _ in range(dim)]
    chis_t = [stt.DecompSymmetricTensor.from_matrix(torch.from_numpy(m)) for m in mats]
    chis_j = [st.DecompSymmetricTensor.from_matrix(jnp.asarray(m)) for m in mats]
    got = stt.symalg.contract_tensor_list(At, chis_t, n_times=1)
    want = st.symalg.contract_tensor_list(Aj, chis_j, n_times=1)
    np.testing.assert_allclose(got.data.numpy(), np.asarray(want.data), rtol=1e-9,
                               atol=1e-12)
    oracle = _oracle(np.asarray(Aj.todense()), np.stack(mats), 1, list(range(dim)))
    np.testing.assert_allclose(got.todense().numpy(), oracle, atol=1e-9)


@pytest.mark.parametrize("case", ["n_times", "length", "shapes", "dim", "rule", "type"])
def test_errors_match_jax(case):
    rng = np.random.default_rng(9)
    Aj, At, _ = _tensor_pair("flat", _sym(rng, 2, 3), rng)
    chis_j, chis_t, _ = _chi_lists("flat", rng, 2, 3)
    other_j, other_t, _ = _chi_lists("flat", rng, 1, 3)
    wide_j, wide_t, _ = _chi_lists("flat", rng, 2, 4)
    calls = {
        "n_times": (dict(n_times=3), chis_j, chis_t),
        "length": ({}, chis_j[:2], chis_t[:2]),
        "shapes": ({}, chis_j[:2] + other_j[:1], chis_t[:2] + other_t[:1]),
        "dim": ({}, wide_j[:3], wide_t[:3]),
        "rule": (dict(rule="first_half"), chis_j, chis_t),
    }
    if case == "type":
        with pytest.raises(TypeError):
            stt.symalg.contract_tensor_list(torch.ones(3, 3), chis_t)
        return
    kw, lj, lt = calls[case]
    with pytest.raises(ValueError) as ej:
        st.symalg.contract_tensor_list(Aj, lj, **kw)
    with pytest.raises(ValueError) as et:
        stt.symalg.contract_tensor_list(At, lt, **kw)
    assert str(et.value) == str(ej.value)


@pytest.mark.parametrize("rule", ["all", "second_half"])
def test_two_indices_take_one_gather_combine_per_contracted_value(monkeypatch, rule):
    """n_times = 2 peels one index through ``symmetric_outer``: one call of
    the gather-combine wrapper (the kernel on a CUDA tensor, its twin
    here) per contracted value, so the kernel route cannot silently give
    way to the subset loop."""
    rng = np.random.default_rng(10)
    dim = 4
    _, At, _ = _tensor_pair("flat", _sym(rng, 3, dim), rng)
    _, chis_t, _ = _chi_lists("flat", rng, 2, dim)
    calls = []
    real = gather_mm.gather_combine
    monkeypatch.setattr(gather_mm, "gather_combine",
                        lambda *a, **k: calls.append(tuple(a[2].shape)) or real(*a, **k))
    before = gather_mm.gather_combine_ref
    twin = []
    monkeypatch.setattr(gather_mm, "gather_combine_ref",
                        lambda *a: twin.append(1) or before(*a))
    out = stt.symalg.contract_tensor_list(At, chis_t, n_times=2, rule=rule)
    n_values = len(_values(rule, dim))
    # result rank 5: C(5, 3) subsets of the rank-3 × rank-2 outer
    assert calls == [(10, stt.utils.indep_size(5, dim))] * n_values
    assert len(twin) == n_values
    assert out.rank == 5
    # three indices: one launch per value at this level and at the one below
    calls.clear()
    _, A4, _ = _tensor_pair("flat", _sym(rng, 4, dim), rng)
    stt.symalg.contract_tensor_list(A4, chis_t, n_times=3, rule=rule)
    assert len(calls) == n_values + n_values ** 2


def test_stack_and_combine_helpers():
    rng = np.random.default_rng(11)
    _, chis_t, chi = _chi_lists("decomp", rng, 2, 3)
    X = tcontract._stack_flat(chis_t)
    assert tuple(X.shape) == (3, 6)
    for i in range(3):
        np.testing.assert_allclose(
            stt.FlatSymmetricTensor._raw(2, 3, X[i]).todense().numpy(), chi[i],
            atol=1e-12)
    # _combine_bilinear of an outer product is the symmetrized outer
    a, b = _sym(rng, 2, 3), _sym(rng, 1, 3)
    Fa = stt.FlatSymmetricTensor.from_dense(torch.from_numpy(a))
    Fb = stt.FlatSymmetricTensor.from_dense(torch.from_numpy(b))
    got = tcontract._combine_bilinear(torch.outer(Fa.data, Fb.data), 2, 1, 3)
    np.testing.assert_allclose(got.data.numpy(),
                               stt.symalg.multiply.outer(Fa, Fb).data.numpy(),
                               rtol=1e-12)
    s = tcontract._combine_bilinear(torch.tensor([[2.5]], dtype=torch.float64), 0, 0, 3)
    assert (s.rank, s.dim) == (0, 1) and float(s.data[0]) == 2.5
