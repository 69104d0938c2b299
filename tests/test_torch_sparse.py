"""The port's sparse format against the JAX package's, on the CPU.

Mirrors the sparse half of ``tests/test_views_sparse.py`` and adds what
the port keeps beside it: duplicate entries, the batched contraction over
blocks of entries, the leaves' types and ``memory_footprint`` against the
JAX package's in its default (32-bit) mode.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import symtensor_tpu as st
import symtensor_tpu_torch as stt
from symtensor_tpu.ops.symmetrize import symmetrize
from symtensor_tpu.utils.profiling import reset_counters as jax_reset_counters
from symtensor_tpu_torch.config import config
from symtensor_tpu_torch.core import sparse_flat as tsf
from symtensor_tpu_torch.interop import sparse_from_numpy, sparse_to_numpy
from symtensor_tpu_torch.utils.profiling import op_counters, reset_counters


@pytest.fixture(autouse=True)
def _cpu_and_fresh_warnings(monkeypatch):
    """Tensors go to the CPU, and each test leaves both packages'
    once-per-site warnings as a fresh process has them."""
    monkeypatch.setattr(config, "default_device", "cpu")
    yield
    reset_counters()
    jax_reset_counters()


def random_sym(rank, dim, rng):
    return np.asarray(symmetrize(rng.normal(size=(dim,) * rank)))


def _entries(rank, dim, nnz, seed, dup=0):
    """Seeded multi-indices (unsorted within rows) and values; the first
    `dup` entries appear twice."""
    rng = np.random.default_rng(seed)
    idx = rng.integers(0, dim, size=(nnz, rank))
    vals = rng.normal(size=nnz)
    return (np.concatenate([idx, idx[:dup]]), np.concatenate([vals, vals[:dup] * 0.5]))


def _pair(rank, dim, nnz, seed, dup=0):
    idx, vals = _entries(rank, dim, nnz, seed, dup)
    Sj = st.SparseFlatSymmetricTensor.from_entries(rank, dim, idx, vals, dtype=jnp.float64)
    St = stt.SparseFlatSymmetricTensor.from_entries(
        rank, dim, torch.from_numpy(idx), torch.from_numpy(vals))
    return Sj, St


# ---------------------------------------------- tests/test_views_sparse.py


def test_sparse_roundtrip():
    rng = np.random.default_rng(0)
    dense = random_sym(3, 5, rng)
    A = stt.FlatSymmetricTensor.from_dense(torch.from_numpy(dense))
    S = stt.SparseFlatSymmetricTensor.from_flat(A)
    assert S.nnz == A.size
    np.testing.assert_allclose(S.todense().numpy(), dense, atol=1e-12)
    A2 = stt.FlatSymmetricTensor(
        rank=2, dim=4, data=torch.tensor([1.0, 0.0, 0.0, 2.0] + [0.0] * 6))
    S2 = stt.SparseFlatSymmetricTensor.from_flat(A2, threshold=0.5)
    assert S2.nnz == 2
    assert S2.memory_footprint() < A2.memory_footprint() + 100


def test_sparse_from_entries_and_element():
    dim, rank = 500, 3
    S = stt.SparseFlatSymmetricTensor.from_entries(
        rank, dim, [(0, 1, 2), (5, 5, 7), (499, 0, 3)], [1.5, -2.0, 3.0])
    assert S.nnz == 3
    np.testing.assert_allclose(float(S[2, 0, 1]), 1.5)
    np.testing.assert_allclose(float(S[5, 7, 5]), -2.0)
    np.testing.assert_allclose(float(S[0, 3, 499]), 3.0)
    np.testing.assert_allclose(float(S[1, 1, 1]), 0.0)


def test_sparse_poly_eval():
    rng = np.random.default_rng(1)
    dense = random_sym(3, 5, rng)
    A = stt.FlatSymmetricTensor.from_dense(torch.from_numpy(dense))
    S = stt.SparseFlatSymmetricTensor.from_flat(A)
    x = rng.normal(size=5)
    got = float(stt.symalg.contract_all_indices_with_vector(S, x))
    np.testing.assert_allclose(got, np.einsum("ijk,i,j,k->", dense, x, x, x), rtol=1e-9)
    dim = 1000
    S2 = stt.SparseFlatSymmetricTensor.from_entries(
        3, dim, [(0, 1, 2), (10, 10, 999)], [2.0, 1.0], dtype=torch.float64)
    x = rng.normal(size=dim)
    got = float(stt.symalg.contract_all_indices_with_vector(S2, x))
    want = 2.0 * 6 * x[0] * x[1] * x[2] + 1.0 * 3 * x[10] ** 2 * x[999]
    np.testing.assert_allclose(got, want, rtol=1e-9)


def test_sparse_arithmetic():
    rng = np.random.default_rng(2)
    dense_a, dense_b = random_sym(2, 4, rng), random_sym(2, 4, rng)
    Sa, Sb = (stt.SparseFlatSymmetricTensor.from_flat(
        stt.FlatSymmetricTensor.from_dense(torch.from_numpy(d)))
        for d in (dense_a, dense_b))
    s = Sa + Sb
    assert isinstance(s, stt.SparseFlatSymmetricTensor)
    np.testing.assert_allclose(s.todense().numpy(), dense_a + dense_b, atol=1e-12)
    m = Sa * 3.0
    assert isinstance(m, stt.SparseFlatSymmetricTensor)
    np.testing.assert_allclose(m.todense().numpy(), 3 * dense_a, atol=1e-12)
    assert isinstance(-Sa, stt.SparseFlatSymmetricTensor)
    assert isinstance(Sa / 2.0, stt.SparseFlatSymmetricTensor)
    assert isinstance(2.0 * Sa, stt.SparseFlatSymmetricTensor)
    d = Sa - Sb
    assert isinstance(d, stt.SparseFlatSymmetricTensor)
    np.testing.assert_allclose(d.todense().numpy(), dense_a - dense_b, atol=1e-12)
    reset_counters()  # the warning below comes once per site and process
    with pytest.warns(UserWarning):
        p = Sa * Sb
    assert op_counters["sparse_flat.densify_storage"] >= 1
    np.testing.assert_allclose(p.todense().numpy(), dense_a * dense_b, atol=1e-12)


# ------------------------------------------------- against the JAX package


@pytest.mark.parametrize("rank,dim,nnz", [(1, 5, 6), (2, 4, 9),
                                          (3, 5, 20), (4, 6, 30), (6, 4, 40)])
def test_from_entries_and_contractions_match_jax(rank, dim, nnz):
    Sj, St = _pair(rank, dim, nnz, 10 + rank, dup=2)
    assert St.nnz == Sj.nnz
    np.testing.assert_array_equal(St.rep.numpy(), np.asarray(Sj.rep))
    np.testing.assert_array_equal(St.gamma.numpy(), np.asarray(Sj.gamma))
    np.testing.assert_array_equal(St.positions.numpy(),
                                  np.asarray(Sj.bcoo.indices[:, 0]))
    assert St.rep.dtype == torch.int32 and St.positions.dtype == torch.int32
    assert St.gamma.dtype == torch.float32
    np.testing.assert_allclose(St.toflat().data.numpy(),
                               np.asarray(Sj.toflat().data), rtol=1e-12)
    rng = np.random.default_rng(50 + rank)
    x, xs = rng.normal(size=dim), rng.normal(size=(7, dim))
    np.testing.assert_allclose(
        float(stt.symalg.contract_all_indices_with_vector(St, x)),
        float(st.symalg.contract_all_indices_with_vector(Sj, jnp.asarray(x))),
        rtol=1e-10)
    np.testing.assert_allclose(
        stt.symalg.contract_all_indices_with_vector_batched(St, torch.from_numpy(xs)).numpy(),
        np.asarray(st.symalg.contract_all_indices_with_vector_batched(Sj, jnp.asarray(xs))),
        rtol=1e-10)


def test_rank_zero():
    """Rank 0 (the JAX package's ``from_entries`` refuses it; its
    ``from_flat`` takes it): every entry sits at position 0."""
    S = stt.SparseFlatSymmetricTensor.from_entries(
        0, 1, torch.zeros((3, 0), dtype=torch.int64),
        torch.tensor([1.0, 2.0, 0.5], dtype=torch.float64))
    assert S.nnz == 3 and float(S.element(())) == 3.5
    assert float(stt.symalg.contract_all_indices_with_vector(S, torch.ones(1))) == 3.5
    np.testing.assert_allclose(
        stt.symalg.contract_all_indices_with_vector_batched(S, torch.ones(4, 1)).numpy(),
        [3.5] * 4)
    Sj = st.SparseFlatSymmetricTensor.from_flat(
        st.FlatSymmetricTensor._raw(0, 1, jnp.asarray([2.5])))
    St = stt.SparseFlatSymmetricTensor.from_flat(
        stt.FlatSymmetricTensor._raw(0, 1, torch.tensor([2.5], dtype=torch.float64)))
    assert St.nnz == Sj.nnz == 1 and St.rep.shape == (1, 0)
    assert float(St.toflat().data[0]) == float(Sj.toflat().data[0]) == 2.5


def test_batched_blocks_over_entries(monkeypatch):
    """A block budget of a few elements splits the entries into many
    blocks with a ragged last one; the result does not change."""
    Sj, St = _pair(4, 5, 37, 3, dup=4)
    xs = np.random.default_rng(4).normal(size=(6, 5))
    want = np.asarray(st.symalg.contract_all_indices_with_vector_batched(Sj, jnp.asarray(xs)))
    monkeypatch.setattr(tsf, "BATCH_BLOCK_ELEMS", 6 * 5)
    got = stt.symalg.contract_all_indices_with_vector_batched(St, torch.from_numpy(xs))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-10)


def test_duplicates_sum_in_toflat_and_element():
    S = stt.SparseFlatSymmetricTensor.from_entries(
        3, 4, [(0, 1, 2), (2, 1, 0), (3, 3, 3), (1, 0, 2)], [1.0, 2.0, 5.0, 0.25],
        dtype=torch.float64)
    assert S.nnz == 4
    np.testing.assert_allclose(float(S[1, 2, 0]), 3.25)
    np.testing.assert_allclose(float(S.toflat()[0, 2, 1]), 3.25)
    T = S.add_sparse(S)
    assert T.nnz == 8
    np.testing.assert_allclose(T.toflat().data.numpy(), 2 * S.toflat().data.numpy())
    np.testing.assert_allclose(float(T[3, 3, 3]), 10.0)


def test_element_class_values_updates_match_jax():
    Sj, St = _pair(3, 4, 12, 7, dup=3)
    for idx in [(0, 0, 0), (1, 2, 3), (3, 1, 1), (-1, 0, 2)]:
        np.testing.assert_allclose(float(St[idx]), float(Sj[idx]), rtol=1e-12)
    for label in ("iii", "iij", "ijk"):
        np.testing.assert_allclose(St[label].numpy(), np.asarray(Sj[label]), rtol=1e-12)
    for got, want in ((St.at[1, 2, 3].set(4.0), Sj.at[1, 2, 3].set(4.0)),
                      (St.at["iij"].set(0.5), Sj.at["iij"].set(0.5)),
                      (St.at[0, 0, 1].add(1.0), Sj.at[0, 0, 1].add(1.0)),
                      (St[2], Sj[2])):
        np.testing.assert_allclose(got.todense().numpy(), np.asarray(want.todense()),
                                   rtol=1e-12)
    with pytest.raises(IndexError):
        St[4, 0, 0]


def test_structure_dtype_device_and_copy():
    _, St = _pair(3, 4, 10, 8)
    assert St.size == St.nnz == 10 and St.format == "sparse_flat"
    assert list(St.keys()) == ["values", "indices"]
    assert [v.shape for v in St.values()] == [(10,), (10,)]
    f32 = St.astype(torch.float32)
    assert f32.dtype == torch.float32 and f32.rep is St.rep
    assert St.to("cpu").device == torch.device("cpu")
    c = St.copy()
    c.vals.mul_(2)
    assert not St.allclose(c)
    assert "nnz=10" in repr(St)


def test_memory_footprint_matches_jax_in_its_default_mode():
    """Values and int32 positions: the bytes of the JAX package's BCOO in
    its default 32-bit mode, for the same entries."""
    idx, vals = _entries(4, 6, 25, 9, dup=5)
    with jax.enable_x64(False):
        Sj = st.SparseFlatSymmetricTensor.from_entries(4, 6, idx, vals)
        want = Sj.memory_footprint()
    St = stt.SparseFlatSymmetricTensor.from_entries(4, 6, idx, vals)
    assert St.dtype == torch.float32
    assert St.memory_footprint() == want == 30 * (4 + 4)


def test_from_flat_matches_jax_and_keeps_the_guard(monkeypatch):
    rng = np.random.default_rng(12)
    data = rng.normal(size=st.utils.indep_size(4, 4)) * (rng.random(35) < 0.4)
    Sj = st.SparseFlatSymmetricTensor.from_flat(
        st.FlatSymmetricTensor._raw(4, 4, jnp.asarray(data)))
    St = stt.SparseFlatSymmetricTensor.from_flat(
        stt.FlatSymmetricTensor._raw(4, 4, torch.from_numpy(data)))
    assert St.nnz == Sj.nnz
    np.testing.assert_array_equal(St.rep.numpy(), np.asarray(Sj.rep))
    np.testing.assert_array_equal(St.vals.numpy(), np.asarray(Sj.bcoo.data))
    from symtensor_tpu_torch.utils.tables import tables

    tables(4, 5)._cache.clear()  # another test may have built rep_np already
    monkeypatch.setattr(config, "max_table_entries", 10)
    with pytest.raises(MemoryError):
        stt.SparseFlatSymmetricTensor.from_flat(
            stt.FlatSymmetricTensor._raw(4, 5, torch.zeros(70)))
    tables(4, 5)._cache.clear()


def test_from_entries_rejects_bad_input():
    with pytest.raises(ValueError):
        stt.SparseFlatSymmetricTensor.from_entries(3, 4, [(0, 1)], [1.0])
    with pytest.raises(IndexError):
        stt.SparseFlatSymmetricTensor.from_entries(2, 4, [(0, 4)], [1.0])
    with pytest.raises(ValueError):
        stt.SparseFlatSymmetricTensor.from_entries(2, 4, [(0, 1), (1, 1)], [1.0])


def test_gradient_through_values():
    """The sparse contraction is plain torch: autograd carries the values'
    gradient, γ_I·∏ x[rep_I]."""
    _, St = _pair(3, 4, 6, 13)
    v = St.vals.clone().requires_grad_(True)
    S = stt.SparseFlatSymmetricTensor._raw(3, 4, v, St.positions, St.rep, St.gamma)
    x = torch.from_numpy(np.random.default_rng(2).normal(size=4))
    stt.symalg.contract_all_indices_with_vector(S, x).backward()
    want = St.gamma.double() * x[St.rep.long()].prod(1)
    np.testing.assert_allclose(v.grad.numpy(), want.numpy(), rtol=1e-12)


def test_interop_roundtrip_with_jax():
    Sj, _ = _pair(4, 5, 15, 14, dup=2)
    St = sparse_from_numpy(4, 5, np.asarray(Sj.bcoo.data), np.asarray(Sj.rep),
                           device="cpu")
    assert St.dtype == torch.float64
    np.testing.assert_allclose(St.toflat().data.numpy(), np.asarray(Sj.toflat().data))
    vals, idx = sparse_to_numpy(St)
    back = st.SparseFlatSymmetricTensor.from_entries(4, 5, idx, vals, dtype=jnp.float64)
    np.testing.assert_array_equal(np.asarray(back.toflat().data),
                                  np.asarray(Sj.toflat().data))


_TYPES = {"float32": (torch.float32, jnp.float32),
          "float64": (torch.float64, jnp.float64),
          "bfloat16": (torch.bfloat16, jnp.bfloat16)}


@pytest.mark.parametrize("op", ["add", "subtract"])
@pytest.mark.parametrize("left,right", [
    ("float32", "float64"), ("float64", "float32"),
    ("bfloat16", "float32"), ("float32", "bfloat16")])
def test_mixed_dtype_sum_promotes_like_jax(left, right, op):
    """sparse ± sparse of two value types has the promoted type in both
    orders, as the JAX package's concatenation gives it; its values and
    its contraction (with a float64 x) agree with the JAX package's."""
    rank, dim = 3, 5
    parts = []
    for k, name in enumerate((left, right)):
        tt, jt = _TYPES[name]
        idx, vals = _entries(rank, dim, 9 + k, 60 + k, dup=2)
        # values exactly representable in the narrower type, for both
        vals = torch.from_numpy(vals).to(tt).double().numpy()
        parts.append((
            st.SparseFlatSymmetricTensor.from_entries(rank, dim, idx, vals, dtype=jt),
            stt.SparseFlatSymmetricTensor.from_entries(
                rank, dim, torch.from_numpy(idx), torch.from_numpy(vals).to(tt))))
    (Aj, At), (Bj, Bt) = parts
    Sj = Aj + Bj if op == "add" else Aj - Bj
    St = At + Bt if op == "add" else At - Bt
    assert isinstance(St, stt.SparseFlatSymmetricTensor)
    want_t = torch.promote_types(_TYPES[left][0], _TYPES[right][0])
    assert St.dtype == want_t
    assert str(np.dtype(Sj.dtype)) == str(want_t).removeprefix("torch.")
    assert St.positions.dtype == torch.int32 and St.nnz == At.nnz + Bt.nnz
    got = St.toflat().data.double().numpy()
    np.testing.assert_allclose(got, np.asarray(Sj.toflat().data, dtype=np.float64),
                               rtol=1e-12, atol=1e-12)
    x = np.random.default_rng(61).normal(size=dim)
    np.testing.assert_allclose(
        float(stt.symalg.contract_all_indices_with_vector(St, torch.from_numpy(x))),
        float(st.symalg.contract_all_indices_with_vector(Sj, jnp.asarray(x))),
        rtol=1e-12)


def test_sum_keeps_the_wider_position_type():
    _, At = _pair(2, 4, 5, 62)
    _, Bt = _pair(2, 4, 6, 63)
    wide = stt.SparseFlatSymmetricTensor._raw(
        2, 4, Bt.vals, Bt.positions.long(), Bt.rep, Bt.gamma)
    for S in (At.add_sparse(wide), wide.add_sparse(At)):
        assert S.positions.dtype == torch.int64
        np.testing.assert_allclose(S.toflat().data.numpy(),
                                   (At.toflat().data + Bt.toflat().data).numpy(),
                                   rtol=1e-12)
