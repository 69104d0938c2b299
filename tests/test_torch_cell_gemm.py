"""The port's cell-major batched GEMMs against the JAX package's
(``tests/test_cell_gemm.py``'s counterparts).

Inputs come from each test's own seeded NumPy generator and go to both
packages in float64; the JAX references are jitted. Errors are normalised:
max|Δ| / max|reference|.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import symtensor_tpu as st
import symtensor_tpu_torch as stt
from symtensor_tpu.kernels import cell_gemm as jcg
from symtensor_tpu.kernels import poly_eval as jpe
from symtensor_tpu_torch.config import config
from symtensor_tpu_torch.interop import flat_from_numpy
from symtensor_tpu_torch.kernels import cell_gemm as tcg
from symtensor_tpu_torch.kernels import poly_eval as tpe
from symtensor_tpu_torch.utils import combinatorics as comb

SHAPES = [(3, 2), (3, 4), (3, 9), (4, 1), (4, 6), (4, 11), (5, 5), (6, 6)]


@pytest.fixture(autouse=True)
def _cpu_default_device(monkeypatch):
    monkeypatch.setattr(config, "default_device", "cpu")
    monkeypatch.delenv("SYMTENSOR_BATCHED_CELL", raising=False)


def _pair(rank, dim, seed, batch=7):
    rng = np.random.default_rng(seed)
    data = rng.normal(size=comb.indep_size(rank, dim))
    xs = rng.normal(size=(batch, dim))
    Aj = st.FlatSymmetricTensor._raw(rank, dim, jnp.asarray(data))
    At = flat_from_numpy(rank, dim, data, device="cpu")
    return Aj, At, xs


def _nerr(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / np.abs(want).max())


@pytest.mark.parametrize("rank,dim", SHAPES)
def test_matches_jax_and_grouped_path(rank, dim):
    Aj, At, xs = _pair(rank, dim, 3 * rank + dim)
    assert tcg.cell_eligible(rank, dim) and jcg.cell_eligible(rank, dim)
    got = tcg.poly_eval_cell_batched(At, torch.from_numpy(xs))
    assert got.shape == (len(xs),) and got.dtype == torch.float64
    want = jcg.poly_eval_cell_batched(Aj, jnp.asarray(xs))
    assert _nerr(got, want) <= 1e-10
    assert _nerr(got, tpe.poly_eval_flat_batched(At, torch.from_numpy(xs))) <= 1e-10


def test_matches_dense_einsum_oracle():
    rank, dim = 4, 5
    rng = np.random.default_rng(1)
    dense = stt.ops.symmetrize(torch.from_numpy(rng.normal(size=(dim,) * rank)))
    A = stt.FlatSymmetricTensor.from_dense(dense)
    xs = rng.normal(size=(3, dim))
    ref = np.einsum("ijkl,bi,bj,bk,bl->b", dense.numpy(), xs, xs, xs, xs)
    got = tcg.poly_eval_cell_batched(A, torch.from_numpy(xs))
    assert _nerr(got, ref) <= 1e-12


@pytest.mark.parametrize("rank,dim", [(3, 20), (4, 20), (5, 7)])
def test_block_structure_matches_jax(rank, dim):
    blocks = tcg._cell_blocks_static(rank, dim)
    want = jcg._cell_blocks_static(rank, dim)
    assert len(blocks) == len(want)
    for (K, t1s, t2s, idx, scale), (Kj, t1j, t2j, idxj, scalej) in zip(blocks, want):
        assert K == Kj and idx.dtype == np.int64
        for a, b in ((t1s, t1j), (t2s, t2j), (idx, idxj), (scale, scalej)):
            np.testing.assert_array_equal(a, b)


def test_block_structure_invariants():
    rank, dim = 4, 20
    n = comb.indep_size(rank, dim)
    blocks = tcg._cell_blocks_static(rank, dim)
    Ks = [b[0] for b in blocks]
    assert Ks == sorted(Ks)  # prefixes never shrink
    cells = set()
    for K, t1s, t2s, idx, scale in blocks:
        assert idx.shape == scale.shape == (K * len(t1s),)
        assert (t1s <= t2s).all()
        cells.update(zip(t1s.tolist(), t2s.tolist()))
        assert idx.min() >= 0 and idx.max() < n
    assert len(cells) == dim * (dim + 1) // 2  # the cells tile the wedge
    # the nonzero scales count the independent components exactly
    assert sum(int((b[4] != 0).sum()) for b in blocks) == n
    # every packed value lands in exactly one nonzero slot
    hit = np.concatenate([b[3][b[4] != 0] for b in blocks])
    np.testing.assert_array_equal(np.sort(hit), np.arange(n))


@pytest.mark.parametrize("rank,dim", [(3, 300), (4, 100), (4, 101), (5, 30),
                                      (5, 31), (6, 12), (2, 5)])
def test_eligibility_matches_jax(rank, dim):
    assert tcg.cell_eligible(rank, dim) == jcg.cell_eligible(rank, dim)


def test_env_switch_routes_the_public_op(monkeypatch):
    Aj, At, xs = _pair(4, 7, 5)
    x = torch.from_numpy(xs)
    op = stt.symalg.contract_all_indices_with_vector_batched
    calls = []
    real = tcg.poly_eval_cell_batched
    monkeypatch.setattr(tcg, "poly_eval_cell_batched",
                        lambda *a: calls.append(1) or real(*a))
    ref = op(At, x)
    assert calls == []
    monkeypatch.setenv("SYMTENSOR_BATCHED_CELL", "1")  # read at call time
    got = op(At, x)
    assert calls == [1]
    assert _nerr(got, ref) <= 1e-10
    want = np.asarray(jax.jit(jpe.poly_eval_flat_batched)(Aj, jnp.asarray(xs)))
    assert _nerr(got, want) <= 1e-10
    # past the level-2 limit the switch leaves the grouped route in place
    monkeypatch.setattr(tcg, "_MAX_LEVEL2", 1)
    op(At, x)
    assert calls == [1]
    monkeypatch.setenv("SYMTENSOR_BATCHED_CELL", "0")
    monkeypatch.setattr(tcg, "_MAX_LEVEL2", 65536)
    op(At, x)
    assert calls == [1]


def test_grad_through_cell_path_matches_jax():
    rank, dim = 4, 6
    Aj, At, xs = _pair(rank, dim, 8, batch=4)
    w = np.random.default_rng(9).normal(size=len(xs))

    def loss_j(x):
        return jnp.dot(jcg.poly_eval_cell_batched(Aj, x), jnp.asarray(w))

    want_x = jax.grad(loss_j)(jnp.asarray(xs))
    vals = At.data.clone().requires_grad_()
    x = torch.from_numpy(xs).requires_grad_()
    y = tcg.poly_eval_cell_batched(type(At)._raw(rank, dim, vals), x)
    gv, gx = torch.autograd.grad(y @ torch.from_numpy(w), (vals, x))
    assert _nerr(gx, want_x) <= 1e-10
    # the values' gradient against the grouped route's (_BatchedEval)
    v2 = At.data.clone().requires_grad_()
    y2 = tpe.poly_eval_flat_batched(type(At)._raw(rank, dim, v2), torch.from_numpy(xs))
    (gv2,) = torch.autograd.grad(y2 @ torch.from_numpy(w), v2)
    assert _nerr(gv, gv2) <= 1e-10
    # and a central difference in one input
    eps = 1e-6
    xp, xm = xs.copy(), xs.copy()
    xp[2, 3] += eps
    xm[2, 3] -= eps
    num = (float(loss_j(jnp.asarray(xp))) - float(loss_j(jnp.asarray(xm)))) / (2 * eps)
    np.testing.assert_allclose(float(gx[2, 3]), num, rtol=1e-7)


def test_training_through_the_switch(monkeypatch):
    """The values' gradient reaches the public batched op under the switch:
    the views are built in the graph and never cached."""
    _, At, xs = _pair(3, 6, 11)
    vals = At.data.clone().requires_grad_()
    A = type(At)._raw(3, 6, vals)
    x = torch.from_numpy(xs)
    op = stt.symalg.contract_all_indices_with_vector_batched
    (ref,) = torch.autograd.grad(op(A, x).sum(), vals)
    monkeypatch.setenv("SYMTENSOR_BATCHED_CELL", "1")
    (got,) = torch.autograd.grad(op(A, x).sum(), vals)
    assert "_cell_views" not in A.__dict__
    assert _nerr(got, ref) <= 1e-10


def test_views_cached_once_and_rebuilt_after_an_in_place_change():
    _, At, xs = _pair(3, 6, 12)
    x = torch.from_numpy(xs)
    v1 = tcg.cell_views(At)
    assert tcg.cell_views(At) is v1
    y1 = tcg.poly_eval_cell_batched(At, x)
    At.data.mul_(-0.5)
    v2 = tcg.cell_views(At)
    assert v2 is not v1
    y2 = tcg.poly_eval_cell_batched(At, x)
    np.testing.assert_allclose(y2.numpy(), -0.5 * y1.numpy(), rtol=1e-12)
    assert tcg.cell_views(At) is v2


def test_batch_chunking(monkeypatch):
    Aj, At, xs = _pair(3, 5, 13, batch=37)
    monkeypatch.setattr(tcg, "_MAX_WEIGHT_ELEMS", 1)  # chunks of 16
    calls = []
    real = tcg._cell_eval
    monkeypatch.setattr(tcg, "_cell_eval", lambda *a: calls.append(len(a[1])) or real(*a))
    got = tcg.poly_eval_cell_batched(At, torch.from_numpy(xs))
    assert calls == [16, 16, 5]
    assert _nerr(got, jax.jit(jpe.poly_eval_flat_batched)(Aj, jnp.asarray(xs))) <= 1e-10


def test_bfloat16_storage_within_2e_2_of_float32():
    _, At, xs = _pair(4, 8, 7)
    x32 = torch.from_numpy(xs).float()
    ref = tcg.poly_eval_cell_batched(At.astype(torch.float32), x32)
    A16 = At.astype(torch.bfloat16)
    got = tcg.poly_eval_cell_batched(A16, x32)
    assert got.dtype == torch.float32
    assert all(V.dtype == torch.bfloat16 for V, _, _ in tcg.cell_views(A16))
    assert _nerr(got, ref) <= 2e-2
