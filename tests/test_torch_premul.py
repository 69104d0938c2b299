"""The port's premultiplied group views against the JAX package's.

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
from symtensor_tpu.kernels import poly_eval as jpe
from symtensor_tpu_torch.interop import flat_from_numpy
from symtensor_tpu_torch.kernels import poly_eval as tpe
from symtensor_tpu_torch.kernels.group_pass import row_offsets
from symtensor_tpu_torch.utils import combinatorics as comb
from symtensor_tpu_torch.utils.tables import tables

SHAPES = [(3, 5), (4, 4), (5, 4), (6, 3)]


def _pair(rank, dim, seed, batch=6):
    rng = np.random.default_rng(seed)
    data = rng.normal(size=comb.indep_size(rank, dim))
    xs = rng.normal(size=(batch, dim))
    Aj = st.FlatSymmetricTensor._raw(rank, dim, jnp.asarray(data))
    At = flat_from_numpy(rank, dim, data, device="cpu")
    return Aj, At, xs


def _nerr(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / np.abs(want).max())


def _jax_factors(rank, dim):
    """Per group the (3, P_j) float64 column factors built from the JAX
    package's (ρ2, ρ3) pair and c1 = 1/(q+1) of its head tables: c1·(1 +
    ρ2 + ρ3) on column 0, c1·(1 + ρ2) on columns 1..d−j−1, c1 beyond."""
    maxel, maxrun = jpe._head_weights(st.utils.get_tables(rank, dim),
                                      jnp.ones(dim), rank)[1:]
    P = tpe._grouped_static(rank, dim)[0]
    out = []
    for j, (rho2, rho3) in enumerate(jpe._premul_static(rank, dim)):
        q = np.where(np.asarray(maxel)[: P[j]] == j, np.asarray(maxrun)[: P[j]], 0)
        c1 = 1.0 / (q + 1.0)
        out.append(np.stack([c1 * (1.0 + rho2 + rho3), c1 * (1.0 + rho2), c1]))
    return out


def _port_factors(rank, dim):
    """The same factors as the port folds them into its views: the
    ``_fold_scales`` of the float64 row weights, group by group, in the
    order (column 0, columns 1..d−j−1, beyond)."""
    t = tables(rank, dim, torch.device("cpu"))
    scales = tpe._fold_scales(tpe._row_maps(t)[2])[..., 0].flip(0)
    prow = row_offsets(t.layout)
    P = tpe._grouped_static(rank, dim)[0]
    return [scales[:, prow[j] : prow[j] + P[j]] for j in range(dim)]


@pytest.mark.parametrize("rank,dim", SHAPES)
def test_premul_static_matches_jax(rank, dim):
    """The port's per-group factors against the ones built from the JAX
    package's pair: equal bit for bit once cast to float32 or bfloat16,
    the storage types of the card's premultiplied routes, and to 1e-15 in
    float64 (c1 + c2 and c1·(1 + ρ2) may round apart in the last bit)."""
    for got, want in zip(_port_factors(rank, dim), _jax_factors(rank, dim)):
        want = torch.from_numpy(want)
        for dt in (torch.float32, torch.bfloat16):
            assert torch.equal(got.to(dt), want.to(dt))
        np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-15, atol=0)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("rank,dim", SHAPES)
def test_views_bit_equal_to_values_times_jax_factors(rank, dim, dtype):
    """``group_views_premul`` of float32 and bfloat16 values equals each
    block V_j times the JAX-built factors rounded to the storage type, bit
    for bit: one rounding of each product."""
    _, At, _ = _pair(rank, dim, 30 + rank)
    A = At.astype(dtype)
    views = tpe.group_views_premul(A)
    P, T, goff, _ = tpe._grouped_static(rank, dim)
    for j, (V, f) in enumerate(zip(views.blocks, _jax_factors(rank, dim))):
        f = torch.from_numpy(f).to(dtype)
        col = torch.arange(T[j])[None, :]
        F = torch.where(col == 0, f[0][:, None],
                        torch.where(col < dim - j, f[1][:, None], f[2][:, None]))
        want = A.data[goff[j] : goff[j] + P[j] * T[j]].view(P[j], T[j]) * F
        assert V.dtype == dtype and torch.equal(V, want)


@pytest.mark.parametrize("rank,dim", SHAPES)
def test_views_match_jax(rank, dim):
    Aj, At, _ = _pair(rank, dim, 3 + rank)
    views = tpe.group_views_premul(At)
    want = jpe.group_views_premul(Aj)
    assert views.rank == rank and len(views.blocks) == dim
    P, T, _, _ = tpe._grouped_static(rank, dim)
    # the port folds c1 = 1/(q+1) into the rows as well
    for j, (V, W, f) in enumerate(zip(views.blocks, want, _jax_factors(rank, dim))):
        assert V.shape == (P[j], T[j]) and V.dtype == torch.float64
        np.testing.assert_allclose(V.numpy(), f[2][:, None] * np.asarray(W),
                                   rtol=1e-15, atol=0)


@pytest.mark.parametrize("rank,dim", SHAPES)
def test_single_input_matches_jax_fast_route(rank, dim):
    Aj, At, xs = _pair(rank, dim, 10 + rank)
    views = tpe.group_views_premul(At)
    for x in xs[:2]:
        want = float(jpe.poly_eval_flat_fast(Aj, jnp.asarray(x)))
        got = tpe.views_eval_premul(views, torch.from_numpy(x))
        assert got.shape == () and got.dtype == torch.float64
        assert abs(float(got) - want) <= 1e-10 * abs(want)
        assert _nerr(got, tpe.poly_eval_flat_fast(At, torch.from_numpy(x))) <= 1e-10


@pytest.mark.parametrize("rank,dim", SHAPES)
def test_batched_matches_jax_premul(rank, dim):
    Aj, At, xs = _pair(rank, dim, 20 + rank)
    want = jpe._views_eval_batched_premul_jitted(rank, dim)(
        jpe.group_views_premul(Aj), jnp.asarray(xs))
    got = tpe.views_eval_batched_premul(tpe.group_views_premul(At), torch.from_numpy(xs))
    assert got.shape == (len(xs),) and got.dtype == torch.float64
    assert _nerr(got, want) <= 1e-10
    fold = jax.jit(jpe.poly_eval_flat_batched)(Aj, jnp.asarray(xs))
    assert _nerr(got, fold) <= 1e-10


@pytest.mark.parametrize("rank,dim", [(3, 5), (4, 8), (6, 4)])
def test_bfloat16_storage_within_2e_2_of_float32(rank, dim):
    """The shapes and seed of test_torch_poly_eval's bfloat16 test; the
    premultiplied copy adds one rounding to bfloat16 storage, so it is also
    held to the fold route over the same bfloat16 values."""
    _, At, xs = _pair(rank, dim, 7)
    A32 = At.astype(torch.float32)
    x32 = torch.from_numpy(xs).float()
    ref = tpe.poly_eval_flat_batched(A32, x32)
    A16 = At.astype(torch.bfloat16)
    fold = tpe._BatchedEval.apply(A16.data, x32, A16.tables, rank, dim, torch.float32)
    views = tpe.group_views_premul(A16)
    assert all(V.dtype == torch.bfloat16 for V in views.blocks)
    got = tpe.views_eval_batched_premul(views, x32)
    assert got.dtype == torch.float32
    assert _nerr(got, ref) <= 2e-2 and _nerr(got, fold) <= 2e-2
    assert _nerr(tpe.views_eval_premul(views, x32[0]), ref[:1]) <= 2e-2


def test_views_cached_and_rebuilt_after_an_in_place_change():
    _, At, xs = _pair(4, 5, 40)
    x = torch.from_numpy(xs)
    v1 = tpe.group_views_premul(At)
    assert tpe.group_views_premul(At) is v1
    y1 = tpe.views_eval_batched_premul(v1, x)
    At.data.mul_(2.0)  # an optimizer's in-place step
    assert tpe._cache_hit(At, "_group_views_premul") is None
    v2 = tpe.group_views_premul(At)
    assert v2 is not v1
    np.testing.assert_allclose(v2.blocks[3].numpy(), 2 * v1.blocks[3].numpy(), rtol=1e-15)
    y2 = tpe.views_eval_batched_premul(v2, x)
    np.testing.assert_allclose(y2.numpy(), 2 * y1.numpy(), rtol=1e-12)
    # new data in the tensor: a new cache
    At.data = At.data.clone()
    assert tpe._cache_hit(At, "_group_views_premul") is None
    assert tpe.group_views_premul(At) is not v2


def test_routing_reads_an_existing_cache(monkeypatch):
    """bfloat16 values take the premultiplied views, built on the first
    call and read from the cache after; a cache on values of another type
    is left unread: they take the fold route."""
    _, At, xs = _pair(5, 4, 50)
    x = torch.from_numpy(xs)
    seen = []
    real = tpe.views_eval_batched_premul
    monkeypatch.setattr(tpe, "views_eval_batched_premul",
                        lambda views, *a: seen.append(views) or real(views, *a))
    fold = tpe.poly_eval_flat_batched(At, x)
    assert "_group_views_premul" not in At.__dict__
    tpe.group_views_premul(At)
    assert torch.equal(tpe.poly_eval_flat_batched(At, x), fold)
    assert seen == []
    A16, x32 = At.astype(torch.bfloat16), x.float()
    first = tpe.poly_eval_flat_batched(A16, x32)
    assert len(seen) == 1 and tpe._cache_hit(A16, "_group_views_premul") is seen[0]
    again = tpe.poly_eval_flat_batched(A16, x32)
    assert len(seen) == 2 and seen[1] is seen[0] and torch.equal(again, first)
    A16.data.add_(0.0)  # stale: the views are built anew
    tpe.poly_eval_flat_batched(A16, x32)
    assert len(seen) == 3 and seen[2] is not seen[0]


def test_bfloat16_storage_routes_to_the_premul_views():
    _, At, xs = _pair(4, 5, 55)
    A16 = At.astype(torch.bfloat16)
    x = torch.from_numpy(xs).float()
    fold = tpe._BatchedEval.apply(A16.data, x, A16.tables, 4, 5, torch.float32)
    got = tpe.poly_eval_flat_batched(A16, x)
    assert tpe._cache_hit(A16, "_group_views_premul") is not None
    assert _nerr(got, fold) <= 2e-2  # the premultiplied copy rounds once more


def test_no_cache_while_the_values_need_a_gradient():
    _, At, xs = _pair(4, 5, 60)
    x = torch.from_numpy(xs)
    vals = At.data.clone().requires_grad_()
    A = type(At)._raw(4, 5, vals)
    views = tpe.group_views_premul(A)
    assert "_group_views_premul" not in A.__dict__
    assert tpe.group_views_premul(A) is not views
    assert tpe._cache_hit(A, "_group_views_premul") is None
    # the views carry the values' gradient: the same as the fold route's
    g_views = torch.autograd.grad(tpe.views_eval_batched_premul(views, x).sum(), vals)[0]
    g_fold = torch.autograd.grad(tpe.poly_eval_flat_batched(A, x).sum(), vals)[0]
    assert _nerr(g_views, g_fold) <= 1e-10
    assert "_group_views_premul" not in A.__dict__


@pytest.mark.parametrize("rank,dim", [(3, 5), (5, 4)])
def test_gradient_in_xs_matches_jax(rank, dim):
    Aj, At, xs = _pair(rank, dim, 70 + rank)
    f = jpe._views_eval_batched_premul_jitted(rank, dim)
    vj = jpe.group_views_premul(Aj)
    w = np.random.default_rng(71).normal(size=len(xs))
    want = jax.grad(lambda x: jnp.dot(f(vj, x), jnp.asarray(w)))(jnp.asarray(xs))
    x = torch.from_numpy(xs).requires_grad_()
    y = tpe.views_eval_batched_premul(tpe.group_views_premul(At), x)
    (got,) = torch.autograd.grad(y @ torch.from_numpy(w), x)
    assert _nerr(got, want) <= 1e-10
