"""The port's gather-combine (twin and autograd Function) against the JAX
package's, on the CPU.

Inputs come from each test's seeded NumPy generator and go to both
packages. The JAX Pallas kernel runs in interpret mode, as the JAX
package's own tests run it on the CPU. It rounds its weights to float32
(``symtensor_tpu/kernels/gather_mm.py:199-200``), so float64 comparisons
use weights k/64, which float32 holds exactly.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from symtensor_tpu.kernels.gather_mm import gather_combine as jax_gather_combine
from symtensor_tpu_torch.kernels import gather_mm as gm

SHAPES = [(21, 21, 6, 126), (100, 250, 6, 1000), (300, 300, 12, 2000)]


def _inputs(n_a, n_b, R, n_out, seed, dtype=np.float64):
    rng = np.random.default_rng(seed)
    a = rng.normal(size=n_a).astype(dtype)
    b = rng.normal(size=n_b).astype(dtype)
    ia = rng.integers(0, n_a, (R, n_out)).astype(np.int32)
    ib = rng.integers(0, n_b, (R, n_out)).astype(np.int32)
    w = rng.integers(1, 64, R) / 64.0  # exact in float32
    return a, b, ia, ib, w


def _jax(a, b, ia, ib, w=None):
    return np.asarray(jax_gather_combine(
        jnp.asarray(a), jnp.asarray(b), jnp.asarray(ia), jnp.asarray(ib),
        weights=None if w is None else jnp.asarray(w), interpret=True,
    ))


def _t(*xs):
    return [torch.from_numpy(np.ascontiguousarray(x)) for x in xs]


@pytest.mark.parametrize("shape", SHAPES)
def test_twin_matches_pallas_float32(shape):
    a, b, ia, ib, _ = _inputs(*shape, seed=shape[0], dtype=np.float32)
    want = _jax(a, b, ia, ib)
    before = gm.gather_combine.launches
    got = gm.gather_combine(*_t(a, b, ia, ib))
    assert gm.gather_combine.launches == before  # no launch on the CPU
    assert got.dtype == torch.float32 and got.shape == (shape[3],)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("shape", SHAPES)
def test_twin_matches_pallas_float64_exact_weights(shape):
    a, b, ia, ib, w = _inputs(*shape, seed=shape[1])
    want = _jax(a, b, ia, ib, w)
    got = gm.gather_combine(*_t(a, b, ia, ib), weights=torch.from_numpy(w))
    assert got.dtype == torch.float64
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-12, atol=1e-12)
    direct = gm.gather_combine_ref(*_t(a, b, ia, ib, w))
    np.testing.assert_allclose(direct.numpy(), want, rtol=1e-12, atol=1e-12)


def test_gradients_match_jax_custom_vjp():
    a, b, ia, ib, w = _inputs(40, 30, 5, 200, seed=3)
    g = np.random.default_rng(4).normal(size=200)

    def loss_j(a_, b_, w_):
        out = jax_gather_combine(a_, b_, jnp.asarray(ia), jnp.asarray(ib),
                                 weights=w_, interpret=True)
        return jnp.dot(out, jnp.asarray(g))

    def loss_plain(a_, b_, w_):
        out = jnp.einsum("r,ro->o", w_, a_[ia] * b_[ib])
        return jnp.dot(out, jnp.asarray(g))

    args = (jnp.asarray(a), jnp.asarray(b), jnp.asarray(w))
    want = jax.grad(loss_j, argnums=(0, 1, 2))(*args)
    plain = jax.grad(loss_plain, argnums=(0, 1, 2))(*args)
    at, bt, wt = (torch.from_numpy(x).requires_grad_() for x in (a, b, w))
    out = gm.gather_combine(at, bt, *_t(ia, ib), weights=wt)
    (out * torch.from_numpy(g)).sum().backward()
    for got, ref, ref_plain in zip((at.grad, bt.grad, wt.grad), want, plain):
        assert got.dtype == torch.float64
        np.testing.assert_allclose(got.numpy(), np.asarray(ref_plain),
                                   rtol=1e-10, atol=1e-10)
    np.testing.assert_allclose(at.grad.numpy(), np.asarray(want[0]), rtol=1e-10, atol=1e-10)
    np.testing.assert_allclose(bt.grad.numpy(), np.asarray(want[1]), rtol=1e-10, atol=1e-10)
    # the custom VJP returns dw in its float32 weight type: one rounding
    np.testing.assert_allclose(wt.grad.numpy(), np.asarray(want[2]), rtol=2**-23)


def test_bfloat16_accumulates_in_float32_and_returns_bfloat16():
    a, b, ia, ib, _ = _inputs(50, 60, 8, 300, seed=5, dtype=np.float32)
    a16, b16 = (torch.from_numpy(x).to(torch.bfloat16) for x in (a, b))
    got = gm.gather_combine(a16, b16, *_t(ia, ib))
    assert got.dtype == torch.bfloat16
    want = gm.gather_combine(a16.float(), b16.float(), *_t(ia, ib))
    # one bfloat16 rounding of the float32 sum
    np.testing.assert_allclose(got.float().numpy(), want.numpy(), rtol=2**-8,
                               atol=1e-6)


def test_float16_accumulates_in_float32_and_returns_float16():
    a, b, ia, ib, _ = _inputs(50, 60, 8, 300, seed=7, dtype=np.float32)
    a16, b16 = (torch.from_numpy(x).half() for x in (a, b))
    got = gm.gather_combine(a16, b16, *_t(ia, ib))
    assert got.dtype == torch.float16
    want = gm.gather_combine(a16.float(), b16.float(), *_t(ia, ib))
    # the float32 sum rounded once to float16, to nearest even
    assert torch.equal(got, want.half())


def test_mixed_operands_promote():
    a, b, ia, ib, _ = _inputs(20, 20, 3, 40, seed=6)
    got = gm.gather_combine(*_t(a.astype(np.float32), b, ia, ib))
    assert got.dtype == torch.float64


@pytest.mark.parametrize("dtype", [torch.int32, torch.int64, torch.bool])
def test_integer_operands_raise(dtype):
    ia = torch.zeros((2, 3), dtype=torch.int32)
    with pytest.raises(TypeError, match="floating-point"):
        gm.gather_combine(torch.ones(4, dtype=dtype), torch.ones(4, dtype=dtype), ia, ia)


BAD = {
    "int64 indices": (lambda a, b, ia, ib, w: (a, b, ia.long(), ib.long(), w), TypeError),
    # float16 operands take float32 weights, not float64 ones
    "float16": (lambda a, b, ia, ib, w: (a.half(), b.half(), ia, ib, w), TypeError),
    "float8": (lambda a, b, ia, ib, w: (a.to(torch.float8_e4m3fn),
                                        b.to(torch.float8_e4m3fn), ia, ib, w.float()),
               TypeError),
    "weights dtype": (lambda a, b, ia, ib, w: (a, b, ia, ib, w.float()), TypeError),
    "shape mismatch": (lambda a, b, ia, ib, w: (a, b, ia, ib[:, :-1], w), ValueError),
    "1-D tables": (lambda a, b, ia, ib, w: (a, b, ia[0], ib[0], w), ValueError),
    "2-D source": (lambda a, b, ia, ib, w: (a[None], b, ia, ib, w), ValueError),
    "weights length": (lambda a, b, ia, ib, w: (a, b, ia, ib, w[:-1]), ValueError),
    "strided": (lambda a, b, ia, ib, w: (a, b, ia[:, ::2], ib[:, ::2], w), ValueError),
    "two devices": (lambda a, b, ia, ib, w: (a, b.to("meta"), ia, ib, w), ValueError),
}


@pytest.mark.parametrize("case", sorted(BAD))
def test_twin_and_function_reject_what_the_kernel_does_not_take(case):
    make, err = BAD[case]
    args = make(torch.ones(8, dtype=torch.float64), torch.ones(8, dtype=torch.float64),
                torch.zeros((3, 10), dtype=torch.int32),
                torch.zeros((3, 10), dtype=torch.int32),
                torch.ones(3, dtype=torch.float64))
    with pytest.raises(err):
        gm.gather_combine_ref(*args[:4], args[4])
    with pytest.raises(err):
        gm._GatherCombine.apply(args[0], args[1], args[4], args[2], args[3])


def test_sources_of_2_31_entries_are_refused_without_allocating():
    big = torch.empty(2**31, dtype=torch.float32, device="meta")  # no storage
    idx = torch.zeros((2, 5), dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="2\\*\\*31"):
        gm.gather_combine(big, big, idx, idx)


def test_index_limit_is_checked_on_both_operands(monkeypatch):
    monkeypatch.setattr(gm, "INDEX_LIMIT", 8)
    idx = torch.zeros((2, 5), dtype=torch.int32)
    small, large = torch.ones(7), torch.ones(8)
    gm.gather_combine(small, small, idx, idx)
    for a, b in ((large, small), (small, large)):
        with pytest.raises(ValueError, match="n_a = "):
            gm.gather_combine(a, b, idx, idx)


def _outputs_covered(n_out, plan, grid):
    """How often each output is written by the kernel's loops
    (csrc/gather_combine.cu): block b walks tiles b, b + grid, ...; thread
    t of a tile owns outputs tile·items·threads + t + k·threads."""
    tile_n = plan.items * plan.threads
    counts = np.zeros(n_out, dtype=np.int64)
    lane = np.arange(plan.threads)[:, None] + plan.threads * np.arange(plan.items)
    for blk in range(grid):
        for tile in range(blk, plan.tiles, grid):
            o = (tile * tile_n + lane).ravel()
            np.add.at(counts, o[o < n_out], 1)
    return counts


# (n_out, SMs, resident blocks per SM, expected (items, threads))
PLANS = {
    "C1": (1_623_160, 132, 6, (4, 256)),
    "table route": (40_920, 132, 8, (1, 128)),
    "one output": (1, 132, 8, (1, 128)),
    "more than the card holds at once": (132 * 6 * 1024 * 3 + 5, 132, 6, (4, 256)),
    "smaller card": (40_920, 32, 8, (2, 256)),
    "dim 20 outer": (177_100, 132, 8, (2, 256)),
    "dim 18 outer": (100_947, 132, 8, (1, 256)),
}


@pytest.mark.parametrize("case", sorted(PLANS))
def test_launch_plan_covers_every_output_once(case):
    n_out, sms, per_sm, want = PLANS[case]
    plan = gm.launch_plan(n_out, sms)
    assert (plan.items, plan.threads) == want
    assert plan.items in (1, 2, 4) and plan.threads % 32 == 0 and plan.threads <= 256
    assert plan.tiles == -(-n_out // (plan.items * plan.threads))
    if plan.items * plan.threads > 128:  # a smaller tile was not needed
        assert plan.tiles >= gm.BLOCKS_PER_SM * sms
    grid = min(plan.tiles, per_sm * sms)  # the kernel's persistent grid
    assert (_outputs_covered(n_out, plan, grid) == 1).all()


def test_launch_plan_keeps_the_c1_tile_and_fills_the_card_at_the_table_route():
    assert gm.launch_plan(1_623_160, 132)[:2] == (4, 256)  # the best point of the C1 sweep
    assert gm.launch_plan(40_920, 132).tiles >= 2 * 132  # was 40 blocks
    assert gm.TILE_CHOICES[0] == (4, 256)


def test_usable_gate_takes_the_kernel_types():
    f64, f32, i32 = torch.ones(2), torch.ones(2, dtype=torch.float64), torch.ones(2, dtype=torch.int32)
    assert gm.usable(f64, f32) and gm.usable(f32, f32)
    assert gm.usable(torch.ones(2, dtype=torch.bfloat16), torch.ones(2, dtype=torch.bfloat16))
    assert not gm.usable(i32, i32)
    assert gm.usable(torch.ones(2, dtype=torch.float16), torch.ones(2, dtype=torch.float16))
