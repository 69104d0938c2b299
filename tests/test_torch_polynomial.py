"""The port's flagship model against the JAX package's, on the CPU.

Mirrors ``tests/test_models.py:16-35`` (the forward pass against a dense
oracle) and ``tests/test_checkpoint.py`` (a checkpoint round trip, here
``torch.save`` of the ``state_dict``), and trains the port with
``torch.optim`` SGD and Adam from weights carried across against optax's
steps of the JAX package's ``train_step``, in float64.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from symtensor_tpu.models import polynomial as jpoly
from symtensor_tpu_torch.interop import polynomial_from_numpy, polynomial_to_numpy
from symtensor_tpu_torch.models import polynomial as tpoly
from symtensor_tpu_torch.utils import combinatorics as comb


def _jax_params(ranks, dim, seed=0):
    return jpoly.init(jax.random.PRNGKey(seed), ranks=ranks, dim=dim, dtype=jnp.float64)


def _as_numpy(params):
    return {"bias": np.asarray(params["bias"]),
            "terms": {k: np.asarray(t.data) for k, t in params["terms"].items()}}


def test_polynomial_model_forward():
    """``tests/test_models.py:16-35``: the batched forward against the
    densified coefficient tensors."""
    rng = np.random.default_rng(0)
    model = tpoly.init((1, 2, 3), 5, generator=torch.Generator().manual_seed(0),
                       dtype=torch.float64, device="cpu")
    xs = rng.normal(size=(4, 5))
    out = tpoly.apply_batched(model, torch.from_numpy(xs))
    expect = np.zeros(4)
    for t in model.tensors().values():
        dense = t.todense().detach().numpy()
        for b in range(4):
            v = dense
            for _ in range(t.rank):
                v = v @ xs[b]
            expect[b] += float(v)
    np.testing.assert_allclose(out.detach().numpy(), expect, rtol=1e-10)


@pytest.mark.parametrize("ranks,dim", [((2, 3, 4), 6), ((0, 1, 2, 3, 4, 5, 6), 3)])
def test_forward_matches_jax_single_and_batched(ranks, dim):
    params = _jax_params(ranks, dim)
    model = polynomial_from_numpy(_as_numpy(params), device="cpu")
    assert model.ranks == tuple(ranks) and model.dim == dim
    xs = np.random.default_rng(1).normal(size=(6, dim))
    want = np.asarray(jpoly.apply_batched(params, jnp.asarray(xs)))
    got = tpoly.apply_batched(model, torch.from_numpy(xs)).detach().numpy()
    np.testing.assert_allclose(got, want, rtol=1e-10)
    for b in range(2):
        np.testing.assert_allclose(
            float(tpoly.apply(model, torch.from_numpy(xs[b]))),
            float(jpoly.apply(params, jnp.asarray(xs[b]))), rtol=1e-10)
    np.testing.assert_allclose(
        float(tpoly.loss_fn(model, torch.from_numpy(xs), torch.ones(6, dtype=torch.float64))),
        float(jpoly.loss_fn(params, jnp.asarray(xs), jnp.ones(6))), rtol=1e-10)


@functools.lru_cache(maxsize=None)
def _jax_step(kind, lr):
    opt = optax.sgd(lr) if kind == "sgd" else optax.adam(lr)
    return opt, jax.jit(functools.partial(jpoly.train_step, optimizer=opt))


@pytest.mark.parametrize("kind,lr", [("sgd", 1e-3), ("adam", 1e-2)])
def test_training_steps_match_optax(kind, lr):
    """Five steps of ``torch.optim`` against five optax steps of the JAX
    package's ``train_step``, from the same weights: losses and every
    parameter to rtol 1e-10."""
    ranks, dim = (0, 2, 3, 4, 6), 4
    params = _jax_params(ranks, dim, seed=3)
    model = polynomial_from_numpy(_as_numpy(params), device="cpu")
    rng = np.random.default_rng(2)
    xs, ys = 0.5 * rng.normal(size=(8, dim)), rng.normal(size=8)
    opt, step = _jax_step(kind, lr)
    opt_state = opt.init(params)
    topt = (torch.optim.SGD(model.parameters(), lr=lr) if kind == "sgd"
            else torch.optim.Adam(model.parameters(), lr=lr))
    for _ in range(5):
        params, opt_state, lj = step(params, opt_state, jnp.asarray(xs), jnp.asarray(ys))
        lt = tpoly.train_step(model, topt, torch.from_numpy(xs), torch.from_numpy(ys))
        assert not lt.requires_grad
        np.testing.assert_allclose(float(lt), float(lj), rtol=1e-10)
    got, want = polynomial_to_numpy(model), _as_numpy(params)
    np.testing.assert_allclose(got["bias"], want["bias"], rtol=1e-10, atol=1e-14)
    for k in want["terms"]:
        np.testing.assert_allclose(got["terms"][k], want["terms"][k], rtol=1e-10,
                                   atol=1e-14)


def test_state_dict_checkpoint_roundtrip(tmp_path):
    """``tests/test_checkpoint.py``: save, restore into a fresh model, and
    get every parameter back bit for bit."""
    model = tpoly.init((2, 3), 6, generator=torch.Generator().manual_seed(0),
                       device="cpu")
    path = tmp_path / "ckpt.pt"
    torch.save(model.state_dict(), path)
    fresh = tpoly.SymmetricPolynomial((2, 3), 6, device="cpu")
    fresh.load_state_dict(torch.load(path, weights_only=True))
    for (k, a), (k2, b) in zip(model.state_dict().items(), fresh.state_dict().items()):
        assert k == k2 and torch.equal(a, b)
    for k, t in fresh.tensors().items():
        assert (t.rank, t.dim) == (int(k[4:]), 6)
        assert t.array_equal(model.tensors()[k])


def test_init_and_views_share_storage():
    g = torch.Generator().manual_seed(5)
    model = tpoly.init((3, 5), 4, generator=g, scale=0.5, device="cpu")
    assert float(model.bias) == 0.0
    assert model.terms["rank5"].shape == (comb.indep_size(5, 4),)
    again = tpoly.init((3, 5), 4, generator=torch.Generator().manual_seed(5),
                       scale=0.5, device="cpu")
    assert all(torch.equal(a, b) for a, b in zip(model.parameters(), again.parameters()))
    t = model.tensors()["rank3"]
    assert t.data.data_ptr() == model.terms["rank3"].data_ptr()
    assert model.terms["rank5"].dtype == torch.float32
    std = float(model.terms["rank5"].std())
    assert 0.4 < std < 0.6


def test_batched_forward_goes_through_the_gradient_function():
    """Every rank ≥ 3 term of the batched forward goes through the
    gradient Function that saves only its inputs."""
    model = tpoly.init((2, 3, 4), 5, generator=torch.Generator().manual_seed(1),
                       dtype=torch.float64, device="cpu")
    y = tpoly.apply_batched(model, torch.randn(3, 5, dtype=torch.float64))
    seen, stack = set(), [y.grad_fn]
    while stack:
        node = stack.pop()
        if node is None or node in seen:
            continue
        seen.add(node)
        stack.extend(f for f, _ in node.next_functions)
    names = [type(n).__name__ for n in seen]
    assert names.count("_BatchedEvalBackward") == 2


def test_polynomial_from_numpy_needs_dim_for_rank_zero_terms():
    params = {"bias": np.float64(1.0), "terms": {"rank0": np.array([2.0])}}
    with pytest.raises(ValueError, match="dim"):
        polynomial_from_numpy(params, device="cpu")
    model = polynomial_from_numpy(params, device="cpu", dim=3)
    assert float(tpoly.apply(model, torch.zeros(3, dtype=torch.float64))) == 3.0


def test_model_defaults_to_the_configured_device_and_dtype(monkeypatch):
    """Like every constructor of the port, the model goes to
    ``config.default_device`` and ``config.default_dtype`` unless asked."""
    from symtensor_tpu_torch.config import config

    monkeypatch.setattr(config, "default_device", "cpu")
    monkeypatch.setattr(config, "default_dtype", "float64")
    for model in (tpoly.SymmetricPolynomial((2,), 3),
                  tpoly.init((2, 3), 3, generator=torch.Generator().manual_seed(0))):
        for p in model.parameters():
            assert p.device == torch.device("cpu") and p.dtype == torch.float64
    x = torch.ones(3, dtype=torch.float64)
    assert torch.equal(tpoly.apply_batched(model, x[None])[0], tpoly.apply(model, x))


def test_model_without_cuda_raises_rather_than_landing_on_the_cpu(monkeypatch):
    from symtensor_tpu_torch.config import config

    monkeypatch.setattr(config, "default_device", "cuda")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="default_device"):
        tpoly.SymmetricPolynomial((2,), 3)
    with pytest.raises(RuntimeError, match="default_device"):
        tpoly.init((2,), 3, generator=torch.Generator())


def test_init_refuses_a_generator_on_another_device():
    with pytest.raises(ValueError, match="generator on cpu"):
        tpoly.init((2,), 3, generator=torch.Generator(), device="meta")
