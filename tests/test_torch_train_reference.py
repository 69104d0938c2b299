"""The flagship fitted by Adam through the port's own path
(``models.polynomial.train_step`` with ``polynomial.adam``) against the
benchmark's plain float64 replay (``portbench/reference/train.py``, which
imports nothing of the port), on the CPU at small sizes: each step's loss,
the coefficients after three steps, each rank's first gradient, the
optimizer's update, and the spans and counter a step records."""

import functools

import numpy as np
import pytest
import torch

from portbench.reference import train
from symtensor_tpu_torch.kernels import poly_eval
from symtensor_tpu_torch.models import polynomial
from symtensor_tpu_torch.utils import combinatorics as comb
from symtensor_tpu_torch.utils import profiling
from symtensor_tpu_torch.utils import tables as tables_mod

RANKS = (2, 3, 4, 5, 6)
BATCH, STEPS, LR = 16, 3, 1e-2
SPANS = ("train.loss", "train.backward", "train.optimizer")


def _setup(dim, dtype, seed=0):
    """(model, pool, targets, batches): N(0, 0.1²) coefficients and bias,
    inputs N(0, 0.3²) and targets N(0, 1), all float32 draws; the model in
    `dtype`; one batch of 16 pool rows a step."""
    g = torch.Generator().manual_seed(seed)
    model = polynomial.init(RANKS, dim, generator=g, scale=0.1, dtype=torch.float32,
                            device="cpu")
    with torch.no_grad():
        model.bias.normal_(0.0, 0.1, generator=g)
    model = model.to(dtype)
    pool = torch.randn(BATCH * STEPS, dim, generator=g) * 0.3
    targets = torch.randn(BATCH * STEPS, generator=g)
    batches = [np.arange(k * BATCH, (k + 1) * BATCH) for k in range(STEPS)]
    return model, pool.to(dtype), targets.to(dtype), batches


def _snapshot(model):
    return ({r: model.terms[f"rank{r}"].detach().clone() for r in model.ranks},
            model.bias.detach().clone())


def _fit(dim, dtype):
    """The program's losses and final coefficients, and the reference's,
    from the same starting values."""
    model, pool, targets, batches = _setup(dim, dtype)
    values, bias = _snapshot(model)
    opt = polynomial.adam(model, LR)
    got = [float(polynomial.train_step(model, opt, pool[b], targets[b])) for b in batches]
    fit = train.Fit(values, bias, pool, targets, LR)
    want = [fit.step(b) for b in batches]
    return np.asarray(got), np.asarray(want), model, fit


# float64: the same arithmetic in another order, so rounding alone (about
# 1e-16 of a loss, 1e-15·lr of a coefficient at these sizes). float32: the
# program rounds values, products and sums to 2⁻²⁴, so a loss is off by about
# 1e-7 of itself, and every step rounds each coefficient again (about 3e-8
# at 0.4) while its update, lr·m̂/(√v̂ + eps), carries its gradient's relative
# error; the worst coefficient seen is off by 1.3e-6 of the largest. Losses
# are held to 1e-5 of themselves, coefficients to 1e-5 of the largest.
TOL = {torch.float64: dict(loss=1e-12, atol=1e-13, rtol=1e-12),
       torch.float32: dict(loss=1e-5, atol=1e-5 * LR, rtol=1e-5)}


@pytest.mark.parametrize("dim", [6, 8])
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32], ids=str)
def test_adam_steps_match_the_float64_replay(dim, dtype):
    got, want, model, fit = _fit(dim, dtype)
    tol = TOL[dtype]
    np.testing.assert_allclose(got, want, rtol=tol["loss"], atol=0)
    assert want[-1] < want[0] or not np.allclose(want[0], want[-1])  # the fit moved
    for r in RANKS:
        p = model.terms[f"rank{r}"].detach().double()
        moved = (p - fit.coefs[r].to(dtype).double()).abs().max()
        assert moved <= tol["atol"] + tol["rtol"] * p.abs().max(), (r, float(moved))
    assert abs(float(model.bias.detach()) - float(fit.bias)) <= tol["atol"] + tol["rtol"] * abs(float(fit.bias))


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32], ids=str)
def test_first_gradient_of_each_rank_matches_the_reference(dtype):
    model, pool, targets, batches = _setup(7, dtype)
    values, bias = _snapshot(model)
    loss = polynomial.loss_fn(model, pool[batches[0]], targets[batches[0]])
    loss.backward()
    grads = {}
    train.Fit(values, bias, pool, targets, LR).step(batches[0], grads=grads)
    rtol = 1e-12 if dtype == torch.float64 else 1e-5
    for r in RANKS:
        got = model.terms[f"rank{r}"].grad.double()
        scale = grads[r].abs().max()
        assert float((got - grads[r]).abs().max()) <= rtol * float(scale), r
    assert float(model.bias.grad) == pytest.approx(float(grads["bias"]), rel=rtol)


def test_replay_moves_no_value_it_was_given():
    model, pool, targets, batches = _setup(6, torch.float64)
    values, bias = _snapshot(model)
    kept = {r: v.clone() for r, v in values.items()}
    train.replay(values, bias, pool, targets, batches, LR)
    assert all(torch.equal(values[r], kept[r]) for r in values)


@pytest.mark.parametrize("betas,eps", [((0.9, 0.999), 1e-8), ((0.8, 0.99), 1e-3)])
def test_adam_is_torch_adam(betas, eps):
    """The port's optimizer is torch's Adam with the given settings, and
    two of its steps move the parameters exactly as torch.optim.Adam does."""
    models = [_setup(6, torch.float64)[0] for _ in range(2)]
    _, pool, targets, batches = _setup(6, torch.float64)
    ours = polynomial.adam(models[0], LR, betas=betas, eps=eps)
    theirs = torch.optim.Adam(models[1].parameters(), lr=LR, betas=betas, eps=eps)
    assert type(ours) is torch.optim.Adam
    assert {k: ours.defaults[k] for k in ("lr", "betas", "eps")} == {"lr": LR, "betas": betas, "eps": eps}
    assert ours.defaults == theirs.defaults
    for b in batches[:2]:
        for model, opt in zip(models, (ours, theirs)):
            polynomial.train_step(model, opt, pool[b], targets[b])
    for a, b in zip(models[0].parameters(), models[1].parameters()):
        assert torch.equal(a, b)


def test_adam_update_is_the_published_one():
    """One step of polynomial.adam against the reference's update written
    out: bias-corrected moments, eps after the square root."""
    model, pool, targets, batches = _setup(6, torch.float64)
    values, bias = _snapshot(model)
    fit = train.Fit(values, bias, pool, targets, LR, betas=(0.8, 0.99), eps=1e-3)
    opt = polynomial.adam(model, LR, betas=(0.8, 0.99), eps=1e-3)
    for b in batches:
        polynomial.train_step(model, opt, pool[b], targets[b])
        fit.step(b)
    for r in RANKS:
        torch.testing.assert_close(model.terms[f"rank{r}"].detach(), fit.coefs[r],
                                   rtol=1e-12, atol=1e-14)


@pytest.fixture
def fresh(monkeypatch):
    monkeypatch.setattr(tables_mod, "_tables", functools.lru_cache(maxsize=None)(tables_mod.Tables))
    profiling.reset_counters()
    yield
    profiling.reset_counters()


@pytest.mark.parametrize("dim", [6, 8])
def test_step_records_its_spans_and_counts_its_products(fresh, tmp_path, dim):
    model, pool, targets, batches = _setup(dim, torch.float32)
    opt = polynomial.adam(model, LR)
    polynomial.train_step(model, opt, pool[batches[0]], targets[batches[0]])  # tables built
    profiling.reset_counters()
    before = poly_eval.batched_backward.products
    with profiling.trace(tmp_path / "t.json"):
        polynomial.train_step(model, opt, pool[batches[1]], targets[batches[1]])
    tot = profiling.span_totals
    backward = [f"batched.backward.r{r}" for r in RANKS if r >= 3]
    for name in SPANS + tuple(backward):
        assert tot[name].count == 1, (name, tot)
    assert sum(tot[n].total_ns for n in backward) <= tot["train.backward"].total_ns
    groups = sum(comb.gflat_layout(r, dim).P.shape[0] for r in RANKS if r >= 3)
    assert groups == dim * len(backward)
    assert poly_eval.batched_backward.products - before == groups


def test_step_records_no_span_without_a_profiler(fresh):
    model, pool, targets, batches = _setup(6, torch.float32)
    opt = polynomial.adam(model, LR)
    polynomial.train_step(model, opt, pool[batches[0]], targets[batches[0]])
    before = poly_eval.batched_backward.products
    profiling.reset_counters()
    polynomial.train_step(model, opt, pool[batches[1]], targets[batches[1]])
    assert profiling.span_totals == {}
    assert poly_eval.batched_backward.products - before == 6 * 4
