"""The training cell ``sympoly-r2to6-d100-adam.train1024-f32`` cut to dim 8
and batches of 16 on the CPU, at its own learning rate: whole runs through
``run.execute`` and ``calibrate.reading`` come out correct; the TF32
control and five faults planted in the fit (the largest rank's gradient
halved, Adam without its bias correction, the optimizer's step skipped so
the state stays unchanged, half of each batch left out, one group of rank
3's gradient halved) come out not
correct; the readers of the backward's span and counter read the traced
window, and nothing where the program records nothing; the step's least
time at full size."""

import time

import pytest
import torch

from pb_helpers import SEEDS
from portbench import calibrate, loop, run, spec, trace
from symtensor_tpu_torch.kernels import poly_eval
from symtensor_tpu_torch.models import polynomial
from symtensor_tpu_torch.utils import profiling

CELL = "sympoly-r2to6-d100-adam.train1024-f32"


def tiny() -> spec.Cell:
    """The cell at dim 8, batches of 16 over a pool of 4."""
    cell = spec.load_cell(CELL)
    cell.config.update({"dim": 8})
    cell.params.update({"batch": 16, "pool_batches": 4})
    return cell


def execute(cell, seed, traced=False):
    return run.execute(cell, seed, 0.3, traced, device="cpu", t_start=time.perf_counter())


def halve_the_largest_gradient(monkeypatch):
    """From the second step on, the gradient of the largest rank's values
    halved before Adam reads it. (Adam divides a gradient by its own root
    mean square, so a gradient halved at every step, the first included,
    would move nothing but eps's share.)"""
    step, seen = torch.optim.Adam.step, [0]

    def halved(self, closure=None):
        seen[0] += 1
        if seen[0] > 1:
            p = max((p for g in self.param_groups for p in g["params"]), key=torch.numel)
            p.grad.mul_(0.5)
        return step(self, closure)
    monkeypatch.setattr(torch.optim.Adam, "step", halved)


class AdamWithoutBiasCorrection(torch.optim.Optimizer):
    """Adam's moments, with p ← p − lr·m/(√v + eps): m and v not divided
    by 1 − βᵗ."""

    def __init__(self, params, lr, betas, eps):
        super().__init__(params, {"lr": lr, "betas": betas, "eps": eps})

    @torch.no_grad()
    def step(self, closure=None):
        for group in self.param_groups:
            b1, b2 = group["betas"]
            for p in group["params"]:
                st = self.state[p]
                if not st:
                    st["m"], st["v"] = torch.zeros_like(p), torch.zeros_like(p)
                st["m"].mul_(b1).add_(p.grad, alpha=1 - b1)
                st["v"].mul_(b2).addcmul_(p.grad, p.grad, value=1 - b2)
                p.addcdiv_(st["m"], st["v"].sqrt().add_(group["eps"]), value=-group["lr"])


def no_bias_correction(monkeypatch):
    def adam(model, lr, *, betas=(0.9, 0.999), eps=1e-8):
        return AdamWithoutBiasCorrection(model.parameters(), lr, betas, eps)
    monkeypatch.setattr(polynomial, "adam", adam)


def skip_the_optimizer_step(monkeypatch):
    """Adam's step does nothing: the state stays as drawn."""
    monkeypatch.setattr(torch.optim.Adam, "step", lambda self, closure=None: None)


def half_the_batch(monkeypatch):
    """Each step trains on the first half of its batch alone."""
    step = polynomial.train_step

    def halved(model, optimizer, xs, ys):
        h = xs.shape[0] // 2
        return step(model, optimizer, xs[:h], ys[:h])
    monkeypatch.setattr(polynomial, "train_step", halved)


def halve_one_group_of_rank_3(monkeypatch):
    """The gradient of rank 3's first group (j = 0) halved at every step:
    a fault in a few hundredths of the smallest rank ≥ 3, which a loss
    barely shows."""
    backward = poly_eval.batched_backward

    def halved(vals, xs, gy, t, r, d, *rest):
        dvals, dx = backward(vals, xs, gy, t, r, d, *rest)
        if r == 3 and dvals is not None:
            T0 = poly_eval._grouped_static(r, d)[1][0]
            dvals[:T0] *= 0.5
        return dvals, dx
    halved.products = 0  # the counter the body adds to, under its module name
    monkeypatch.setattr(poly_eval, "batched_backward", halved)


FAULTS = [halve_the_largest_gradient, no_bias_correction, skip_the_optimizer_step,
          half_the_batch, halve_one_group_of_rank_3]


@pytest.mark.parametrize("seed", SEEDS)
def test_tiny_cell_is_correct(seed):
    line = execute(tiny(), seed)
    assert line["correct"] is True and line["failed"] == 0 and line["attempted"] > 0
    assert set(line["compared"]) == {"loss_gap", "grad_gap", "update_gap"}
    for c in line["compared"].values():
        assert 0 < c["value"] <= c["limit"]
    assert line["metrics"] == {}  # a CPU run reports no device metric


@pytest.mark.parametrize("seed", SEEDS[:2])
def test_calibrate_reads_the_program_and_the_tf32_control(seed):
    cell = tiny()
    r = calibrate.reading(cell, seed, 0.3, True, device="cpu")
    limits = cell.workload["limits"]
    assert r["calls"] > 0 and all(r[k] <= limits[k] for k in limits)
    assert any(r[f"control_{k}"] > limits[k] for k in limits)


@pytest.mark.parametrize("fault", FAULTS, ids=lambda f: f.__name__)
@pytest.mark.parametrize("seed", SEEDS)
def test_fault_is_not_correct(monkeypatch, fault, seed):
    fault(monkeypatch)
    line = execute(tiny(), seed)
    assert line["correct"] is False
    assert any(c["value"] > c["limit"] for c in line["compared"].values())


@pytest.mark.parametrize("seed", SEEDS)
def test_unchanged_state_reads_one(monkeypatch, seed):
    skip_the_optimizer_step(monkeypatch)
    assert execute(tiny(), seed)["compared"]["update_gap"]["value"] == 1.0


def test_units_train_through_the_ports_adam(monkeypatch):
    made = []
    adam = polynomial.adam
    monkeypatch.setattr(polynomial, "adam", lambda *a, **kw: made.append(1) or adam(*a, **kw))
    assert execute(tiny(), SEEDS[0])["correct"] is True
    assert made == [1]


def traced_ctx(units: int = 3) -> run.Context:
    """A few training steps of the tiny cell after two warm-up steps, the
    window under the profiler as ``run.execute`` traces it."""
    cell = tiny()
    kind = spec.load_module("traffic", cell.kind)
    ys = spec.load_module("yardsticks", cell.yardstick)
    made = ys.draw(cell.config, cell.dtype, kind.pool_rows(cell.params), SEEDS[1], "cpu")
    system = spec.load_module("systems", cell.config["system"]).System(cell.config, made)
    warmed = loop.warm(kind, system, made.pool, cell.params)
    profiling.reset_counters()

    def window():
        rec = loop.Record()
        with torch.enable_grad():
            for k in range(units):
                rec.add(0.0, 1.0, *kind.unit(system, made.pool, cell.params, k))
        return rec

    rec, tr = trace.traced(window)
    rec.warmup = warmed
    return run.Context(cell, rec, 1.0, 0, tr)


def reader(name: str):
    return spec.load_module("layer_metrics", name).read


@pytest.fixture
def counted(monkeypatch):
    monkeypatch.setattr(poly_eval.batched_backward, "products", 0)
    profiling.reset_counters()
    yield
    profiling.reset_counters()


def test_backward_readers_read_the_window(counted):
    ctx = traced_ctx(units=3)
    assert profiling.span_totals["batched.backward.r6"].count == 3
    assert reader("backward_host_ms.train")(ctx) > 0
    # one product a group: 8 groups at each of ranks 3-6, every step
    assert reader("backward_products.train")(ctx) == 32.0
    assert reader("launches.train")(ctx) is None  # no device op on the CPU
    assert 0 < reader("train_mfu")(ctx)


def test_backward_readers_without_the_program_read_none(counted, monkeypatch):
    ctx = traced_ctx(units=2)
    profiling.reset_counters()
    assert reader("backward_host_ms.train")(ctx) is None
    with monkeypatch.context() as m:  # a program without the counter or the table
        m.delattr(poly_eval, "batched_backward")
        m.delattr(profiling, "span_totals")
        assert reader("backward_host_ms.train")(ctx) is None
        assert reader("backward_products.train")(ctx) is None


def test_step_bound_at_full_size():
    """2·B·n operations twice at the TF32 rate and 28 bytes a coefficient
    at 3.35 TB/s: 28.4 ms a step of 1 024 rows."""
    mfu = spec.load_module("layer_metrics", "train_mfu")
    cfg = spec.load_cell(CELL).config
    n = 1_705_904_645
    want = 2 * (2 * 1024 * n / 495e12) + 28 * n / 3.35e12
    assert mfu.step_bound_s(cfg, 1024) == pytest.approx(want, rel=1e-12)
    assert 0.0283 < want < 0.0285
