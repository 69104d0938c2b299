"""A configuration that brings its own yardstick and a traffic kind that
trains, added as files alone: a throwaway tree under ``tmp_path`` holds
``portbench/``'s files with those of ``seam/`` added beside them (a tiny
``SymmetricPolynomial`` fitted by SGD through the port's ``train_step``, a
kind with ``GRAD = True``, and the yardstick ``sgd_replay``, which replays
every step in float64) and a ``BENCHMARK.json`` naming them, and ``spec``
reads that tree in place of ``portbench/``. The run and the calibration go through the same
``run.execute`` and ``calibrate.reading`` as every cell."""

import json
import shutil
import time
from pathlib import Path

import pytest
import torch

from pb_helpers import CELLS, SEEDS, dry_run
from portbench import calibrate, loop, run, spec

SEAM = Path(__file__).resolve().parent / "seam"
CELL = "tiny-sgd.steps"


@pytest.fixture
def seam(tmp_path, monkeypatch):
    """The cell `CELL` of a tree that holds nothing but the seam's files."""
    skip = shutil.ignore_patterns("tests", "__pycache__")
    added = [p.relative_to(SEAM) for p in SEAM.rglob("*.*") if "__pycache__" not in p.parts]
    assert not any((spec.HERE / p).exists() for p in added)  # no file of the harness changes
    tree = tmp_path / "portbench"
    shutil.copytree(spec.HERE, tree, ignore=skip)
    shutil.copytree(SEAM, tree, ignore=skip, dirs_exist_ok=True)
    bench = {"configs": [{"name": "tiny-sgd", "file": "portbench/configs/tiny-sgd.json"}],
             "workloads": [{"name": CELL, "config": "tiny-sgd", "traffic": "steps", "chips": 1}],
             "end_to_end": [], "per_layer": []}
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    monkeypatch.setattr(spec, "HERE", tree)
    monkeypatch.setattr(spec, "ROOT", tmp_path)
    return spec.load_cell(CELL, root=tmp_path)


def execute(cell, seed):
    return run.execute(cell, seed, 0.3, False, device="cpu", t_start=time.perf_counter())


def zero_the_gradient(monkeypatch):
    """Every SGD step with its gradient zeroed out: the state stays as it was."""
    step = torch.optim.SGD.step

    def zeroed(self, closure=None):
        for group in self.param_groups:
            for p in group["params"]:
                if p.grad is not None:
                    p.grad.zero_()
        return step(self, closure)
    monkeypatch.setattr(torch.optim.SGD, "step", zeroed)


def spy_on_grad_mode(monkeypatch) -> list:
    """torch.is_grad_enabled() inside every unit that a traffic kind runs."""
    seen, load = [], spec.load_module

    def loader(folder, name):
        mod = load(folder, name)
        if folder == "traffic":
            unit = mod.unit

            def spied(*args):
                seen.append(torch.is_grad_enabled())
                return unit(*args)
            mod.unit = spied
        return mod
    monkeypatch.setattr(spec, "load_module", loader)
    return seen


def test_the_cell_names_its_own_yardstick(seam):
    assert seam.yardstick == "sgd_replay" and "ranks" not in seam.config
    assert spec.load_module("traffic", seam.kind).GRAD is True


@pytest.mark.parametrize("seed", SEEDS)
def test_training_cell_is_correct(seam, seed):
    line = execute(seam, seed)
    assert line["correct"] is True and line["failed"] == 0 and line["attempted"] > 0
    c = line["compared"]["loss_gap"]
    assert 0 <= c["value"] <= c["limit"]
    json.dumps(line)


@pytest.mark.parametrize("seed", SEEDS)
def test_gradient_zeroed_is_not_correct(seam, monkeypatch, seed):
    zero_the_gradient(monkeypatch)
    assert execute(seam, seed)["correct"] is False


@pytest.mark.parametrize("seed", SEEDS[:2])
def test_calibrate_reads_the_program_and_the_control(seam, seed):
    r = calibrate.reading(seam, seed, 0.3, True, device="cpu")
    limit = seam.workload["limits"]["loss_gap"]
    assert r["calls"] > 0 and r["loss_gap"] <= limit < r["control_loss_gap"]


def test_units_train_with_autograd_on(seam, monkeypatch):
    seen = spy_on_grad_mode(monkeypatch)
    execute(seam, SEEDS[0])
    assert seen and all(seen)


@pytest.mark.parametrize("name", CELLS)
def test_other_kinds_run_without_autograd(monkeypatch, name):
    seen = spy_on_grad_mode(monkeypatch)
    assert dry_run(name)["correct"] is True
    assert seen and not any(seen)


def test_context_of_a_configuration_without_ranks(seam):
    """Calls and points come from the record alone, so a training unit that
    reports its batch's rows gets ``points_per_s``."""
    kind = spec.load_module("traffic", seam.kind)
    ys = spec.load_module("yardsticks", seam.yardstick)
    made = ys.draw(seam.config, seam.dtype, kind.pool_rows(seam.params), SEEDS[0], "cpu")
    system = spec.load_module("systems", seam.config["system"]).System(seam.config, made)
    warmed = loop.warm(kind, system, made.pool, seam.params)
    rec = loop.drive(kind, system, made.pool, seam.params, 0.2)
    assert warmed.units == seam.params["warmup_units"]
    ctx = run.Context(seam, rec, 1.0, 0, None)
    assert ctx.calls == rec.units and ctx.points == rec.units * seam.params["batch"]
    points_per_s = spec.load_module("end_to_end", "points_per_s").read
    assert points_per_s(ctx) == pytest.approx(ctx.points / rec.elapsed)
