"""The comparison fails what it must: the control (the reference in the
next lower precision, in the program's place) and the faults a cell can
have, each planted under a whole CPU run at a tiny size, on three seeds.
The program itself passes the same runs (``test_portbench_dryrun.py``)."""

import pytest

from pb_helpers import (CELLS, SEEDS, control, dry_run, half_batch_mean,
                        nth_answer_altered, patched, tiny)

SINGLE = [c for c in CELLS if tiny(c).kind != "closed_batched"]
BATCHED = [c for c in CELLS if tiny(c).kind == "closed_batched"]


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("name", CELLS)
def test_control_is_not_correct(monkeypatch, name, seed):
    ev = control(tiny(name).workload["control"])
    with patched(monkeypatch, single=ev, batched=ev):
        line = dry_run(name, seed)
    assert line["correct"] is False


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("name", CELLS)
def test_an_answer_altered_is_not_correct(monkeypatch, name, seed):
    # the window's first call, past the warm-up (a window runs one unit or
    # more, however slow the machine); the model calls the route once a rank
    cell = tiny(name)
    n = cell.params["warmup_units"] * cell.params.get("chunk", 1) * len(cell.config["ranks"])
    ev = nth_answer_altered(n)
    with patched(monkeypatch, single=ev, batched=ev):
        line = dry_run(name, seed)
    assert line["correct"] is False


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("name", BATCHED)
def test_half_batch_left_out_is_not_correct(monkeypatch, name, seed):
    with patched(monkeypatch, batched=half_batch_mean):
        line = dry_run(name, seed)
    assert line["correct"] is False


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("name", SINGLE)
def test_program_passes_the_same_runs(name, seed):
    assert dry_run(name, seed)["correct"] is True
