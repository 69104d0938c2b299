"""Whole runs on the CPU at tiny sizes: the line's keys, no device metric
without a card, and the command's refusal to run without one."""

import json
import subprocess
import sys

import pytest
import torch

from pb_helpers import CELLS, SEEDS, dry_run
from portbench import spec


@pytest.mark.parametrize("name", CELLS)
@pytest.mark.parametrize("traced", [False, True])
def test_dry_run_line(name, traced):
    line = dry_run(name, traced=traced)
    assert list(line)[:5] == ["correct", "attempted", "failed", "metrics", "device"]
    assert list(line)[-1] == "compared" and set(line) <= {
        "correct", "attempted", "failed", "metrics", "device", "breakdown", "compared"}
    assert line["metrics"] == {}  # a CPU run reports no device metric
    assert line["device"]["platform"] == "cpu"
    assert line["correct"] is True and line["failed"] == 0 and line["attempted"] > 0
    c = line["compared"]["err"]
    assert 0 <= c["value"] <= c["limit"]
    json.dumps(line)


@pytest.mark.parametrize("name", CELLS)
def test_same_seed_same_inputs(name):
    from portbench import inputs
    from pb_helpers import tiny

    cell = tiny(name)
    rows = spec.load_module("traffic", cell.kind).pool_rows(cell.params)
    a, b, c = (inputs.make(cell.config, cell.dtype, rows, s, "cpu")
               for s in (SEEDS[1], SEEDS[1], SEEDS[2]))
    for r in cell.config["ranks"]:
        assert torch.equal(a.values[r], b.values[r]) and not torch.equal(a.values[r], c.values[r])
    assert torch.equal(a.pool, b.pool) and not torch.equal(a.pool, c.pool)
    assert (a.bias is None) == (not cell.config["bias_std"])


def test_command_refuses_without_a_card():
    out = subprocess.run([sys.executable, "-m", "portbench.run", "--workload", CELLS[0],
                          "--seed", "1", "--seconds", "1", "--trace", "0"],
                         capture_output=True, text=True, cwd=spec.ROOT, timeout=300)
    if "no CUDA card" not in out.stderr:
        pytest.skip("a card is present")
    assert out.returncode != 0 and out.stdout == ""


def test_command_refuses_an_unknown_cell():
    out = subprocess.run([sys.executable, "-m", "portbench.run", "--workload", "nope",
                          "--seed", "1", "--seconds", "1"],
                         capture_output=True, text=True, cwd=spec.ROOT, timeout=300)
    assert out.returncode != 0 and out.stdout == ""
