"""The readers of the port's spans (``host_prefix_us.single``,
``fold_host_ms.batched``, ``tables_s``) on the CPU: tiny cells driven
under ``trace.traced`` as the traced window is, each reader given the
window's ``run.Context``; a positive number where the program recorded its
spans, ``None`` where it did not or has no span table."""

import functools

import pytest
import torch

from pb_helpers import SEEDS, tiny
from portbench import inputs, loop, run, spec, trace
from symtensor_tpu_torch.utils import profiling
from symtensor_tpu_torch.utils import tables as tables_mod

READERS = {  # reader: the tiny cell it reads
    "host_prefix_us.single": "flat-r6-d100.single-f32",
    "fold_host_ms.batched": "sympoly-r2to6-d100.batch1024-f32",
    "tables_s": "flat-r6-d100.single-bf16",
}


@pytest.fixture(autouse=True)
def fresh(monkeypatch):
    """Tables built anew (so set-up times some) and empty span totals."""
    monkeypatch.setattr(tables_mod, "_tables", functools.lru_cache(maxsize=None)(tables_mod.Tables))
    profiling.reset_counters()
    yield
    profiling.reset_counters()


def traced_ctx(name: str, units: int = 3) -> run.Context:
    """A few units of the tiny cell after set-up, under the profiler, as
    ``run.execute`` traces its window."""
    cell = tiny(name)
    kind = spec.load_module("traffic", cell.kind)
    made = inputs.make(cell.config, cell.dtype, kind.pool_rows(cell.params), SEEDS[1], "cpu")
    system = spec.load_module("systems", cell.config["system"]).System(cell.config, made)
    with torch.no_grad():
        kind.unit(system, made.pool, cell.params, 0)  # set-up: every table built

    def window():
        rec = loop.Record()
        for k in range(units):
            calls, rows, results = kind.unit(system, made.pool, cell.params, k)
            rec.calls.append(calls)
            rec.rows.append(rows)
            rec.results.append(results)
        return rec

    with torch.no_grad():
        rec, tr = trace.traced(window)
    return run.Context(cell, rec, 1.0, 0, tr)


def reader(name: str):
    return spec.load_module("layer_metrics", name).read


@pytest.mark.parametrize("name", sorted(READERS))
def test_reader_reads_the_spans_of_the_window(name):
    ctx = traced_ctx(READERS[name])
    value = reader(name)(ctx)
    assert isinstance(value, float) and value > 0, value


def test_window_spans_count_the_window_alone():
    ctx = traced_ctx(READERS["host_prefix_us.single"], units=4)
    assert ctx.calls == 4 and profiling.span_totals["eval.single"].count == 4
    profiling.reset_counters()
    ctx = traced_ctx(READERS["fold_host_ms.batched"], units=2)
    for r in (3, 4, 5, 6):
        assert profiling.span_totals[f"batched.fold.r{r}"].count == 2


@pytest.mark.parametrize("name", sorted(READERS))
def test_reader_without_its_spans_reads_none(name, monkeypatch):
    ctx = traced_ctx(READERS[name])
    profiling.reset_counters()
    assert reader(name)(ctx) is None
    with monkeypatch.context() as m:
        m.delattr(profiling, "span_totals")  # a program without the table
        assert reader(name)(ctx) is None


def test_window_readers_read_nothing_in_the_other_cells():
    ctx = traced_ctx(READERS["fold_host_ms.batched"])
    assert reader("host_prefix_us.single")(ctx) is None
    profiling.reset_counters()  # each cell runs in a process of its own
    ctx = traced_ctx(READERS["host_prefix_us.single"])
    assert reader("fold_host_ms.batched")(ctx) is None
