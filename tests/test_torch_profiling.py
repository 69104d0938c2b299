"""utils/profiling.py on the CPU: a torch.profiler trace written to a file,
and the port's spans: off without a profiler (no ``record_function``
entered), recorded under one with their totals and self times, nested in
the Chrome trace, one per route, the table and library builds timed
always, and results unchanged by the profiler."""

import functools
import json

import numpy as np
import pytest
import torch

import symtensor_tpu_torch as stt
from symtensor_tpu_torch.kernels import _build
from symtensor_tpu_torch.models import polynomial
from symtensor_tpu_torch.utils import combinatorics as comb
from symtensor_tpu_torch.utils import profiling
from symtensor_tpu_torch.utils import tables as tables_mod

SINGLE = ("eval.single", "eval.single.heads", "eval.single.tri")


@pytest.fixture(autouse=True)
def fresh(monkeypatch):
    """Empty span totals and a table cache of this test's own, so that
    every table it needs is built in it."""
    monkeypatch.setattr(tables_mod, "_tables", functools.lru_cache(maxsize=None)(tables_mod.Tables))
    profiling.reset_counters()
    yield
    profiling.reset_counters()


def _flat(rank, dim, seed=0, dtype=torch.float64):
    g = torch.Generator().manual_seed(seed)
    data = torch.randn(comb.indep_size(rank, dim), generator=g, dtype=torch.float64)
    x = torch.randn(dim, generator=g, dtype=torch.float64) * 0.5
    return stt.FlatSymmetricTensor(rank, dim, data=data.to(dtype)), x.to(dtype)


def _model(ranks=(2, 3, 4, 5), dim=8, batch=6):
    model = polynomial.init(ranks, dim, generator=torch.Generator().manual_seed(1),
                            dtype=torch.float32, device="cpu")
    xs = torch.randn(batch, dim, generator=torch.Generator().manual_seed(2)) * 0.3
    return model, xs


def _single(A, x):
    with torch.no_grad():
        return stt.symalg.contract_all_indices_with_vector(A, x)


def test_trace_writes_a_chrome_trace(tmp_path):
    path = tmp_path / "trace.json"
    a = torch.randn(64, 64, dtype=torch.float64)
    with profiling.trace(path) as prof:
        b = a @ a
    assert torch.isfinite(b).all()
    names = {e["name"] for e in json.loads(path.read_text())["traceEvents"]
             if isinstance(e, dict) and "name" in e}
    assert any("mm" in n for n in names), sorted(names)[:20]
    assert any("mm" in k.key for k in prof.key_averages())


def test_spans_enter_no_record_function_without_a_profiler(monkeypatch):
    def refuse(*args, **kw):
        raise AssertionError("record_function entered with no profiler running")

    for mod in (profiling, torch.profiler, torch.autograd.profiler):
        monkeypatch.setattr(mod, "record_function", refuse)
    A, x = _flat(5, 9)
    model, xs = _model()
    with torch.no_grad():
        y = _single(A, x)
        ys = polynomial.apply_batched(model, xs)
    assert torch.isfinite(y) and torch.isfinite(ys).all()
    assert profiling.span_totals, "the tables this test needed were built"
    assert all(name.startswith("tables.") for name in profiling.span_totals), profiling.span_totals


def test_single_call_records_its_spans_once(tmp_path):
    A, x = _flat(6, 10)
    _single(A, x)  # tables built outside the trace
    profiling.reset_counters()
    with profiling.trace(tmp_path / "t.json"):
        _single(A, x)
    tot = profiling.span_totals
    assert set(tot) == set(SINGLE), tot
    for name in SINGLE:
        assert tot[name].count == 1
        assert 0 < tot[name].self_ns <= tot[name].total_ns
    parent, heads, tri = (tot[n] for n in SINGLE)
    assert heads.total_ns + tri.total_ns <= parent.total_ns
    assert parent.self_ns == parent.total_ns - heads.total_ns - tri.total_ns
    assert not profiling._open


def test_chrome_trace_nests_the_spans_in_the_call(tmp_path):
    A, x = _flat(4, 12)
    _single(A, x)
    path = tmp_path / "t.json"
    with profiling.trace(path):
        _single(A, x)
    ann = [e for e in json.loads(path.read_text())["traceEvents"]
           if e.get("cat") == "user_annotation" and e.get("name") in SINGLE]
    by_name = {}
    for e in ann:
        by_name.setdefault(e["name"], []).append(e)
    assert sorted(by_name) == sorted(SINGLE) and all(len(v) == 1 for v in by_name.values())
    outer = by_name["eval.single"][0]
    o0, o1 = float(outer["ts"]), float(outer["ts"]) + float(outer["dur"])
    for name in SINGLE[1:]:
        e = by_name[name][0]
        assert o0 <= float(e["ts"]) and float(e["ts"]) + float(e["dur"]) <= o1, name


def test_batched_model_records_the_fold_once_per_rank(tmp_path):
    model, xs = _model()
    with torch.no_grad():
        polynomial.apply_batched(model, xs)
        profiling.reset_counters()
        with profiling.trace(tmp_path / "t.json"):
            polynomial.apply_batched(model, xs)
    tot = profiling.span_totals
    assert set(tot) == {"model.forward", "batched.heads",
                        "batched.fold.r3", "batched.fold.r4", "batched.fold.r5"}, tot
    assert tot["model.forward"].count == 1 and tot["batched.heads"].count == 3
    assert all(tot[f"batched.fold.r{r}"].count == 1 for r in (3, 4, 5))
    folds = sum(tot[f"batched.fold.r{r}"].total_ns for r in (3, 4, 5))
    assert tot["model.forward"].self_ns == tot["model.forward"].total_ns - folds


def test_bfloat16_batch_without_a_gradient_records_the_premul_route(tmp_path):
    A, _ = _flat(4, 9, dtype=torch.bfloat16)
    xs = torch.randn(5, 9, generator=torch.Generator().manual_seed(3)) * 0.3
    op = stt.symalg.contract_all_indices_with_vector_batched
    op(A, xs)
    profiling.reset_counters()
    with profiling.trace(tmp_path / "t.json"):
        op(A, xs)
    assert set(profiling.span_totals) == {"batched.premul"}
    assert profiling.span_totals["batched.premul"].count == 1


def test_gradient_route_records_the_unfused_marker(tmp_path):
    A, x = _flat(5, 8)
    x.requires_grad_(True)
    stt.symalg.contract_all_indices_with_vector(A, x).backward()  # its tables
    x.grad = None
    profiling.reset_counters()
    with profiling.trace(tmp_path / "t.json"):
        y = stt.symalg.contract_all_indices_with_vector(A, x)
    y.backward()
    assert set(profiling.span_totals) == {"eval.single.unfused"}
    assert x.grad is not None and torch.isfinite(x.grad).all()


def test_table_builds_are_timed_once_per_key_without_a_profiler():
    A, x = _flat(6, 11)
    _single(A, x)
    built = dict(profiling.span_totals)
    assert {"tables.tri_pairs", "tables.mono_weighted", "tables.group_eval_static",
            "tables.group_pass_rows"} <= set(built), built
    assert all(name.startswith("tables.") for name in built)
    assert all(row.count == 1 and 0 <= row.self_ns <= row.total_ns for row in built.values())
    _single(A, x)
    B, _ = _flat(6, 11, seed=5)  # another tensor of the same (rank, dim)
    _single(B, x)
    assert profiling.span_totals == built


def test_library_build_spans_close_on_a_failed_build(monkeypatch, tmp_path):
    def no_nvcc():
        raise RuntimeError("nvcc not found")

    monkeypatch.setattr(_build, "_nvcc", no_nvcc)
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(_build, "library_path", lambda: tmp_path / "lib.so")
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build.load_library.__wrapped__()
    tot = profiling.span_totals
    assert set(tot) == {"kernels.load", "kernels.build"}
    assert tot["kernels.load"].count == tot["kernels.build"].count == 1
    assert tot["kernels.load"].self_ns == tot["kernels.load"].total_ns - tot["kernels.build"].total_ns
    assert not profiling._open


def test_span_forms_time_nested_blocks(tmp_path):
    with profiling.trace(tmp_path / "t.json"):
        with profiling.span("outer"):
            got = profiling.spanned("inner", lambda a, b: a + b, 2, 3)
            with profiling.span("fold.r", 7):
                pass
        with profiling.build_span("once"):
            pass
    tot = profiling.span_totals
    assert got == 5 and set(tot) == {"outer", "inner", "fold.r7", "once"}
    o = tot["outer"]
    assert o.self_ns == o.total_ns - tot["inner"].total_ns - tot["fold.r7"].total_ns
    assert all(row.count == 1 for row in tot.values())
    # off: the no-op context and a direct call, nothing recorded
    profiling.reset_counters()
    with profiling.span("outer"):
        assert profiling.spanned("inner", max, 1, 4) == 4
    assert profiling.span_totals == {}


def test_results_are_bit_identical_under_the_profiler(tmp_path):
    A, x = _flat(5, 10, dtype=torch.float32)
    model, xs = _model()
    with torch.no_grad():
        y0, ys0 = _single(A, x), polynomial.apply_batched(model, xs)
        with profiling.trace(tmp_path / "t.json"):
            y1, ys1 = _single(A, x), polynomial.apply_batched(model, xs)
    assert torch.equal(y0, y1) and torch.equal(ys0, ys1)
    assert np.isfinite(float(y0))
    assert "eval.single" in profiling.span_totals
    profiling.op_counters["site"] += 1
    profiling.reset_counters()
    assert profiling.span_totals == {} and not profiling.op_counters
