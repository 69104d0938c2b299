"""utils/profiling.py: the kernel counter under the JAX package's key,
timeit's median over repeats, and a torch.profiler trace written to a
file; on the CPU."""

import json

import torch

from symtensor_tpu.utils import profiling as jprof
from symtensor_tpu_torch.utils import profiling


def test_count_kernel_uses_the_reference_key():
    profiling.reset_counters()
    jprof.reset_counters()
    for _ in range(3):
        profiling.count_kernel("group_pass")
        jprof.count_kernel("group_pass")
    assert dict(profiling.op_counters) == dict(jprof.op_counters) == {"kernel:group_pass": 3}
    profiling.reset_counters()
    jprof.reset_counters()
    assert not profiling.op_counters


def test_timeit_is_the_median_of_the_repeats(monkeypatch):
    """Calls that take 1, 5, 2, 9 and 3 s on a stubbed clock (after one
    warm-up call): the median is 3 s, and the last call's result comes
    back."""
    ticks = iter([0, 1, 10, 15, 20, 22, 30, 39, 40, 43])
    monkeypatch.setattr(profiling.time, "perf_counter", lambda: next(ticks))
    calls = []

    def fn(x, scale=1):
        calls.append(x)
        return len(calls) * scale

    median, last = profiling.timeit(fn, 7, repeats=5, warmup=1, scale=10)
    assert median == 3 and last == 60 and calls == [7] * 6


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
