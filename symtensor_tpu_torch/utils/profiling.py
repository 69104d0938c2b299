"""Counters of dispatch, and timing and tracing helpers.

The counterpart of ``symtensor_tpu/utils/profiling.py``: every op that
leaves a compressed format for a slower one calls ``count_fallback(site)``,
which counts the site in ``op_counters`` and warns once per site while
``config.warn_on_densify`` is set; each launch of a hand-written kernel
counts ``op_counters["kernel:<name>"]`` (``count_kernel``). ``timeit``
takes the median host time of calls that end in
``torch.cuda.synchronize()``, and ``trace`` records ``torch.profiler``
over a block into a Chrome trace.
"""

from __future__ import annotations

import collections
import contextlib
import statistics
import time
import warnings
from typing import Callable

import torch

from ..config import config

op_counters = collections.Counter()
_warned_sites = set()


def count_fallback(site: str, detail: str = "") -> None:
    """Record (and optionally warn about) a slow-path dispatch."""
    op_counters[site] += 1
    if config.warn_on_densify and site not in _warned_sites:
        _warned_sites.add(site)
        warnings.warn(
            f"symtensor_tpu_torch slow path '{site}' {detail} — performance "
            "warning emitted once per site; see utils.profiling.op_counters",
            stacklevel=3,
        )


def count_kernel(site: str) -> None:
    """Record one launch of a hand-written kernel."""
    op_counters[f"kernel:{site}"] += 1


def reset_counters() -> None:
    op_counters.clear()
    _warned_sites.clear()


def _sync() -> None:
    if torch.cuda.is_available() and torch.cuda.is_initialized():
        torch.cuda.synchronize()


def timeit(fn: Callable, *args, repeats: int = 5, warmup: int = 1, **kw):
    """Median host time of fn(*args, **kw) over `repeats` calls after
    `warmup` calls, each ended by ``torch.cuda.synchronize()`` where CUDA
    is in use. Returns (median_seconds, last_result)."""
    out = None
    for _ in range(warmup):
        out = fn(*args, **kw)
        _sync()
    times = []
    for _ in range(repeats):
        t0 = time.perf_counter()
        out = fn(*args, **kw)
        _sync()
        times.append(time.perf_counter() - t0)
    return statistics.median(times), out


@contextlib.contextmanager
def trace(path):
    """``torch.profiler`` over the block (CPU activity, and CUDA where a
    card is present), its Chrome trace written to the file `path` at the
    end (open it in Perfetto or chrome://tracing); yields the profiler,
    whose ``key_averages()`` sums the time by op."""
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    with profile(activities=acts) as prof:
        yield prof
    prof.export_chrome_trace(str(path))
