"""Counters of dispatch, spans at the port's layer boundaries, and tracing.

The counterpart of ``symtensor_tpu/utils/profiling.py``: every op that
leaves a compressed format for a slower one calls ``count_fallback(site)``,
which counts the site in ``op_counters`` and warns once per site while
``config.warn_on_densify`` is set. ``trace`` records ``torch.profiler``
over a block into a Chrome trace.

Spans. ``span(name)`` (a context manager) and ``spanned(name, fn, *args)``
(the call form, for the single-input path, where a ``with`` costs more
than the flag test) mark a layer of the port. They are off unless a
``torch.profiler`` is recording: then they return at once and enter no
``record_function``. When on, a span opens ``record_function(name)``, so
it lands in the profiler's trace as a ``user_annotation`` on the kernels'
clock, and adds its host time to ``span_totals[name]``: the calls, the
total nanoseconds, and the self nanoseconds (the total less the part its
child spans cover, on one thread). ``build_span(name)`` marks a one-off
build (a table, the kernels' library) and times it whether a profiler
records or not. ``reset_counters`` clears the counters and the totals.
"""

from __future__ import annotations

import collections
import contextlib
import time
import warnings
from typing import NamedTuple

import torch
from torch.autograd import profiler as _autograd_profiler
from torch.autograd.profiler import record_function

from ..config import config

op_counters = collections.Counter()
_warned_sites = set()


class SpanTotal(NamedTuple):
    count: int
    total_ns: int
    self_ns: int


span_totals: dict = {}
_open: list = []  # the spans open on the (one) thread, innermost last
_OFF = contextlib.nullcontext()


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


def reset_counters() -> None:
    op_counters.clear()
    _warned_sites.clear()
    span_totals.clear()


class _Span:
    """One open span: its ``record_function`` (None when no profiler
    records), its start, and the time its children took."""

    __slots__ = ("name", "rf", "t0", "inner")

    def __init__(self, name: str, traced: bool):
        self.name = name
        self.rf = record_function(name) if traced else None

    def __enter__(self):
        if self.rf is not None:
            self.rf.__enter__()
        self.inner = 0
        _open.append(self)
        self.t0 = time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        dt = time.perf_counter_ns() - self.t0
        _open.pop()
        if _open:
            _open[-1].inner += dt
        c, total, own = span_totals.get(self.name, (0, 0, 0))
        span_totals[self.name] = SpanTotal(c + 1, total + dt, own + dt - self.inner)
        if self.rf is not None:
            self.rf.__exit__(*exc)
        return False


def span(name: str, suffix=None):
    """A span over the ``with`` block while a profiler records, named
    `name` followed by `suffix` (formatted only then); else a shared
    no-op context."""
    if not _autograd_profiler._is_profiler_enabled:
        return _OFF
    return _Span(name if suffix is None else f"{name}{suffix}", True)


def spanned(name: str, fn, *args):
    """fn(*args), inside the span `name` while a profiler records."""
    if not _autograd_profiler._is_profiler_enabled:
        return fn(*args)
    with _Span(name, True):
        return fn(*args)


def build_span(name: str):
    """A span over a one-off build, timed into ``span_totals`` always and
    in the profiler's trace while one records."""
    return _Span(name, _autograd_profiler._is_profiler_enabled)


@contextlib.contextmanager
def trace(path):
    """``torch.profiler`` over the block (CPU activity, and CUDA where a
    card is present), its Chrome trace written to the file `path` at the
    end (open it in Perfetto or chrome://tracing, where the port's spans
    lie beside the kernels); yields the profiler, whose ``key_averages()``
    sums the time by op."""
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    with profile(activities=acts) as prof:
        yield prof
    prof.export_chrome_trace(str(path))
