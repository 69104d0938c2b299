"""The measured window: units of work run back to back, each timed by the
host's clock from its start to its results on the host.

A traffic kind (``traffic/<kind>.py``) says what one unit is: ``unit(system,
pool, params, k)`` runs the k-th unit and returns (calls, rows, results),
the rows of the input pool it used and its results as floats, read back to
the host. ``warm`` runs the first units before the window, so the window
starts with every shape built, records them in a ``Record`` of their own,
and then moves every object that set-up left to the collector's permanent
generation (``gc.freeze``), so that a collection in the window scans the
window's own objects and not the port's tables; ``drive`` runs units until
the window's seconds have passed and records every one. Both run the units
with autograd off, unless the kind sets ``GRAD = True`` (a training step).
"""

from __future__ import annotations

import dataclasses
import gc
import time

import numpy as np
import torch


@dataclasses.dataclass
class Record:
    starts: list = dataclasses.field(default_factory=list)
    ends: list = dataclasses.field(default_factory=list)
    calls: list = dataclasses.field(default_factory=list)
    rows: list = dataclasses.field(default_factory=list)
    results: list = dataclasses.field(default_factory=list)
    warmup: "Record | None" = None  # the units ``warm`` ran before the window

    def add(self, start: float, end: float, calls: int, rows, results) -> None:
        self.starts.append(start)
        self.ends.append(end)
        self.calls.append(calls)
        self.rows.append(np.asarray(rows, dtype=np.int64))
        self.results.append(np.asarray(results, dtype=np.float64))

    @property
    def units(self) -> int:
        return len(self.ends)

    @property
    def elapsed(self) -> float:
        return self.ends[-1] - self.starts[0]

    def latencies(self) -> np.ndarray:
        return np.asarray(self.ends) - np.asarray(self.starts)

    def all_rows(self) -> np.ndarray:
        return np.concatenate(self.rows)

    def all_results(self) -> np.ndarray:
        return np.concatenate(self.results)


def grad_mode(kind):
    """Autograd on for a kind that sets ``GRAD = True``, off for any other."""
    return torch.enable_grad() if getattr(kind, "GRAD", False) else torch.no_grad()


def warm(kind, system, pool, params: dict) -> Record:
    rec = Record()
    clock = time.perf_counter
    with grad_mode(kind):
        for k in range(params.get("warmup_units", 3)):
            t0 = clock()
            calls, rows, results = kind.unit(system, pool, params, k)
            rec.add(t0, clock(), calls, rows, results)
    gc.collect()
    gc.freeze()
    return rec


def drive(kind, system, pool, params: dict, seconds: float) -> Record:
    rec = Record()
    clock = time.perf_counter
    with grad_mode(kind):
        start = clock()
        k = 0
        while True:
            t0 = clock()
            calls, rows, results = kind.unit(system, pool, params, k)
            t1 = clock()
            rec.add(t0, t1, calls, rows, results)
            k += 1
            if t1 - start >= seconds:
                return rec
