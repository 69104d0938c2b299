"""The measured window: units of work run back to back, each timed by the
host's clock from its start to its results on the host.

A traffic kind (``traffic/<kind>.py``) says what one unit is: ``unit(system,
pool, params, k)`` runs the k-th unit and returns (calls, rows, results),
the rows of the input pool it evaluated and their results as floats, read
back to the host. ``warm`` runs the first units before the window, so the
window starts with every shape built, and then moves every object that
set-up left to the collector's permanent generation (``gc.freeze``), so
that a collection in the window scans the window's own objects and not
the port's tables; ``drive`` runs units until the window's seconds have
passed and records every one.
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


def warm(kind, system, pool, params: dict) -> None:
    with torch.no_grad():
        for k in range(params.get("warmup_units", 3)):
            kind.unit(system, pool, params, k)
    gc.collect()
    gc.freeze()


def drive(kind, system, pool, params: dict, seconds: float) -> Record:
    rec = Record()
    clock = time.perf_counter
    with torch.no_grad():
        start = clock()
        k = 0
        while True:
            t0 = clock()
            calls, rows, results = kind.unit(system, pool, params, k)
            t1 = clock()
            rec.starts.append(t0)
            rec.ends.append(t1)
            rec.calls.append(calls)
            rec.rows.append(np.asarray(rows, dtype=np.int64))
            rec.results.append(np.asarray(results, dtype=np.float64))
            k += 1
            if t1 - start >= seconds:
                return rec
