"""The traced window: ``torch.profiler`` (host and device activity) around
the window, read back from its Chrome trace.

The window is marked by a span of the harness's own (``WINDOW``), so the
device's work is read inside it alone: its device operations (kernels,
copies, fills) merged into busy intervals, the idle gaps between them, and
for each gap the innermost host operation running at its middle, which
says what the card waited for.
"""

from __future__ import annotations

import bisect
import collections
import dataclasses
import json
import os
import re
import tempfile

import torch

WINDOW = "portbench.window"
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATS = ("cpu_op", "cuda_runtime", "cuda_driver", "user_annotation")
TOP = 10
NAME_CHARS = 160


def short(name: str) -> str:
    """A device operation's name without the C++ noise, cut to NAME_CHARS."""
    name = re.sub(r"^void |at::native::|\(anonymous namespace\)::|std::", "", name)
    return name[:NAME_CHARS]


@dataclasses.dataclass
class Trace:
    window_s: float
    busy_s: float
    kernels: int          # kernel launches that ran in the window
    device_ops: list      # [[name, seconds]], the most time first
    idle_gaps: list       # [[host operation, seconds]], the most first


def traced(fn):
    """(fn(), Trace) with fn run under the profiler inside the window span."""
    from torch.profiler import ProfilerActivity, profile, record_function

    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    with profile(activities=acts) as prof:
        with record_function(WINDOW):
            out = fn()
            if torch.cuda.is_available():
                torch.cuda.synchronize()
    fd, path = tempfile.mkstemp(suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f)["traceEvents"]
    finally:
        os.unlink(path)
    return out, read(events)


def _merge(spans):
    merged = []
    for s, e in sorted(spans):
        if merged and s <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], e)
        else:
            merged.append([s, e])
    return merged


def read(events: list) -> Trace:
    """The window's numbers from Chrome-trace events (times in µs)."""
    spans = [e for e in events if e.get("ph") == "X" and "dur" in e]
    win = max((e for e in spans if e.get("name") == WINDOW and e.get("cat") == "user_annotation"),
              key=lambda e: e["dur"])
    w0, w1 = float(win["ts"]), float(win["ts"]) + float(win["dur"])
    dev = [e for e in spans if e.get("cat") in DEVICE_CATS
           and w0 <= float(e["ts"]) < w1]
    per_name = collections.Counter()
    for e in dev:
        per_name[short(e["name"])] += float(e["dur"]) * 1e-6
    busy = _merge((float(e["ts"]), min(float(e["ts"]) + float(e["dur"]), w1)) for e in dev)
    busy_us = sum(e - s for s, e in busy)

    gaps, t = [], w0
    for s, e in busy:
        if s > t:
            gaps.append((t, s))
        t = max(t, e)
    if w1 > t:
        gaps.append((t, w1))
    host = sorted(
        ((float(e["ts"]), float(e["ts"]) + float(e["dur"]), e["name"]) for e in spans
         if e.get("cat") in HOST_CATS and e.get("name") != WINDOW and w0 <= float(e["ts"]) < w1),
        key=lambda h: (h[0], -h[1]))
    starts = [h[0] for h in host]
    by_op = collections.Counter()
    stack, pushed = [], 0
    for g0, g1 in sorted(gaps):
        mid = 0.5 * (g0 + g1)
        upto = bisect.bisect_right(starts, mid)
        for h in host[pushed:upto]:
            while stack and stack[-1][1] <= h[0]:
                stack.pop()
            stack.append(h)
        pushed = max(pushed, upto)
        while stack and stack[-1][1] < mid:
            stack.pop()
        # the innermost operation still open at the gap's middle
        by_op[short(stack[-1][2]) if stack else "host: between operations"] += (g1 - g0) * 1e-6
    return Trace(
        window_s=(w1 - w0) * 1e-6,
        busy_s=busy_us * 1e-6,
        kernels=sum(1 for e in dev if e.get("cat") == "kernel"),
        device_ops=[[n, s] for n, s in per_name.most_common(TOP)],
        idle_gaps=[[n, s] for n, s in by_op.most_common(TOP)],
    )
