"""Run one cell of the benchmark and print its result line.

    python -m portbench.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout, on a machine with an NVIDIA card. One process:
it draws the cell's inputs on the card from the seed (the configuration's
yardstick, ``yardsticks/<name>.py``), builds the system under test from
them (the first run in a checkout also builds the port's CUDA library into
``symtensor_tpu_torch/_build/``), warms up the cell's shapes, measures for
``--seconds`` (under ``torch.profiler`` with ``--trace 1``), then has the
yardstick compare what the window produced with its plain reference and
prints one JSON line: with ``--trace 0`` the cell's end-to-end metrics, with
``--trace 1`` its per-layer ones. The numbers compared, each beside its
limit, end both standard error and the line. Without a card, with fewer
cards than the cell asks for, or with jax or the JAX package loaded, it
prints no result and exits with a code other than 0.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import dataclasses  # noqa: E402
import json  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

import numpy as np  # noqa: E402
import torch  # noqa: E402

from . import loop, spec, trace, work  # noqa: E402
from .peaks import bound_s  # noqa: E402

FORBIDDEN = ("jax", "jaxlib", "flax", "symtensor_tpu")


class NotRunnable(RuntimeError):
    """The run cannot give a result here."""


@dataclasses.dataclass
class Context:
    """What a metric's reader (``read(ctx)``) is given."""

    cell: spec.Cell
    record: loop.Record
    setup_s: float
    peak_bytes: int
    trace: trace.Trace | None

    @property
    def calls(self) -> int:
        return int(sum(self.record.calls))

    @property
    def points(self) -> int:
        return int(sum(len(r) for r in self.record.rows))

    def work_per_call(self) -> dict:
        return work.call(self.cell.config, self.cell.dtype, rows=self.points // self.calls)

    def bound_per_call_s(self) -> float:
        """The least time one call could take on the card (``peaks.py``)."""
        return bound_s(self.work_per_call(), self.cell.dtype)

    # The readings of the traced window, None without a trace.

    def launches_per_call(self):
        if self.trace is None or not self.trace.kernels:
            return None
        return self.trace.kernels / self.calls

    def idle_pct(self):
        if self.trace is None or self.trace.busy_s <= 0:
            return None
        return 100.0 * (1.0 - self.trace.busy_s / self.trace.window_s)

    def roofline_pct(self):
        """The calls' least time over the card's busy time."""
        if self.trace is None or self.trace.busy_s <= 0:
            return None
        return 100.0 * self.bound_per_call_s() * self.calls / self.trace.busy_s

    def mfu_pct(self):
        """The calls' least time over the traced window's wall time."""
        if self.trace is None:
            return None
        return 100.0 * self.bound_per_call_s() * self.calls / self.trace.window_s


def forbidden_modules() -> list:
    """Top-level names of loaded modules that must not be, compared whole
    (``symtensor_tpu_torch`` is not ``symtensor_tpu``)."""
    return sorted({m.partition(".")[0] for m in list(sys.modules)} & set(FORBIDDEN))


def require_cards(chips: int) -> None:
    if not torch.cuda.is_available():
        raise NotRunnable("no CUDA card (torch.cuda.is_available() is false)")
    if torch.cuda.device_count() < chips:
        raise NotRunnable(f"the cell asks for {chips} cards; "
                          f"{torch.cuda.device_count()} present")


def require_port_in(root: Path) -> None:
    """The program under test is the checkout's own."""
    import symtensor_tpu_torch

    where = Path(symtensor_tpu_torch.__file__).resolve()
    if root.resolve() not in where.parents:
        raise NotRunnable(f"symtensor_tpu_torch imported from {where}, outside {root}")


def card_text() -> str:
    """The card's name and power limit as ``nvidia-smi`` reads them."""
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"],
                             capture_output=True, text=True, timeout=60, check=True)
        return out.stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError):
        return "nvidia-smi unavailable"


def sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def read_metrics(entries: list, folder: str, ctx: Context) -> dict:
    out = {}
    for m in entries:
        value = spec.load_module(folder, m["name"]).read(ctx)
        if value is not None:
            out[m["name"]] = {"value": value, "unit": m["unit"]}
    return out


def execute(cell: spec.Cell, seed: int, seconds: float, traced: bool,
            device="cuda", t_start: float = T_START, log=sys.stderr) -> dict:
    """One run of `cell`; returns the result line as a dict. On a device
    other than a card (the CPU rehearsal) it reports no metric."""
    on_card = torch.device(device).type == "cuda"
    if on_card:
        torch.cuda.reset_peak_memory_stats()
    kind = spec.load_module("traffic", cell.kind)
    system_mod = spec.load_module("systems", cell.config["system"])
    yardstick = spec.load_module("yardsticks", cell.yardstick)
    rows = kind.pool_rows(cell.params)
    made = yardstick.draw(cell.config, cell.dtype, rows, seed, device)
    system = system_mod.System(cell.config, made)
    warmed = loop.warm(kind, system, made.pool, cell.params)
    sync(device)
    setup_s = time.perf_counter() - t_start

    def window():
        return loop.drive(kind, system, made.pool, cell.params, seconds)

    tr = None
    if traced:
        rec, tr = trace.traced(window)
    else:
        rec = window()
    sync(device)
    peak = torch.cuda.max_memory_allocated() if on_card else 0
    del system
    made.release()
    if on_card:
        torch.cuda.empty_cache()

    rec.warmup = warmed
    results = rec.all_results()
    again = yardstick.draw(cell.config, cell.dtype, rows, seed, device)
    compared, correct = yardstick.compare(cell.workload, rec, again)
    again.release()

    ctx = Context(cell, rec, setup_s, peak, tr)
    metrics = {}
    if on_card:
        metrics = (read_metrics(cell.per_layer, "layer_metrics", ctx) if traced
                   else read_metrics(cell.end_to_end, "end_to_end", ctx))
    dev = {"platform": "gpu" if on_card else torch.device(device).type,
           "kind": torch.cuda.get_device_name() if on_card else "cpu",
           "count": 1, "memory_peak_bytes": peak}
    line = {"correct": correct, "attempted": ctx.calls,
            "failed": int((~np.isfinite(results)).sum()), "metrics": metrics,
            "device": dev}
    if tr is not None:
        dev["busy_s"], dev["window_s"] = tr.busy_s, tr.window_s
        line["breakdown"] = {"device_ops": tr.device_ops, "idle_gaps": tr.idle_gaps}
    line["compared"] = compared
    print(f"[portbench] {cell.name} seed {seed}: {rec.units} units, {ctx.calls} calls "
          f"in {rec.elapsed:.3f} s; set-up {setup_s:.3f} s; peak {peak} bytes", file=log)
    return line


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="python -m portbench.run")
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)
    try:
        bench = spec.load_json(spec.ROOT / "BENCHMARK.json")
        entry = next(w for w in bench["workloads"] if w["name"] == args.workload)
        require_cards(entry["chips"])
        require_port_in(spec.ROOT)
        cell = spec.load_cell(args.workload)
        print(f"[portbench] card: {card_text()}", file=sys.stderr)
        line = execute(cell, args.seed, args.seconds, bool(args.trace))
        found = forbidden_modules()
        if found:
            raise NotRunnable(f"loaded in this process: {', '.join(found)}")
    except (NotRunnable, ImportError, FileNotFoundError, KeyError, StopIteration) as e:
        print(f"[portbench] no result: {type(e).__name__}: {e}", file=sys.stderr)
        return 2
    for name, c in line["compared"].items():
        print(f"[portbench] compared {name} = {c['value']!r} (limit {c['limit']!r})",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
