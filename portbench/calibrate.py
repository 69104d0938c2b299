"""The readings that a cell's limit is set from, on the card at the cell's
own size, in one process.

    python -m portbench.calibrate --workload <cell> --seeds 1,2,... \
        [--control-seeds 1,2,3] [--seconds 3]

For each seed: the cell's inputs, its system and a short window at its own
load, exactly as a run makes them; then each number that the cell's
yardstick compares (``err`` for a packed polynomial), read from the
program's results (the lower reading is the largest over the seeds) and,
on the control seeds, as ``control_<name>`` from the yardstick's control in
the program's place, for a packed polynomial the reference in the
workload's lower precision at the same rows (the upper reading is the
smallest). One JSON line per seed. The benchmark's runs never run this.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import torch

from . import loop, spec


def reading(cell: spec.Cell, seed: int, seconds: float, control: bool, device="cuda") -> dict:
    kind = spec.load_module("traffic", cell.kind)
    system_mod = spec.load_module("systems", cell.config["system"])
    yardstick = spec.load_module("yardsticks", cell.yardstick)
    rows = kind.pool_rows(cell.params)
    t0 = time.perf_counter()
    made = yardstick.draw(cell.config, cell.dtype, rows, seed, device)
    system = system_mod.System(cell.config, made)
    warmed = loop.warm(kind, system, made.pool, cell.params)
    rec = loop.drive(kind, system, made.pool, cell.params, seconds)
    rec.warmup = warmed
    del system
    made.release()
    again = yardstick.draw(cell.config, cell.dtype, rows, seed, device)
    out = {"seed": seed, "calls": int(sum(rec.calls))}
    compared, _ = yardstick.compare(cell.workload, rec, again)
    out.update((name, c["value"]) for name, c in compared.items())
    if control:
        compared, _ = yardstick.control(cell.workload, rec, again)
        out.update((f"control_{name}", c["value"]) for name, c in compared.items())
    again.release()
    out["s"] = time.perf_counter() - t0
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="python -m portbench.calibrate")
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--control-seeds", default="")
    p.add_argument("--seconds", type=float, default=3.0)
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        print("no CUDA card", file=sys.stderr)
        return 2
    cell = spec.load_cell(args.workload)
    seeds = [int(s) for s in args.seeds.split(",") if s]
    controls = {int(s) for s in args.control_seeds.split(",") if s}
    for seed in seeds + sorted(controls - set(seeds)):
        r = reading(cell, seed, args.seconds, seed in controls)
        print(json.dumps({"workload": cell.name, **r}), flush=True)
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
