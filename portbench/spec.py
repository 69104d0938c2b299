"""What a cell is, found by name.

``BENCHMARK.json`` (at the root of the checkout) names each cell's
configuration and traffic and lists, per metric, the cells that report it.
Everything else of a cell is a file of its own under ``portbench/``:

- ``configs/<config>.json``: the sizes, the system under test
  (``systems/<system>.py``), how its inputs are drawn and, under an
  optional ``yardstick`` key, the module ``yardsticks/<yardstick>.py``
  that draws them and decides ``correct`` (``packed_poly`` without it);
- ``workloads/<cell>.json``: the traffic kind (``traffic/<kind>.py``), its
  parameters and the limits of the comparison that decides ``correct``;
- ``end_to_end/<metric>.py`` and ``layer_metrics/<metric>.py``: one reader
  per metric, ``read(ctx) -> float | None``.

A later cell, configuration, yardstick, traffic kind or metric is a new file
and a new entry in ``BENCHMARK.json``; no file here changes.
"""

from __future__ import annotations

import dataclasses
import importlib.util
import json
import re
from pathlib import Path

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
DEFAULT_YARDSTICK = "packed_poly"


@dataclasses.dataclass
class Cell:
    name: str
    config: dict      # configs/<config>.json
    workload: dict    # workloads/<cell>.json
    end_to_end: list  # BENCHMARK.json metric entries this cell reports
    per_layer: list

    @property
    def kind(self) -> str:
        return self.workload["kind"]

    @property
    def params(self) -> dict:
        return self.workload["params"]

    @property
    def yardstick(self) -> str:
        """The module under ``yardsticks/`` that draws the inputs and
        decides ``correct``."""
        return self.config.get("yardstick", DEFAULT_YARDSTICK)

    @property
    def dtype(self) -> str:
        """The storage type: the traffic's, else the configuration's."""
        return self.params.get("dtype", self.config["dtype"])


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def reports(metric: dict, cell: str) -> bool:
    return cell in metric.get("workloads", [cell])


def load_cell(name: str, root: Path = ROOT) -> Cell:
    """The cell `name` of ``root/BENCHMARK.json`` with its files."""
    bench = load_json(root / "BENCHMARK.json")
    entry = next((w for w in bench["workloads"] if w["name"] == name), None)
    if entry is None:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")
    cfg_entry = next(c for c in bench["configs"] if c["name"] == entry["config"])
    config = load_json(root / cfg_entry["file"])
    workload = load_json(HERE / "workloads" / f"{name}.json")
    if (workload["config"], workload["traffic"]) != (entry["config"], entry["traffic"]):
        raise ValueError(f"workloads/{name}.json disagrees with BENCHMARK.json")
    return Cell(
        name=name, config=config, workload=workload,
        end_to_end=[m for m in bench["end_to_end"] if reports(m, name)],
        per_layer=[m for m in bench["per_layer"] if reports(m, name)],
    )


def load_module(folder: str, name: str):
    """``portbench/<folder>/<name>.py`` as a module (names may hold dots)."""
    path = HERE / folder / f"{name}.py"
    if not path.is_file():
        raise FileNotFoundError(f"no {folder}/{name}.py under portbench/")
    mod_name = "portbench._" + re.sub(r"\W", "_", f"{folder}_{name}")
    spec = importlib.util.spec_from_file_location(mod_name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod
