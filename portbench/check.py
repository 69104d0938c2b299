"""The comparison that decides ``correct``.

Every result of the window is compared: the reference evaluates each pool
row that the window used, from inputs drawn again from the seed (nothing
the program holds or made), and each result's gap to it is divided by the
root sum of squares of the polynomial's terms at that row
(``reference/poly.py``). The number compared, ``err``, is the worst such
gap; the workload's file gives its limit and the control's precision.
"""

from __future__ import annotations

import numpy as np
import torch

from .reference import poly


def reference_at(inputs, rows: np.ndarray, precision: str = "float64"):
    """(y, rss) of the reference at the pool rows `rows`, as NumPy."""
    xs = inputs.pool[torch.as_tensor(rows, device=inputs.pool.device)]
    y, rss = poly.evaluate(inputs.values, inputs.bias, xs, precision=precision)
    return y.cpu().numpy(), rss.cpu().numpy()


def worst_gap(rows: np.ndarray, results: np.ndarray, inputs) -> float:
    """max over results of |result − reference| / rss; inf where a result
    is not finite."""
    uniq, inv = np.unique(rows, return_inverse=True)
    y, rss = reference_at(inputs, uniq)
    gap = np.abs(results - y[inv]) / rss[inv]
    gap[~np.isfinite(results)] = np.inf
    return float(gap.max())


def compare(workload: dict, rows: np.ndarray, results: np.ndarray, inputs):
    """({name: {"value", "limit"}}, correct)."""
    limit = workload["limits"]["err"]
    err = worst_gap(rows, results, inputs)
    return {"err": {"value": err, "limit": limit}}, bool(err <= limit)


def control_results(workload: dict, rows: np.ndarray, inputs) -> np.ndarray:
    """The reference in the control's lower precision, at the same rows:
    what the program would return if it computed that way."""
    uniq, inv = np.unique(rows, return_inverse=True)
    y, _ = reference_at(inputs, uniq, precision=workload["control"])
    return y[inv].astype(np.float32).astype(np.float64)  # the program's result type
