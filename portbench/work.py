"""The necessary work of one call, from the configuration's shapes alone.

Frozen with the benchmark: it counts what the op itself must read, write
and compute, not what a kernel of the port happens to build (tables,
triangle monomials, head weights), so a kernel that replaces another is
read against the same work. Evaluating a polynomial of packed values is
one multiply-add per value and input: the values are read once, the
inputs once, the results written once.
"""

from __future__ import annotations

from .inputs import DTYPES, n_values

X_BYTES = 4    # inputs are float32
OUT_BYTES = 4  # so is every result


def values(config: dict) -> int:
    """Packed values of all ranks, the bias included."""
    n = sum(n_values(r, config["dim"]) for r in config["ranks"])
    return n + (1 if config.get("bias_std") else 0)


def call(config: dict, dtype: str, rows: int = 1) -> dict:
    """{"bytes", "flops"} of one call evaluating `rows` inputs."""
    n = values(config)
    return {
        "bytes": n * DTYPES[dtype].itemsize + rows * (config["dim"] * X_BYTES + OUT_BYTES),
        "flops": 2 * rows * n,
    }
