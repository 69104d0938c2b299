"""Closed loop, one caller fitting: each unit is one training step on the
next batch of the pool, with autograd on, its loss (before the step's
update) read back before the next step starts."""

import numpy as np

GRAD = True


def pool_rows(params: dict) -> int:
    return params["batch"] * params["pool_batches"]


def unit(system, pool, params: dict, k: int):
    B = params["batch"]
    s = (k % params["pool_batches"]) * B
    rows = np.arange(s, s + B)
    return 1, rows, [system.step(pool[s: s + B], rows)]
