"""Closed loop, one caller: each call evaluates the next batch of the pool
and reads the batch's results back before the next call starts."""

import numpy as np


def pool_rows(params: dict) -> int:
    return params["batch"] * params["pool_batches"]


def unit(system, pool, params: dict, k: int):
    B = params["batch"]
    s = (k % params["pool_batches"]) * B
    return 1, np.arange(s, s + B), system.batched(pool[s: s + B]).cpu().double().numpy()
