"""Single inputs enqueued back to back: a unit is a chunk of calls on the
next inputs of the pool, whose scalars are read back once, together."""

import numpy as np
import torch


def pool_rows(params: dict) -> int:
    return params["pool_rows"]


def unit(system, pool, params: dict, k: int):
    chunk = params["chunk"]
    rows = (k * chunk + np.arange(chunk)) % pool.shape[0]
    ys = torch.stack([system.single(pool[int(r)]) for r in rows])
    return chunk, rows, ys.cpu().double().numpy()
