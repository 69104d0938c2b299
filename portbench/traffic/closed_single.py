"""Closed loop, one caller: each call evaluates the next input of the pool
and reads its scalar back before the next call starts."""


def pool_rows(params: dict) -> int:
    return params["pool_rows"]


def unit(system, pool, params: dict, k: int):
    row = k % pool.shape[0]
    return 1, [row], [system.single(pool[row]).item()]
