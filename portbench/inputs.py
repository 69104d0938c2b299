"""A cell's inputs, drawn from the seed on the device.

One ``torch.Generator`` on the run's device, seeded with ``--seed``, draws in
a fixed order: the packed values of each rank (ascending), in the storage
type, in one call each; the bias; the pool of inputs x. The same seed gives
the same inputs, so the reference draws them again rather than read what
the program holds.
"""

from __future__ import annotations

import dataclasses
import math

import torch

DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
          "float64": torch.float64}


def n_values(rank: int, dim: int) -> int:
    """Packed values of a rank-`rank` dim-`dim` symmetric tensor."""
    return math.comb(dim + rank - 1, rank)


@dataclasses.dataclass
class Inputs:
    values: dict            # rank -> (C(d+r-1, r),) in the storage type
    bias: torch.Tensor      # 0-d in the storage type, or None
    pool: torch.Tensor      # (rows, dim) float32

    def release(self) -> None:
        self.values, self.bias, self.pool = {}, None, None


def make(config: dict, dtype: str, pool_rows: int, seed: int, device) -> Inputs:
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    dt, d = DTYPES[dtype], config["dim"]
    values = {}
    for r in sorted(config["ranks"]):
        values[r] = torch.empty(n_values(r, d), dtype=dt, device=device).normal_(
            0.0, config["values_std"], generator=gen)
    bias = None
    if config.get("bias_std"):
        bias = torch.empty((), dtype=dt, device=device).normal_(
            0.0, config["bias_std"], generator=gen)
    pool = torch.empty((pool_rows, d), dtype=torch.float32, device=device).normal_(
        0.0, config["input_std"], generator=gen)
    return Inputs(values, bias, pool)
