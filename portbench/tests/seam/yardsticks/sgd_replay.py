"""The yardstick of a polynomial fitted by plain SGD on a mean squared
error: its inputs are the packed coefficients of each degree, a bias, a
pool of x and a target for each x; ``correct`` replays every step the
program took (the warm-up's, then the window's, at the rows each used) in
float64 with plain torch and compares the program's loss of each step.

The polynomial is linear in its coefficients: at a batch X, the values of
degree r multiply the features r!/∏m_k · ∏_k x_{I_k} of their index tuples
I (``reference/poly.py``'s storage order and running multiplicities), so
the loss and its gradient are two products with that feature matrix."""

import dataclasses
import math

import numpy as np
import torch

from portbench.reference import poly

DTYPES = {"float32": torch.float32, "float64": torch.float64,
          "bfloat16": torch.bfloat16}


@dataclasses.dataclass
class Inputs:
    values: dict            # degree -> (C(d+r-1, r),) packed coefficients
    bias: torch.Tensor      # 0-d
    pool: torch.Tensor      # (rows, dim)
    targets: torch.Tensor   # (rows,)
    lr: float

    def release(self) -> None:
        self.values, self.bias, self.pool, self.targets = {}, None, None, None


def draw(config: dict, dtype: str, pool_rows: int, seed: int, device) -> Inputs:
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    dt, d = DTYPES[dtype], config["dim"]

    def normal(shape, std):
        return torch.empty(shape, dtype=dt, device=device).normal_(0.0, std, generator=gen)

    values = {r: normal(math.comb(d + r - 1, r), config["coef_std"])
              for r in sorted(config["degrees"])}
    return Inputs(values, normal((), config["bias_std"]),
                  normal((pool_rows, d), config["input_std"]),
                  normal((pool_rows,), config["target_std"]), config["lr"])


def features(rank: int, X: torch.Tensor) -> torch.Tensor:
    """(rows, C(d+r-1, r)): the factor of each packed value at each row."""
    idx = poly.storage_order(rank, X.shape[1])
    coef = math.factorial(rank) / np.prod(poly.running_multiplicity(idx), axis=1)
    return torch.as_tensor(coef, dtype=X.dtype) * X[:, torch.as_tensor(idx)].prod(-1)


def replay(record, made, dtype: torch.dtype) -> np.ndarray:
    """The loss of every step the record holds, computed in `dtype`."""
    v = {r: t.detach().cpu().to(dtype) for r, t in made.values.items()}
    b = made.bias.detach().cpu().to(dtype)
    pool, targets = made.pool.cpu().to(dtype), made.targets.cpu().to(dtype)
    lr, losses = made.lr, []
    for rows in record.warmup.rows + record.rows:
        X, t = pool[rows], targets[rows]
        F = {r: features(r, X) for r in v}
        e = b + sum(F[r] @ v[r] for r in v) - t
        losses.append(float((e * e).mean()))
        for r in v:
            v[r] = v[r] - lr * (2.0 / len(rows)) * (F[r].T @ e)
        b = b - lr * 2.0 * e.mean()
    return np.asarray(losses)


def _gap(workload: dict, losses: np.ndarray, ref: np.ndarray):
    limit = workload["limits"]["loss_gap"]
    gap = float(np.max(np.abs(losses - ref) / ref)) if len(losses) == len(ref) else np.inf
    if not np.all(np.isfinite(losses)):
        gap = np.inf
    return {"loss_gap": {"value": gap, "limit": limit}}, bool(gap <= limit)


def compare(workload: dict, record, made):
    """The worst relative gap of the program's loss to the reference's."""
    losses = np.concatenate(record.warmup.results + record.results)
    return _gap(workload, losses, replay(record, made, torch.float64))


def control(workload: dict, record, made):
    """The same replay in the workload's lower precision, in the program's
    place."""
    losses = replay(record, made, DTYPES[workload["control"]]).astype(np.float64)
    return _gap(workload, losses, replay(record, made, torch.float64))
