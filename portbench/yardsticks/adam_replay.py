"""The yardstick of a ``SymmetricPolynomial`` fitted by Adam to a teacher
network's outputs: its inputs are the packed coefficients of each rank, a
bias, a pool of x (drawn as ``inputs.make`` draws them) and the targets;
``correct`` replays every step the program took, the warm-up's and then
the window's at the rows each used, in float64 (``reference/train.py``),
and compares three numbers:

- ``loss_gap``: the worst |program's loss − replay's loss| / replay's loss
  over the steps;
- ``grad_gap``: the worst over the ranks of ‖g − g_ref‖ / ‖g_ref‖, g the
  rank's coefficients' gradient at the first step;
- ``update_gap``: the worst over the ranks of ‖Δ − Δ_ref‖ / ‖Δ_ref‖, Δ the
  change of the rank's coefficients from their drawn values over every
  step; a state left unchanged reads 1.

The bias has no gap of its own: its gradient, the sum of a batch's
residuals, can cancel to near nothing, where a relative gap means
nothing. The loss holds it.

A step count that differs from the replay's, a loss that is not finite, or
a gradient or change the program did not leave, reads as infinite.

The model's parameters are the drawn tensors themselves (the system loads
them with ``assign=True``), so Adam moves them in place: the system keeps
each parameter's first gradient on the host (``Inputs.first``), and
``Inputs.release`` keeps each rank's final values there, for the
comparison that follows on inputs drawn again. The control is the same
replay with every product's operands rounded to TF32, in the program's
place."""

import dataclasses
import math

import numpy as np
import torch

from portbench.inputs import DTYPES, n_values
from portbench.reference import train

NAMES = ("loss_gap", "grad_gap", "update_gap")
_CHUNK = 1 << 26  # values a block when a rank crosses between host and card

# What the program left when its inputs were released: "first" (each
# parameter's first gradient) and "final" (each rank's values), dicts of
# parameter name -> flat float32 tensor on the host. The next compare takes
# it.
_left: dict = {}


def leaf(key) -> str:
    """A parameter's name in the model: "bias" or "terms.rank<r>"."""
    return "bias" if key == "bias" else f"terms.rank{key}"


@dataclasses.dataclass
class Trail:
    """What a fit leaves to compare: each step's loss, and each rank's
    first gradient and change over the fit (flat, float32, on the host,
    under the parameter's name)."""

    losses: np.ndarray
    first: dict | None
    moved: dict | None


@dataclasses.dataclass
class Inputs:
    values: dict            # rank -> (C(d+r-1, r),) packed coefficients
    bias: torch.Tensor      # 0-d
    pool: torch.Tensor      # (rows, dim) float32
    targets: torch.Tensor   # (rows,) the teacher's outputs at the pool
    adam: dict              # the configuration's lr, betas and eps
    first: dict | None = None  # name -> the program's first gradient, host (the system's)
    replayed: dict = dataclasses.field(default_factory=dict)  # precision -> (record, Trail)

    def state(self) -> dict:
        """The model's state dict: these tensors under the parameters' names."""
        return {leaf("bias"): self.bias, **{leaf(r): v for r, v in self.values.items()}}

    def release(self) -> None:
        if self.first is not None:  # a system trained these tensors in place
            _left.update(first=self.first,
                         final={leaf(r): v.detach().reshape(-1).to("cpu", torch.float32)
                                for r, v in self.values.items()})
        self.values, self.bias, self.pool, self.targets = {}, None, None, None
        self.first, self.replayed = None, {}


def draw(config: dict, dtype: str, pool_rows: int, seed: int, device) -> Inputs:
    """From one generator seeded with `seed`, in this order: each rank's
    values N(0, values_std²) (ascending), the bias N(0, bias_std²), the pool
    N(0, input_std²), then the teacher, a tanh layer of `teacher_width`
    units with weights N(0, teacher_std²) and output weights N(0,
    teacher_std²); the targets are its outputs at the pool rows, computed
    in float64 and stored in the values' type."""
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    dt, d = DTYPES[dtype], config["dim"]

    def normal(shape, std, dtype=dt):
        return torch.empty(shape, dtype=dtype, device=device).normal_(0.0, std, generator=gen)

    values = {r: normal(n_values(r, d), config["values_std"]) for r in sorted(config["ranks"])}
    bias = normal((), config["bias_std"])
    pool = normal((pool_rows, d), config["input_std"], torch.float32)
    w = normal((config["teacher_width"], d), config["teacher_std"], torch.float32)
    a = normal((config["teacher_width"],), config["teacher_std"], torch.float32)
    targets = torch.tanh(pool.double() @ w.double().T) @ a.double()
    adam = {k: config[k] for k in ("lr", "betas", "eps")}
    return Inputs(values, bias, pool, targets.to(dt), adam)


def replayed(record, made, precision: str) -> Trail:
    """The replay of every step of the record (warm-up first), kept on
    `made` so that the control and the comparison share one replay."""
    hit = made.replayed.get(precision)
    if hit is not None and hit[0] is record:
        return hit[1]
    host = lambda t: torch.empty(t.numel(), dtype=torch.float32)  # noqa: E731
    first = {r: host(v) for r, v in made.values.items()}
    moved = {r: host(v) for r, v in made.values.items()}
    a = made.adam
    losses = train.replay(made.values, made.bias, made.pool, made.targets,
                          record.warmup.rows + record.rows, a["lr"], tuple(a["betas"]),
                          a["eps"], precision, grads=first, moved=moved)
    out = Trail(losses, {leaf(r): first[r] for r in made.values},
                {leaf(r): moved[r] for r in made.values})
    made.replayed[precision] = (record, out)
    return out


def _program(record, made) -> Trail:
    """The program's trail: the record's losses, and what it left at
    release, its final values less the values drawn again."""
    left = dict(_left)
    _left.clear()
    losses = np.concatenate(record.warmup.results + record.results)
    if not left:
        return Trail(losses, None, None)
    start = made.state()
    moved = {}
    for k, final in left["final"].items():
        s0 = start[k].reshape(-1)
        out = moved[k] = torch.empty_like(final)
        for s in range(0, final.numel(), _CHUNK):
            e = s + _CHUNK
            out[s:e] = final[s:e].to(s0.device, torch.float64) - s0[s:e].to(torch.float64)
    return Trail(losses, left["first"], moved)


def _rel(got: dict | None, ref: dict, device) -> float:
    """The worst over ref's ranks of ‖got − ref‖ / ‖ref‖, in float64 on
    `device`; infinite where got lacks a rank or a size."""
    worst = 0.0
    for k, want in ref.items():
        have = None if got is None else got.get(k)
        if have is None or have.numel() != want.numel():
            return math.inf
        num = den = 0.0
        for s in range(0, want.numel(), _CHUNK):
            e = s + _CHUNK
            y = want[s:e].to(device, torch.float64)
            num += float(torch.sum((have[s:e].to(device, torch.float64) - y) ** 2))
            den += float(torch.sum(y * y))
        worst = max(worst, math.sqrt(num / den) if den > 0 else math.inf)
    return worst


def _gaps(workload: dict, got: Trail, ref: Trail, device):
    loss = math.inf
    if len(got.losses) == len(ref.losses) and np.all(np.isfinite(got.losses)):
        loss = float(np.max(np.abs(got.losses - ref.losses) / ref.losses))
    values = {"loss_gap": loss, "grad_gap": _rel(got.first, ref.first, device),
              "update_gap": _rel(got.moved, ref.moved, device)}
    values = {k: v if v == v else math.inf for k, v in values.items()}  # NaN reads infinite
    limits = workload["limits"]
    out = {k: {"value": values[k], "limit": limits[k]} for k in NAMES}
    return out, all(bool(values[k] <= limits[k]) for k in NAMES)


def compare(workload: dict, record, made):
    """The program's losses, first gradients and changes against the
    float64 replay's."""
    return _gaps(workload, _program(record, made), replayed(record, made, "float64"),
                 made.pool.device)


def control(workload: dict, record, made):
    """The TF32 replay in the program's place."""
    return _gaps(workload, replayed(record, made, workload["control"]),
                 replayed(record, made, "float64"), made.pool.device)
