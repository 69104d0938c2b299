"""The whole training step's share of the card's peak: a step's least time
over the traced window's wall time per step, host work and idle card
included. The least time is the sum of three phases, each the larger of
its operations over ``peaks.py``'s float32 rate (TF32 tensor cores) and
its bytes over the memory rate, with n the packed coefficients and B the
rows of a step:

- forward: 2·B·n operations, the coefficients read once (4n bytes);
- the coefficients' gradient: 2·B·n operations, written once (4n bytes);
- Adam: p, g, m and v read and p, m and v written (28n bytes)."""

from portbench.inputs import n_values
from portbench.peaks import FLOPS_PER_S, HBM_BYTES_PER_S


def step_bound_s(config: dict, rows: float) -> float:
    n = sum(n_values(r, config["dim"]) for r in config["ranks"])
    gemm = max(2.0 * rows * n / FLOPS_PER_S["float32"], 4.0 * n / HBM_BYTES_PER_S)
    return 2.0 * gemm + 28.0 * n / HBM_BYTES_PER_S


def read(ctx):
    if ctx.trace is None or not ctx.calls:
        return None
    bound = step_bound_s(ctx.cell.config, ctx.points / ctx.calls)
    return 100.0 * bound * ctx.calls / ctx.trace.window_s
