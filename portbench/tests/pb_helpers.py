"""Cells of ``BENCHMARK.json`` cut to sizes the CPU runs in a second, and
faults planted in the port, for the tests here (none needs a card)."""

from __future__ import annotations

import contextlib
import time

import torch

from portbench import run, spec
from portbench.reference import poly

CELLS = [
    "flat-r6-d100.single-f32",
    "sympoly-r2to6-d100.batch1024-f32",
    "flat-r6-d100.stream-f32",
    "flat-r6-d100.single-bf16",
    "flat-r6-d100.stream-bf16",
]
TINY = {  # (configuration, traffic) keys changed for the CPU
    "flat_tensor": ({"dim": 12}, {"pool_rows": 64, "chunk": 8}),
    "polynomial": ({"dim": 16}, {"batch": 64, "pool_batches": 4}),
}
SEEDS = (3, 2**31 + 77, 4_000_000_001)


def tiny(name: str) -> spec.Cell:
    cell = spec.load_cell(name)
    cfg, par = TINY[cell.config["system"]]
    cell.config.update(cfg)
    cell.params.update({k: v for k, v in par.items() if k in cell.params})
    return cell


def dry_run(name: str, seed: int = SEEDS[0], traced: bool = False, seconds: float = 0.3) -> dict:
    """A whole run of the tiny cell on the CPU, its result line."""
    return run.execute(tiny(name), seed, seconds, traced, device="cpu",
                       t_start=time.perf_counter())


@contextlib.contextmanager
def patched(monkeypatch, single=None, batched=None):
    """Replace the port's single-input and batched evaluation routes
    (``kernels.poly_eval``), which ``ops.contract`` looks up at each call:
    `single(orig, A, x)` and `batched(orig, A, xs)` wrap the originals."""
    from symtensor_tpu_torch.kernels import poly_eval

    if single is not None:
        orig_s = poly_eval.poly_eval_flat_fast
        monkeypatch.setattr(poly_eval, "poly_eval_flat_fast",
                            lambda A, x: single(orig_s, A, x))
    if batched is not None:
        orig_b = poly_eval.poly_eval_flat_batched
        monkeypatch.setattr(poly_eval, "poly_eval_flat_batched",
                            lambda A, xs: batched(orig_b, A, xs))
    yield


def control(precision: str):
    """The reference in `precision`, in the program's place, for a flat
    tensor A at x (dim,) or xs (B, dim), in the program's result type."""
    def ev(orig, A, x):
        xs = x[None] if x.ndim == 1 else x
        y, _ = poly.evaluate({A.rank: A.data}, None, xs, precision=precision)
        y = y.to(torch.float32)
        return y[0] if x.ndim == 1 else y
    return ev


def nth_answer_altered(n: int):
    """The n-th call's answer (counted over single and batched calls, from
    0) moved by 1 % of itself and 1e-3."""
    count = [0]

    def ev(orig, A, x):
        y = orig(A, x)
        if count[0] == n:
            y = y.clone()
            flat = y.view(-1)
            flat[0] = flat[0] + 0.01 * flat[0].abs() + 1e-3
        count[0] += 1
        return y
    return ev


def half_batch_mean(orig, A, xs):
    """Half of the batch left out, the mean of the other half in its place."""
    half = orig(A, xs[: xs.shape[0] // 2])
    return torch.cat([half, half.mean().expand(xs.shape[0] - half.shape[0])])
