"""work.py's counts against closed forms."""

import math

import pytest

from portbench import peaks, work


@pytest.mark.parametrize("rank,dim", [(1, 5), (2, 7), (3, 4), (6, 5), (6, 100)])
def test_single_call(rank, dim):
    cfg = {"ranks": [rank], "dim": dim, "bias_std": 0}
    n = math.comb(dim + rank - 1, rank)
    assert work.values(cfg) == n
    assert work.call(cfg, "float32") == {"bytes": 4 * n + 4 * dim + 4, "flops": 2 * n}
    assert work.call(cfg, "bfloat16")["bytes"] == 2 * n + 4 * dim + 4


def test_batched_polynomial():
    cfg = {"ranks": [2, 3, 4, 5, 6], "dim": 100, "bias_std": 0.01}
    n = 1_705_904_645
    assert work.values(cfg) == n + 1
    w = work.call(cfg, "float32", rows=1024)
    assert w == {"bytes": 4 * (n + 1) + 1024 * 404, "flops": 2 * 1024 * (n + 1)}
    # the flagship batch is bound by operations: 7.06 ms at the TF32 peak
    assert peaks.bound_s(w, "float32") == pytest.approx(2 * 1024 * (n + 1) / 495e12)


def test_rank6_dim100_bound():
    w = work.call({"ranks": [6], "dim": 100}, "float32")
    assert peaks.bound_s(w, "float32") == pytest.approx(6.4373768e9 / 3.35e12, rel=1e-6)
