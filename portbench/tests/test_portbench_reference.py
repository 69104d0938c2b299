"""The plain reference against a dense contraction of the symmetrised
tensor, and its enumeration against the port's own format."""

import itertools
import math

import numpy as np
import pytest
import torch

from portbench.reference import poly


def dense_of(vals: np.ndarray, rank: int, dim: int) -> np.ndarray:
    """The symmetric dense tensor: every permutation of each stored tuple."""
    T = np.zeros((dim,) * rank)
    for v, idx in zip(vals, poly.storage_order(rank, dim)):
        for p in set(itertools.permutations(idx)):
            T[p] = v
    return T


@pytest.mark.parametrize("rank,dim", [(0, 3), (1, 6), (2, 6), (3, 5), (4, 6), (4, 3), (3, 1)])
def test_equals_dense_einsum(rank, dim):
    g = np.random.default_rng(rank * 10 + dim)
    n = math.comb(dim + rank - 1, rank)
    vals = g.standard_normal(n)
    xs = g.standard_normal((5, dim))
    T = dense_of(vals, rank, dim)
    letters = "abcdefgh"[:rank]
    want = [np.einsum(f"{letters}," + ",".join(letters) + "->", T, *([x] * rank))
            if rank else T for x in xs]
    y, rss = poly.evaluate({rank: torch.as_tensor(vals)}, None, torch.as_tensor(xs))
    assert np.allclose(y.numpy(), want, rtol=1e-12, atol=1e-12 * rss.numpy())


def test_bias_and_several_ranks_add():
    g = np.random.default_rng(0)
    vals = {r: torch.as_tensor(g.standard_normal(math.comb(4 + r - 1, r))) for r in (2, 3, 5)}
    xs = torch.as_tensor(g.standard_normal((3, 4)))
    bias = torch.tensor(0.25, dtype=torch.float64)
    y, rss = poly.evaluate(vals, bias, xs, block_rows=2)
    parts = [poly.evaluate({r: v}, None, xs) for r, v in vals.items()]
    assert torch.allclose(y, bias + sum(p[0] for p in parts), rtol=1e-13)
    assert torch.allclose(rss ** 2, bias ** 2 + sum(p[1] ** 2 for p in parts), rtol=1e-13)


@pytest.mark.parametrize("rank,dim", [(3, 6), (4, 5), (6, 4), (2, 7)])
def test_storage_order_is_the_ports(rank, dim):
    """The order the reference enumerates is the one the port stores."""
    import symtensor_tpu_torch as stt

    n = math.comb(dim + rank - 1, rank)
    A = stt.FlatSymmetricTensor(rank, dim, data=torch.arange(n, dtype=torch.float64))
    D = A.todense().numpy()
    order = poly.storage_order(rank, dim)
    assert len(order) == n
    assert np.array_equal(D[tuple(order.T)], np.arange(n))


def test_enumeration_must_cover_the_values():
    with pytest.raises(ValueError):
        poly.evaluate({4: torch.zeros(10, dtype=torch.float64)}, None, torch.zeros(1, 3))


def test_controls_round_as_stated():
    t = torch.tensor([1.0 + 2.0 ** -11, 1.0 + 3 * 2.0 ** -11, -(1.0 + 2.0 ** -10)], dtype=torch.float64)
    assert poly.round_tf32(t).tolist() == [1.0, 1.0 + 2 * 2.0 ** -10, -(1.0 + 2.0 ** -10)]
    q = poly.quantize_fp8(torch.tensor([448.0, 1.0, 0.3]), 448.0)
    assert q.tolist() == [448.0, 1.0, 0.3125]
