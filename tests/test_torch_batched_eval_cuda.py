"""The hand-written batched fold kernel (``csrc/batched_fold.cu``) against
its plain twin ``_batched_forward`` in float64, on the card.

These tests need a CUDA card and skip without one. They import no jax, so
they run with the repository's conftest (which only configures jax) left
out:

    python -m pytest -p no:cacheprovider --noconftest -m cuda \
        tests/test_torch_batched_eval_cuda.py
"""

import pytest
import torch

from portbench.reference import poly
from symtensor_tpu_torch.core.flat import FlatSymmetricTensor
from symtensor_tpu_torch import symalg
from symtensor_tpu_torch.kernels import _build
from symtensor_tpu_torch.kernels import batched_eval as be
from symtensor_tpu_torch.kernels import group_pass as gp
from symtensor_tpu_torch.kernels import poly_eval as tpe
from symtensor_tpu_torch.models import polynomial
from symtensor_tpu_torch.utils import combinatorics as comb

pytestmark = pytest.mark.cuda

# |kernel − float64 twin| over the twin at |values| and |x|, per input: the
# fold's effective weights ω are all positive, so that scale bounds every
# partial sum; float32 sums of up to 5 050 products stay below it, and at
# these dims one row of ΣP_j left out or counted twice is above it.
TOL = 1e-5
# |kernel − float64 reference| over the root sum of squares of the terms
# (the batch benchmark's err, ``portbench/reference/poly.py``), where the
# |values| normalisation above has room for far coarser products: at rank
# 6, dim 100 and B = 1 024 the split-TF32 kernel with runs of at most
# ENTRY_COLUMNS columns reads below it; one TF32 product (no lo halves) or
# a whole group's K in one run of the tensor cores' truncating float32 sums
# reads above it.
RSS_TOL = 2e-5


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", 0)


def _inputs(dev, rank, dim, batch, seed):
    g = torch.Generator(device=dev).manual_seed(seed)
    vals = torch.randn(comb.indep_size(rank, dim), generator=g, device=dev)
    xs = torch.randn(batch, dim, generator=g, device=dev) / dim**0.5
    return FlatSymmetricTensor._raw(rank, dim, vals), xs


def _kernel(A, xs):
    return tpe._BatchedEval.apply(A.data, xs, A.tables, A.rank, A.dim, torch.float32)


def _twin64(A, vals, xs):
    return tpe._batched_forward(vals.double(), xs.double(), A.tables, A.rank, A.dim,
                                torch.float64)


def _nerr(A, xs, got):
    ref = _twin64(A, A.data, xs)
    scale = _twin64(A, A.data.abs(), xs.abs())
    return float(((got.double() - ref).abs() / scale).max())


def _rss_err(A, xs, got):
    ref, rss = poly.evaluate({A.rank: A.data}, None, xs)
    return float(((got.double() - ref).abs() / rss).max())


CASES = [(r, d) for r in range(3, 8) for d in range(1, 7)] + [(4, 100)]


@pytest.mark.parametrize("batch", [1, 3, 64, 200, 1000, 1024])
@pytest.mark.parametrize("rank,dim", CASES)
def test_kernel_matches_twin_float64(cuda, rank, dim, batch):
    A, xs = _inputs(cuda, rank, dim, batch, 1000 * rank + 10 * dim + batch)
    before = be.batched_eval.launches
    got = _kernel(A, xs)
    again = _kernel(A, xs)
    torch.cuda.synchronize()
    assert be.batched_eval.launches == before + 2
    assert got.dtype == torch.float32 and got.shape == (batch,)
    assert torch.equal(got, again)  # no atomics on values: the same bits
    assert _nerr(A, xs, got) <= TOL


def test_rank6_dim40_many_tiles_a_block(cuda):
    """Rank 6 at dim 40 and B = 1 024: 984 entries of 8 batch tiles, about
    30 tiles a block, groups with T_j < 16 and P_j not a multiple of 128."""
    A, xs = _inputs(cuda, 6, 40, 1024, 7)
    got = _kernel(A, xs)
    assert _nerr(A, xs, got) <= TOL
    assert torch.equal(_kernel(A, xs), got)


@pytest.mark.parametrize("rank,dim,batch", [(4, 9, 64), (6, 12, 200)])
def test_shares_the_done_counter_with_group_eval(cuda, rank, dim, batch):
    """batched_eval counts its blocks in group_eval's done counter on the
    stream: the two launched in turns give the bits each gives alone, and
    leave the counter at zero."""
    A, xs = _inputs(cuda, rank, dim, batch, 70 + rank)

    def single():
        return symalg.contract_all_indices_with_vector(A, xs[0])

    want_b, want_s = _kernel(A, xs), single()
    before = (be.batched_eval.launches, gp.group_eval.launches)
    for _ in range(3):
        assert torch.equal(_kernel(A, xs), want_b)
        assert torch.equal(single(), want_s)
    assert (be.batched_eval.launches, gp.group_eval.launches) == (before[0] + 3,
                                                                  before[1] + 3)
    done = _build.done_counter(cuda, torch.cuda.current_stream(cuda).cuda_stream)
    assert int(done.view(torch.int32)[0]) == 0


@pytest.mark.parametrize("rank,dim,batch", [(3, 6, 5), (4, 9, 64), (6, 5, 33)])
def test_value_and_gradients_unchanged(cuda, rank, dim, batch):
    """_BatchedEval through the kernel: its value and the values' and x's
    gradients (the unchanged plain backward) against the float64 twin."""
    A, xs = _inputs(cuda, rank, dim, batch, 50 + rank)
    g = torch.randn(batch, device=cuda, dtype=torch.float64)
    outs = {}
    for name, dt in (("kernel", torch.float32), ("twin", torch.float64)):
        v = A.data.to(dt).clone().requires_grad_(True)
        x = xs.to(dt).clone().requires_grad_(True)
        y = tpe._BatchedEval.apply(v, x, A.tables, rank, dim, dt)
        (y * g.to(dt)).sum().backward()
        outs[name] = (y.double(), v.grad.double(), x.grad.double())
    for got, want in zip(outs["kernel"], outs["twin"]):
        assert float((got - want).abs().max()) <= 1e-4 * float(want.abs().max())


def test_model_counts_one_launch_a_rank(cuda):
    """apply_batched over ranks 2-6 under no_grad (the parameters require a
    gradient, so every rank ≥ 3 takes _BatchedEval): one launch for each
    of ranks 3-6, and the float64 model's result."""
    g = torch.Generator(device=cuda).manual_seed(3)
    model = polynomial.init([2, 3, 4, 5, 6], 8, generator=g, device=cuda,
                            dtype=torch.float32)
    xs = torch.randn(100, 8, generator=g, device=cuda) / 8**0.5
    before = be.batched_eval.launches
    with torch.no_grad():
        y = polynomial.apply_batched(model, xs)
        torch.cuda.synchronize()
        assert be.batched_eval.launches == before + 4
        want = polynomial.apply_batched(model.double(), xs.double())
    assert be.batched_eval.launches == before + 4
    assert y.dtype == torch.float32 and y.shape == (100,)
    assert float((y.double() - want).abs().max()) <= 1e-5 * float(want.abs().max())


def test_rank6_dim100_batch1024(cuda):
    """The flagship's rank at the batch cell's size (128 x 128 tiles, two
    stages a block): against the float64 twin, against the plain reference
    by the root sum of squares of the terms, and the same bits twice."""
    A, xs = _inputs(cuda, 6, 100, 1024, 61)
    got = _kernel(A, xs)
    assert torch.equal(_kernel(A, xs), got)
    assert _nerr(A, xs, got) <= TOL
    assert _rss_err(A, xs, got) <= RSS_TOL


@pytest.mark.parametrize("rank,dim,batch", [(3, 48, 5), (3, 40, 60), (4, 33, 200),
                                            (5, 33, 10), (5, 33, 64), (5, 36, 300)])
def test_row_term_and_misaligned_rows_at_every_offset(cuda, rank, dim, batch):
    """Groups j = 0 .. d - 1 put the row term's end rl = d - j at every
    offset of a 16- or 32-column stage, and their rows of T_j floats start
    at every offset from a 16-byte boundary; column t = 0 opens each
    group's first stage. Every tile shape's stage width is covered."""
    layout = comb.gflat_layout(rank, dim)
    assert {(dim - j) % 32 for j in range(dim)} == set(range(32))
    rows = {int(layout.group_off[j] + p * layout.T[j]) % 4
            for j in range(dim) for p in range(min(int(layout.P[j]), 4))}
    assert rows == {0, 1, 2, 3}
    A, xs = _inputs(cuda, rank, dim, batch, 90 + rank + dim)
    got = _kernel(A, xs)
    assert torch.equal(_kernel(A, xs), got)
    assert _nerr(A, xs, got) <= TOL

