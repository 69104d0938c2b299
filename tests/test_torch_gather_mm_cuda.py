"""The hand-written CUDA gather-combine against its plain twin, on the card.

These tests need a CUDA card and skip without one. They import no jax, so
they run with the repository's conftest (which only configures jax) left
out:

    python -m pytest -p no:cacheprovider --noconftest -m cuda \
        tests/test_torch_gather_mm_cuda.py
"""

import numpy as np
import pytest
import torch

import symtensor_tpu_torch as stt
from symtensor_tpu_torch.kernels import _build
from symtensor_tpu_torch.kernels import gather_mm as gm
from symtensor_tpu_torch.ops.outer import _subset_tables, _tensordot_tables
from symtensor_tpu_torch.utils import combinatorics as comb

pytestmark = pytest.mark.cuda

# normalised tolerance per operand type: the kernel rounds as the twin does
# (bfloat16, float16: the twin's float32 sum rounded once to their type)
TOL = {torch.float64: 1e-12, torch.float32: 1e-5, torch.bfloat16: 1e-5,
       torch.float16: 1e-5}
DTYPES = [torch.float64, torch.float32, torch.bfloat16, torch.float16]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", 0)


def _random(cuda, n_a, n_b, R, n_out, dtype, seed):
    g = torch.Generator(device=cuda).manual_seed(seed)
    a = torch.randn(n_a, generator=g, device=cuda, dtype=torch.float64).to(dtype)
    b = torch.randn(n_b, generator=g, device=cuda, dtype=torch.float64).to(dtype)
    ia = torch.randint(0, n_a, (R, n_out), generator=g, device=cuda, dtype=torch.int32)
    ib = torch.randint(0, n_b, (R, n_out), generator=g, device=cuda, dtype=torch.int32)
    w = torch.rand(R, generator=g, device=cuda, dtype=torch.float64).to(gm.acc_dtype(dtype))
    return a, b, ia, ib, w


def _err(got, ref):
    return float((got.double() - ref.double()).abs().max() / ref.double().abs().max())


# n_out 1000 is not a multiple of the kernel's 1024-output tile; R 1500
# spans two weight chunks; n_out 126 and 300 take the smallest tiles
@pytest.mark.parametrize("n_a,n_b,R,n_out", [
    (21, 21, 6, 126), (300, 250, 12, 1000), (100_000, 300, 7, 5000),
    (64, 64, 1500, 300), (4960, 4960, 20, 70_001),
])
@pytest.mark.parametrize("dtype", DTYPES)
def test_kernel_matches_twin(cuda, n_a, n_b, R, n_out, dtype):
    a, b, ia, ib, w = _random(cuda, n_a, n_b, R, n_out, dtype, n_a + R)
    before = gm.gather_combine.launches
    got = gm.gather_combine(a, b, ia, ib, w)
    torch.cuda.synchronize()
    assert gm.gather_combine.launches == before + 1
    ref = gm.gather_combine_ref(a, b, ia, ib, w)
    assert got.dtype == ref.dtype == dtype and got.shape == (n_out,)
    assert _err(got, ref) <= TOL[dtype]
    # each product and sum rounded as the twin's torch ops round them
    assert torch.equal(got, ref)
    # deterministic: no atomics, the same bits on every run
    assert torch.equal(gm.gather_combine(a, b, ia, ib, w), got)


@pytest.mark.parametrize("choice", gm.TILE_CHOICES)
@pytest.mark.parametrize("dtype", DTYPES)
def test_every_launch_plan_choice_matches_twin_bit_for_bit(cuda, dtype, choice, monkeypatch):
    a, b, ia, ib, w = _random(cuda, 4960, 4960, 45, 20_001, dtype, 7)
    items, threads = choice
    monkeypatch.setattr(gm, "launch_plan", lambda n_out, sms: gm.LaunchPlan(
        items, threads, -(-n_out // (items * threads))))
    got = gm.gather_combine(a, b, ia, ib, w)
    torch.cuda.synchronize()
    assert torch.equal(got, gm.gather_combine_ref(a, b, ia, ib, w))


@pytest.mark.parametrize("dtype", DTYPES)
def test_table_route_tables_match_twin_bit_for_bit(cuda, dtype):
    A_tab, B_tab, gam, n_sub = _tensordot_tables(3, 3, 1, 30, cuda)
    R = n_sub * A_tab.shape[1]
    ta, tb = A_tab.reshape(R, -1), B_tab.reshape(R, -1)
    assert ta.shape == (180, 40_920)
    plan = gm.launch_plan(ta.shape[1], torch.cuda.get_device_properties(cuda).multi_processor_count)
    assert plan.tiles >= gm.BLOCKS_PER_SM * 100  # fills the card
    n = comb.indep_size(3, 30)
    a, b, *_ = _random(cuda, n, n, 1, 1, dtype, 5)
    w = (gam.repeat(n_sub) / n_sub).to(gm.acc_dtype(dtype))
    got = gm.gather_combine(a, b, ta, tb, w)
    torch.cuda.synchronize()
    assert torch.equal(got, gm.gather_combine_ref(a, b, ta, tb, w))


def test_c1_subset_tables_float32(cuda):
    ta, tb = _subset_tables(3, 3, 30, cuda)
    assert ta.shape == tb.shape == (20, comb.indep_size(6, 30))
    a, b, *_ = _random(cuda, comb.indep_size(3, 30), comb.indep_size(3, 30),
                       1, 1, torch.float32, 3)
    got = gm.gather_combine(a, b, ta, tb)
    ref = gm.gather_combine_ref(a, b, ta, tb, torch.full((20,), 1 / 20, device=cuda))
    assert _err(got, ref) <= TOL[torch.float32]


def test_out_of_range_index_gives_nan_not_a_fault(cuda):
    a, b, ia, ib, w = _random(cuda, 40, 40, 3, 100, torch.float32, 9)
    ia[1, 17] = 40
    ib[2, 50] = -1
    got = gm.gather_combine(a, b, ia, ib, w)
    torch.cuda.synchronize()
    bad = torch.zeros(100, dtype=torch.bool, device=cuda)
    bad[[17, 50]] = True
    assert bool(got[bad].isnan().all()) and bool(got[~bad].isfinite().all())


def test_gradient_on_card_matches_cpu(cuda):
    a, b, ia, ib, w = _random(cuda, 40, 30, 5, 200, torch.float64, 11)
    g = torch.randn(200, dtype=torch.float64, device=cuda)
    grads = []
    for dev in (cuda, torch.device("cpu")):
        leaves = [t.detach().to(dev).requires_grad_() for t in (a, b, w)]
        out = gm.gather_combine(leaves[0], leaves[1], ia.to(dev), ib.to(dev), leaves[2])
        (out * g.to(dev)).sum().backward()
        grads.append([t.grad.cpu() for t in leaves])
    for got, want in zip(*grads):
        torch.testing.assert_close(got, want, rtol=1e-12, atol=1e-12)


@pytest.mark.parametrize("ra,rb,dim", [(3, 3, 8), (2, 4, 6), (1, 2, 9)])
def test_public_outer_on_card_matches_cpu(cuda, ra, rb, dim):
    rng = np.random.default_rng(ra * 10 + rb)
    A = stt.FlatSymmetricTensor(ra, dim, rng.normal(size=comb.indep_size(ra, dim)),
                                device="cpu")
    B = stt.FlatSymmetricTensor(rb, dim, rng.normal(size=comb.indep_size(rb, dim)),
                                device="cpu")
    want = stt.symalg.multiply.outer(A, B).data
    before = gm.gather_combine.launches
    got = stt.symalg.multiply.outer(A.to(cuda), B.to(cuda))
    assert gm.gather_combine.launches == before + 1
    assert got.data.device.type == "cuda"
    torch.testing.assert_close(got.data.cpu(), want, rtol=1e-12, atol=1e-12)
    td_want = stt.symalg.tensordot(A, B, axes=1, stream=False).data
    td = stt.symalg.tensordot(A.to(cuda), B.to(cuda), axes=1, stream=False)
    assert gm.gather_combine.launches == before + 2
    torch.testing.assert_close(td.data.cpu(), td_want, rtol=1e-12, atol=1e-12)


def test_failed_build_raises_instead_of_falling_back(cuda, monkeypatch):
    def broken():
        raise RuntimeError("nvcc failed")

    monkeypatch.setattr(_build, "load_library", broken)
    a, b, ia, ib, w = _random(cuda, 10, 10, 2, 10, torch.float32, 1)
    with pytest.raises(RuntimeError, match="nvcc failed"):
        gm.gather_combine(a, b, ia, ib, w)
