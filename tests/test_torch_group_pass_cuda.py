"""The hand-written CUDA group pass against its plain twin, on the card.

These tests need a CUDA card and skip without one. They import no jax, so
they run with the repository's conftest (which only configures jax) left
out:

    python -m pytest -p no:cacheprovider --noconftest -m cuda \
        tests/test_torch_group_pass_cuda.py
"""

import numpy as np
import pytest
import torch

import symtensor_tpu_torch as stt
from symtensor_tpu_torch.kernels import _build
from symtensor_tpu_torch.kernels.group_pass import (
    acc_dtype,
    group_pass,
    group_pass_ref,
    tile_table,
)
from symtensor_tpu_torch.utils import combinatorics as comb

pytestmark = pytest.mark.cuda

# normalised tolerance per storage type: both sides sum in the
# accumulation type, in different orders
TOL = {torch.float64: 1e-12, torch.float32: 1e-5, torch.bfloat16: 1e-5}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", 0)


DTYPES = [torch.float64, torch.float32, torch.bfloat16]


def _inputs(cuda, rank, dim, dtype, offset=0):
    """Seeded values (a view `offset` elements into a larger buffer, so
    its data_ptr need not be 16-byte aligned) and tri."""
    g = torch.Generator(device=cuda).manual_seed(rank * 100 + dim + offset)
    lay = comb.gflat_layout(rank, dim)
    store = torch.float64 if dtype == torch.float64 else torch.float32
    buf = torch.randn(lay.n + offset, generator=g, device=cuda, dtype=store)
    vals = buf.to(dtype)[offset:]
    tri = torch.randn(comb.tri_size(dim), generator=g, device=cuda,
                      dtype=acc_dtype(dtype))
    return lay, vals, tri


def _check_against_twin(lay, vals, tri, dtype):
    before = group_pass.launches
    got = group_pass(vals, tri, lay)
    torch.cuda.synchronize()
    assert group_pass.launches == before + 1
    ref = group_pass_ref(vals, tri, lay)
    assert got.dtype == ref.dtype == acc_dtype(dtype)
    err = float((got - ref).abs().max() / ref.abs().max())
    assert err <= TOL[dtype]
    # deterministic: no atomics, the same bits on every run
    assert torch.equal(group_pass(vals, tri, lay), got)


@pytest.mark.parametrize("offset", [1, 2, 3])
@pytest.mark.parametrize("rank,dim", [(3, 7), (5, 9), (6, 12)])
@pytest.mark.parametrize("dtype", DTYPES)
def test_unaligned_views_match_twin(cuda, rank, dim, dtype, offset):
    lay, vals, tri = _inputs(cuda, rank, dim, dtype, offset)
    assert vals.data_ptr() % 16 == offset * dtype.itemsize % 16
    _check_against_twin(lay, vals, tri, dtype)


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_rows_longer_than_a_stage_match_twin(cuda, dtype):
    lay, vals, tri = _inputs(cuda, 3, 300, dtype, 1)  # T_0 = 45 150
    _check_against_twin(lay, vals, tri, dtype)


@pytest.mark.parametrize("dtype", DTYPES)
def test_many_tiles_per_block_wrap_the_ring(cuda, dtype):
    lay, vals, tri = _inputs(cuda, 6, 56, dtype)
    sms = torch.cuda.get_device_properties(cuda).multi_processor_count
    assert len(tile_table(lay, dtype)) > 3 * 4 * sms  # each block: 3 rounds
    _check_against_twin(lay, vals, tri, dtype)


@pytest.mark.parametrize("rank,dim", [(3, 5), (3, 40), (4, 4), (5, 6), (6, 12), (7, 3)])
@pytest.mark.parametrize("dtype", DTYPES)
def test_kernel_matches_twin(cuda, rank, dim, dtype):
    lay, vals, tri = _inputs(cuda, rank, dim, dtype)
    _check_against_twin(lay, vals, tri, dtype)


@pytest.mark.parametrize("rank,dim", [(3, 6), (4, 5), (6, 4)])
def test_public_op_on_card_matches_cpu(cuda, rank, dim):
    rng = np.random.default_rng(rank)
    data = torch.from_numpy(rng.normal(size=comb.indep_size(rank, dim)))
    x = torch.from_numpy(rng.normal(size=dim))
    A = stt.FlatSymmetricTensor(rank, dim, data)
    want = float(stt.symalg.contract_all_indices_with_vector(A, x))
    before = group_pass.launches
    got = stt.symalg.contract_all_indices_with_vector(A.to(cuda), x.to(cuda))
    assert group_pass.launches == before + 1
    assert got.device.type == "cuda"
    np.testing.assert_allclose(float(got), want, rtol=1e-10)


@pytest.mark.parametrize("batched", [False, True])
@pytest.mark.parametrize("rank,dim", [(3, 6), (4, 5), (6, 4)])
def test_gradients_on_card_match_cpu(cuda, rank, dim, batched):
    """The public op's gradients on the card (the single input through the
    kernel's forward) equal the CPU's in float64."""
    rng = np.random.default_rng(10 + rank)
    data = rng.normal(size=comb.indep_size(rank, dim))
    x = rng.normal(size=(7, dim) if batched else dim)
    op = (stt.symalg.contract_all_indices_with_vector_batched if batched
          else stt.symalg.contract_all_indices_with_vector)
    grads = []
    for dev in ("cpu", cuda):
        a = torch.tensor(data, device=dev, requires_grad=True)
        xx = torch.tensor(x, device=dev, requires_grad=True)
        before = group_pass.launches
        op(stt.FlatSymmetricTensor._raw(rank, dim, a), xx).sum().backward()
        if dev == cuda and not batched:
            assert group_pass.launches == before + 1
        grads.append((a.grad.cpu().numpy(), xx.grad.cpu().numpy()))
    for want, got in zip(*grads):
        np.testing.assert_allclose(got, want, rtol=1e-10, atol=1e-12)


def test_failed_build_raises_instead_of_falling_back(cuda, monkeypatch):
    def broken():
        raise RuntimeError("nvcc failed")

    monkeypatch.setattr(_build, "load_library", broken)
    lay = comb.gflat_layout(3, 4)
    vals = torch.zeros(lay.n, device=cuda)
    tri = torch.zeros(comb.tri_size(4), device=cuda)
    with pytest.raises(RuntimeError, match="nvcc failed"):
        group_pass(vals, tri, lay)
