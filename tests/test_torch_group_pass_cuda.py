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


@pytest.mark.parametrize("rank,dim", [(3, 5), (3, 40), (4, 4), (5, 6), (6, 12), (7, 3)])
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32, torch.bfloat16])
def test_kernel_matches_twin(cuda, rank, dim, dtype):
    g = torch.Generator(device=cuda).manual_seed(rank * 100 + dim)
    lay = comb.gflat_layout(rank, dim)
    store = torch.float64 if dtype == torch.float64 else torch.float32
    vals = torch.randn(lay.n, generator=g, device=cuda, dtype=store).to(dtype)
    tri = torch.randn(comb.tri_size(dim), generator=g, device=cuda,
                      dtype=acc_dtype(dtype))
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


def test_failed_build_raises_instead_of_falling_back(cuda, monkeypatch):
    def broken():
        raise RuntimeError("nvcc failed")

    monkeypatch.setattr(_build, "load_library", broken)
    lay = comb.gflat_layout(3, 4)
    vals = torch.zeros(lay.n, device=cuda)
    tri = torch.zeros(comb.tri_size(4), device=cuda)
    with pytest.raises(RuntimeError, match="nvcc failed"):
        group_pass(vals, tri, lay)
