"""The port's matmul-precision policy, on the CPU.

The counterpart of the policy cases of ``tests/test_precision.py``. The JAX
package asks for ``Precision.HIGHEST`` (``HIGH`` for its batched GEMMs) on
every value-path dot; the port has one rule instead: a float32 product on
the value path runs under ``torch.set_float32_matmul_precision("highest")``
(``utils/precision.full_fp32_matmul``), so TF32 never truncates it on the
card. The CPU computes every setting in full float32, so these tests check
the policy itself: the setting in force at each matrix product the
dispatcher sees, whatever the caller set.
"""

import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

import symtensor_tpu_torch as stt
from symtensor_tpu_torch.config import config
from symtensor_tpu_torch.kernels import poly_eval as tpe
from symtensor_tpu_torch.utils import combinatorics as comb
from symtensor_tpu_torch.utils.precision import full_fp32_matmul

aten = torch.ops.aten
# the matrix products the float32 matmul precision governs
PRODUCTS = {aten.mm, aten.mv, aten.addmm, aten.addmv, aten.bmm, aten.baddbmm}


@pytest.fixture(autouse=True)
def _cpu_and_callers_precision(monkeypatch):
    """Tensors on the CPU; the caller's precision is "high" (TF32 allowed)
    and is put back as it was after the test."""
    monkeypatch.setattr(config, "default_device", "cpu")
    prev = torch.get_float32_matmul_precision()
    torch.set_float32_matmul_precision("high")
    yield
    torch.set_float32_matmul_precision(prev)


class PrecisionAtProducts(TorchDispatchMode):
    """Records the float32 matmul precision in force at each matrix
    product dispatched."""

    def __init__(self):
        super().__init__()
        self.seen = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if func.overloadpacket in PRODUCTS:
            self.seen.append((func.overloadpacket.__name__,
                              torch.get_float32_matmul_precision()))
        return func(*args, **(kwargs or {}))


def test_full_fp32_matmul_sets_highest_and_restores():
    assert torch.get_float32_matmul_precision() == "high"
    with full_fp32_matmul():
        assert torch.get_float32_matmul_precision() == "highest"
        with full_fp32_matmul():
            assert torch.get_float32_matmul_precision() == "highest"
        assert torch.get_float32_matmul_precision() == "highest"
    assert torch.get_float32_matmul_precision() == "high"


def test_full_fp32_matmul_restores_when_the_body_raises():
    torch.set_float32_matmul_precision("medium")
    with pytest.raises(ZeroDivisionError):
        with full_fp32_matmul():
            assert torch.get_float32_matmul_precision() == "highest"
            1 / 0
    assert torch.get_float32_matmul_precision() == "medium"


def _flat(rank, dim, seed, dtype=torch.float32):
    rng = np.random.default_rng(seed)
    data = torch.from_numpy(rng.normal(size=comb.indep_size(rank, dim)))
    return (stt.FlatSymmetricTensor._raw(rank, dim, data.to(dtype)),
            torch.from_numpy(rng.normal(size=(6, dim))).float())


def _single(A, xs):
    return stt.symalg.contract_all_indices_with_vector(A, xs[0])


def _fold(A, xs):
    return stt.symalg.contract_all_indices_with_vector_batched(A, xs)


def _premul(A, xs):
    return tpe.views_eval_batched_premul(tpe.group_views_premul(A), xs)


def _cell(A, xs):
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("SYMTENSOR_BATCHED_CELL", "1")
        return stt.symalg.contract_all_indices_with_vector_batched(A, xs)


def _gradient(A, xs):
    vals = A.data.clone().requires_grad_(True)
    B = stt.FlatSymmetricTensor._raw(A.rank, A.dim, vals)
    stt.symalg.contract_all_indices_with_vector_batched(B, xs).sum().backward()
    return vals.grad


def _basis_change(A, xs):
    W = torch.from_numpy(np.random.default_rng(3).normal(size=(A.dim, 4))).float()
    return stt.symalg.contract_all_indices_with_matrix(A, W).data


def _blocked_basis_change(A, xs):
    W = torch.from_numpy(np.random.default_rng(4).normal(size=(A.dim, 3))).float()
    return stt.symalg.contract_all_indices_with_matrix(
        A, W, block_elems=17, transient_elems=23).data


def _sparse_batched(A, xs):
    return stt.symalg.contract_all_indices_with_vector_batched(
        stt.SparseFlatSymmetricTensor.from_flat(A), xs)


ROUTES = {
    "single input (group pass twin)": (_single, 4),
    "batched, fold": (_fold, 4),
    "batched, premultiplied views": (_premul, 4),
    "batched, cell GEMMs": (_cell, 4),
    "batched, rank 2": (_fold, 2),
    "batched, gradient": (_gradient, 4),
    "basis change, whole-level": (_basis_change, 4),
    "basis change, blocked": (_blocked_basis_change, 4),
    "sparse, batched": (_sparse_batched, 3),
}


@pytest.mark.parametrize("route", list(ROUTES))
def test_value_path_products_run_at_highest(route):
    fn, rank = ROUTES[route]
    A, xs = _flat(rank, 6, seed=len(route))
    with PrecisionAtProducts() as mode:
        out = fn(A, xs)
    assert torch.isfinite(out).all()
    assert mode.seen, f"{route}: no matrix product dispatched"
    assert {p for _, p in mode.seen} == {"highest"}, mode.seen
    # the caller's setting is back
    assert torch.get_float32_matmul_precision() == "high"


def test_a_product_outside_the_policy_sees_the_callers_setting():
    """The recorder is not vacuous: a bare product runs at the caller's
    setting."""
    a = torch.ones(3, 3)
    with PrecisionAtProducts() as mode:
        a @ a
    assert mode.seen == [("mm", "high")]
