"""Bind the port's generic battery to each ported format, as
``tests/test_api_suite.py`` binds the JAX package's."""

import numpy as np
import pytest
import torch

import symtensor_tpu_torch as stt
from symtensor_tpu_torch.config import config
from symtensor_tpu_torch.testing import SymTensorSuite, does_not_warn, random_symmetric


@pytest.fixture(autouse=True)
def _cpu_default_device(monkeypatch):
    """The battery builds tensors without naming a device: ask for the CPU."""
    monkeypatch.setattr(config, "default_device", "cpu")


class TestTorchFlatSuite(SymTensorSuite):
    tensor_cls = stt.FlatSymmetricTensor


class TestTorchPermClsSuite(SymTensorSuite):
    tensor_cls = stt.PermClsSymmetricTensor


class TestTorchDenseSuite(SymTensorSuite):
    tensor_cls = stt.DenseSymmetricTensor


class TestTorchDecompSuite(SymTensorSuite):
    """Decomp binds the whole battery: ``from_dense`` is exact at any rank
    (eigh at rank 2, the standard-basis decomposition at rank ≥ 3), so
    only the functional-update tests skip: the format is read-only, as in
    the JAX package."""

    tensor_cls = stt.DecompSymmetricTensor
    atol = 1e-8
    supports_updates = False

    def test_negative_indices(self):
        t = stt.DecompSymmetricTensor.from_vector(
            torch.arange(1.0, 4.0, dtype=torch.float64), 2)
        d = t.todense().numpy()
        np.testing.assert_allclose(float(t[-1, 0]), d[2, 0], atol=1e-8)
        with pytest.raises(IndexError):
            t[3, 0]


def test_does_not_warn_helper():
    import warnings

    with does_not_warn():
        pass
    with pytest.raises(AssertionError):
        with does_not_warn(UserWarning):
            warnings.warn("boom")
    with does_not_warn(match="densifying"):
        warnings.warn("another message")


def test_random_symmetric_helper_matches_the_jax_packages():
    from symtensor_tpu.testing import random_symmetric as jax_random_symmetric

    a = random_symmetric(3, 4, np.random.default_rng(5))
    assert stt.symalg.is_symmetric(a)
    np.testing.assert_allclose(
        a, jax_random_symmetric(3, 4, np.random.default_rng(5)), rtol=1e-15
    )
