"""Bind the port's generic battery to all five formats, as
``tests/test_api_suite.py`` binds the JAX package's."""

import numpy as np
import pytest
import torch

import symtensor_tpu_torch as stt
from symtensor_tpu_torch.config import config
from symtensor_tpu_torch.testing import SymTensorSuite, does_not_warn, random_symmetric
from symtensor_tpu_torch.utils.profiling import reset_counters


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

    def test_serialization(self):
        import symtensor_tpu_torch.serialization as ser

        t = stt.DecompSymmetricTensor.from_vector(torch.arange(3.0), 2)
        b = ser.from_json(ser.to_json(t))
        assert t.toflat().allclose(b.toflat())


class TestTorchSparseFlatSuite(SymTensorSuite):
    """The sparse format passes the battery through a ``from_dense``/
    ``zeros`` facade, as the JAX package binds it; functional updates
    return flat tensors (the battery checks values, not the storage
    class)."""

    class _SparseFacade:
        @staticmethod
        def from_dense(arr, **kw):
            return stt.SparseFlatSymmetricTensor.from_flat(
                stt.FlatSymmetricTensor.from_dense(arr, **kw))

        @staticmethod
        def zeros(rank, dim, dtype=None, device=None):
            return stt.SparseFlatSymmetricTensor.from_flat(
                stt.FlatSymmetricTensor.zeros(rank, dim, dtype=dtype, device=device))

    tensor_cls = _SparseFacade
    atol = 1e-8

    @pytest.fixture(autouse=True)
    def _fresh_warnings(self):
        """Expanding to flat warns once per site and process."""
        yield
        reset_counters()

    def test_illegal_initializations(self):
        with pytest.raises((TypeError, ValueError)):
            self.tensor_cls(rank=2)
        with pytest.raises((ValueError, NotImplementedError)):
            self.tensor_cls.from_dense(torch.arange(9.0).reshape(3, 3))

    def test_copy(self):
        """The copy owns its leaves: a write into its values leaves the
        original as it was (its positions stay valid)."""
        t, _ = self.make(*self.ranks_dims[0], self._rng())
        c = t.copy()
        assert type(c) is type(t) and c.allclose(t)
        c.vals.mul_(2).add_(1)
        assert not c.allclose(t)
        assert all(a.data_ptr() != b.data_ptr()
                   for a, b in zip((c.vals, c.positions, c.rep, c.gamma),
                                   (t.vals, t.positions, t.rep, t.gamma)))


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
