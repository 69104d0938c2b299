"""The port's Tables against the JAX package's, on the CPU."""

import numpy as np
import pytest
import torch

from symtensor_tpu.utils.tables import tables as jax_tables
from symtensor_tpu_torch.config import config
from symtensor_tpu_torch.utils import combinatorics as comb
from symtensor_tpu_torch.utils.tables import _check_table, tables

SHAPES = [(1, 4), (2, 5), (3, 4), (4, 3), (5, 4), (6, 3)]


def _np(x):
    return np.asarray(x)


@pytest.mark.parametrize("rank,dim", SHAPES)
def test_tri_pairs_and_offsets_match_jax(rank, dim):
    t, j = tables(rank, dim), jax_tables(rank, dim)
    for a, b in zip(t.tri_pairs, j.tri_pairs):
        assert a.dtype == torch.int64 and a.device.type == "cpu"
        np.testing.assert_array_equal(a.numpy(), _np(b))
    if rank >= 2:
        for name in ("group_off", "group_T", "tri_off"):
            np.testing.assert_array_equal(
                getattr(t, name).numpy(), _np(getattr(j, name))
            )
    np.testing.assert_array_equal(t.pascal.numpy(), _np(j.pascal))


@pytest.mark.parametrize("rank,dim", SHAPES)
def test_mono_tables_weighted_match_jax(rank, dim):
    t, j = tables(rank, dim), jax_tables(rank, dim)
    got, want = t.mono_tables_weighted(rank), j.mono_tables_weighted(rank)
    assert len(got) == len(want) == rank
    for (p, m, r), (pj, mj, rj) in zip(got, want):
        np.testing.assert_array_equal(p.numpy(), _np(pj))
        np.testing.assert_array_equal(m.numpy(), _np(mj))
        np.testing.assert_array_equal(r.numpy(), _np(rj))


@pytest.mark.parametrize("rank,dim", SHAPES)
def test_colex_perm_dense_gather_rep_match_jax(rank, dim):
    t, j = tables(rank, dim), jax_tables(rank, dim)
    np.testing.assert_array_equal(t.colex_perm.numpy(), _np(j.colex_perm))
    np.testing.assert_array_equal(t.dense_gather.numpy(), _np(j.dense_gather))
    np.testing.assert_array_equal(t.rep_np(), j.rep_np())


@pytest.mark.parametrize("rank,dim", [(3, 4), (4, 3), (5, 3)])
def test_class_positions_match_jax(rank, dim):
    t, j = tables(rank, dim), jax_tables(rank, dim)
    for cls in comb.perm_classes(rank):
        np.testing.assert_array_equal(
            t.class_positions(cls).numpy(), _np(j.class_positions(cls))
        )


def test_tables_cached_per_device_and_checked():
    assert tables(4, 3) is tables(4, 3, "cpu")
    assert tables(4, 3, torch.device("cpu")).device == torch.device("cpu")
    with pytest.raises(ValueError):
        tables(-1, 3)
    with pytest.raises(ValueError):
        tables(2, 0)
    with pytest.raises(MemoryError, match="max_table_entries"):
        _check_table(config.max_table_entries + 1, "probe")
