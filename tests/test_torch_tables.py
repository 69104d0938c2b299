"""The port's Tables against the JAX package's, on the CPU."""

import jax
import jax.numpy as jnp
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


# ------------------------------------------------- closed-form ranking


@pytest.mark.parametrize("rank,dim", [(1, 4), (2, 5), (3, 4), (4, 3), (5, 4), (6, 3)])
def test_position_T_rep_T_multiplicity_match_jax(rank, dim):
    t, j = tables(rank, dim), jax_tables(rank, dim)
    rep_T = t.rep_T
    assert rep_T.dtype == torch.int64 and rep_T.shape == (rank, t.n)
    got = t.position_T(rep_T)
    assert got.dtype == torch.int64
    np.testing.assert_array_equal(got.numpy(), np.arange(t.n))
    np.testing.assert_array_equal(
        got.numpy(), _np(jax.jit(j.position_jnp_T)(j.rep.T))
    )
    gam = t.multiplicity
    assert gam.dtype == torch.float64
    np.testing.assert_array_equal(gam.numpy(), _np(j.multiplicity))


def test_position_T_takes_any_trailing_shape():
    t = tables(4, 5)
    rep = torch.as_tensor(t.rep_np()[::7])  # (m, 4)
    grid = rep.T.reshape(4, -1, 1).expand(4, rep.shape[0], 3)
    np.testing.assert_array_equal(
        t.position_T(grid).numpy(), np.repeat(np.arange(0, t.n, 7)[:, None], 3, 1)
    )
    assert tables(0, 3).position_T(torch.zeros((0, 6), dtype=torch.int64)).shape == (6,)


@pytest.mark.parametrize("rank", [2, 3, 4, 5, 6])
@pytest.mark.parametrize("dim", [1, 2, 3, 4, 5, 6])
def test_position_insert_T_matches_position_of_sorted_merge(rank, dim):
    t = tables(rank, dim)
    rep = tables(rank - 1, dim).rep_np()  # (n_u, rank − 1)
    got = t.position_insert_T(torch.as_tensor(rep.T))
    assert got.shape == (len(rep), dim) and got.dtype == torch.int64
    merged = np.concatenate(
        [np.repeat(rep[:, None, :], dim, 1),
         np.broadcast_to(np.arange(dim)[None, :, None], (len(rep), dim, 1))], 2
    )
    merged = np.sort(merged, axis=2).reshape(-1, rank)
    want = t.position_T(torch.as_tensor(merged.T)).reshape(len(rep), dim)
    np.testing.assert_array_equal(got.numpy(), want.numpy())


@pytest.mark.parametrize("rank,dim", [(2, 5), (3, 4), (4, 4), (5, 3), (6, 3)])
def test_position_insert_T_matches_jax(rank, dim):
    t, j = tables(rank, dim), jax_tables(rank, dim)
    rep_T = tables(rank - 1, dim).rep_np().T
    want = jax.jit(j.position_insert_jnp_T)(jnp.asarray(rep_T.astype(np.int32)))
    np.testing.assert_array_equal(
        t.position_insert_T(torch.as_tensor(rep_T)).numpy(), _np(want)
    )


def test_positions_past_2_31_stay_exact():
    """Rank 6, dim 110: n = C(115, 6) > 2**31, where the JAX package's
    int32 ranking wraps. Random multisets and the last ones of the layout
    against the host int64 layout."""
    rank, dim = 6, 110
    lay = comb.gflat_layout(rank, dim)
    assert lay.n > 2**31
    rng = np.random.default_rng(0)
    rows = np.sort(rng.integers(0, dim, (2000, rank)), axis=1)
    rows[-1] = dim - 1  # the last position of the layout
    rows[-2] = [0, 0, 0, dim - 1, dim - 1, dim - 1]
    t = tables(rank, dim)
    got = t.position_T(torch.as_tensor(rows.T))
    want = lay.position_array(rows)
    np.testing.assert_array_equal(got.numpy(), want)
    assert int(got.max()) == lay.n - 1
    # inserting one element into rank-5 multisets of the same dim
    rep = rows[:200, 1:]
    ins = t.position_insert_T(torch.as_tensor(rep.T))
    merged = np.sort(np.concatenate(
        [np.repeat(rep[:, None, :], dim, 1),
         np.broadcast_to(np.arange(dim)[None, :, None], (200, dim, 1))], 2), axis=2)
    np.testing.assert_array_equal(
        ins.numpy(), lay.position_array(merged.reshape(-1, rank)).reshape(200, dim)
    )
    assert int(ins.max()) > 2**31
