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


@pytest.mark.parametrize("size", [1, 2, 3, 4, 5])
@pytest.mark.parametrize("dim", [1, 2, 3, 4, 5, 6])
def test_mono_tables_match_jax(dim, size):
    """The colex level `size` over dim values: each multiset's parent and
    max element, as the basis change's row pick reads them."""
    t, j = tables(size, dim), jax_tables(size, dim)
    got, want = t.mono_tables(size), j.mono_tables(size)
    assert len(got) == len(want) == 2
    for g, w in zip(got, want):
        assert g.dtype == torch.int64 and g.device == t.device
        assert g.shape == (comb.multiset_count(dim, size),)
        np.testing.assert_array_equal(g.numpy(), _np(w))
    assert t.mono_tables(size) is got  # memoized
    # appending maxel to the parent gives the colex enumeration
    par, mx = (g.numpy() for g in got)
    level = comb.multisets_colex(dim, size)
    np.testing.assert_array_equal(level[:, -1], mx)
    np.testing.assert_array_equal(
        level[:, :-1], comb.multisets_colex(dim, size - 1)[par])


def test_mono_tables_guard_message_matches_jax(monkeypatch):
    from symtensor_tpu.config import config as jconfig
    from symtensor_tpu.utils.tables import Tables as JaxTables
    from symtensor_tpu_torch.utils.tables import Tables

    monkeypatch.setattr(config, "max_table_entries", 100)
    monkeypatch.setattr(jconfig, "max_table_entries", 100)
    with pytest.raises(MemoryError, match=r"mono_tables\(3\)") as ej:
        JaxTables(3, 9).mono_tables(3)
    fresh = Tables(3, 9, torch.device("cpu"))
    with pytest.raises(MemoryError, match=r"mono_tables\(3\)") as et:
        fresh.mono_tables(3)
    assert str(et.value) == str(ej.value)
    assert fresh.mono_tables(2)[0].shape == (45,)  # C(10, 2) <= 100 passes


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


def _reps(rank, dim):
    """(n, rank) ascending representatives in storage order, built without
    the tables' cache (other files count on shapes whose tables are new)."""
    if rank == 0:
        return np.zeros((1, 0), dtype=np.int64)
    if rank == 1:
        return np.arange(dim, dtype=np.int64)[:, None]
    return comb.gflat_layout(rank, dim).rep_indices()


@pytest.mark.parametrize("rank", [1, 2, 3, 4, 5, 6])
@pytest.mark.parametrize("dim", [1, 2, 3, 4, 5, 6, 7])
def test_position_base_T_plus_b_is_the_position_of_the_merge(rank, dim):
    """For every representative of rank − 1 components and every
    b ≥ max(rep): base + b is the position of sort(rep ∪ {b}), and those
    positions cover the layout exactly once."""
    t = tables(rank, dim)
    rep = _reps(rank - 1, dim)  # (n_u, rank − 1), rows ascending
    base = t.position_base_T(torch.as_tensor(rep.T))
    assert base.shape == (len(rep),) and base.dtype == torch.int64
    lo = rep[:, -1] if rank > 1 else np.zeros(1, dtype=np.int64)
    rows, bs = np.nonzero(np.arange(dim)[None, :] >= lo[:, None])
    merged = np.concatenate([rep[rows], bs[:, None]], axis=1)  # still ascending
    want = t.position_T(torch.as_tensor(merged.T))
    got = base[torch.as_tensor(rows)] + torch.as_tensor(bs)
    np.testing.assert_array_equal(got.numpy(), want.numpy())
    np.testing.assert_array_equal(np.sort(got.numpy()), np.arange(t.n))


@pytest.mark.parametrize("rank,dim", [(1, 4), (2, 5), (3, 4), (4, 4), (5, 3), (6, 3), (6, 7)])
def test_position_base_T_matches_jax(rank, dim):
    t, j = tables(rank, dim), jax_tables(rank, dim)
    rep_T = _reps(rank - 1, dim).T
    want = jax.jit(j.position_base_jnp_T)(jnp.asarray(rep_T.astype(np.int32)))
    np.testing.assert_array_equal(
        t.position_base_T(torch.as_tensor(rep_T.astype(np.int32))).numpy(), _np(want))


@pytest.mark.parametrize("rank,dim", [(1, 4), (2, 5), (3, 4), (5, 4), (6, 3)])
def test_position_on_the_trailing_axis_matches_jax(rank, dim):
    t, j = tables(rank, dim), jax_tables(rank, dim)
    rep = t.rep_np()
    got = t.position(torch.as_tensor(rep))
    np.testing.assert_array_equal(got.numpy(), np.arange(t.n))
    np.testing.assert_array_equal(got.numpy(), _np(jax.jit(j.position_jnp)(j.rep)))
    grid = torch.as_tensor(rep[::3]).reshape(-1, 1, rank).expand(-1, 2, rank)
    assert t.position(grid).shape == (grid.shape[0], 2)


def test_position_base_T_past_2_31_stays_exact():
    rank, dim = 6, 110
    lay = comb.gflat_layout(rank, dim)
    rng = np.random.default_rng(1)
    rep = np.sort(rng.integers(0, dim, (500, rank - 1)), axis=1)
    rep[-1] = dim - 1
    base = tables(rank, dim).position_base_T(torch.as_tensor(rep.T))
    b = np.maximum(rep[:, -1], rng.integers(0, dim, 500))
    want = lay.position_array(np.concatenate([rep, b[:, None]], axis=1))
    np.testing.assert_array_equal(base.numpy() + b, want)
    assert int(base.max()) + dim - 1 == lay.n - 1 > 2**31


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


# ------------------------------------- tables of the permcls and list paths


@pytest.mark.parametrize("rank,dim", [(2, 4), (3, 4), (4, 3), (6, 3)])
def test_dense_ravel_inverts_dense_gather(rank, dim):
    """Compressing is one gather through dense_ravel, expanding one gather
    through dense_gather: packed → dense → packed is the identity."""
    t = tables(rank, dim)
    ravel = t.dense_ravel
    assert ravel.dtype == torch.int64 and ravel.shape == (t.n,)
    np.testing.assert_array_equal(t.dense_gather[ravel].numpy(), np.arange(t.n))
    np.testing.assert_array_equal(
        ravel.numpy(), np.ravel_multi_index(tuple(t.rep_np().T), (dim,) * rank)
    )


def test_table_guards_raise_in_the_order_of_the_jax_packages(monkeypatch):
    """Lowered guard: a class's positions fail in rep_np's guard (n·rank
    entries) before any class table is built, in both packages, with the
    same message. (A fresh, uncached Tables object: a guard runs at a
    table's first build.)"""
    from symtensor_tpu.config import config as jax_config
    from symtensor_tpu.utils.tables import Tables as JaxTables
    from symtensor_tpu_torch.utils.tables import Tables

    monkeypatch.setattr(config, "max_table_entries", 100)
    monkeypatch.setattr(jax_config, "max_table_entries", 100)
    with pytest.raises(MemoryError, match="rep_indices") as ej:
        JaxTables(3, 7).class_positions((1, 1, 1))
    with pytest.raises(MemoryError, match="rep_indices") as et:
        Tables(3, 7, torch.device("cpu")).class_positions((1, 1, 1))
    assert str(et.value) == str(ej.value)


@pytest.mark.parametrize("k,dim", [(1, 5), (2, 4), (3, 6), (0, 3)])
def test_insert_table_matches_jax(k, dim):
    want = np.asarray(jax_tables(k + 1, dim).insert_table(k))
    t = tables(k + 1, dim)
    got = t.insert_table(k)
    assert got.dtype == torch.int64 and got.device == t.device
    assert tuple(got.shape) == (comb.indep_size(k, dim), dim)
    np.testing.assert_array_equal(got.numpy(), want)
    assert t.insert_table_np(k).dtype == np.int64
    np.testing.assert_array_equal(t.insert_table_np(k), want)
    assert t.insert_table(k) is got  # memoized
    # row J, column i holds the position of sort(J ∪ {i})
    rep = tables(k, dim).rep_np()
    merged = np.sort(np.concatenate(
        [np.repeat(rep[:, None, :], dim, 1),
         np.broadcast_to(np.arange(dim)[None, :, None], (len(rep), dim, 1))], 2), 2)
    np.testing.assert_array_equal(
        tables(k + 1, dim).position_T(torch.from_numpy(np.moveaxis(merged, 2, 0))).numpy(),
        want)


def test_insert_table_guard_message_matches_jax(monkeypatch):
    from symtensor_tpu.config import config as jconfig

    monkeypatch.setattr(config, "max_table_entries", 100)
    monkeypatch.setattr(jconfig, "max_table_entries", 100)
    with pytest.raises(MemoryError) as ej:
        jax_tables(3, 7).insert_table_np(2)
    with pytest.raises(MemoryError) as et:
        tables(3, 7).insert_table_np(2)
    assert str(et.value) == str(ej.value)
