"""The port's native table generator against its NumPy builds and the JAX
package's binding: bit for bit, at the sizes of ``tests/test_native.py``."""

import filecmp
import warnings
from pathlib import Path

import numpy as np
import pytest
import torch

from symtensor_tpu import native as jnative
from symtensor_tpu.utils import combinatorics as jcomb
from symtensor_tpu_torch import native
from symtensor_tpu_torch.utils import combinatorics as comb
from symtensor_tpu_torch.utils import profiling
from symtensor_tpu_torch.utils import tables as tables_mod
from symtensor_tpu_torch.utils.tables import Tables

ROOT = Path(__file__).resolve().parent.parent


@pytest.fixture(autouse=True)
def _native_on(monkeypatch):
    monkeypatch.delenv("SYMTENSOR_NO_NATIVE", raising=False)


def _jax_native(fn, *args):
    """The JAX package's binding, or None where it cannot build."""
    return getattr(jnative, fn)(*args) if jnative.available() else None


def test_source_is_a_byte_equal_copy():
    assert filecmp.cmp(ROOT / "symtensor_tpu" / "native" / "tablegen.cpp",
                       native.SRC, shallow=False)


def test_builds_into_the_package_build_dir():
    assert native.available()
    so = native.library_path()
    assert so.exists() and so.parent == ROOT / "symtensor_tpu_torch" / "_build"
    # nothing is written beside the sources
    assert sorted(p.name for p in native.SRC.parent.iterdir()
                  if p.suffix not in (".cu", ".cpp")) == []


@pytest.mark.parametrize("rank,dim", [(2, 7), (3, 6), (4, 5), (5, 4), (6, 3), (6, 8)])
def test_gflat_rep_bit_identical(rank, dim):
    got = native.gflat_rep(rank, dim)
    assert got.dtype == np.int32
    np.testing.assert_array_equal(got.astype(np.int64),
                                  comb.gflat_layout(rank, dim).rep_indices())
    want = _jax_native("gflat_rep", rank, dim)
    if want is not None:
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("rank,dim", [(3, 5), (5, 4), (8, 3)])
def test_row_stats_bit_identical(rank, dim):
    rep = comb.gflat_layout(rank, dim).rep_indices()
    gamma, cid = native.row_stats(rep, rank, comb.perm_classes(rank))
    np.testing.assert_array_equal(gamma, comb.row_multiplicities(rep).astype(np.float32))
    np.testing.assert_array_equal(cid.astype(np.int64), comb.class_id_of_rows(rep, rank))
    want = _jax_native("row_stats", rep, rank, jcomb.perm_classes(rank))
    if want is not None:
        np.testing.assert_array_equal(gamma, want[0])
        np.testing.assert_array_equal(cid, want[1])


@pytest.mark.parametrize("rank,dim", [(2, 9), (4, 5), (6, 4)])
def test_position_bit_identical(rank, dim):
    lay = comb.gflat_layout(rank, dim)
    rep = lay.rep_indices()
    got = native.position(rep, rank, dim)
    np.testing.assert_array_equal(got, np.arange(lay.n))
    want = _jax_native("position", rep, rank, dim)
    if want is not None:
        np.testing.assert_array_equal(got, want)


def _dense_gather_np(rank, dim):
    grids = np.indices((dim,) * rank).reshape(rank, -1).T
    grids.sort(axis=1)
    return grids[:, 0] if rank == 1 else comb.gflat_layout(rank, dim).position_array(grids)


@pytest.mark.parametrize("rank,dim", [(1, 6), (3, 4), (4, 3)])
def test_dense_gather_bit_identical(rank, dim):
    got = native.dense_gather(rank, dim)
    np.testing.assert_array_equal(got.astype(np.int64), _dense_gather_np(rank, dim))
    want = _jax_native("dense_gather", rank, dim)
    if want is not None:
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("k,dim", [(1, 6), (2, 5), (3, 4)])
def test_insert_table_bit_identical(k, dim):
    rep = (comb.gflat_layout(k, dim).rep_indices() if k >= 2
           else np.arange(dim, dtype=np.int64)[:, None])
    got = native.insert_table(rep, k, dim)
    lay1 = comb.gflat_layout(k + 1, dim)
    ref = np.empty((len(rep), dim), dtype=np.int64)
    for i in range(dim):
        cols = np.concatenate([rep, np.full((len(rep), 1), i)], axis=1)
        cols.sort(axis=1)
        ref[:, i] = lay1.position_array(cols)
    np.testing.assert_array_equal(got.astype(np.int64), ref)
    want = _jax_native("insert_table", rep, k, dim)
    if want is not None:
        np.testing.assert_array_equal(got, want)


def _host_tables(rank, dim, k):
    t = Tables(rank, dim, torch.device("cpu"))
    return (t.rep_np(), t.class_ids_np, t.multiplicity.numpy(),
            t.dense_gather.numpy(), t.insert_table_np(k))


@pytest.mark.parametrize("rank,dim,k", [(1, 5, 1), (2, 6, 1), (4, 5, 2), (5, 4, 3), (6, 3, 4)])
def test_tables_native_equal_numpy(monkeypatch, rank, dim, k):
    nat = _host_tables(rank, dim, k)
    tables_mod._tables.cache_clear()  # insert_table_np reads the rank-k tables
    monkeypatch.setenv("SYMTENSOR_NO_NATIVE", "1")
    assert not native.available()
    ref = _host_tables(rank, dim, k)
    tables_mod._tables.cache_clear()
    for a, b in zip(nat, ref):
        assert a.dtype == b.dtype and a.shape == b.shape
        np.testing.assert_array_equal(a, b)
    assert nat[0].dtype == nat[1].dtype == nat[3].dtype == nat[4].dtype == np.int64
    assert nat[2].dtype == np.float64


def test_tables_take_the_native_build_where_it_is_faster(monkeypatch):
    """rep_np and the class ids (with γ) come from the generator;
    dense_gather and insert_table_np stay NumPy builds (slower natively on
    the card's host, PERF.md)."""
    calls = []
    for name in ("gflat_rep", "row_stats", "dense_gather", "insert_table", "position"):
        fn = getattr(native, name)
        monkeypatch.setattr(native, name,
                            lambda *a, _fn=fn, _n=name: calls.append(_n) or _fn(*a))
    _host_tables(4, 5, 2)
    assert sorted(set(calls)) == ["gflat_rep", "row_stats"]
    assert calls.count("row_stats") == 1  # one pass serves γ and the class ids


def test_gamma_beyond_float32_comes_from_numpy(monkeypatch):
    monkeypatch.setattr(tables_mod, "_NATIVE_GAMMA_MAX_RANK", 2)
    t = Tables(3, 4, torch.device("cpu"))
    np.testing.assert_array_equal(
        t.multiplicity.numpy(),
        comb.row_multiplicities(t.rep_np()).astype(np.float64))
    np.testing.assert_array_equal(t.class_ids_np, t._native_row_stats()[1])


def test_failed_build_is_counted_and_warned(monkeypatch, tmp_path):
    profiling.reset_counters()
    monkeypatch.setattr(native, "_loaded", {})
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path)
    broken = tmp_path / "tablegen.cpp"
    broken.write_text("this is not C++\n")
    monkeypatch.setattr(native, "SRC", broken)
    with pytest.warns(UserWarning, match="native_tablegen"):
        assert native.gflat_rep(3, 4) is None
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        assert not native.available()  # the failure is remembered
    assert profiling.op_counters[native.FALLBACK_SITE] == 1
    assert not any(tmp_path.glob("*.so"))
    profiling.reset_counters()


def test_disabled_by_environment(monkeypatch):
    monkeypatch.setenv("SYMTENSOR_NO_NATIVE", "1")
    assert not native.available()
    assert native.gflat_rep(3, 4) is None and native.dense_gather(2, 3) is None
