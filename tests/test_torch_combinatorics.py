"""The port's combinatorics copy against the JAX package's module."""

import math

import numpy as np
import pytest

from symtensor_tpu.utils import combinatorics as jcomb
from symtensor_tpu_torch.utils import combinatorics as tcomb

SHAPES = [(r, d) for r in range(2, 7) for d in (1, 2, 3, 5, 8, 12)
          if math.comb(d + r - 1, r) <= 20_000]


@pytest.mark.parametrize("rank,dim", SHAPES)
def test_gflat_layout_matches_jax(rank, dim):
    t = tcomb.gflat_layout(rank, dim)
    j = jcomb.gflat_layout(rank, dim)
    assert t.n == j.n
    for name in ("groups", "P", "T", "group_off", "tri_off"):
        np.testing.assert_array_equal(getattr(t, name), getattr(j, name))
    rep = t.rep_indices()
    np.testing.assert_array_equal(rep, j.rep_indices())
    pos = t.position_array(rep)
    np.testing.assert_array_equal(pos, j.position_array(rep))
    np.testing.assert_array_equal(pos, np.arange(t.n))
    for row in rep[:: max(1, t.n // 7)]:
        assert t.position(tuple(row)) == j.position(tuple(row))


@pytest.mark.parametrize("num_values", [1, 3, 7, 12])
@pytest.mark.parametrize("size", [0, 1, 2, 3, 4])
def test_multisets_colex_matches_jax(num_values, size):
    got = tcomb.multisets_colex(num_values, size)
    np.testing.assert_array_equal(got, jcomb.multisets_colex(num_values, size))
    np.testing.assert_array_equal(
        tcomb.colex_rank_array(got), np.arange(len(got))
    )


@pytest.mark.parametrize("dim,size", [(4, 1), (6, 2), (5, 3)])
def test_mono_recursion_tables_match_jax(dim, size):
    for a, b in zip(tcomb.mono_recursion_tables(dim, size),
                    jcomb.mono_recursion_tables(dim, size)):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("rank", range(0, 8))
@pytest.mark.parametrize("dim", [1, 2, 3, 5, 9])
def test_class_identities(rank, dim):
    classes = tcomb.perm_classes(rank)
    assert classes == jcomb.perm_classes(rank)
    sizes = [tcomb.class_size(c, dim) for c in classes]
    gammas = [tcomb.class_multiplicity(c) for c in classes]
    assert sum(s * g for s, g in zip(sizes, gammas)) == dim**rank
    assert sum(sizes) == math.comb(dim + rank - 1, rank)
    assert sizes == [jcomb.class_size(c, dim) for c in classes]
    labels = [tcomb.class_label(c) for c in classes]
    assert labels == [jcomb.class_label(c) for c in classes]
    assert [tcomb.class_counts(s) for s in labels] == list(classes)


@pytest.mark.parametrize("rank,dim", [(3, 4), (4, 3), (5, 5)])
def test_row_helpers_match_jax(rank, dim):
    rep = tcomb.gflat_layout(rank, dim).rep_indices()
    np.testing.assert_array_equal(
        tcomb.row_multiplicities(rep), jcomb.row_multiplicities(rep)
    )
    np.testing.assert_array_equal(
        tcomb.class_id_of_rows(rep, rank), jcomb.class_id_of_rows(rep, rank)
    )
    for row in rep[:5]:
        assert tcomb.colex_unrank(tcomb.colex_rank(row[:2]), 2) == tuple(row[:2])
        assert sorted(tcomb.distinct_permutations(row)) == sorted(
            jcomb.distinct_permutations(row)
        )
