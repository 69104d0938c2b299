"""The port's Decomp format against the JAX package's, on the CPU, in
float64.

Every op that is deterministic in its leaves is compared leaf for leaf
(weights and factors carried across with ``interop``); the ops that pass
through an eigendecomposition (``from_matrix``, rank-2 ``from_dense`` and
``reduce_factors``) are compared through ``todense()``, since eigenvector
signs and degenerate subspaces are the solver's own.
"""

import itertools
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

import symtensor_tpu as st
import symtensor_tpu_torch as stt
from symtensor_tpu.core import decomp as jdecomp
from symtensor_tpu_torch.config import config
from symtensor_tpu_torch.core import decomp as tdecomp
from symtensor_tpu_torch.interop import decomp_from_numpy, decomp_to_numpy
from symtensor_tpu_torch.utils import profiling

Dj, Dt = st.DecompSymmetricTensor, stt.DecompSymmetricTensor
MULTS = [(2,), (3,), (1, 1), (2, 1), (2, 2), (1, 1, 1), (3, 2), (2, 1, 1, 1)]


@pytest.fixture(autouse=True)
def _cpu_default_device(monkeypatch):
    """This file builds tensors without naming a device: ask for the CPU."""
    monkeypatch.setattr(config, "default_device", "cpu")


def make(seed, dim, mult, F=3):
    """The same float64 leaves as a JAX tensor and a port tensor."""
    rng = np.random.default_rng(seed)
    k = len(mult)
    w, f = rng.normal(size=(F,) * k), rng.normal(size=(F, dim))
    tj = Dj(rank=sum(mult), dim=dim, weights=jnp.asarray(w),
            factors=jnp.asarray(f), multiplicities=mult, dtype=jnp.float64)
    tt = decomp_from_numpy(sum(mult), dim, w, f, mult, device="cpu")
    return tj, tt


def same_leaves(got, want, rtol=1e-12):
    assert isinstance(got, Dt) and isinstance(want, Dj)
    assert (got.rank, got.dim, got.multiplicities) == (
        want.rank, want.dim, want.multiplicities)
    w, f, _ = decomp_to_numpy(got)
    assert w.dtype == np.asarray(want.weights).dtype
    np.testing.assert_allclose(w, np.asarray(want.weights), rtol=rtol, atol=1e-14)
    np.testing.assert_allclose(f, np.asarray(want.factors), rtol=rtol, atol=1e-14)


def same_dense(got, want, rtol=1e-10):
    np.testing.assert_allclose(
        got.todense().numpy(), np.asarray(want.todense()), rtol=rtol, atol=1e-12)


# ------------------------------------------------------------ construction


def test_constructor_properties_and_interop_roundtrip():
    tj, tt = make(1, 4, (2, 1), F=5)
    assert tt.format == "decomp" and tt.dtype == torch.float64
    for name in ("num_factors", "num_indep_factors", "num_arrangements", "size",
                 "rank", "dim", "multiplicities", "shape", "indep_size"):
        assert getattr(tt, name) == getattr(tj, name), name
    assert list(tt.keys()) == list(tj.keys()) == ["weights", "factors"]
    assert [tuple(v.shape) for v in tt.values()] == [(5, 5), (5, 4)]
    assert tt.memory_footprint() == tj.memory_footprint() == 45 * 8
    w, f, m = decomp_to_numpy(tt)
    same_leaves(decomp_from_numpy(3, 4, w, f, m, device="cpu"), tj)
    assert tt.astype(torch.float32).dtype == torch.float32
    assert tt.astype(torch.float32).factors.dtype == torch.float32
    assert tt.to("cpu").device.type == "cpu"
    c = tt.copy()
    c.weights.mul_(2)
    same_leaves(tt, tj)
    assert "DecompSymmetricTensor(rank=3, dim=4" in repr(tt)


def test_default_multiplicities_zero_tensor_and_dtype_default():
    t = Dt(3, 4)
    j = Dj(3, 4)
    assert t.multiplicities == j.multiplicities == (3,)
    assert tuple(t.weights.shape) == (1,) and tuple(t.factors.shape) == (1, 4)
    assert t.dtype == torch.float32  # config.default_dtype, as in the JAX package
    assert float(t.todense().abs().max()) == 0.0
    z = Dt.zeros(0, 3, dtype=torch.float64)
    assert z.multiplicities == () and z.weights.shape == ()
    # leaves given in float64 without dtype take the default type, as in JAX
    t = Dt(2, 3, torch.ones(2, dtype=torch.float64), torch.ones(2, 3, dtype=torch.float64))
    assert t.dtype == torch.float32


def test_constructor_without_tensor_data_goes_to_the_default_device(monkeypatch):
    monkeypatch.setattr(config, "default_device", "cuda")
    if torch.cuda.is_available():
        assert Dt(2, 3).device.type == "cuda"
        return
    for build in (lambda: Dt(2, 3), lambda: Dt.zeros(2, 3),
                  lambda: Dt(2, 3, np.ones(2), np.ones((2, 3))),
                  lambda: Dt.from_vector(np.ones(3), 2),
                  lambda: Dt.from_matrix(np.eye(3)),
                  lambda: Dt.from_dense(np.ones((3, 3, 3)))):
        with pytest.raises(RuntimeError, match="default_device"):
            build()
    # tensor data keeps its device, and device= is honoured
    assert Dt.from_vector(torch.ones(3), 2).device.type == "cpu"
    assert Dt(2, 3, device="cpu").device.type == "cpu"
    with pytest.raises(ValueError, match="more than one device"):
        Dt(2, 3, torch.ones(2), torch.ones(2, 3, device="meta"))


@pytest.mark.parametrize("kw", [
    dict(rank=None, dim=3),
    dict(rank=3, dim=None),
    dict(rank=3, dim=3, multiplicities=(2, 2)),
    dict(rank=3, dim=3, multiplicities=(4, -1)),
    dict(rank=2, dim=3, weights=np.ones(2), factors=np.ones((2, 4))),
    dict(rank=2, dim=3, weights=np.ones(2), factors=np.ones(3)),
    dict(rank=2, dim=3, weights=np.ones((2, 2)), factors=np.ones((2, 3))),
    dict(rank=3, dim=3, weights=np.ones(3), factors=np.ones((2, 3)),
         multiplicities=(3,)),
])
def test_constructor_errors_match_jax(kw):
    with pytest.raises(ValueError) as ej:
        Dj(**kw)
    with pytest.raises(ValueError) as et:
        Dt(**kw)
    assert str(et.value) == str(ej.value)


@pytest.mark.parametrize("mult", MULTS)
def test_toflat_todense_elements_and_classes_match_jax(mult):
    dim = 3
    tj, tt = make(10 + len(mult) + sum(mult), dim, mult)
    np.testing.assert_allclose(tt.toflat().data.numpy(),
                               np.asarray(tj.toflat().data), rtol=1e-10, atol=1e-13)
    same_dense(tt, tj)
    dense = np.asarray(tj.todense())
    for idx in itertools.islice(
            itertools.product(range(dim), repeat=tt.rank), 0, 30, 3):
        np.testing.assert_allclose(float(tt.element(idx)), dense[idx],
                                   rtol=1e-10, atol=1e-13, err_msg=str(idx))
        np.testing.assert_allclose(float(tt[idx]), dense[idx], rtol=1e-10,
                                   atol=1e-13)
    for label in tt.perm_classes:
        np.testing.assert_allclose(
            np.atleast_1d(tt[label].numpy()), np.atleast_1d(np.asarray(tj[label])),
            rtol=1e-10, atol=1e-13)
    # partial indexing goes through the packed form
    np.testing.assert_allclose(tt[1].todense().numpy(), dense[1], rtol=1e-10,
                               atol=1e-13)


def test_subset_chains_equal_the_jax_packages():
    for mult in MULTS:
        tj, tt = make(0, 3, mult, F=2)
        assert tt._subset_chains() == tj._subset_chains()


def test_rank0_and_from_vector():
    tj = Dj(rank=0, dim=3, weights=jnp.asarray(2.5), factors=jnp.zeros((1, 3)),
            multiplicities=(), dtype=jnp.float64)
    tt = decomp_from_numpy(0, 3, np.asarray(2.5), np.zeros((1, 3)), (), device="cpu")
    assert float(tt.todense()) == float(tj.todense()) == 2.5
    assert float(tt.element(())) == 2.5
    assert tt.toflat().data.shape == (1,)
    x = np.arange(3.0)
    assert float(tt.contract_all_indices_with_vector(x)) == 2.5
    assert float(tt.add_decomp(tt).todense()) == float(tj.add_decomp(tj).todense()) == 5.0
    assert float((tt - tt.scale(3.0)).todense()) == -5.0
    v = np.random.default_rng(3).normal(size=5)
    same_leaves(Dt.from_vector(torch.from_numpy(v), 3), Dj.from_vector(jnp.asarray(v), 3))


@pytest.mark.parametrize("cutoff,top_k", [(1e-12, None), (0.0, None), (0.5, None),
                                          (1e-12, 2), (10.0, None)])
def test_from_matrix_matches_jax_through_todense(cutoff, top_k):
    rng = np.random.default_rng(4)
    m = rng.normal(size=(5, 5))
    m = m + m.T
    tj = Dj.from_matrix(jnp.asarray(m), cutoff=cutoff, top_k=top_k)
    tt = Dt.from_matrix(torch.from_numpy(m), cutoff=cutoff, top_k=top_k)
    assert tt.num_factors == tj.num_factors and tt.multiplicities == (2,)
    np.testing.assert_allclose(tt.weights.numpy(), np.asarray(tj.weights), rtol=1e-10)
    same_dense(tt, tj)
    if cutoff <= 1e-12 and top_k is None:
        np.testing.assert_allclose(tt.todense().numpy(), m, atol=1e-10)


def test_from_matrix_drops_zero_eigenvalues():
    rng = np.random.default_rng(5)
    a = rng.normal(size=(5, 2))
    m = a @ a.T
    tj, tt = Dj.from_matrix(jnp.asarray(m)), Dt.from_matrix(torch.from_numpy(m))
    assert tt.num_factors == tj.num_factors == 2
    np.testing.assert_allclose(tt.todense().numpy(), m, atol=1e-10)


@pytest.mark.parametrize("rank", [0, 1, 2, 3, 4])
def test_from_dense_matches_jax(rank):
    rng = np.random.default_rng(20 + rank)
    dense = np.array(st.symalg.symmetrize(rng.normal(size=(3,) * rank)))
    tj, tt = Dj.from_dense(jnp.asarray(dense)), Dt.from_dense(torch.from_numpy(dense))
    assert (tt.rank, tt.dim, tt.multiplicities) == (tj.rank, tj.dim, tj.multiplicities)
    if rank != 2:
        same_leaves(tt, tj)
    np.testing.assert_allclose(np.asarray(tt.todense()), dense, atol=1e-10)
    same_dense(tt, tj)


def test_from_dense_checks_symmetry_like_jax():
    bad = np.arange(27.0).reshape(3, 3, 3)
    with pytest.raises(ValueError) as ej:
        Dj.from_dense(jnp.asarray(bad))
    with pytest.raises(ValueError) as et:
        Dt.from_dense(torch.from_numpy(bad))
    assert str(et.value) == str(ej.value)
    with pytest.raises(ValueError) as ej:
        Dj.from_dense(jnp.ones((2, 3)))
    with pytest.raises(ValueError) as et:
        Dt.from_dense(torch.ones(2, 3))
    assert str(et.value) == str(ej.value)
    same_leaves(Dt.from_dense(torch.from_numpy(bad), symmetrize=True),
                Dj.from_dense(jnp.asarray(bad), symmetrize=True))


# ------------------------------------------------------ multiplicity surgery


@pytest.mark.parametrize("mult,pos", [((3, 1), 0), ((2, 2), 1), ((4,), 0), ((2, 1, 1), 0)])
def test_split_factors_leaf_for_leaf(mult, pos):
    tj, tt = make(30, 3, mult)
    same_leaves(tt.split_factors(pos), tj.split_factors(pos))
    same_dense(tt.split_factors(pos), tj)


def test_sort_match_and_common_multiplicities_leaf_for_leaf():
    tj, tt = make(31, 3, (1, 3))
    same_leaves(tt.sort_multiplicities(), tj.sort_multiplicities())
    uj, ut = make(32, 3, (3, 1))
    assert ut.sort_multiplicities() is ut
    for target in ((2, 1, 1), (1, 1, 1, 1), (3, 1)):
        same_leaves(ut.match_multiplicities(target), uj.match_multiplicities(target))
    same_leaves(tt.match_multiplicities((2, 1, 1)), tj.match_multiplicities((2, 1, 1)))
    vj, vt = make(33, 3, (2, 2))
    assert ut.find_common_multiplicities(vt) == uj.find_common_multiplicities(vj) == (2, 1, 1)
    wj, wt = make(34, 3, (4,))
    assert wt.find_common_multiplicities(wt) == (4,)
    assert wt.find_common_multiplicities(vt) == wj.find_common_multiplicities(vj)


@pytest.mark.parametrize("call", [
    lambda t: t.split_factors(1),              # a multiplicity-1 group
    lambda t: t.match_multiplicities((2, 2, 1)),  # wrong total
    lambda t: t.match_multiplicities((2, 2)),  # (3, 1) cannot become (2, 2)
    lambda t: t.match_multiplicities((4,)),    # multiplicities only decrease
])
def test_multiplicity_errors_match_jax(call):
    tj, tt = make(35, 3, (3, 1))
    with pytest.raises(ValueError) as ej:
        call(tj)
    with pytest.raises(ValueError) as et:
        call(tt)
    assert str(et.value) == str(ej.value)


def test_find_common_multiplicities_needs_equal_ranks():
    (_, a), (_, b) = make(36, 3, (3,)), make(36, 3, (2,))
    with pytest.raises(ValueError, match="ranks must match"):
        a.find_common_multiplicities(b)


# ------------------------------------------------------------------ algebra


@pytest.mark.parametrize("ma,mb", [((2, 1), (3,)), ((2,), (1, 1)), ((2, 2), (3, 1)),
                                   ((1, 1, 1), (2, 1))])
def test_add_decomp_leaf_for_leaf(ma, mb):
    (aj, at), (bj, bt) = make(40, 3, ma), make(41, 3, mb, F=2)
    same_leaves(at.add_decomp(bt), aj.add_decomp(bj))
    same_dense(at.add_decomp(bt), aj.add_decomp(bj))
    # mixed types promote as in JAX
    got = at.astype(torch.float32).add_decomp(bt)
    want = aj.astype(jnp.float32).add_decomp(bj)
    same_leaves(got, want, rtol=1e-6)


def test_add_decomp_auto_compaction_leaf_for_leaf(monkeypatch):
    from symtensor_tpu.config import config as jconfig

    (aj, at), (bj, bt) = make(42, 3, (2, 1), F=4), make(43, 3, (1, 1, 1), F=4)
    # common pattern (1, 1, 1): 8**3 = 512 block elements against 3**3
    monkeypatch.setattr(jconfig, "decomp_autoreduce_elems", 100)
    monkeypatch.setattr(config, "decomp_autoreduce_elems", 100)
    got, want = at.add_decomp(bt), aj.add_decomp(bj)
    assert got.num_factors == 3 and got.multiplicities == (1, 1, 1)
    same_leaves(got, want)
    # 0 disables the rule
    monkeypatch.setattr(jconfig, "decomp_autoreduce_elems", 0)
    monkeypatch.setattr(config, "decomp_autoreduce_elems", 0)
    got, want = at.add_decomp(bt), aj.add_decomp(bj)
    assert got.num_factors == 8
    same_leaves(got, want)
    assert config.__class__().decomp_autoreduce_elems == 65536


def test_add_decomp_shape_mismatch():
    (_, a), (_, b) = make(44, 3, (2,)), make(44, 4, (2,))
    with pytest.raises(ValueError, match="rank/dim mismatch"):
        a.add_decomp(b)


@pytest.mark.parametrize("mult", [(3,), (2, 1), (1, 1, 1), (2, 2), (3, 2)])
def test_to_standard_basis_leaf_for_leaf(mult):
    tj, tt = make(45, 3, mult, F=4)
    same_leaves(tt._to_standard_basis(), tj._to_standard_basis())
    same_dense(tt._to_standard_basis(), tj)
    std = tt._to_standard_basis()
    assert std._to_standard_basis() is std


def test_scale_neg_and_device_rule():
    tj, tt = make(46, 3, (2, 1))
    same_leaves(tt.scale(2.5), tj.scale(2.5))
    same_leaves(tt.scale(np.float64(0.5)), tj.scale(np.float64(0.5)))
    same_leaves(tt.scale(torch.tensor(3.0)), tj.scale(3.0))
    same_leaves(-tt, -tj)
    with pytest.raises(ValueError, match="scale factor on meta"):
        tt.scale(torch.tensor(2.0, device="meta"))


def test_outer_decomp_leaf_for_leaf():
    (aj, at), (bj, bt) = make(47, 3, (2,), F=2), make(48, 3, (1, 1), F=2)
    same_leaves(at.outer_decomp(bt), aj.outer_decomp(bj))
    got = stt.symalg.multiply.outer(at, bt)
    assert got.format == "decomp" and got.multiplicities == (2, 1, 1)
    same_leaves(got, st.symalg.multiply.outer(aj, bj))
    oracle = st.symalg.symmetrize(np.multiply.outer(
        np.asarray(aj.todense()), np.asarray(bj.todense())))
    np.testing.assert_allclose(got.todense().numpy(), np.asarray(oracle), atol=1e-10)
    (_, c) = make(49, 4, (2,))
    with pytest.raises(ValueError, match="dim mismatch"):
        at.outer_decomp(c)


TENSORDOT_CASES = (
    [((ra,), (rb,), k) for ra, rb, k in
     [(2, 2, 1), (2, 2, 2), (3, 2, 1), (3, 2, 2), (2, 1, 1)]]
    + [(ma, mb, 1) for ma, mb in
       [((2, 1), (2,)), ((1, 1), (2, 1)), ((2, 2), (1, 1))]]
    + [((2, 1), (2, 1), 2), ((2, 1), (3,), 2), ((2, 2), (2, 1), 3),
       ((1, 1, 1), (2, 1), 2), ((2, 1), (2, 1), 3), ((2, 2), (1, 1, 1, 1), 4)]
)


@pytest.mark.parametrize("ma,mb,k", TENSORDOT_CASES)
def test_tensordot_decomp_leaf_for_leaf(ma, mb, k):
    (aj, at), (bj, bt) = make(50, 3, ma, F=2), make(51, 3, mb, F=2)
    want = jax.jit(lambda a, b: a.tensordot_decomp(b, axes=k))(aj, bj)
    got = at.tensordot_decomp(bt, axes=k)
    oracle = np.asarray(st.symalg.symmetrize(np.tensordot(
        np.asarray(aj.todense()), np.asarray(bj.todense()), axes=k)))
    out = stt.symalg.tensordot(at, bt, axes=k)
    if sum(ma) + sum(mb) - 2 * k == 0:
        assert isinstance(got, torch.Tensor) and got.shape == ()
        np.testing.assert_allclose(float(got), float(want), rtol=1e-12)
        assert out.format == "flat" and out.rank == 0
        np.testing.assert_allclose(float(out.todense()), oracle, atol=1e-9)
    else:
        same_leaves(got, want)
        assert out.format == "decomp"
        np.testing.assert_allclose(out.todense().numpy(), oracle, atol=1e-9)


def test_tensordot_decomp_axes0_and_errors():
    (aj, at), (bj, bt) = make(52, 3, (2,), F=2), make(53, 3, (1, 1), F=2)
    same_leaves(at.tensordot_decomp(bt, axes=0), aj.tensordot_decomp(bj, axes=0))
    assert stt.symalg.tensordot(at, bt, axes=0).format == "decomp"
    with pytest.raises(ValueError, match="too many axes"):
        at.tensordot_decomp(bt, axes=3)
    (_, c) = make(54, 4, (2,))
    with pytest.raises(ValueError, match="dim mismatch"):
        at.tensordot_decomp(c)


@pytest.mark.parametrize("ma,mb,q", [((2, 1), (2, 1), 2), ((2, 2), (1, 1, 1, 1), 4),
                                     ((3,), (3,), 1), ((1, 1, 1), (2, 1), 2)])
def test_pairing_tables_equal_as_lists(ma, mb, q):
    assert list(tdecomp._pairing_tables(ma, mb, q)) == list(
        jdecomp._pairing_tables(ma, mb, q))


@pytest.mark.parametrize("mult", [(3,), (2, 1), (1, 1, 1), (4,), (2, 2), (3, 1),
                                  (2, 1, 1), (3, 2)])
def test_reduce_factors_high_rank_leaf_for_leaf(mult):
    tj, tt = make(55, 3, mult, F=5)  # num_factors > dim triggers the reduction
    got, want = tt.reduce_factors(), tj.reduce_factors()
    assert got.num_factors == 3 and got.multiplicities == (1,) * sum(mult)
    same_leaves(got, want)
    same_dense(got, tj)
    (_, small) = make(56, 3, mult, F=2)
    assert small.reduce_factors() is small  # below the gate


def test_reduce_factors_ranks_1_and_2_through_todense():
    rng = np.random.default_rng(57)
    v1, v2 = rng.normal(size=4), rng.normal(size=4)
    tt = Dt.from_vector(torch.from_numpy(v1), 1).add_decomp(
        Dt.from_vector(torch.from_numpy(v2), 1))
    red = tt.reduce_factors()
    assert red.num_factors == 1
    np.testing.assert_allclose(red.todense().numpy(), v1 + v2, atol=1e-12)
    m = rng.normal(size=(5, 5))
    m = m + m.T
    t2 = Dt.from_matrix(torch.from_numpy(m))
    big = t2.add_decomp(t2.scale(-0.5))
    j2 = Dj.from_matrix(jnp.asarray(m))
    bigj = j2.add_decomp(j2.scale(-0.5))
    assert big.num_factors == bigj.num_factors == 10
    red, redj = big.reduce_factors(), bigj.reduce_factors()
    assert red.num_factors == redj.num_factors <= 5
    same_dense(red, redj)
    np.testing.assert_allclose(red.todense().numpy(), 0.5 * m, atol=1e-9)
    assert Dt.zeros(0, 3).reduce_factors().rank == 0


def test_expansion_keeps_its_intermediates_small():
    """``_expand_groups`` contracts one weight axis at a time against its
    group's factor copies: at F = 6, dim = 2, multiplicities (2, 2, 1) no
    intermediate exceeds F^(k−1)·d² = 144 elements. A left-to-right einsum
    of the generated spec ``abc,ap,aq,br,bs,ct->pqrst`` keeps `a` alive to
    the second operand and reaches F³·d² = 864."""
    rng = np.random.default_rng(58)
    F, d, mult = 6, 2, (2, 2, 1)
    w = torch.from_numpy(rng.normal(size=(F,) * 3))
    f = torch.from_numpy(rng.normal(size=(F, d)))
    peak = [0]

    class Peak(TorchDispatchMode):
        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            out = func(*args, **(kwargs or {}))
            if isinstance(out, torch.Tensor):
                peak[0] = max(peak[0], out.numel())
            return out

    with Peak():
        got = tdecomp._expand_groups(w, f, mult)
    assert peak[0] <= F ** 3  # the weights themselves: 216
    want = np.einsum("abc,ap,aq,br,bs,ct->pqrst", w.numpy(), *[f.numpy()] * 5)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-12, atol=1e-13)
    tj, tt = make(59, 2, mult, F=6)
    with Peak():
        tt._to_standard_basis()
    assert peak[0] <= F ** 3


# -------------------------------------------------------------- contractions


def test_contract_with_matrix_leaf_for_leaf():
    tj, tt = make(60, 4, (2, 1))
    W = np.random.default_rng(61).normal(size=(4, 5))
    got = stt.symalg.contract_all_indices_with_matrix(tt, torch.from_numpy(W))
    want = st.symalg.contract_all_indices_with_matrix(tj, jnp.asarray(W))
    assert got.format == "decomp" and got.dim == 5
    same_leaves(got, want)
    same_leaves(tt.contract_all_indices_with_matrix(W), want)  # NumPy W
    oracle = np.einsum("abc,ai,bj,ck->ijk", np.asarray(tj.todense()), W, W, W)
    np.testing.assert_allclose(got.todense().numpy(), oracle, atol=1e-9)
    with pytest.raises(ValueError) as ej:
        tj.contract_all_indices_with_matrix(jnp.ones((3, 3)))
    with pytest.raises(ValueError) as et:
        tt.contract_all_indices_with_matrix(torch.ones(3, 3))
    assert str(et.value) == str(ej.value)


def test_contract_with_matrix_dense_and_unported_formats():
    rng = np.random.default_rng(62)
    dense = np.array(st.symalg.symmetrize(rng.normal(size=(3, 3, 3))))
    W = rng.normal(size=(3, 4))
    got = stt.symalg.contract_all_indices_with_matrix(
        stt.DenseSymmetricTensor(data=torch.from_numpy(dense)), torch.from_numpy(W))
    want = st.symalg.contract_all_indices_with_matrix(
        st.DenseSymmetricTensor(data=jnp.asarray(dense)), jnp.asarray(W))
    assert got.format == "dense" and got.dim == 4
    np.testing.assert_allclose(got.data.numpy(), np.asarray(want.data), rtol=1e-12)
    # flat and permcls operands run the packed basis change and keep their
    # format, on its whole-level route and, under budgets of a few elements,
    # on its blocked route
    flat = stt.FlatSymmetricTensor.from_dense(torch.from_numpy(dense))
    for A in (flat, flat.topermcls()):
        for kw in ({}, {"block_elems": 17, "transient_elems": 23}):
            out = stt.symalg.contract_all_indices_with_matrix(
                A, torch.from_numpy(W), **kw)
            assert out.format == A.format and out.dim == 4
            np.testing.assert_allclose(out.todense().numpy(), np.asarray(want.data),
                                       rtol=1e-10, atol=1e-13)
    with pytest.raises(TypeError):
        stt.symalg.contract_all_indices_with_matrix(torch.ones(3, 3), W)


@pytest.mark.parametrize("mult", MULTS + [()])
def test_contract_with_vector_matches_jax_and_the_flat_route(mult):
    dim = 4
    if mult:
        tj, tt = make(63, dim, mult)
    else:
        tj = Dj(rank=0, dim=dim, weights=jnp.asarray(1.5), factors=jnp.zeros((1, dim)),
                multiplicities=(), dtype=jnp.float64)
        tt = decomp_from_numpy(0, dim, np.asarray(1.5), np.zeros((1, dim)), (),
                               device="cpu")
    rng = np.random.default_rng(64)
    x, xs = rng.normal(size=dim), rng.normal(size=(6, dim))
    want = float(st.symalg.contract_all_indices_with_vector(tj, jnp.asarray(x)))
    got = stt.symalg.contract_all_indices_with_vector(tt, torch.from_numpy(x))
    assert got.shape == () and got.dtype == torch.float64
    np.testing.assert_allclose(float(got), want, rtol=1e-12)
    np.testing.assert_allclose(
        float(stt.symalg.contract_all_indices_with_vector(tt, x)), want, rtol=1e-12)
    wants = np.asarray(st.symalg.contract_all_indices_with_vector_batched(
        tj, jnp.asarray(xs)))
    gots = stt.symalg.contract_all_indices_with_vector_batched(tt, torch.from_numpy(xs))
    assert gots.shape == (6,)
    np.testing.assert_allclose(gots.numpy(), wants, rtol=1e-12)
    # the port's own flat route on the expanded tensor
    flat = tt.toflat()
    np.testing.assert_allclose(
        float(stt.symalg.contract_all_indices_with_vector(flat, torch.from_numpy(x))),
        want, rtol=1e-10)
    np.testing.assert_allclose(
        stt.symalg.contract_all_indices_with_vector_batched(
            flat, torch.from_numpy(xs)).numpy(), wants, rtol=1e-10)


def test_contract_with_vector_shape_errors_match_jax():
    tj, tt = make(65, 4, (2, 1))
    for bad_j, bad_t in ((jnp.ones(3), torch.ones(3)),):
        with pytest.raises(ValueError):
            stt.symalg.contract_all_indices_with_vector(tt, bad_t)
    with pytest.raises(ValueError) as ej:
        st.symalg.contract_all_indices_with_vector_batched(tj, jnp.ones(4))
    with pytest.raises(ValueError) as et:
        stt.symalg.contract_all_indices_with_vector_batched(tt, torch.ones(4))
    assert str(et.value) == str(ej.value)
    with pytest.raises(ValueError) as ej:
        st.symalg.contract_all_indices_with_vector_batched(tj, jnp.ones((2, 3)))
    with pytest.raises(ValueError) as et:
        stt.symalg.contract_all_indices_with_vector_batched(tt, torch.ones(2, 3))
    assert str(et.value) == str(ej.value)


def test_gradient_through_weights_and_factors_matches_jax_grad():
    """``tests/test_decomp.py:272``, through autograd."""
    tj, tt = make(66, 4, (2, 1), F=2)
    x = np.random.default_rng(67).normal(size=4)
    g = jax.grad(lambda t: st.symalg.contract_all_indices_with_vector(
        t, jnp.asarray(x)))(tj)
    w = tt.weights.clone().requires_grad_()
    f = tt.factors.clone().requires_grad_()
    y = stt.symalg.contract_all_indices_with_vector(
        Dt._raw(3, 4, w, f, (2, 1)), torch.from_numpy(x))
    y.backward()
    np.testing.assert_allclose(w.grad.numpy(), np.asarray(g.weights), rtol=1e-10)
    np.testing.assert_allclose(f.grad.numpy(), np.asarray(g.factors), rtol=1e-10)
    # and through toflat
    w.grad = f.grad = None
    Dt._raw(3, 4, w, f, (2, 1)).toflat().data.square().sum().backward()
    gj = jax.grad(lambda t: (t.toflat().data ** 2).sum())(tj)
    np.testing.assert_allclose(w.grad.numpy(), np.asarray(gj.weights), rtol=1e-9)
    np.testing.assert_allclose(f.grad.numpy(), np.asarray(gj.factors), rtol=1e-9)


# ------------------------------------------------- assignment and operators


def test_assignment_raises_type_error_like_jax():
    tj, tt = make(70, 3, (2,))
    for key in ("ii", (0, 1)):
        with pytest.raises(TypeError) as ej:
            tj.at[key].set(1.0)
        with pytest.raises(TypeError) as et:
            tt.at[key].set(1.0)
        assert str(et.value) == str(ej.value)
    with pytest.raises(TypeError):
        tt.set_element((0, 1), 1.0)
    with pytest.raises(TypeError):
        tt.at["ij"].add(1.0)


def test_elementwise_stays_decomp_where_the_structure_allows():
    (aj, at), (bj, bt) = make(71, 3, (2, 1)), make(72, 3, (3,))
    pairs = [
        (at + bt, aj + bj), (at - bt, aj - bj), (at * 2.5, aj * 2.5),
        (2.5 * at, 2.5 * aj), (at / 4.0, aj / 4.0), (0.5 + at, 0.5 + aj),
        (at + 0.5, aj + 0.5), (at - 0.25, aj - 0.25), (0.25 - at, 0.25 - aj),
        (-at, -aj), (at * np.float64(2.0), aj * np.float64(2.0)),
        (at + torch.tensor(1.5, dtype=torch.float64), aj + 1.5),
    ]
    for got, want in pairs:
        assert got.format == want.format == "decomp"
        same_leaves(got, want)
    da, db = np.asarray(aj.todense()), np.asarray(bj.todense())
    np.testing.assert_allclose((at + bt).todense().numpy(), da + db, atol=1e-10)
    np.testing.assert_allclose((0.5 + at).todense().numpy(), da + 0.5, atol=1e-10)
    np.testing.assert_allclose((0.25 - at).todense().numpy(), 0.25 - da, atol=1e-10)


def test_elementwise_with_another_format_goes_to_flat_and_is_counted():
    aj, at = make(73, 3, (2,), F=2)
    (_, bt) = make(74, 3, (1, 1), F=2)
    da = np.array(aj.todense())
    flat = stt.FlatSymmetricTensor.from_dense(torch.from_numpy(da))
    profiling.reset_counters()
    with pytest.warns(UserWarning, match="elementwise.decomp_to_flat"):
        out = at + flat
    assert out.format == "flat"
    np.testing.assert_allclose(out.todense().numpy(), 2 * da, atol=1e-10)
    assert profiling.op_counters["elementwise.decomp_to_flat"] == 1
    with warnings.catch_warnings():
        warnings.simplefilter("error")  # once per site: no second warning
        out = at * bt  # decomp × decomp elementwise is not structural
        # the expanded operand is flat, and flat wins the promotion
        assert (flat.topermcls() - at).format == "flat"
        assert (stt.DenseSymmetricTensor(data=flat.todense()) * at).format == "flat"
    assert out.format == "flat"
    np.testing.assert_allclose(out.todense().numpy(),
                               da * bt.todense().numpy(), atol=1e-10)
    assert profiling.op_counters["elementwise.decomp_to_flat"] == 5
    # unary maps and comparisons expand without counting, as in JAX
    assert abs(at).format == "flat" and stt.symalg.exp(at).format == "flat"
    assert (at ** 2).format == "flat"
    assert at.allclose(flat) and stt.symalg.array_equal(at, at)
    assert profiling.op_counters["elementwise.decomp_to_flat"] == 5
    # no warning when the switch is off
    profiling.reset_counters()
    config.warn_on_densify, keep = False, config.warn_on_densify
    try:
        with warnings.catch_warnings():
            warnings.simplefilter("error")
            at + flat
    finally:
        config.warn_on_densify = keep
    assert profiling.op_counters["elementwise.decomp_to_flat"] == 1
    profiling.reset_counters()
    assert not profiling.op_counters


def test_mixed_operands_of_outer_and_tensordot_go_through_toflat():
    aj, at = make(75, 3, (2,), F=2)
    da = np.array(aj.todense())
    Fj = st.FlatSymmetricTensor.from_dense(jnp.asarray(da))
    Ft = stt.FlatSymmetricTensor.from_dense(torch.from_numpy(da))
    got = stt.symalg.tensordot(at, Ft, axes=1)
    want = st.symalg.tensordot(aj, Fj, axes=1)
    assert got.format == "flat"
    np.testing.assert_allclose(got.data.numpy(), np.asarray(want.data), rtol=1e-10)
    got = stt.symalg.multiply.outer(Ft, at)
    want = st.symalg.multiply.outer(Fj, aj)
    assert got.format == "flat"
    np.testing.assert_allclose(got.data.numpy(), np.asarray(want.data), rtol=1e-10,
                               atol=1e-13)
    # add.outer of two decomp tensors is not structural either
    assert stt.symalg.add.outer(at, at).format == "flat"
    # a rank-0 decomp operand takes the scalar path
    s = decomp_from_numpy(0, 3, np.asarray(2.0), np.zeros((1, 3)), (), device="cpu")
    assert stt.symalg.multiply.outer(s, at).format == "flat"
