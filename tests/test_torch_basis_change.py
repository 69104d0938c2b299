"""The port's packed basis change (whole-level route, and its routing)
against the JAX package's, on the CPU, in float64 unless stated.

The same NumPy inputs, made from a seed, go through both packages; the JAX
side is ``basis_change_packed`` and ``symalg.contract_all_indices_with_matrix``
with default arguments, which take its whole-op route at these sizes. The
blocked route has its own file, ``test_torch_basis_blocked.py``.
"""

import weakref

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

import symtensor_tpu as st
import symtensor_tpu_torch as stt
from symtensor_tpu.ops.basis_change import basis_change_packed as jax_packed
from symtensor_tpu_torch.config import config
from symtensor_tpu_torch.interop import (
    flat_from_numpy, flat_to_numpy, permcls_from_numpy, permcls_to_numpy,
)
from symtensor_tpu_torch.ops import basis_change as bc
from symtensor_tpu_torch.testing import random_symmetric
from symtensor_tpu_torch.utils import combinatorics as comb
from symtensor_tpu_torch.utils.tables import tables

# ranks 0-6 at dims 1-4 (square), and four rectangular shapes
SQUARE = [(r, d, d) for r in range(7) for d in (1, 2, 3, 4)]
RECT = [(4, 7, 6), (3, 9, 4), (2, 3, 2), (6, 3, 4)]
# the shapes of the JAX package's own einsum-oracle test
ORACLE = [(1, 4, 4), (2, 4, 4), (3, 3, 3), (4, 3, 3), (3, 3, 5), (2, 3, 2)]


@pytest.fixture(autouse=True)
def _cpu_default_device(monkeypatch):
    """This file builds tensors without naming a device: ask for the CPU."""
    monkeypatch.setattr(config, "default_device", "cpu")


def operands(rank, dim, d_out, seed=0):
    """Packed float64 values and W, the same for both packages."""
    rng = np.random.default_rng([seed, rank, dim, d_out])
    data = rng.normal(size=comb.indep_size(rank, dim))
    W = rng.normal(size=(dim, d_out))
    return data, W


def both_flat(rank, dim, data, dtype=None):
    Aj = st.FlatSymmetricTensor(rank=rank, dim=dim, data=jnp.asarray(data, dtype=dtype))
    At = flat_from_numpy(rank, dim, np.asarray(Aj.data), device="cpu")
    return Aj, At


# ------------------------------------------------------------------ parity


@pytest.mark.parametrize("rank,dim,d_out", SQUARE + RECT)
def test_flat_matches_jax(rank, dim, d_out):
    data, W = operands(rank, dim, d_out)
    Aj, At = both_flat(rank, dim, data)
    want = st.symalg.contract_all_indices_with_matrix(Aj, jnp.asarray(W))
    got = stt.symalg.contract_all_indices_with_matrix(At, torch.from_numpy(W))
    assert got.format == "flat" and want.format == "flat"
    assert (got.rank, got.dim) == (want.rank, want.dim)
    assert got.dtype == torch.float64 and got.data.shape == want.data.shape
    np.testing.assert_allclose(flat_to_numpy(got), np.asarray(want.data),
                               rtol=1e-10, atol=1e-13)
    # the packed entry point itself, W as a NumPy array
    direct = bc.basis_change_packed(At, W)
    np.testing.assert_allclose(
        flat_to_numpy(direct), np.asarray(jax_packed(Aj, jnp.asarray(W)).data),
        rtol=1e-10, atol=1e-13)


@pytest.mark.parametrize("rank,dim,d_out",
                         [s for s in SQUARE + RECT if s[0] >= 1])
def test_permcls_matches_jax_leaf_for_leaf(rank, dim, d_out):
    data, W = operands(rank, dim, d_out, seed=1)
    Pj = st.FlatSymmetricTensor(rank=rank, dim=dim, data=jnp.asarray(data)).topermcls()
    Pt = permcls_from_numpy(
        rank, dim, {k: np.asarray(v) for k, v in Pj.data.items()}, device="cpu")
    want = st.symalg.contract_all_indices_with_matrix(Pj, jnp.asarray(W))
    got = stt.symalg.contract_all_indices_with_matrix(Pt, torch.from_numpy(W))
    assert got.format == "permcls" and want.format == "permcls"
    assert (got.rank, got.dim) == (want.rank, want.dim)
    leaves = permcls_to_numpy(got)
    assert set(leaves) == set(want.data)
    for k, v in want.data.items():
        assert leaves[k].shape == np.asarray(v).shape, k
        np.testing.assert_allclose(leaves[k], np.asarray(v), rtol=1e-10, atol=1e-13)


@pytest.mark.parametrize("fmt", ["flat", "permcls"])
@pytest.mark.parametrize("rank,dim,d_out", ORACLE)
def test_einsum_oracle_and_format_kept(fmt, rank, dim, d_out):
    rng = np.random.default_rng([2, rank, dim, d_out])
    dense = random_symmetric(rank, dim, rng)
    W = rng.normal(size=(dim, d_out))
    A = stt.FlatSymmetricTensor.from_dense(torch.from_numpy(dense))
    if fmt == "permcls":
        A = A.topermcls()
    out = stt.symalg.contract_all_indices_with_matrix(A, torch.from_numpy(W))
    assert out.rank == rank and out.dim == d_out
    ins, outs = "abcdefgh"[:rank], "ijklmnop"[:rank]
    spec = ins + "," + ",".join(f"{i}{o}" for i, o in zip(ins, outs)) + "->" + outs
    oracle = np.einsum(spec, dense, *[W] * rank)
    np.testing.assert_allclose(out.todense().numpy(), oracle, atol=1e-9)
    assert out.format == fmt


# ---------------------------------------------------------------- chunking


@pytest.mark.parametrize("rank,dim,d_out,budget", [
    (4, 7, 6, 300), (3, 9, 4, 100), (6, 3, 4, 60), (5, 4, 4, 1), (2, 3, 2, 1),
])
def test_small_budget_chunks_equal_the_unchunked_result(rank, dim, d_out, budget):
    """A small budget forces several windows of W's columns and several
    row chunks (the last one ragged); the values are the unchunked ones."""
    data, W = operands(rank, dim, d_out, seed=3)
    data, W = torch.from_numpy(data), torch.from_numpy(W)
    windows, row_chunks = 0, 0
    for t in range(rank):
        k = rank - t - 1
        N_k = bc._n_cols(k, dim)
        chunks = bc._window_chunks(t, N_k, d_out, budget)
        assert chunks[0][0] == 0 and chunks[-1][1] == d_out
        assert all(a[1] == b[0] for a, b in zip(chunks, chunks[1:]))
        windows = max(windows, len(chunks))
        for _, b1 in chunks:
            mm = comb.multiset_count(b1, t)
            if k >= 1 and bc._row_chunk(mm, N_k, dim, budget) < mm:
                row_chunks += 1
    assert windows > 1
    assert row_chunks > 0 or rank == 2
    args = (rank, dim, d_out, torch.float64, torch.float64)
    whole = bc._basis_change_levels(data, W, *args, 2**26)
    got = bc._basis_change_levels(data, W, *args, budget)
    np.testing.assert_allclose(got.numpy(), whole.numpy(), rtol=1e-12, atol=1e-12)


def test_pick_keeps_its_shape_at_one_column_and_one_window_column():
    """``H[par, :, mx]`` with a slice between two index tensors: the picked
    rows come first, also when N_k = 1 (the last level) and when a window
    is one column wide."""
    H = torch.arange(2 * 1 * 3.0).reshape(2, 1, 3)
    par, mx = torch.tensor([0, 0, 1]), torch.tensor([0, 2, 1])
    seg = H[par, :, mx]
    assert seg.shape == (3, 1)
    np.testing.assert_array_equal(seg[:, 0].numpy(), [0.0, 2.0, 4.0])
    H = torch.arange(2 * 4 * 1.0).reshape(2, 4, 1)
    seg = H[torch.tensor([1, 0]), :, torch.tensor([0, 0])]
    assert seg.shape == (2, 4)
    np.testing.assert_array_equal(seg.numpy(), [[4, 5, 6, 7], [0, 1, 2, 3]])


# -------------------------------------------------------------------- types


def test_float32_data_with_float64_accumulation_matches_jax():
    rank, dim, d_out = 4, 3, 3
    data, W = operands(rank, dim, d_out, seed=4)
    Aj, At = both_flat(rank, dim, data, dtype=jnp.float32)
    assert At.dtype == torch.float32
    want = jax_packed(Aj, jnp.asarray(W), acc_dtype=jnp.float64)
    got = bc.basis_change_packed(At, torch.from_numpy(W), acc_dtype=torch.float64)
    assert want.data.dtype == jnp.float32 and got.dtype == torch.float32
    np.testing.assert_allclose(flat_to_numpy(got), np.asarray(want.data), rtol=1e-6)
    # float64 accumulation: the float32 result is the rounded float64 one
    exact = bc.basis_change_packed(At.astype(torch.float64), torch.from_numpy(W))
    np.testing.assert_array_equal(got.data.numpy(), exact.data.float().numpy())
    # the defaults: float32 data accumulates in float32, W cast to it
    plain = bc.basis_change_packed(At, torch.from_numpy(W))
    assert plain.dtype == torch.float32
    np.testing.assert_allclose(flat_to_numpy(plain), flat_to_numpy(exact), rtol=1e-4)


def test_bfloat16_storage_matches_jax():
    rank, dim, d_out = 3, 3, 5
    data, W = operands(rank, dim, d_out, seed=5)
    Aj, At = both_flat(rank, dim, data, dtype=jnp.float32)
    want = st.symalg.contract_all_indices_with_matrix(
        Aj, jnp.asarray(W), store_dtype=jnp.bfloat16)
    got = stt.symalg.contract_all_indices_with_matrix(
        At, torch.from_numpy(W), store_dtype=torch.bfloat16)
    assert want.data.dtype == jnp.bfloat16 and got.dtype == torch.bfloat16
    exact = bc.basis_change_packed(At.astype(torch.float64), torch.from_numpy(W))
    scale = float(exact.data.abs().max())
    np.testing.assert_allclose(flat_to_numpy(got), flat_to_numpy(exact),
                               atol=2e-2 * scale)
    np.testing.assert_allclose(
        flat_to_numpy(got), np.asarray(want.data.astype(jnp.float32)),
        atol=2e-2 * scale)
    # a permcls operand passes the keywords on and keeps its format
    P = stt.symalg.contract_all_indices_with_matrix(
        At.topermcls(), torch.from_numpy(W), store_dtype=torch.bfloat16)
    assert P.format == "permcls" and P.dtype == torch.bfloat16


# ------------------------------------------------------------------- errors


def test_wrong_w_shape_raises_as_in_the_jax_package():
    data, _ = operands(3, 4, 4)
    Aj, At = both_flat(3, 4, data)
    for shape in ((3, 4), (4,), (4, 4, 4)):
        with pytest.raises(ValueError) as ej:
            jax_packed(Aj, jnp.ones(shape))
        with pytest.raises(ValueError) as et:
            bc.basis_change_packed(At, torch.ones(shape))
        assert str(et.value) == str(ej.value)
    with pytest.raises(ValueError):
        stt.symalg.contract_all_indices_with_matrix(At.topermcls(), torch.ones(3, 4))


@pytest.mark.parametrize("keyword", ["block_elems", "transient_elems",
                                     "onthefly_above", "donate_root", "mesh",
                                     "tp_axis"])
def test_blocked_path_keywords_are_not_accepted_yet(keyword):
    """The blocked route's keywords, a ``TypeError`` each until that route
    was ported: every one is accepted now, selects the blocked route and
    gives the all-default values; `mesh` goes to the parallel layer, which
    takes a ``DeviceMesh`` (tests/test_torch_parallel.py runs it), and
    `tp_axis` without a mesh changes nothing."""
    data, W = operands(3, 3, 3)
    _, At = both_flat(3, 3, data)
    want = stt.symalg.contract_all_indices_with_matrix(At, W)
    assert bc.last_call["route"] == "whole-level"
    if keyword == "mesh":
        with pytest.raises(TypeError, match="DeviceMesh"):
            stt.symalg.contract_all_indices_with_matrix(At, W, mesh=1)
        return
    if keyword == "tp_axis":
        got = stt.symalg.contract_all_indices_with_matrix(At, W, tp_axis="x")
        assert bc.last_call["route"] == "whole-level"
        np.testing.assert_array_equal(flat_to_numpy(got), flat_to_numpy(want))
        return
    for fmt in ("flat", "permcls"):
        A = At.topermcls() if fmt == "permcls" else At
        got = stt.symalg.contract_all_indices_with_matrix(A, W, **{keyword: 1})
        assert bc.last_call["route"] == "blocked" and got.format == fmt
        np.testing.assert_allclose(flat_to_numpy(got.toflat()), flat_to_numpy(want),
                                   rtol=1e-12, atol=1e-13)


def _route_tables_built(rank, dim):
    return [k for k in tables(rank, dim)._cache
            if isinstance(k, tuple) and k[0] in ("insert", "insert_np", "mono")]


def test_past_the_residency_gate_raises_before_any_table(monkeypatch):
    """Past the residency gate the call raised until the blocked route was
    ported; now it runs that route, builds none of the whole-level route's
    colex tables, and gives the whole-level values."""
    rank, dim = 3, 11  # a shape no other test of this file touches
    data, W = operands(rank, dim, dim)
    Aj, At = both_flat(rank, dim, data)
    want = np.asarray(jax_packed(Aj, jnp.asarray(W)).data)
    monkeypatch.setenv("SYMTENSOR_BASIS_SMALL_ELEMS", "1")
    got = stt.symalg.contract_all_indices_with_matrix(At, W)
    assert bc.last_call["route"] == "blocked"
    np.testing.assert_allclose(flat_to_numpy(got), want, rtol=1e-10, atol=1e-13)
    assert not [k for k in _route_tables_built(rank, dim) if k[0] == "mono"]
    assert "colex_perm" not in tables(rank, dim)._cache
    P = stt.symalg.contract_all_indices_with_matrix(At.topermcls(), W)
    assert bc.last_call["route"] == "blocked" and P.format == "permcls"
    np.testing.assert_allclose(flat_to_numpy(P.toflat()), want, rtol=1e-10, atol=1e-13)
    # 0 closes the whole-level route, as in the JAX package
    monkeypatch.setenv("SYMTENSOR_BASIS_SMALL_ELEMS", "0")
    np.testing.assert_allclose(flat_to_numpy(bc.basis_change_packed(At, W)), want,
                               rtol=1e-10, atol=1e-13)
    assert bc.last_call["route"] == "blocked"
    # ranks 0 and 1 never reach the gate
    _, A1 = both_flat(1, dim, data[:dim])
    assert bc.basis_change_packed(A1, W).data.shape == (dim,)
    assert "route" not in bc.last_call
    monkeypatch.delenv("SYMTENSOR_BASIS_SMALL_ELEMS")
    assert stt.symalg.contract_all_indices_with_matrix(At, W).dim == dim
    assert bc.last_call["route"] == "whole-level"


def test_past_the_table_guard_raises_before_any_table(monkeypatch):
    """An insert table past the guard raised until the positions could be
    ranked on the device; now the same call stays on the whole-level route,
    never builds that table, and gives the same values. A result whose
    storage-order table passes the guard goes to the blocked route."""
    rank, dim = 4, 9  # a shape no other test of this file touches
    data, W = operands(rank, dim, dim)
    Aj, At = both_flat(rank, dim, data)
    want = np.asarray(jax_packed(Aj, jnp.asarray(W)).data)
    entries = comb.indep_size(3, dim) * dim * 4  # insert_table(3): 5 940
    monkeypatch.setattr(config, "max_table_entries", entries - 1)
    names = [n for n, _ in bc._small_table_entries(rank, dim, dim)]
    assert "rep_indices of rank 3 dim 9" in names
    assert "insert_table(3) at dim 9" not in names
    got = stt.symalg.contract_all_indices_with_matrix(At, W)
    assert bc.last_call["route"] == "whole-level"
    np.testing.assert_allclose(flat_to_numpy(got), want, rtol=1e-10, atol=1e-13)
    built = _route_tables_built(rank, dim)
    assert ("insert", 3) not in built and ("insert", 2) in built
    # the result's side: a wide W, whose colex_perm would need 123 410 · 4
    # entries, runs blocked and builds no table of the result's dim
    wide = np.ones((dim, 40))
    out = bc.basis_change_packed(At, wide)
    assert bc.last_call["route"] == "blocked" and out.dim == 40
    assert not [k for k in tables(rank, 40)._cache
                if k in ("rep_np", "colex_perm") or isinstance(k, tuple)]
    np.testing.assert_allclose(
        flat_to_numpy(out), np.asarray(jax_packed(Aj, jnp.asarray(wide)).data),
        rtol=1e-10, atol=1e-10)


def test_default_shapes_pass_or_trip_the_gate_by_the_table_guard():
    """At the default limits BASELINE C2 and the mid sizes take the
    whole-level route with their insert tables; rank 6 dim 50 takes it
    with ``insert_table(5)`` ranked on the device; rank 5 dim 100 does not
    (the storage order of its result needs 4.6e8 entries) and rank 6 dim
    100 does not (5.4e10 elements): both run blocked."""
    for rank, dim in ((4, 100), (5, 60), (6, 32)):
        assert bc._whole_level_fits(rank, dim, dim, bc._SMALL_BUDGET)
        assert not any(bc._on_the_fly(k, dim, None) for k in range(1, rank))
    assert bc._whole_level_fits(6, 50, 50, bc._SMALL_BUDGET)
    assert [k for k in range(1, 6) if bc._on_the_fly(k, 50, None)] == [5]
    assert bc._small_peak_elems(5, 100, 100, bc._SMALL_BUDGET) < bc._SMALL_ELEMS
    assert dict(bc._small_table_entries(5, 100, 100))[
        "rep_indices of rank 5 dim 100"] == 91962520 * 5 > config.max_table_entries
    assert not bc._whole_level_fits(5, 100, 100, bc._SMALL_BUDGET)
    assert bc._small_peak_elems(6, 100, 100, bc._SMALL_BUDGET) > bc._SMALL_ELEMS
    assert not bc._whole_level_fits(6, 100, 100, bc._SMALL_BUDGET)
    assert [k for k in range(1, 6) if bc._on_the_fly(k, 100, None)] == [4, 5]


# ---------------------------------------------------------------- gradients


@pytest.mark.parametrize("rank,dim,d_out", [(3, 3, 3), (4, 3, 3), (3, 3, 5)])
def test_gradients_match_jax_grad(rank, dim, d_out):
    data, W = operands(rank, dim, d_out, seed=6)
    G = np.random.default_rng(7).normal(size=comb.indep_size(rank, d_out))

    def loss_jax(values, w):
        A = st.FlatSymmetricTensor._raw(rank, dim, values)
        C = st.symalg.contract_all_indices_with_matrix(A, w)
        return (C.data * jnp.asarray(G)).sum()

    g_data, g_W = jax.grad(loss_jax, argnums=(0, 1))(jnp.asarray(data), jnp.asarray(W))
    values = torch.from_numpy(data).requires_grad_()
    w = torch.from_numpy(W).requires_grad_()
    for fmt in ("flat", "permcls"):
        values.grad = w.grad = None
        A = stt.FlatSymmetricTensor._raw(rank, dim, values)
        C = stt.symalg.contract_all_indices_with_matrix(
            A.topermcls() if fmt == "permcls" else A, w)
        (C.toflat().data * torch.from_numpy(G)).sum().backward()
        np.testing.assert_allclose(values.grad.numpy(), np.asarray(g_data),
                                   rtol=1e-9, atol=1e-12)
        np.testing.assert_allclose(w.grad.numpy(), np.asarray(g_W),
                                   rtol=1e-9, atol=1e-12)


def test_gradients_pass_through_the_chunked_route():
    rank, dim, d_out, budget = 4, 5, 4, 40
    data, W = operands(rank, dim, d_out, seed=8)
    grads = []
    for b in (budget, 2**26):
        values = torch.from_numpy(data).requires_grad_()
        w = torch.from_numpy(W).requires_grad_()
        out = bc._basis_change_levels(values, w, rank, dim, d_out,
                                      torch.float64, torch.float64, b)
        (out ** 2).sum().backward()
        grads.append((values.grad, w.grad))
    for got, want in zip(*grads):
        np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-11)


# ---------------------------------------------------------------- residency


class LiveElements(TorchDispatchMode):
    """Counts the elements of the distinct storages behind every tensor
    that an op under the mode returned and that is still alive; keeps the
    most seen at once."""

    def __init__(self):
        super().__init__()
        self.refs = []
        self.peak = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        outs = out if isinstance(out, (tuple, list)) else (out,)
        self.refs += [weakref.ref(o) for o in outs if isinstance(o, torch.Tensor)]
        live = {}
        for ref in self.refs:
            t = ref()
            if t is not None and t.is_floating_point():
                s = t.untyped_storage()
                live[s.data_ptr()] = s.nbytes() // t.element_size()
        self.refs = [ref for ref in self.refs if ref() is not None]
        self.peak = max(self.peak, sum(live.values()))
        return out


@pytest.mark.parametrize("budget", [150, 2**26])
def test_peak_residency_by_element_count(budget):
    """The route keeps no second copy of the child level: at rank 4,
    dim 6 → 6 the floating-point elements alive at once stay within the
    projection (the operands count on top of it), and with several windows
    a level below parent + twice the child + the product, which a
    concatenation of the windows' segments would reach."""
    rank, dim, d_out = 4, 6, 6
    data, W = operands(rank, dim, d_out, seed=9)
    data, W = torch.from_numpy(data), torch.from_numpy(W)
    tables(rank, dim).insert_table(rank - 1)  # tables are not residency
    with LiveElements() as mode:
        out = bc._basis_change_levels(data, W, rank, dim, d_out,
                                      torch.float64, torch.float64, budget)
    projected = bc._small_peak_elems(rank, dim, d_out, budget)
    # W's window and row slices are views of the operands' storages
    assert mode.peak <= projected + data.numel() + W.numel() + out.numel()
    if budget == 150:
        # level 1: 6 × 56 parents, 21 × 21 children, several windows
        assert len(bc._window_chunks(1, 21, d_out, budget)) > 1
        with_concat = max(
            comb.multiset_count(d_out, t) * comb.indep_size(rank - t, dim)
            + 2 * comb.multiset_count(d_out, t + 1) * bc._n_cols(rank - t - 1, dim)
            for t in range(rank))
        assert projected < with_concat + budget
        assert mode.peak < with_concat + data.numel() + W.numel()


def test_small_peak_elems_follows_the_levels():
    # rank 2, dim 3 → 3, one window a level: level 0 holds A (6), the
    # gathered rows (3 × 3), their product (3 × 3) and the child (3 × 3)
    assert bc._small_peak_elems(2, 3, 3, 2**26) == 6 + 9 + 9 + 9
    # BASELINE C2 under the default budget: level 1
    assert bc._small_peak_elems(4, 100, 100, 2**28) == (
        100 * 171700 + 5050 * 5050 + 2 * 100 * 5050 * 100)
    names = [n for n, _ in bc._small_table_entries(4, 100, 100)]
    assert names[:3] == [f"insert_table({k}) at dim 100" for k in (1, 2, 3)]
    assert dict(bc._small_table_entries(4, 100, 100))[
        "insert_table(3) at dim 100"] == 171700 * 100 * 4


# --------------------------------------------------------------------- card


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", 0)


@pytest.mark.cuda
@pytest.mark.parametrize("fmt", ["flat", "permcls"])
def test_result_lives_on_the_card(cuda, fmt):
    data, W = operands(4, 12, 9, seed=10)
    A = flat_from_numpy(4, 12, data, device=cuda)
    if fmt == "permcls":
        A = A.topermcls()
    out = stt.symalg.contract_all_indices_with_matrix(A, W)  # W from the host
    assert out.format == fmt and out.device.type == "cuda" and out.dim == 9
    want = bc.basis_change_packed(flat_from_numpy(4, 12, data, device="cpu"), W)
    np.testing.assert_allclose(flat_to_numpy(out), flat_to_numpy(want), rtol=1e-10)


@pytest.mark.cuda
def test_float32_against_float64_on_the_card(cuda):
    data, W = operands(5, 16, 16, seed=11)
    A = flat_from_numpy(5, 16, data, device=cuda)
    W = torch.from_numpy(W).to(cuda)
    ref = bc.basis_change_packed(A, W).data
    got = bc.basis_change_packed(A.astype(torch.float32), W.float()).data
    assert got.dtype == torch.float32
    err = float((got.double() - ref).abs().max() / ref.abs().max())
    assert err <= 1e-5, err
