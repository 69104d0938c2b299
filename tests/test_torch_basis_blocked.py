"""The port's blocked basis change, its root pass and the on-the-fly
ranking against the JAX package's, on the CPU, in float64 unless stated.

The same NumPy inputs, made from a seed, go through both packages with the
same `block_elems` and `transient_elems`; the JAX package's blocked route
runs its jitted step programs on the CPU. Beside it stand the port's own
whole-level route and the dense einsum.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import symtensor_tpu as st
import symtensor_tpu_torch as stt
from symtensor_tpu.ops import basis_change as jax_bc
from symtensor_tpu.ops import basis_root as jax_root
from symtensor_tpu_torch.config import config
from symtensor_tpu_torch.interop import flat_from_numpy, flat_to_numpy
from symtensor_tpu_torch.ops import basis_change as bc
from symtensor_tpu_torch.ops import basis_root as br
from symtensor_tpu_torch.testing import random_symmetric
from symtensor_tpu_torch.utils import combinatorics as comb
from symtensor_tpu_torch.utils.tables import Tables, tables

from test_torch_basis_change import LiveElements

# the budget pairs of the JAX package's own sweep (tests/test_symalg.py)
BUDGETS = [(17, 23), (64, 32), (500, 4096)]
f64 = torch.float64


@pytest.fixture(autouse=True)
def _cpu_default_device(monkeypatch):
    monkeypatch.setattr(config, "default_device", "cpu")


def operands(rank, dim, d_out, seed=0):
    rng = np.random.default_rng([seed, rank, dim, d_out])
    return rng.normal(size=comb.indep_size(rank, dim)), rng.normal(size=(dim, d_out))


def jax_blocked(rank, dim, data, W, **kw):
    A = st.FlatSymmetricTensor._raw(rank, dim, jnp.asarray(data))
    return np.asarray(jax_bc.basis_change_packed(A, jnp.asarray(W), **kw).data)


def blocked(rank, dim, data, W, **kw):
    A = flat_from_numpy(rank, dim, np.asarray(data), device="cpu")
    out = bc.basis_change_packed(A, torch.from_numpy(W), **kw)
    assert bc.last_call["route"] == "blocked"
    return out


def whole_level(rank, dim, data, W, budget=2**26, **kw):
    return bc._basis_change_levels(
        torch.from_numpy(data), torch.from_numpy(W), rank, dim, W.shape[1],
        f64, f64, budget, **kw).numpy()


def nerr(got, want):
    return float(np.abs(got - want).max() / np.abs(want).max())


# --------------------------------------------------------------- root pass


@pytest.mark.parametrize("d", [3, 4, 5, 6])
@pytest.mark.parametrize("k", [3, 4, 5])
def test_root_tables_match_jax(k, d):
    """``bundle_table`` and ``head_insert_table`` element for element."""
    J, IH = br.bundle_table(d), br.head_insert_table(k - 3, d)
    assert J.dtype == np.int64 and IH.dtype == np.int64
    np.testing.assert_array_equal(J, jax_root.bundle_table(d))
    np.testing.assert_array_equal(IH, jax_root.head_insert_table(k - 3, d))
    assert br.group_shapes(k, d) == jax_root.group_shapes(k, d)
    IH_dev, J_dev = br.root_tables(k, d, "cpu")
    np.testing.assert_array_equal(J_dev.numpy(), J)
    np.testing.assert_array_equal(IH_dev.numpy(), IH)
    assert br.root_tables(k, d, "cpu")[0] is IH_dev  # memoized


@pytest.mark.parametrize("k,d", [(3, 3), (3, 4), (3, 7), (4, 5), (4, 6),
                                 (5, 3), (5, 6), (6, 5)])
def test_root_pass_matches_the_oracles(k, d):
    """As the JAX package's ``test_root_kernel_vs_oracle``: a window of 3
    columns from b_lo = 2 of a (d, d + 2) matrix."""
    rng = np.random.default_rng(k * 31 + d)
    A = rng.normal(size=comb.indep_size(k + 1, d))
    W = rng.normal(size=(d, d + 2))
    width, b_lo = 3, 2
    got = br.root_pass(torch.from_numpy(A), torch.from_numpy(W)[:, b_lo:b_lo + width],
                       k, d, 2**20, f64)
    assert got.shape == (width, comb.indep_size(k, d)) and got.dtype == f64
    want = jax_root.root_pass_oracle(A, W, k, d, b_lo, width)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-10)
    np.testing.assert_allclose(br.root_pass_oracle(A, W, k, d, b_lo, width), want,
                               rtol=0, atol=1e-12)


@pytest.mark.parametrize("tile_elems", [1, 64, 100])
def test_root_pass_tiling_changes_nothing(tile_elems):
    k, d, width = 4, 7, 4
    rng = np.random.default_rng(0)
    A = torch.from_numpy(rng.normal(size=comb.indep_size(k + 1, d)))
    W = torch.from_numpy(rng.normal(size=(d, width)))
    assert any(br.tile_rows(k, d, g, tile_elems) < comb.tri_size(d - g)
               for g in range(d))
    big = br.root_pass(A, W, k, d, 2**20, f64)
    small = br.root_pass(A, W, k, d, tile_elems, f64)
    np.testing.assert_allclose(small.numpy(), big.numpy(), rtol=0, atol=1e-12)


def test_root_pass_reads_views_and_keeps_types():
    """The group blocks are views of the flat parent: the pass allocates
    its bundle, tile and result, never a copy of the parent; bfloat16
    parents give a bfloat16 block within bfloat16 rounding."""
    k, d, width = 4, 6, 3
    rng = np.random.default_rng(2)
    A = torch.from_numpy(rng.normal(size=comb.indep_size(k + 1, d)))
    W = torch.from_numpy(rng.normal(size=(d, width)))
    with LiveElements() as mode:
        want = br.root_pass(A, W, k, d, 2**20, f64)
    # the views count A's storage once; a copy of it would count it twice
    assert mode.peak <= (A.numel() + want.numel()
                         + br.root_pass_peak_elems(k, d, width, 2**20))
    got = br.root_pass(A.bfloat16(), W.bfloat16(), k, d, 2**20, torch.bfloat16)
    assert got.dtype == torch.bfloat16
    assert nerr(got.double().numpy(), want.numpy()) <= 2e-2
    with pytest.raises(ValueError, match="child rank >= 3"):
        br.root_pass(A, W, 2, d, 2**20, f64)


# ----------------------------------------------------- against the JAX route


@pytest.mark.parametrize("d_out", [2, 4, 5])
@pytest.mark.parametrize("block_elems,transient_elems", BUDGETS)
def test_budget_sweep_matches_jax(block_elems, transient_elems, d_out):
    """Rank 3 dim 4 under the three budget pairs, d_out below, at and
    above dim (a window that overhangs d_out is sliced exactly)."""
    data, W = operands(3, 4, d_out)
    kw = dict(block_elems=block_elems, transient_elems=transient_elems)
    got = blocked(3, 4, data, W, **kw)
    assert got.dim == d_out and got.dtype == f64
    np.testing.assert_allclose(flat_to_numpy(got), jax_blocked(3, 4, data, W, **kw),
                               rtol=1e-10, atol=1e-13)


@pytest.mark.parametrize("rank,dim,d_out,budgets", [
    (2, 4, 3, (64, 32)), (2, 5, 5, (500, 4096)), (4, 4, 4, (64, 32)),
    (4, 5, 3, (500, 4096)), (5, 4, 4, (64, 32)), (5, 3, 4, (500, 4096)),
    (6, 3, 3, (500, 4096)), (6, 3, 4, (64, 32)), (4, 3, 1, (17, 23)),
])
def test_ranks_and_rectangular_w_match_jax(rank, dim, d_out, budgets):
    data, W = operands(rank, dim, d_out, seed=1)
    kw = dict(block_elems=budgets[0], transient_elems=budgets[1])
    got = blocked(rank, dim, data, W, **kw)
    np.testing.assert_allclose(flat_to_numpy(got), jax_blocked(rank, dim, data, W, **kw),
                               rtol=1e-10, atol=1e-13)
    np.testing.assert_allclose(flat_to_numpy(got), whole_level(rank, dim, data, W),
                               rtol=1e-10, atol=1e-13)


def test_onthefly_positions_match_jax():
    """`onthefly_above=0` ranks every level's insert positions on the
    device (``tests/test_symalg.py``, ``test_basis_change_onthefly_positions``)."""
    data, W = operands(4, 6, 6, seed=2)
    got = blocked(4, 6, data, W, onthefly_above=0)
    np.testing.assert_allclose(
        flat_to_numpy(got), jax_blocked(4, 6, data, W, onthefly_above=0),
        rtol=1e-10, atol=1e-13)


@pytest.mark.parametrize("d_out", [4, 5, 6])
def test_per_row_path_matches_jax(monkeypatch, d_out):
    """Levels ≥ 1 swept row by row through the root pass, forced on in both
    packages, with windows narrower than d_out."""
    rank, dim = 5, 5
    monkeypatch.setenv("SYMTENSOR_BASIS_ROW_INCID", "1")
    monkeypatch.setenv("SYMTENSOR_BASIS_ROW_WINDOW", "3")
    monkeypatch.setattr(bc, "_ROW_PASS_INCID", 1)
    data, W = operands(rank, dim, d_out, seed=3)
    kw = dict(block_elems=4000, transient_elems=4096)
    got = blocked(rank, dim, data, W, **kw)
    assert bc.last_call["row_windows"] > 0
    np.testing.assert_allclose(flat_to_numpy(got), jax_blocked(rank, dim, data, W, **kw),
                               rtol=1e-10, atol=1e-13)


def test_row_budgets_follow_the_jax_rule():
    for r, d, d_out, total in ((6, 100, 100, 2**32), (5, 100, 100, 2**32),
                               (6, 50, 50, 2**28), (4, 9, 7, 600), (3, 4, 5, 17)):
        widths = [comb.indep_size(r - t, d) for t in range(r + 1)]
        got = bc._row_budgets(r, d_out, widths, total, 77)
        want = jax_bc._row_budgets(r, d_out, widths, total)
        assert got[:r] == want[:r]
        assert got[r] == min(77, comb.multiset_count(d_out, r))


def test_rows_override_from_the_environment(monkeypatch):
    monkeypatch.setenv("SYMTENSOR_BASIS_ROWS", "1:2,3:5,9:1")
    data, W = operands(4, 5, 5, seed=4)
    got = blocked(4, 5, data, W, block_elems=10**6)
    assert bc.last_call["rows"][0] == 2 and bc.last_call["rows"][2] == 5
    assert bc.last_call["root_windows"] == 3
    np.testing.assert_allclose(flat_to_numpy(got), whole_level(4, 5, data, W),
                               rtol=1e-10, atol=1e-13)


# ------------------------------------------- the port's routes and the oracle


@pytest.mark.parametrize("rank,dim,d_out", [(2, 5, 4), (3, 5, 5), (4, 4, 5),
                                            (5, 4, 3), (6, 3, 3)])
def test_blocked_equals_whole_level_equals_dense_oracle(rank, dim, d_out):
    rng = np.random.default_rng([5, rank, dim, d_out])
    dense = random_symmetric(rank, dim, rng)
    W = rng.normal(size=(dim, d_out))
    A = stt.FlatSymmetricTensor.from_dense(torch.from_numpy(dense))
    ins, outs = "abcdef"[:rank], "ijklmn"[:rank]
    spec = ins + "," + ",".join(f"{i}{o}" for i, o in zip(ins, outs)) + "->" + outs
    oracle = np.einsum(spec, dense, *[W] * rank)
    small = bc.basis_change_packed(A, W)
    assert bc.last_call["route"] == "whole-level"
    np.testing.assert_allclose(small.todense().numpy(), oracle, atol=1e-9)
    for budgets in BUDGETS:
        got = bc.basis_change_packed(A, W, block_elems=budgets[0],
                                     transient_elems=budgets[1])
        assert bc.last_call["route"] == "blocked"
        np.testing.assert_allclose(got.todense().numpy(), oracle, atol=1e-9)
        np.testing.assert_allclose(flat_to_numpy(got), flat_to_numpy(small),
                                   rtol=1e-10, atol=1e-12)


def test_small_budgets_force_blocks_at_every_level_and_an_over_budget_group(monkeypatch):
    """Rank 4 dim 5 under 17 block elements: one row a level, so every
    group of more than one parent is cut into parent-prefix pieces."""
    calls = []
    chunk = bc._Blocked.chunk

    def spy(self, t, blk, b_lo, b_hi, row0, cnts):
        calls.append((t, b_hi - b_lo, row0, tuple(cnts)))
        return chunk(self, t, blk, b_lo, b_hi, row0, cnts)

    monkeypatch.setattr(bc._Blocked, "chunk", spy)
    data, W = operands(4, 5, 5, seed=6)
    got = blocked(4, 5, data, W, block_elems=17, transient_elems=23)
    assert bc.last_call["rows"] == [1, 1, 1, 23]
    assert bc.last_call["root_windows"] == 5
    assert {t for t, *_ in calls} == {1, 2, 3}
    np.testing.assert_allclose(flat_to_numpy(got), whole_level(4, 5, data, W),
                               rtol=1e-10, atol=1e-13)
    # a wider budget: windows of several columns, and still a group over it
    calls.clear()
    got = blocked(4, 5, data, W, block_elems=400, transient_elems=7)
    assert any(width > 1 for _, width, _, _ in calls)
    assert any(row0 > 0 for _, _, row0, _ in calls)
    assert bc.last_call["segments"] > bc.last_call["chunks"] - bc.last_call["emits"]
    np.testing.assert_allclose(flat_to_numpy(got), whole_level(4, 5, data, W),
                               rtol=1e-10, atol=1e-13)


@pytest.mark.parametrize("rank,dim", [(2, 4), (3, 5), (4, 4), (6, 3)])
def test_identity_returns_the_values_exactly(rank, dim):
    data, _ = operands(rank, dim, dim, seed=7)
    got = blocked(rank, dim, data, np.eye(dim), block_elems=64, transient_elems=32)
    np.testing.assert_array_equal(flat_to_numpy(got), data)


@pytest.mark.parametrize("budget", [2**26, 150])
@pytest.mark.parametrize("rank,dim,d_out", [(3, 5, 4), (4, 6, 6), (5, 4, 5)])
def test_whole_level_ranked_on_the_device_equals_the_table_route(rank, dim, d_out,
                                                                 budget):
    """`onthefly_above=0` on the whole-level route; the small budget ranks
    a few columns at a time and gathers a few rows at a time."""
    data, W = operands(rank, dim, d_out, seed=8)
    want = whole_level(rank, dim, data, W)
    got = whole_level(rank, dim, data, W, budget=budget, onthefly_above=0)
    np.testing.assert_allclose(got, want, rtol=1e-12, atol=1e-12)
    if budget == 150:
        n_k = comb.indep_size(rank - 1, dim)
        assert bc._fly_cols(n_k, dim, budget) < n_k
    assert (bc._small_peak_elems(rank, dim, d_out, budget, onthefly_above=0)
            > bc._small_peak_elems(rank, dim, d_out, budget))


def test_bfloat16_blocks_and_float32_blocks():
    """bfloat16 blocks within 2e-2 of float64 (normalised), float32 blocks
    within 1e-5; the blocks of the route are in the storage type."""
    rank, dim, d_out = 5, 5, 6
    data, W = operands(rank, dim, d_out, seed=9)
    exact = whole_level(rank, dim, data, W)
    kw = dict(block_elems=5000, transient_elems=4096)
    A32 = flat_from_numpy(rank, dim, data.astype(np.float32), device="cpu")
    got = bc.basis_change_packed(A32, W, **kw)
    assert got.dtype == torch.float32
    assert nerr(flat_to_numpy(got), exact) <= 1e-5
    got = bc.basis_change_packed(A32, W, store_dtype=torch.bfloat16, **kw)
    assert got.dtype == torch.bfloat16
    assert nerr(got.data.double().numpy(), exact) <= 2e-2
    want = st.symalg.contract_all_indices_with_matrix(
        st.FlatSymmetricTensor._raw(rank, dim, jnp.asarray(data, jnp.float32)),
        jnp.asarray(W, jnp.float32), store_dtype=jnp.bfloat16, **kw)
    assert nerr(got.data.double().numpy(),
                np.asarray(want.data.astype(jnp.float64))) <= 2e-2
    # float64 accumulation over float32 blocks
    got = bc.basis_change_packed(A32, W, acc_dtype=f64, **kw)
    assert got.dtype == torch.float32 and nerr(flat_to_numpy(got), exact) <= 1e-6


# ------------------------------------------------------ routing and residency


def test_default_call_past_the_gate_runs_blocked(monkeypatch):
    rank, dim = 4, 7
    data, W = operands(rank, dim, dim, seed=10)
    A = flat_from_numpy(rank, dim, data, device="cpu")
    want = bc.basis_change_packed(A, W)
    assert bc.last_call["route"] == "whole-level"
    monkeypatch.setenv("SYMTENSOR_BASIS_SMALL_ELEMS", "100")
    for fmt in ("flat", "permcls"):
        got = stt.symalg.contract_all_indices_with_matrix(
            A.topermcls() if fmt == "permcls" else A, W)
        assert bc.last_call["route"] == "blocked" and got.format == fmt
        np.testing.assert_allclose(flat_to_numpy(got.toflat()), flat_to_numpy(want),
                                   rtol=1e-10, atol=1e-13)
    monkeypatch.delenv("SYMTENSOR_BASIS_SMALL_ELEMS")
    # the budgets' environment variables select the blocked route too
    monkeypatch.setenv("SYMTENSOR_BASIS_BLOCK_ELEMS", "300")
    bc.basis_change_packed(A, W)
    assert bc.last_call["route"] == "blocked" and bc.last_call["rows"][0] == 1
    # a mesh selects the parallel layer's route, which takes a DeviceMesh
    with pytest.raises(TypeError, match="DeviceMesh"):
        bc.basis_change_packed(A, W, mesh=object())


@pytest.mark.parametrize("budgets", [(300, 200), (5000, 4096)])
def test_live_elements_stay_under_the_projection(budgets):
    rank, dim, d_out = 4, 6, 6
    data, W = operands(rank, dim, d_out, seed=11)
    A = flat_from_numpy(rank, dim, data, device="cpu")
    Wt = torch.from_numpy(W)
    kw = dict(block_elems=budgets[0], transient_elems=budgets[1])
    bc.basis_change_packed(A, Wt, **kw)  # tables are not residency
    with LiveElements() as mode:
        out = bc.basis_change_packed(A, Wt, **kw)
    projected = bc.last_call["projected_elems"]
    widths = [comb.indep_size(rank - t, dim) for t in range(rank + 1)]
    R = bc._row_budgets(rank, d_out, widths, budgets[0], budgets[1])
    assert projected == bc._blocked_peak_elems(rank, dim, d_out, R, budgets[1])
    assert projected >= out.data.numel()
    # W in the products' type is the one copy on top of the projection
    assert mode.peak <= projected + W.size
    if budgets[0] == 300:
        # no level is ever whole: the largest holds 21 × 56 elements
        assert mode.peak < 21 * 56


def test_a_failing_ranking_surfaces_on_either_route(monkeypatch):
    """Nothing falls back: an error in ``position_insert_T`` is the call's
    error, on the blocked route and on the whole-level route."""
    def broken(self, rep_T):
        raise RuntimeError("ranking failed on purpose")

    data, W = operands(4, 5, 5, seed=12)
    A = flat_from_numpy(4, 5, data, device="cpu")
    bc.basis_change_packed(A, W, onthefly_above=0)
    monkeypatch.setattr(Tables, "position_insert_T", broken)
    with pytest.raises(RuntimeError, match="ranking failed on purpose"):
        bc.basis_change_packed(A, W, onthefly_above=0)
    monkeypatch.setattr(config, "max_table_entries",
                        comb.indep_size(3, 5) * 5 * 4 - 1)
    with pytest.raises(RuntimeError, match="ranking failed on purpose"):
        bc.basis_change_packed(A, W)
    assert bc.last_call["route"] == "whole-level"


def test_a_table_past_the_guard_raises_memory_error(monkeypatch):
    """What stays refusable: `onthefly_above` asks for an insert table that
    the tables' guard refuses."""
    data, W = operands(3, 12, 3, seed=13)
    A = flat_from_numpy(3, 12, data, device="cpu")
    monkeypatch.setattr(config, "max_table_entries", 2000)
    with pytest.raises(MemoryError, match=r"insert_table\(2\)"):
        bc.basis_change_packed(A, W, onthefly_above=10**9)
    assert bc.basis_change_packed(A, W, block_elems=5000).dim == 3


def test_gradients_follow_the_blocked_route():
    rank, dim, d_out = 4, 5, 4
    data, W = operands(rank, dim, d_out, seed=14)
    grads = []
    for kw in (dict(block_elems=300, transient_elems=200), {}):
        values = torch.from_numpy(data).requires_grad_()
        w = torch.from_numpy(W).requires_grad_()
        out = bc.basis_change_packed(
            stt.FlatSymmetricTensor._raw(rank, dim, values), w, **kw)
        assert out.data.requires_grad
        (out.data ** 2).sum().backward()
        grads.append((values.grad, w.grad))
    assert bc.last_call["route"] == "whole-level"
    for got, want in zip(*grads):
        np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-10)


def test_donate_root_frees_only_a_copied_root():
    rank, dim = 4, 5
    data, W = operands(rank, dim, dim, seed=15)
    A = flat_from_numpy(rank, dim, data.astype(np.float32), device="cpu")
    want = bc.basis_change_packed(A, W, block_elems=5000)
    same = bc.basis_change_packed(A, W, block_elems=5000, donate_root=True)
    assert A.data.numel() == comb.indep_size(rank, dim)  # read in place
    np.testing.assert_array_equal(flat_to_numpy(same), flat_to_numpy(want))
    half = bc.basis_change_packed(A, W, block_elems=5000, donate_root=True,
                                  store_dtype=torch.bfloat16)
    assert A.data.numel() == 0  # the bfloat16 copy was read
    assert nerr(half.data.double().numpy(), flat_to_numpy(want).astype(np.float64)) <= 2e-2


# --------------------------------------------------------------------- card


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", 0)


@pytest.mark.cuda
@pytest.mark.parametrize("store", [None, torch.bfloat16])
def test_blocked_route_on_the_card(cuda, store):
    rank, dim, d_out = 5, 14, 12
    data, W = operands(rank, dim, d_out, seed=16)
    A = flat_from_numpy(rank, dim, data.astype(np.float32), device=cuda)
    kw = {"store_dtype": store} if store else {}
    got = bc.basis_change_packed(A, W.astype(np.float32), block_elems=2**16,
                                 transient_elems=2**14, onthefly_above=2000, **kw)
    assert bc.last_call["route"] == "blocked" and got.device.type == "cuda"
    want = whole_level(rank, dim, data, W)
    assert nerr(got.data.double().cpu().numpy(), want) <= (2e-2 if store else 1e-5)
