"""The port's parallel layer against the JAX package's, on the CPU.

One 4-rank gloo world serves the module (``parallel.launch.World``); its
ranks run the cases of ``symtensor_tpu_torch.testing.parallel_cases`` on
(dp, tp) meshes (2, 2), (1, 4) and (4, 1), and return NumPy values. The
inputs come from a seeded NumPy generator here, and the JAX reference
runs here, through ``symtensor_tpu.parallel`` on conftest's 8 virtual
devices, on a mesh of the same shape. float64 throughout: normalised error
at most 1e-10 (the sums are reordered), gradients 1e-9.
"""

import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import symtensor_tpu as st
from symtensor_tpu import parallel as jpar
from symtensor_tpu_torch.parallel import launch
from symtensor_tpu_torch.testing import parallel_cases as pc

SHAPES = [(2, 2), (1, 4), (4, 1)]


class SharedWorld:
    """The module's 4-rank world, started anew if a failed case ended it."""

    def __init__(self):
        self.w = None

    def run(self, fn, *args):
        if self.w is None or self.w.closed:
            self.w = launch.World(4, backend="gloo", device="cpu", timeout_s=180)
        return self.w.run(fn, *args)


@pytest.fixture(scope="module")
def world():
    shared = SharedWorld()
    yield shared
    if shared.w is not None:
        shared.w.close()


@pytest.fixture(scope="module")
def jmesh():
    assert len(jax.devices()) >= 4
    meshes = {}

    def get(shape):
        if shape not in meshes:
            meshes[shape] = jpar.make_mesh(shape, ("dp", "tp"))
        return meshes[shape]

    return get


def nerr(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, (got.shape, want.shape)
    return float(np.abs(got - want).max() / np.abs(want).max())


def jflat(rank, dim, vals):
    return st.FlatSymmetricTensor._raw(rank, dim, jnp.asarray(vals))


def same_on_every_rank(results, key=None):
    pick = (lambda r: r[key]) if key is not None else (lambda r: r)
    for r in results[1:]:
        np.testing.assert_array_equal(pick(r), pick(results[0]))
    return pick(results[0])


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("rank,dim,batch", [(3, 10, 8), (2, 9, 4)])
def test_colex_eval_and_gradients_match_jax(world, jmesh, shape, rank, dim, batch):
    """The colex route's outputs and the gradients of their sum in the
    values and in xs; n = 45 at rank 2 dim 9 pads over tp. At tp > 1 a
    gradient counted once per tp rank would be off by the factor tp."""
    rng = np.random.default_rng(rank * 100 + dim)
    vals = rng.normal(size=st.utils.indep_size(rank, dim))
    xs = rng.normal(size=(batch, dim))
    results = world.run(pc.colex_eval, shape, rank, dim, vals, xs)
    out, gv, gx = results[0]
    for r in results[1:]:
        for a, b in zip(r, results[0]):
            np.testing.assert_allclose(a, b, rtol=1e-12)
    mesh = jmesh(shape)

    def f(v, x):
        y = jpar.poly_eval_batched_sharded(jflat(rank, dim, v), x, mesh)
        return y.sum(), y

    def f1(v, x):
        A = jflat(rank, dim, v)
        return jax.vmap(lambda xx: st.symalg.contract_all_indices_with_vector(A, xx))(x).sum()

    v, x = jnp.asarray(vals), jnp.asarray(xs)
    (_, want), (_, wx) = jax.jit(jax.value_and_grad(f, argnums=(0, 1), has_aux=True))(v, x)
    # the values' gradient of the unsharded op: the JAX package's jitted
    # sharded gradient is wrong at the padding on a (2, 2) mesh (3× on
    # value 0 at rank 2 dim 9; its eager gradient is right; ROADMAP queue 3)
    wv, wx1 = jax.jit(jax.grad(f1, argnums=(0, 1)))(v, x)
    assert nerr(out, want) <= 1e-10
    assert nerr(gv, wv) <= 1e-9
    assert nerr(gx, wx) <= 1e-9 and nerr(gx, wx1) <= 1e-9
    if rank == 2:  # the dense oracle of the JAX test
        dense = np.asarray(jflat(rank, dim, vals).todense())
        assert nerr(gx, 2 * np.einsum("ij,bj->bi", dense, xs)) <= 1e-9


def test_shard_flat_placement(world, jmesh):
    rng = np.random.default_rng(15)
    vals, x = rng.normal(size=120), rng.normal(size=15)  # rank 2 dim 15
    res = world.run(pc.flat_placement, (2, 2), 2, 15, vals, x)
    for r in res:
        assert r["placements"] == ["R", "S(0)"] and r["local"] == 60 and r["whole"]
        assert "45 not divisible" in r["indivisible"]
        # no op outside the layer computes on the local shard
        for op, err in r["outside"].items():
            assert err is not None and "symtensor_tpu_torch.parallel" in err, op
    want = st.symalg.contract_all_indices_with_vector(jflat(2, 15, vals), jnp.asarray(x))
    assert nerr(res[0]["eval"], [float(want)]) <= 1e-10


@pytest.mark.parametrize("rank,dim", [(3, 8), (4, 9), (5, 6), (2, 9)])
def test_grouped_eval_matches_jax(world, jmesh, rank, dim):
    """Every group's head axis over tp; below rank 3 data-parallel only."""
    rng = np.random.default_rng(rank * 10 + dim)
    vals = rng.normal(size=st.utils.indep_size(rank, dim))
    xs = rng.normal(size=(8, dim))
    res = world.run(pc.grouped_eval, (2, 2), rank, dim, vals, xs)
    out = same_on_every_rank(res, "out")
    np.testing.assert_array_equal(res[0]["again"], out)
    want = jpar.poly_eval_batched_sharded_grouped(jflat(rank, dim, vals), jnp.asarray(xs),
                                                  jmesh((2, 2)))
    assert nerr(out, want) <= 1e-10
    if rank < 3:
        return
    # the views actually live sharded: some group is split, and a rank
    # holds fewer values than the tensor
    assert any(m != "replicated" for m in res[0]["modes"])
    assert res[0]["local"] < res[0]["n"]


@pytest.mark.parametrize("shape", [(1, 4), (4, 1)])
def test_grouped_eval_replicated_groups(world, jmesh, shape):
    """At rank 4 dim 9 over tp = 4 some groups divide neither P_j nor T_j:
    they are added by one tp rank alone (else the sum over tp counts them
    tp times). At tp = 1 every group is split by rows."""
    rng = np.random.default_rng(49)
    vals = rng.normal(size=st.utils.indep_size(4, 9))
    xs = rng.normal(size=(8, 9))
    res = world.run(pc.grouped_eval, shape, 4, 9, vals, xs)
    modes = res[0]["modes"]
    if shape[1] == 4:
        assert "replicated" in modes
    else:
        assert set(modes) == {"rows"}
    want = jpar.poly_eval_batched_sharded_grouped(jflat(4, 9, vals), jnp.asarray(xs),
                                                  jmesh(shape))
    assert nerr(same_on_every_rank(res, "out"), want) <= 1e-10
    # the gradient in xs counts each group once, the replicated ones too
    import symtensor_tpu_torch as stt
    from symtensor_tpu_torch.kernels.poly_eval import poly_eval_flat_batched

    x = torch.from_numpy(xs).requires_grad_()
    poly_eval_flat_batched(stt.FlatSymmetricTensor(4, 9, torch.from_numpy(vals)), x).sum().backward()
    assert nerr(same_on_every_rank(res, "dx"), x.grad.numpy()) <= 1e-9


@pytest.mark.parametrize("rank,dim", [(3, 6), (4, 5)])
def test_basis_change_sharded_matches_jax(world, jmesh, rank, dim):
    """Column-sharded blocked basis change, small blocks forcing many
    chunks; the result's values are tp-sharded."""
    from symtensor_tpu.ops.basis_change import basis_change_packed

    rng = np.random.default_rng(rank + dim)
    vals = rng.normal(size=st.utils.indep_size(rank, dim))
    W = rng.normal(size=(dim, dim))
    res = world.run(pc.basis, (2, 2), rank, dim, vals, W, 500)
    got = same_on_every_rank(res, "data")
    want = basis_change_packed(jflat(rank, dim, vals), jnp.asarray(W), mesh=jmesh((2, 2)),
                               block_elems=500)
    assert nerr(got, want.data) <= 1e-10
    n_out = st.utils.indep_size(rank, dim)
    for r in res:
        assert r["placements"] == ["R", "S(0)"] and r["route"] == "blocked, sharded"
        assert r["local"] == -(-n_out // 2)


@pytest.mark.parametrize("shape", [(2, 2), (1, 4)])
def test_basis_change_sharded_row_passes(world, shape):
    """Level rows swept one by one through the root pass, as the rank-6
    dim-100 tensor's level 1 is: each rank gathers the row and keeps its
    slice of the child columns."""
    from symtensor_tpu_torch.ops.basis_change import basis_change_packed
    import symtensor_tpu_torch as stt

    rng = np.random.default_rng(55)
    vals = rng.normal(size=st.utils.indep_size(5, 5))
    W = rng.normal(size=(5, 4))
    res = world.run(pc.basis, shape, 5, 5, vals, W, 300, None, "cpu", False, True)
    assert res[0]["row_windows"] > 0
    want = basis_change_packed(stt.FlatSymmetricTensor(5, 5, torch.from_numpy(vals)),
                               torch.from_numpy(W)).data.numpy()
    assert nerr(same_on_every_rank(res, "data"), want) <= 1e-10


@pytest.mark.parametrize("shape", [(2, 2), (1, 4)])
def test_basis_change_sharded_gathered_root(world, shape):
    """Where level 0's tables pass no guard (rank 6 dim 100), rank ≥ 4
    gathers the root and each rank runs the root pass on its own columns;
    the masked root step is not taken."""
    from symtensor_tpu_torch.ops.basis_change import basis_change_packed
    import symtensor_tpu_torch as stt

    rng = np.random.default_rng(64)
    vals = rng.normal(size=st.utils.indep_size(4, 6))
    W = rng.normal(size=(6, 5))
    res = world.run(pc.basis, shape, 4, 6, vals, W, 300, None, "cpu", False, True, True)
    n = st.utils.indep_size(4, 6)
    for r in res:
        assert r["root_gathered"] and r["root_shard"] == n and r["root_windows"] > 0
    want = basis_change_packed(stt.FlatSymmetricTensor(4, 6, torch.from_numpy(vals)),
                               torch.from_numpy(W)).data.numpy()
    assert nerr(same_on_every_rank(res, "data"), want) <= 1e-10


def test_basis_change_sharded_oversized_shard_gathers(world, jmesh, monkeypatch):
    """A root shard above SYMTENSOR_GATHER_MAX_BYTES is gathered in masked
    pieces inside the shard: 64 bytes force many."""
    from symtensor_tpu.ops.basis_change import basis_change_packed

    rng = np.random.default_rng(46)
    vals = rng.normal(size=st.utils.indep_size(4, 6))
    W = rng.normal(size=(6, 6))
    res = world.run(pc.basis, (2, 2), 4, 6, vals, W, 500, 64)
    monkeypatch.setenv("SYMTENSOR_GATHER_MAX_BYTES", "64")
    want = basis_change_packed(jflat(4, 6, vals), jnp.asarray(W), mesh=jmesh((2, 2)),
                               block_elems=500)
    assert nerr(same_on_every_rank(res, "data"), want.data) <= 1e-10


@pytest.mark.parametrize("shape", [(1, 4), (4, 1)])
def test_basis_change_sharded_root_memory(world, shape):
    """The root stays sharded: a rank holds ceil(n/tp) of the n root
    values, fewer than the root at tp > 1. A shard_flat input keeps its
    own shards and gives the same values."""
    from symtensor_tpu_torch.ops.basis_change import basis_change_packed
    import symtensor_tpu_torch as stt

    rank, dim = 4, 6
    n = st.utils.indep_size(rank, dim)  # 126: divides by 1, 2 and... not 4
    rng = np.random.default_rng(24)
    vals = rng.normal(size=n)
    W = rng.normal(size=(dim, dim))
    res = world.run(pc.basis, shape, rank, dim, vals, W, 500)
    tp = shape[1]
    for r in res:
        assert r["root"] == n and r["root_shard"] == -(-n // tp)
        assert not r["root_gathered"]
        if tp > 1:
            assert r["root_shard"] < r["root"]
    want = basis_change_packed(stt.FlatSymmetricTensor(rank, dim, torch.from_numpy(vals)),
                               torch.from_numpy(W)).data.numpy()
    assert nerr(same_on_every_rank(res, "data"), want) <= 1e-10
    n6 = st.utils.indep_size(2, 7)  # 28 divides by 4: a shard_flat root
    v6 = rng.normal(size=n6)
    W6 = rng.normal(size=(7, 5))
    res = world.run(pc.basis, shape, 2, 7, v6, W6, 100, None, "cpu", True)
    want = basis_change_packed(stt.FlatSymmetricTensor(2, 7, torch.from_numpy(v6)),
                               torch.from_numpy(W6)).data.numpy()
    assert nerr(same_on_every_rank(res, "data"), want) <= 1e-10


def test_model_training_sharded(world):
    """20 Adam steps of models.polynomial, the loss through
    poly_eval_batched_sharded on a (2, 2) mesh, from the JAX model's
    initial coefficients: the losses fall and equal optax's Adam on the
    JAX model step for step."""
    import optax

    from symtensor_tpu.models import polynomial

    params = polynomial.init(jax.random.PRNGKey(0), ranks=(2, 3), dim=8, dtype=jnp.float64)
    rng = np.random.default_rng(8)
    xs, ys = rng.normal(size=(16, 8)), rng.normal(size=(16,))
    optimizer = optax.adam(1e-2)
    opt_state = optimizer.init(params)

    @jax.jit
    def step(params, opt_state):
        return polynomial.train_step(params, opt_state, jnp.asarray(xs), jnp.asarray(ys),
                                     optimizer)

    want = []
    p = params
    for _ in range(20):
        p, opt_state, loss = step(p, opt_state)
        want.append(float(loss))
    terms = {t.rank: np.asarray(t.data) for t in params["terms"].values()}
    res = world.run(pc.train, (2, 2), 8, terms, np.asarray(params["bias"], np.float64),
                    xs, ys, 20, 1e-2)
    got = same_on_every_rank(res)
    assert got[-1] < got[0]
    np.testing.assert_allclose(got, want, rtol=1e-8)


@pytest.mark.parametrize("operands", ["replicated", "sharded"])
def test_tensordot_sharded_matches_jax(world, jmesh, operands):
    """Both operand modes at dim 8; in the sharded mode each rank's shard
    of an operand holds (n + pad)/tp values, fewer than n."""
    rng = np.random.default_rng(len(operands))
    tp = 2
    for ra, rb, ax in [(3, 3, 1), (2, 3, 1), (3, 3, 2)]:
        na, nb = st.utils.indep_size(ra, 8), st.utils.indep_size(rb, 8)
        a, b = rng.normal(size=na), rng.normal(size=nb)
        res = world.run(pc.tensordot, (2, 2), ra, rb, ax, 8, a, b, operands)
        got = same_on_every_rank(res, "data")
        want = jpar.tensordot_sharded(jflat(ra, 8, a), jflat(rb, 8, b), ax, jmesh((2, 2)),
                                      axis="tp", operands=operands)
        assert nerr(got, want.data) <= 1e-10
        if operands == "sharded":
            assert res[0]["shards"] == [-(-na // tp), -(-nb // tp)]
            assert res[0]["shards"][0] < na


def test_tensordot_sharded_input_keeps_its_shards(world):
    """A shard_flat operand enters the sharded mode with its own shards
    and the replicated mode gathered; both give the streamed values."""
    import symtensor_tpu_torch as stt

    rng = np.random.default_rng(3)
    a, b = rng.normal(size=120), rng.normal(size=120)  # rank 3 dim 8
    A = stt.FlatSymmetricTensor(3, 8, torch.from_numpy(a))
    B = stt.FlatSymmetricTensor(3, 8, torch.from_numpy(b))
    want = stt.symalg.tensordot(A, B, axes=1, stream=True).data.numpy()
    for operands in ("sharded", "replicated"):
        res = world.run(pc.tensordot, (1, 4), 3, 3, 1, 8, a, b, operands, "cpu", True)
        assert nerr(same_on_every_rank(res, "data"), want) <= 1e-10
        assert res[0]["shards"][0] == 30


def test_ranks_import_no_jax_and_no_test_module(world):
    assert world.run(pc.foreign_modules) == [[]] * 4


def test_dryrun_multichip_cpu(capsys):
    from symtensor_tpu_torch.parallel.dryrun import dryrun_multichip

    out = dryrun_multichip(4, device="cpu", timeout_s=180)
    line = capsys.readouterr().out
    assert "dryrun_multichip OK: mesh=(2x2)" in line and "backend gloo" in line
    assert out["replicated groups"] > 0 and out["losses"][1] < out["losses"][0]


def test_failing_rank_fails_the_world_within_its_deadline():
    """Rank 1 raises while rank 0 waits in a barrier: the caller gets rank
    1's traceback, well inside the deadline, and no worker is left."""
    t0 = time.monotonic()
    with pytest.raises(RuntimeError, match="rank 1 fails on purpose"):
        launch.spawn_world(pc.raise_on, 2, timeout_s=60, args=(1,))
    assert time.monotonic() - t0 < 60
