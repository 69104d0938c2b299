"""The port's grouped evaluation and group pass against the JAX package.

Inputs come from each test's own seeded NumPy generator and go to both
packages. The JAX Pallas kernel runs in interpret mode, as the JAX
package's own tests run it on the CPU; the JAX references are jitted,
which is the same computation at a fraction of the eager dispatch time.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import symtensor_tpu as st
from symtensor_tpu.kernels import pallas_poly
from symtensor_tpu.kernels import poly_eval as jpe
from symtensor_tpu_torch.interop import flat_from_numpy
from symtensor_tpu_torch.kernels import poly_eval as tpe
from symtensor_tpu_torch.kernels.group_pass import (
    CHUNK,
    FIELDS,
    FIRST,
    LANE_VALUES,
    LAST,
    STAGE_BYTES,
    TRI_BYTES,
    acc_dtype,
    chunk_starts,
    group_pass,
    group_pass_ref,
    row_offsets,
    tile_table,
)
from symtensor_tpu_torch.utils import combinatorics as comb

CONSUMER_WARPS = 16  # csrc/group_pass.cu: kConsumerWarps
SHAPES = [(3, 4), (3, 7), (4, 5), (5, 4), (6, 3), (6, 5), (7, 3)]


def _pair(rank, dim, seed, dtype=np.float64):
    rng = np.random.default_rng(seed)
    data = rng.normal(size=comb.indep_size(rank, dim)).astype(dtype)
    x = rng.normal(size=dim).astype(dtype)
    Aj = st.FlatSymmetricTensor._raw(rank, dim, jnp.asarray(data))
    At = flat_from_numpy(rank, dim, data, device="cpu")
    return Aj, At, x


@pytest.mark.parametrize("rank,dim", [(3, 5), (4, 4), (6, 3)])
def test_group_pass_ref_matches_pallas_group_by_group(rank, dim):
    rng = np.random.default_rng(11 + rank)
    lay = comb.gflat_layout(rank, dim)
    vals = rng.normal(size=lay.n).astype(np.float32)
    tri = rng.normal(size=comb.tri_size(dim)).astype(np.float32)
    got = group_pass_ref(torch.from_numpy(vals), torch.from_numpy(tri), lay)
    assert got.shape == (3, int(lay.P.sum())) and got.dtype == torch.float32
    prow = row_offsets(lay)
    for j in range(dim):
        P, T = int(lay.P[j]), int(lay.T[j])
        g, to = int(lay.group_off[j]), int(lay.tri_off[j])
        V = jnp.asarray(vals[g : g + P * T].reshape(P, T))
        want = pallas_poly._group_pass(
            V, jnp.asarray(tri[to : to + T]), dim - j, interpret=True
        )
        np.testing.assert_allclose(
            got[:, prow[j] : prow[j] + P].numpy(), np.asarray(want),
            rtol=2e-5, atol=1e-6,
        )


def _split(a, count, size):
    """csrc/group_pass.cu:split_span for a span at byte address a (taken
    from a 16-byte boundary): (head, tail0, interior bytes, stage base)."""
    e = a + count * size
    a0, a1 = -(-a // 16) * 16, e // 16 * 16
    head = (min(a0, e) - a) // size
    interior = a1 - a0 if a1 > a0 else 0
    tail0 = (a1 - a) // size if interior else head
    return head, tail0, interior, 16 - (a0 - a)


def _whole_row_owners(nrows, L, rot):
    """csrc/group_pass.cu:whole_rows' assignment of a tile's rows: the
    consumer warp and lane that store each row (sub-lane 0 of the row's L
    lanes), and the next tile's rotation."""
    per_warp, per_pass = 32 // L, CONSUMER_WARPS * 32 // L
    owner = {}
    for warp in range(CONSUMER_WARPS):
        slot = (warp - rot) % CONSUMER_WARPS
        base = 0
        while base + slot * per_warp < nrows:  # the warp's loop, uniform
            for lane in range(0, 32, L):
                r = base + (slot * 32 + lane) // L
                if r < nrows:
                    assert r not in owner, "row stored twice"
                    owner[r] = (warp, lane)
            base += per_pass
    rot = (rot + (nrows - 1) % per_pass // per_warp + 1) % CONSUMER_WARPS
    return owner, rot


def _emulate_kernel(vals, tri, tiles, dim, ncols, size, offset, grid):
    """The CUDA kernel's index arithmetic (csrc/group_pass.cu), in NumPy:
    each block's chunks of tiles (from chunk_starts), each tile's split
    into a bulk-copied aligned interior and head/tail fragments loaded by
    the producer warp's lanes (storage elements of `size` bytes, `vals`
    starting `offset` elements past a 16-byte boundary), the stage those
    fill, the rows each consumer warp takes, and the whole-row and
    split-row reductions read from the stage. Sums are float64."""
    f = dict(zip(FIELDS, range(len(FIELDS))))
    ntiles, out = len(tiles), np.full((3, ncols), np.nan)
    seen = np.zeros(ntiles, dtype=int)
    starts = chunk_starts(tiles)
    nchunks = -(-ntiles // CHUNK)
    assert len(starts) == nchunks + 1 and starts[-1] == ntiles

    def walk(blk):  # block blk's tiles: chunks blk, blk + grid, ...
        for chunk in range(blk, nchunks, grid):
            yield from range(starts[chunk], starts[chunk + 1])

    for blk in range(grid):
        carry, rot = None, 0
        for t in walk(blk):
            seen[t] += 1
            j, row0, nrows, c0, c1, T, start, count, toff, prow, L, flags = (
                int(v) for v in tiles[t])
            head, tail0, interior, base = _split((offset + start) * size, count, size)
            assert interior % 16 == 0 and head * size < 16 and head <= 16
            assert count - tail0 <= 16 and (count - tail0) * size < 32
            stage = np.full((STAGE_BYTES + 32) // size, np.nan)
            # the bulk copy: from the first 16-byte boundary to the last
            n_in = interior // size
            stage[16 // size : 16 // size + n_in] = vals[start + head : start + head + n_in]
            for lane in range(32):  # the producer warp's fragment loads
                k = lane if lane < 16 else tail0 + lane - 16
                if (lane < 16 and k < head) or (lane >= 16 and k < count):
                    assert np.isnan(stage[(base + k * size) // size])
                    stage[(base + k * size) // size] = vals[start + k]
            sv = stage[base // size : base // size + count]
            assert base >= 0 and not np.isnan(sv).any()  # nothing else read
            tri_s = tri[toff + c0 : toff + c1]
            row_len = dim - j - c0
            if flags == FIRST | LAST:
                owner, rot = _whole_row_owners(nrows, L, rot)
                assert sorted(owner) == list(range(nrows))
                V = sv.reshape(nrows, T)
                part = V[:, :row_len] @ tri_s[:row_len]
                rest = V[:, row_len:] @ tri_s[row_len:]
                cols = slice(prow + row0, prow + row0 + nrows)
                assert np.isnan(out[:, cols]).all(), "column written twice"
                out[:, cols] = (part + rest, part, V[:, 0] * tri_s[0])
                continue
            x = sv * tri_s
            if flags & FIRST:
                carry = np.array([0.0, 0.0, sv[0] * tri_s[0]])
            assert carry is not None, "a block starts inside a split row"
            carry += (x.sum(), x[: max(row_len, 0)].sum(), 0.0)
            if flags & LAST:
                assert np.isnan(out[:, prow + row0]).all(), "column written twice"
                out[:, prow + row0] = carry
                carry = None
    assert (seen == 1).all()
    return out


@pytest.mark.parametrize("offset", [0, 1, 2, 3])
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32, torch.bfloat16])
@pytest.mark.parametrize("rank,dim,grid", [(3, 9, 1), (4, 6, 7), (6, 4, 3), (3, 300, 132)])
def test_tile_table_kernel_emulation_matches_twin(rank, dim, grid, dtype, offset):
    lay = comb.gflat_layout(rank, dim)
    vals, tri, want = _twin_case(rank, dim)
    tiles = tile_table(lay, dtype)
    if dim == 300:  # rows longer than a stage: split into pieces
        assert (tiles[:, FIELDS.index("flags")] != FIRST | LAST).any()
    got = _emulate_kernel(vals, tri, tiles, dim, want.shape[1], dtype.itemsize,
                          offset, grid)
    np.testing.assert_allclose(got, want, rtol=1e-12, atol=1e-12)


@functools.lru_cache(maxsize=None)
def _twin_case(rank, dim):
    """Seeded float64 values and tri, and the twin's result on them."""
    rng = np.random.default_rng(5)
    lay = comb.gflat_layout(rank, dim)
    vals = rng.normal(size=lay.n)
    tri = rng.normal(size=comb.tri_size(dim))
    want = group_pass_ref(torch.from_numpy(vals), torch.from_numpy(tri), lay)
    return vals, tri, want.numpy()


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32, torch.bfloat16])
@pytest.mark.parametrize("rank,dim", [(3, 100), (4, 100), (6, 100), (6, 110), (3, 300)])
def test_tile_table_covers_every_row_once(rank, dim, dtype):
    lay = comb.gflat_layout(rank, dim)
    tiles = tile_table(lay, dtype)
    assert tiles.dtype == np.int64 and tiles.shape[1] == len(FIELDS) == 12
    j, row0, nrows, c0, c1, T, start, count, toff, prow, L, flags = tiles.T
    # tiles follow each other through the values without gap or overlap
    assert start[0] == 0 and int(start[-1] + count[-1]) == lay.n  # int64
    np.testing.assert_array_equal(start[1:], start[:-1] + count[:-1])
    np.testing.assert_array_equal(start, lay.group_off[j] + row0 * T + c0)
    np.testing.assert_array_equal(count, nrows * (c1 - c0))
    np.testing.assert_array_equal(T, lay.T[j])
    np.testing.assert_array_equal(toff, lay.tri_off[j])
    np.testing.assert_array_equal(prow, row_offsets(lay)[j])
    # a tile fits one stage, and its tri slice the tri buffer
    assert np.all(count * dtype.itemsize <= STAGE_BYTES) and np.all(count > 0)
    assert np.all((c1 - c0) * acc_dtype(dtype).itemsize <= TRI_BYTES)
    assert np.all((L & (L - 1)) == 0)
    # L: the largest power of two <= T / LANE_VALUES, between 1 and 32
    lanes = np.maximum(1, T // LANE_VALUES)
    assert np.all((1 <= L) & (L <= 32) & ((L <= lanes) | (L == 1)))
    assert np.all((L == 32) | (2 * L > lanes))
    # whole rows, as many as fit a stage (a group's last tile takes the
    # rest), or pieces of one row from column 0 to T
    whole = flags == FIRST | LAST
    last = np.append(j[1:] != j[:-1], True)
    fit = STAGE_BYTES // dtype.itemsize // T
    assert np.all((nrows == fit)[whole & ~last])
    assert np.all((nrows <= fit)[whole & last])
    assert np.all((c0 == 0) & (c1 == T) | ~whole) and np.all(nrows[~whole] == 1)
    np.testing.assert_array_equal(flags & FIRST > 0, c0 == 0)
    np.testing.assert_array_equal(flags & LAST > 0, c1 == T)
    # every output column once: whole-row tiles and first pieces
    firsts = (flags & FIRST) > 0
    np.testing.assert_array_equal(np.bincount(j[firsts], weights=nrows[firsts],
                                              minlength=dim), lay.P)
    # chunks start at row-starting tiles, in order, and cover every tile
    starts = chunk_starts(tiles)
    assert len(starts) == -(-len(tiles) // CHUNK) + 1
    assert starts[0] == 0 and starts[-1] == len(tiles)
    assert np.all(np.diff(starts) >= 0) and np.all(flags[starts[:-1][starts[:-1] < len(tiles)]] & FIRST)
    assert np.all(starts[:-1] >= np.arange(0, len(tiles), CHUNK))


@pytest.mark.parametrize("L", [1, 2, 4, 8, 16, 32])
@pytest.mark.parametrize("nrows", [1, 2, 3, 15, 16, 17, 100, 513, 8192])
def test_whole_rows_are_stored_once_and_the_next_tile_rotates(L, nrows):
    for rot in (0, 5, CONSUMER_WARPS - 1):
        owner, nxt = _whole_row_owners(nrows, L, rot)
        assert sorted(owner) == list(range(nrows))
        # the tile's first row goes to warp `rot`; the next tile's to the
        # warp after the one that stored the last row of the last pass
        assert owner[0] == (rot, 0)
        assert nxt == (owner[nrows - 1][0] + 1) % CONSUMER_WARPS


@pytest.mark.parametrize("rank,dim", SHAPES)
def test_plain_and_fast_match_jax_float64(rank, dim):
    Aj, At, x = _pair(rank, dim, 20 + 3 * rank + dim)
    want = float(jax.jit(jpe.poly_eval_flat)(Aj, jnp.asarray(x)))
    pallas = float(pallas_poly.poly_eval_flat_pallas(Aj, jnp.asarray(x), interpret=True))
    xt = torch.from_numpy(x)
    for got in (tpe.poly_eval_flat(At, xt), tpe.poly_eval_flat_fast(At, xt)):
        assert got.dtype == torch.float64 and got.shape == ()
        np.testing.assert_allclose(float(got), want, rtol=1e-10)
        np.testing.assert_allclose(float(got), pallas, rtol=1e-10)


@pytest.mark.parametrize("rank,dim", [(3, 5), (4, 8), (6, 4)])
def test_bfloat16_storage_within_2e_2_of_float32(rank, dim):
    _, At, x = _pair(rank, dim, 7, np.float32)
    xt = torch.from_numpy(x)
    ref = float(tpe.poly_eval_flat(At, xt))
    A16 = At.astype(torch.bfloat16)
    for got in (tpe.poly_eval_flat(A16, xt), tpe.poly_eval_flat_fast(A16, xt)):
        assert got.dtype == torch.float32
        np.testing.assert_allclose(float(got), ref, rtol=2e-2)


@pytest.mark.parametrize("rank,dim", [(0, 1), (1, 4), (2, 5), (3, 5), (4, 4), (6, 3)])
def test_batched_matches_jax_float64(rank, dim):
    Aj, At, _ = _pair(rank, dim, 40 + rank)
    xs = np.random.default_rng(41 + rank).normal(size=(6, dim))
    want = np.asarray(jax.jit(jpe.poly_eval_flat_batched)(Aj, jnp.asarray(xs)))
    got = tpe.poly_eval_flat_batched(At, torch.from_numpy(xs))
    assert got.shape == (6,) and got.dtype == torch.float64
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-10)


def test_group_pass_cpu_uses_twin_and_counts_no_launch():
    lay = comb.gflat_layout(4, 4)
    vals = torch.randn(lay.n, dtype=torch.float64)
    tri = torch.randn(comb.tri_size(4), dtype=torch.float64)
    before = group_pass.launches
    torch.testing.assert_close(
        group_pass(vals, tri, lay), group_pass_ref(vals, tri, lay),
        rtol=0, atol=0,
    )
    assert group_pass.launches == before


BAD_INPUTS = {
    "rank 2": (2, torch.float32, torch.float32, None, ValueError),
    "int values": (4, torch.int32, torch.float32, None, TypeError),
    "tri dtype": (4, torch.float32, torch.float64, None, TypeError),
    "bf16 tri": (4, torch.bfloat16, torch.bfloat16, None, TypeError),
    "short": (4, torch.float32, torch.float32, "short", ValueError),
    "strided": (4, torch.float32, torch.float32, "strided", ValueError),
    "meta": (4, torch.float32, torch.float32, "meta", ValueError),
}


@pytest.mark.parametrize("case", sorted(BAD_INPUTS))
def test_group_pass_rejects_what_the_kernel_does_not_take(case):
    rank, vdt, tdt, how, err = BAD_INPUTS[case]
    lay = comb.gflat_layout(rank, 4)
    vals = torch.zeros(lay.n * (2 if how == "strided" else 1), dtype=vdt)
    if how == "strided":
        vals = vals[::2]
    if how == "short":
        vals = vals[:-1]
    tri = torch.zeros(comb.tri_size(4), dtype=tdt)
    if how == "meta":
        vals, tri = vals.to("meta"), tri.to("meta")
    with pytest.raises(err):
        group_pass(vals, tri, lay)
