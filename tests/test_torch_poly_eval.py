"""The port's grouped evaluation and group pass against the JAX package.

Inputs come from each test's own seeded NumPy generator and go to both
packages. The JAX Pallas kernel runs in interpret mode, as the JAX
package's own tests run it on the CPU; the JAX references are jitted,
which is the same computation at a fraction of the eager dispatch time.
"""

import itertools

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
    ROWS,
    THREADS,
    group_pass,
    group_pass_ref,
    row_offsets,
    tile_table,
)
from symtensor_tpu_torch.utils import combinatorics as comb

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


def _emulate_kernel(vals, tri, tiles, dim, ncols):
    """The CUDA kernel's index arithmetic, block by block and lane by lane
    (csrc/group_pass.cu), in NumPy: a check of the tile table and of the
    row/rest split that the CPU can run."""
    out = np.full((3, ncols), np.nan)
    for j, row0, nrows, T, goff, toff, prow, L in tiles:
        nseg = THREADS // L
        row_len = dim - j
        for base in range(0, nrows, nseg * ROWS):
            for seg, k in itertools.product(range(nseg), range(ROWS)):
                r = base + seg + k * nseg
                if r >= nrows:
                    continue
                v = vals[goff + (row0 + r) * T :]
                part = rest = cell = 0.0
                for sub in range(L):
                    ts = np.arange(sub, T, L)
                    head, tail = ts[ts < row_len], ts[ts >= row_len]
                    part += float(v[head] @ tri[toff + head])
                    rest += float(v[tail] @ tri[toff + tail])
                    if sub == 0:
                        cell = v[0] * tri[toff]
                c = prow + row0 + r
                assert np.isnan(out[0, c]), "column written twice"
                out[:, c] = (part + rest, part, cell)
    return out


@pytest.mark.parametrize("rank,dim", [(3, 9), (4, 6), (6, 4)])
def test_tile_table_kernel_emulation_matches_twin(rank, dim):
    rng = np.random.default_rng(5)
    lay = comb.gflat_layout(rank, dim)
    vals = rng.normal(size=lay.n)
    tri = rng.normal(size=comb.tri_size(dim))
    ncols = int(lay.P.sum())
    got = _emulate_kernel(vals, tri, tile_table(lay), dim, ncols)
    want = group_pass_ref(torch.from_numpy(vals), torch.from_numpy(tri), lay)
    np.testing.assert_allclose(got, want.numpy(), rtol=1e-12, atol=1e-12)


@pytest.mark.parametrize("rank,dim", [(3, 100), (4, 100), (6, 100), (6, 110)])
def test_tile_table_covers_every_row_once(rank, dim):
    lay = comb.gflat_layout(rank, dim)
    tiles = tile_table(lay)
    assert tiles.dtype == np.int64 and 0 < len(tiles) < 2**31 - 1
    j, row0, nrows, T, goff, toff, prow, L = tiles.T
    assert np.all(nrows > 0) and np.all((L & (L - 1)) == 0)
    assert np.all((L <= T) & (L <= 32) & ((L == 32) | (2 * L > T)))
    np.testing.assert_array_equal(np.bincount(j, weights=nrows), lay.P)
    # tiles of a group follow each other without gap or overlap
    ends = row0 + nrows
    same = j[1:] == j[:-1]
    np.testing.assert_array_equal(row0[1:][same], ends[:-1][same])
    assert int((goff + (row0 + nrows) * T).max()) == lay.n  # int64 offsets


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
