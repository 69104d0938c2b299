"""The batched fold kernel's host side (``kernels/batched_eval.py``), on the
CPU.

The kernel (``csrc/batched_fold.cu``) runs only on a CUDA card. These
tests hold what surrounds it: its tile list covers every (group, row,
batch tile) once, in the order it walks; ``_BatchedEval`` sends CPU
tensors and float64 to the plain twin ``_batched_forward`` and launches
nothing; the twin agrees with the JAX package in float64; and a NumPy
emulation of the kernel's walk over the route's own inputs (the tile
list, tri transposed and padded, M̃, the head codes and corrections it
decodes) gives the twin's result. Inputs come from seeded NumPy
generators and go to both packages. A NumPy emulation of the kernel's
split-TF32 product (each float32 operand as two TF32 values rounded to
nearest, three products of depth 8 at a time into float32 sums, with the
tensor cores' truncating addition as modelled in ``_mma``) on the route's
own float32 inputs stays within float32's accuracy of the float64 twin,
where one plain TF32 product does not, and the tile list's runs of at most
``ENTRY_COLUMNS`` columns keep the truncation's drift in a long group
below what one run of the group's whole K reads.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import symtensor_tpu as st
from symtensor_tpu.kernels import poly_eval as jpe
from symtensor_tpu_torch.interop import flat_from_numpy
from symtensor_tpu_torch.kernels import batched_eval as be
from symtensor_tpu_torch.kernels import poly_eval as tpe
from symtensor_tpu_torch.kernels.group_pass import HEAD_SHIFT, head_codes
from symtensor_tpu_torch.utils import combinatorics as comb

F = {name: i for i, name in enumerate(be.FIELDS)}
BM_CHOICES = (16, 64, 128)
BN_CHOICES = (32, 128)
# batches on both sides of each BM the chooser picks
BATCHES = (1, 3, 16, 17, 64, 65, 128, 129, 300, 512, 1024)


def _pair(rank, dim, batch, seed, dtype=np.float64):
    rng = np.random.default_rng(seed)
    data = rng.normal(size=comb.indep_size(rank, dim)).astype(dtype)
    xs = rng.normal(size=(batch, dim)).astype(dtype)
    Aj = st.FlatSymmetricTensor._raw(rank, dim, jnp.asarray(data))
    At = flat_from_numpy(rank, dim, data, device="cpu")
    return Aj, At, xs


def _check_tiles(layout, bn):
    """Entries by their columns nt from the largest down, and per group
    rows p0, p0 + BN, ... covering [0, P_j) once, each with its group's
    T_j and offsets, and for each of them columns t0, t0 + nt, ... covering
    [0, T_j) once in runs of at most ``ENTRY_COLUMNS``."""
    tiles = be.tile_list(layout, bn)
    assert tiles.dtype == np.int64 and tiles.shape[1] == len(be.FIELDS)
    assert (np.diff(tiles[:, F["nt"]]) <= 0).all()
    P, T = layout.P.astype(np.int64), layout.T.astype(np.int64)
    runs = -(-T // be.ENTRY_COLUMNS)
    j = tiles[:, F["j"]]
    assert (np.bincount(j, minlength=len(P)) == -(-P // bn) * runs).all()
    t = tiles[np.lexsort((tiles[:, F["t0"]], tiles[:, F["p0"]], j))]
    j = t[:, F["j"]]
    run = np.concatenate([np.arange(r) for r in runs[j[np.r_[0, np.flatnonzero(np.diff(
        t[:, F["p0"]]) | np.diff(j)) + 1]]]])
    assert (t[:, F["t0"]] == run * be.ENTRY_COLUMNS).all()
    assert (t[:, F["nt"]] == np.minimum(be.ENTRY_COLUMNS, T[j] - t[:, F["t0"]])).all()
    t = t[t[:, F["t0"]] == 0]
    j = t[:, F["j"]]
    first = np.concatenate(([0], np.cumsum(-(-P // bn))[:-1]))
    p0 = (np.arange(len(t)) - first[j]) * bn
    assert (t[:, F["p0"]] == p0).all()
    assert (t[:, F["np"]] == np.minimum(bn, P[j] - p0)).all() and (t[:, F["np"]] > 0).all()
    assert (np.bincount(j, weights=t[:, F["np"]], minlength=len(P)) == P).all()
    assert (t[:, F["T"]] == layout.T[j]).all()
    assert (t[:, F["voff"]] == layout.group_off[j] + p0 * layout.T[j]).all()
    assert (t[:, F["toff"]] == layout.tri_off[j]).all()
    return tiles


@pytest.mark.parametrize("bn", BN_CHOICES)
@pytest.mark.parametrize("rank,dim", [(r, d) for r in range(3, 8) for d in range(1, 9)]
                         + [(r, 100) for r in range(3, 8)])
def test_tile_list_covers_every_row_once(rank, dim, bn):
    layout = comb.gflat_layout(rank, dim)
    tiles = _check_tiles(layout, bn)
    if layout.n <= 5000:  # every value of every group, once
        seen = np.zeros(layout.n, np.int64)
        for e in tiles:
            for n in range(e[F["np"]]):
                row = e[F["voff"]] + n * e[F["T"]] + e[F["t0"]]
                seen[row: row + e[F["nt"]]] += 1
        assert (seen == 1).all()


@pytest.mark.parametrize("batch", BATCHES)
@pytest.mark.parametrize("rank,dim", [(3, 100), (4, 5), (4, 100), (5, 100), (6, 3), (6, 100)])
def test_tile_shape_and_batch_tiles(rank, dim, batch):
    """The chooser's BN is 32 where tiles of 128 rows would at least
    double the products (always where no group has more than 32 rows);
    its BM holds the batch in the fewest tiles of at most 128; the batch
    tiles cover [0, B) once with less than a tile of padding."""
    layout = comb.gflat_layout(rank, dim)
    bm, bn = be.tile_shape(batch, layout)
    assert bm in BM_CHOICES and bn in BN_CHOICES
    P, T = layout.P.astype(np.int64), layout.T.astype(np.int64)
    work = {w: int(sum(-(-p // w) * w * t for p, t in zip(P, T))) for w in BN_CHOICES}
    assert (bn == 32) == (2 * work[32] <= work[128])
    if int(layout.P.max()) <= 32:
        assert bn == 32
    assert bm == min(m for m in BM_CHOICES if m >= min(batch, 128))
    Bp = be.padded_batch(batch, layout)
    assert Bp % bm == 0 and batch <= Bp < batch + bm
    cover = np.zeros(Bp, np.int64)
    for b0 in range(0, Bp, bm):
        cover[b0: b0 + bm] += 1
    assert (cover == 1).all()


def _spy(monkeypatch):
    calls = {"twin": 0, "kernel": 0}
    twin, kernel = tpe._batched_forward, tpe.batched_eval

    def counted_twin(*a):
        calls["twin"] += 1
        return twin(*a)

    def counted_kernel(*a):
        calls["kernel"] += 1
        return kernel(*a)

    monkeypatch.setattr(tpe, "_batched_forward", counted_twin)
    monkeypatch.setattr(tpe, "batched_eval", counted_kernel)
    return calls


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("rank", [3, 4, 6])
def test_cpu_and_float64_take_the_twin(rank, dtype, monkeypatch):
    """CPU tensors of either type run ``_batched_forward`` once a call and
    leave ``batched_eval.launches`` where it was; gradients too."""
    calls = _spy(monkeypatch)
    _, At, xs = _pair(rank, 5, 7, 10 + rank, dtype)
    before = be.batched_eval.launches
    xt = torch.from_numpy(xs).requires_grad_(True)
    y = tpe.poly_eval_flat_batched(At, xt)
    y.sum().backward()
    assert calls == {"twin": 1, "kernel": 0}
    assert be.batched_eval.launches == before
    assert xt.grad is not None and xt.grad.shape == xs.shape


@pytest.mark.parametrize("what", ["cpu float32", "float64 on the route"])
def test_kernel_wrapper_raises_off_the_card(what):
    """The wrapper takes float32 CUDA tensors only; it never runs a twin."""
    _, At, xs = _pair(4, 5, 3, 5, np.float32)
    vals, x = At.data, torch.from_numpy(xs)
    if what == "float64 on the route":
        vals, x = vals.double(), x.double()
    inputs = tpe._batched_kernel_inputs(x, At.tables, 4, 5)
    with pytest.raises(TypeError, match="float32 CUDA"):
        be.batched_eval(vals, *inputs, At.tables.layout)


@pytest.mark.parametrize("rank,dim,batch", [(3, 4, 5), (3, 9, 2), (4, 5, 6), (4, 7, 1),
                                            (5, 4, 17), (5, 6, 3), (6, 3, 4), (6, 5, 9),
                                            (7, 3, 2)])
def test_twin_matches_jax_float64(rank, dim, batch):
    """The route's forward on CPU tensors (the kernel's plain twin) against
    the JAX package's batched evaluation."""
    Aj, At, xs = _pair(rank, dim, batch, 300 + 10 * rank + dim)
    want = np.asarray(jax.jit(jpe.poly_eval_flat_batched)(Aj, jnp.asarray(xs)))
    got = tpe._BatchedEval.apply(At.data, torch.from_numpy(xs), At.tables, rank, dim,
                                 torch.float64)
    assert got.shape == (batch,) and got.dtype == torch.float64
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-10, atol=1e-12)


def _emulate(vals, tri_t, M, xs, layout, grid):
    """The kernel's walk in float64: tile k = (entry k // nbt, batch tile
    k % nbt) goes to block k % grid; each weights its value tile (the
    entry's rows and columns t0 to t0 + nt) by the decoded corrections,
    takes the product with its tri tile and adds x_bj·Σ_p M̃·S to the
    block's partials; the partials are summed in block order and scaled by
    r!."""
    B, Bp = len(xs), tri_t.shape[1]
    bm, bn = be.tile_shape(B, layout)
    tiles = be.tile_list(layout, bn)
    heads, corr = (v.numpy() for v in head_codes(layout, torch.device("cpu")))
    nbt = Bp // bm
    part = np.zeros((grid, Bp))
    for k in range(len(tiles) * nbt):
        j, p0, rows, T, voff, toff, t0, nt = tiles[k // nbt]
        b0 = (k % nbt) * bm
        V = vals[voff: voff + rows * T].reshape(rows, T)[:, t0: t0 + nt]
        h = heads[p0: p0 + rows]
        run = np.where(h >> 8 == j, h & (HEAD_SHIFT - 1), 0)
        w = corr[run]
        t = np.arange(t0, t0 + nt)
        omega = w[:, :1] + w[:, 1:2] * (t < layout.dim - j) + w[:, 2:3] * (t == 0)
        S = tri_t[toff + t0: toff + t0 + nt, b0: b0 + bm].T @ (V * omega).T  # (bm, rows)
        b = np.arange(b0, b0 + bm)
        b = b[b < B]
        part[k % grid, b] += (M[b, p0: p0 + rows] * S[: len(b)]).sum(1) * xs[b, j]
    return part.sum(0)[:B] * math.factorial(layout.rank)


@pytest.mark.parametrize("rank,dim,batch", [(3, 6, 3), (3, 40, 20), (4, 6, 70),
                                            (4, 33, 5), (5, 5, 17), (6, 4, 130),
                                            (7, 3, 1)])
def test_emulated_walk_matches_twin(rank, dim, batch):
    """The kernel's inputs as the route builds them (tri zero past the
    batch), walked as the kernel walks them, give the twin's result."""
    _, At, xs = _pair(rank, dim, batch, 500 + rank + dim)
    x = torch.from_numpy(xs)
    tri_t, M, x = tpe._batched_kernel_inputs(x, At.tables, rank, dim)
    assert tri_t.shape == (comb.tri_size(dim), be.padded_batch(batch, At.tables.layout))
    assert (tri_t[:, batch:] == 0).all()
    torch.testing.assert_close(tri_t[:, :batch].T, tpe._tri(At.tables, x), rtol=0, atol=0)
    want = tpe._batched_forward(At.data, x, At.tables, rank, dim, torch.float64)
    got = _emulate(At.data.numpy(), tri_t.numpy(), M.numpy(), xs, At.tables.layout, grid=5)
    np.testing.assert_allclose(got, want.numpy(), rtol=1e-11, atol=1e-12)


def _tf32(a):
    """float32 to the nearest TF32 value, ties away from zero (the
    rounding of cvt.rna.tf32.f32): the low 13 bits of the magnitude
    rounded off."""
    bits = np.ascontiguousarray(a, dtype=np.float32).view(np.uint32)
    return ((bits + np.uint32(0x1000)) & np.uint32(0xFFFFE000)).view(np.float32)


def _round_toward_zero(x):
    """float64 to float32, toward zero."""
    y = x.astype(np.float32)
    return np.where(np.abs(y.astype(np.float64)) > np.abs(x), np.nextafter(y, np.float32(0)), y)


def _mma(acc, a, b):
    """One TF32 tensor-core product of depth 8 into float32 sums, acc +
    a @ b.T, with the tensor cores' addition as modelled here: the
    products exact, every addend (acc among them) cut toward zero to 24
    bits below the leading bit of the largest, the cut addends summed
    exactly, the sum cut toward zero to float32."""
    terms = np.concatenate([acc.astype(np.float64)[..., None],
                            a.astype(np.float64)[:, None, :] * b.astype(np.float64)[None]], -1)
    quantum = np.ldexp(1.0, np.frexp(np.abs(terms).max(-1, keepdims=True))[1] - 24)
    return _round_toward_zero((np.trunc(terms / quantum) * quantum).sum(-1))


def _tensor_core_product(A, B, split):
    """A @ B.T of float32 tiles as the kernel takes it, one depth of 8
    columns at a time into float32 sums that start at zero. Split: each
    operand as hi = tf32(a) plus lo = tf32(a - hi), and lo·hi, hi·lo, then
    hi·hi at each depth; else one product of the TF32 roundings."""
    ah, bh = _tf32(A), _tf32(B)
    al, bl = _tf32(A - ah), _tf32(B - bh)
    acc = np.zeros((A.shape[0], B.shape[0]), np.float32)
    for k in range(0, A.shape[1], 8):
        c = slice(k, k + 8)
        if split:
            acc = _mma(acc, al[:, c], bh[:, c])
            acc = _mma(acc, ah[:, c], bl[:, c])
        acc = _mma(acc, ah[:, c], bh[:, c])
    return acc


def _folded_tile(vals, heads, corr, layout, entry):
    """An entry's value tile weighted in float32 in _folded's order."""
    j, p0, rows, T, voff, _, t0, nt = entry
    V = vals[voff: voff + rows * T].reshape(rows, T)[:, t0: t0 + nt]
    h = heads[p0: p0 + rows]
    w = corr[np.where(h >> 8 == j, h & (HEAD_SHIFT - 1), 0)].astype(np.float32)
    t = np.arange(t0, t0 + nt)
    f = V * w[:, :1]
    f += np.where(t < layout.dim - j, V * w[:, 1:2], np.float32(0))
    f += np.where(t == 0, V * w[:, 2:3], np.float32(0))
    return f


def _emulate_f32(vals, tri_t, M, xs, layout, split):
    """The kernel's walk over float32 inputs with the tensor cores' product:
    each value tile weighted in float32 in _folded's order, its product
    with the tri tile, x_bj·Σ_p M̃·S summed in float64. Returns the results
    and, per input, the root sum of squares of the terms
    r!·x_bj·M̃[b, p]·tri[b, t]·Ṽ[p, t]."""
    B, Bp = len(xs), tri_t.shape[1]
    bm, bn = be.tile_shape(B, layout)
    heads, corr = (v.numpy() for v in head_codes(layout, torch.device("cpu")))
    out, rss = np.zeros(B), np.zeros(B)
    for entry in be.tile_list(layout, bn):
        j, p0, rows, _, _, toff, t0, nt = entry
        f = _folded_tile(vals, heads, corr, layout, entry)
        for b0 in range(0, Bp, bm):
            tri = tri_t[toff + t0: toff + t0 + nt, b0: b0 + bm].T
            S = _tensor_core_product(tri, f, split)  # (bm, rows)
            b = np.arange(b0, min(b0 + bm, B))
            Mb, x = M[b, p0: p0 + rows].astype(np.float64), xs[b, j].astype(np.float64)
            out[b] += (Mb * S[: len(b)]).sum(1) * x
            sq = tri[: len(b)].astype(np.float64) ** 2 @ (f.astype(np.float64) ** 2).T
            rss[b] += (Mb**2 * sq).sum(1) * x**2
    r = math.factorial(layout.rank)
    return out * r, np.sqrt(rss) * r


def _product_err(rank, dim, split):
    """max_b |emulation - float64 twin| / root sum of squares of the terms,
    on float32 values and inputs, the route's own kernel inputs."""
    _, At, xs = _pair(rank, dim, 64, 700 + 10 * rank + dim, np.float32)
    x = torch.from_numpy(xs)
    tri_t, M, x = tpe._batched_kernel_inputs(x, At.tables, rank, dim)
    assert tri_t.dtype == M.dtype == torch.float32
    got, rss = _emulate_f32(At.data.numpy(), tri_t.numpy(), M.numpy(), xs,
                            At.tables.layout, split)
    want = tpe._batched_forward(At.data.double(), x.double(), At.tables, rank, dim,
                                torch.float64).numpy()
    return float((np.abs(got - want) / rss).max())


@pytest.mark.parametrize("rank,dim", [(r, d) for r in range(3, 7) for d in range(1, 9)])
def test_split_tf32_product_keeps_float32_accuracy(rank, dim):
    """Three TF32 products of the split operands: within 1e-5 of the
    float64 twin, normalised as the batch cell's err."""
    assert _product_err(rank, dim, split=True) <= 1e-5


@pytest.mark.parametrize("rank,dim", [(r, d) for r in range(3, 7) for d in range(1, 9)])
def test_plain_tf32_product_loses_it(rank, dim):
    """One product of the TF32 roundings reads above 1e-4 on the same
    inputs: the split's three products are what keeps the result float32."""
    assert _product_err(rank, dim, split=False) > 1e-4


# An entry's drift under the truncating sums: |Σ over its runs − float64|
# over the root sum of squares of its terms, per (input, row). The runs of
# ENTRY_COLUMNS read 1.8e-6 to 3.3e-6 in these cases; a group's whole K
# (1 830 to 5 050 columns) in one run reads 9.5e-6 to 2.0e-5.
RUN_DRIFT = 5e-6


@pytest.mark.parametrize("rank,dim,j", [(3, 60, 0), (3, 100, 0), (3, 100, 1), (4, 100, 3)])
def test_entry_runs_bound_the_truncation_drift(rank, dim, j):
    """The long groups' first rows, B = 64, on the route's own inputs:
    tile_list's runs of at most ENTRY_COLUMNS, each summed by the tensor
    cores and added in float64 (the kernel's epilogue), stay within
    RUN_DRIFT; the group's whole K in one run does not."""
    _, At, xs = _pair(rank, dim, 64, 40 + j, np.float32)
    layout = At.tables.layout
    tri_t, _, _ = tpe._batched_kernel_inputs(torch.from_numpy(xs), At.tables, rank, dim)
    tri_t = tri_t.numpy()
    heads, corr = (v.numpy() for v in head_codes(layout, torch.device("cpu")))
    tiles = be.tile_list(layout, be.tile_shape(64, layout)[1])
    runs = tiles[(tiles[:, F["j"]] == j) & (tiles[:, F["p0"]] == 0)]
    T, toff = int(layout.T[j]), int(layout.tri_off[j])
    assert len(runs) == -(-T // be.ENTRY_COLUMNS) > 1
    whole = runs[0].copy()
    whole[F["t0"]], whole[F["nt"]] = 0, T
    f = _folded_tile(At.data.numpy(), heads, corr, layout, whole).astype(np.float64)
    tri = tri_t[toff: toff + T, :64].T.astype(np.float64)
    exact, rss = tri @ f.T, np.sqrt(tri**2 @ (f**2).T)

    def drift(entries):
        got = 0.0
        for e in entries:
            t0, nt = e[F["t0"]], e[F["nt"]]
            got = got + _tensor_core_product(
                tri_t[toff + t0: toff + t0 + nt, :64].T,
                _folded_tile(At.data.numpy(), heads, corr, layout, e), True).astype(np.float64)
        return float((np.abs(got - exact) / rss).max())

    assert drift(runs) <= RUN_DRIFT < drift([whole])
