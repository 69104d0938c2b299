"""The group-pass kernel's evaluation mode (``group_eval``) against the JAX
package, on the CPU.

``group_eval`` weights each row of the group pass by its head monomial,
x_j and the trailing-run corrections and sums the rows to one float64
scalar in the kernel; on a CPU tensor it runs its twin ``group_eval_ref``.
These tests hold the twin on the route's own inputs to the JAX package's
evaluation (its Pallas kernel in interpret mode, as the JAX package's own
tests run it on the CPU, and its plain loop), emulate the kernel's walk
and fixed-order reduction in NumPy, and check which route the single-input
op takes: ``group_eval`` without a gradient, ``group_pass`` and the
differentiable epilogue with one. Inputs come from seeded NumPy generators
and go to both packages.
"""

import functools
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import symtensor_tpu as st
import symtensor_tpu_torch as stt
from symtensor_tpu.kernels import pallas_poly
from symtensor_tpu.kernels import poly_eval as jpe
from symtensor_tpu_torch.interop import flat_from_numpy
from symtensor_tpu_torch.kernels import group_pass as gp
from symtensor_tpu_torch.kernels import poly_eval as tpe
from symtensor_tpu_torch.kernels.group_pass import (
    CHUNK,
    FIELDS,
    FIRST,
    HEAD_SHIFT,
    LAST,
    chunk_starts,
    group_eval,
    group_eval_ref,
    group_eval_terms,
    tile_table,
)
from symtensor_tpu_torch.testing.kernel_properties import group_eval_tol
from symtensor_tpu_torch.utils import combinatorics as comb

CONSUMER_WARPS = 16  # csrc/group_pass.cu: kConsumerWarps
CONSUMERS = 32 * CONSUMER_WARPS


def _route_inputs(rank, dim, seed, dtype=np.float64, storage=None):
    """Seeded values and x, as both packages' tensors, and the kernel's
    inputs as ``poly_eval_flat_fast`` builds them: values, tri in the
    accumulation type, the float64 head monomials M̃ and x."""
    rng = np.random.default_rng(seed)
    data = rng.normal(size=comb.indep_size(rank, dim)).astype(dtype)
    x = rng.normal(size=dim).astype(dtype)
    Aj = st.FlatSymmetricTensor._raw(rank, dim, jnp.asarray(data))
    At = flat_from_numpy(rank, dim, data, device="cpu")
    if storage is not None:
        At = At.astype(storage)
    t = At.tables
    x64 = torch.from_numpy(x).double()
    M = tpe._head_weights(t, x64, rank)[0]
    tri = tpe._tri(t, torch.from_numpy(x).to(gp.acc_dtype(At.dtype)))
    return Aj, At, x, (At.data, tri, M, x64, t.layout)


@pytest.mark.parametrize("rank,dim", [(3, 4), (3, 9), (4, 5), (4, 7), (5, 4),
                                      (5, 6), (6, 3), (6, 5)])
def test_group_eval_ref_matches_jax_float64(rank, dim):
    Aj, At, x, inputs = _route_inputs(rank, dim, 900 + 10 * rank + dim)
    want = float(jax.jit(jpe.poly_eval_flat)(Aj, jnp.asarray(x)))
    pallas = float(pallas_poly.poly_eval_flat_pallas(Aj, jnp.asarray(x), interpret=True))
    got = group_eval_ref(*inputs)
    assert got.dtype == torch.float64 and got.shape == ()
    public = stt.symalg.contract_all_indices_with_vector(At, torch.from_numpy(x))
    for value in (got, group_eval(*inputs), public):
        np.testing.assert_allclose(float(value), want, rtol=1e-10)
        np.testing.assert_allclose(float(value), pallas, rtol=1e-10)


@pytest.mark.parametrize("rank,dim", [(3, 5), (4, 8), (6, 4)])
def test_bfloat16_storage_within_2e_2_of_float32(rank, dim):
    _, A32, x, inputs32 = _route_inputs(rank, dim, 7, np.float32)
    _, A16, _, inputs16 = _route_inputs(rank, dim, 7, np.float32, torch.bfloat16)
    assert inputs16[0].dtype == torch.bfloat16 and inputs16[1].dtype == torch.float32
    ref = float(group_eval_ref(*inputs32))
    np.testing.assert_allclose(float(group_eval_ref(*inputs16)), ref, rtol=2e-2)
    got = tpe.poly_eval_flat_fast(A16, torch.from_numpy(x))
    assert got.dtype == torch.float32
    np.testing.assert_allclose(float(got), ref, rtol=2e-2)


def test_corrections_and_head_codes_are_the_epilogues():
    """The kernel's static inputs: each head's code decodes to the head
    runs, and the rows' weights decoded from the codes and the correction
    table (``row_weights``, which the unfused epilogue takes too) are the
    ``corrections`` of each row's trailing run, taken from the int64 head
    runs as ``poly_eval_flat`` takes them."""
    for rank, dim in ((3, 6), (4, 5), (6, 4), (7, 3)):
        lay = comb.gflat_layout(rank, dim)
        t = stt.FlatSymmetricTensor(rank, dim, device="cpu").tables
        heads, corr = gp.head_codes(lay, torch.device("cpu"))
        maxel, maxrun = gp.head_runs(t)
        assert heads.dtype == torch.int32 and corr.shape == (rank - 2, 3)
        np.testing.assert_array_equal(heads.numpy() >> 8, maxel.numpy())
        np.testing.assert_array_equal(heads.numpy() & (HEAD_SHIFT - 1), maxrun.numpy())
        w = gp.row_weights(lay, torch.device("cpu"))
        assert w.dtype == torch.float64 and w.shape == (int(lay.P.sum()), 3)
        for j, s in enumerate(gp.row_offsets(lay)):
            Pj = int(lay.P[j])
            q = torch.where(maxel[:Pj] == j, maxrun[:Pj], 0).to(torch.float64)
            want = torch.stack(gp.corrections(q, 1.0), 1)
            assert torch.equal(w[s : s + Pj], want)
        assert torch.equal(tpe._row_maps(t)[2], w.T)


@pytest.mark.parametrize("rank,dim", [(3, 300), (5, 20), (6, 30)])
def test_eval_tolerance_sees_one_wrong_row(rank, dim):
    """The card's limit for group_eval against its twin (``group_eval_tol``,
    normalised by r!·Σ|weighted rows|) lies between what float32 sums in
    another order read and what one row of median size, dropped, reads."""
    lay = comb.gflat_layout(rank, dim)
    g = torch.Generator().manual_seed(rank + dim)
    vals = torch.randn(lay.n, generator=g, dtype=torch.float64)
    tri = torch.randn(comb.tri_size(dim), generator=g, dtype=torch.float64)
    M = torch.randn(int(lay.P[-1]), generator=g, dtype=torch.float64)
    x = torch.randn(dim, generator=g, dtype=torch.float64)
    terms = group_eval_terms(vals, tri, M, x, lay).abs()
    tol = group_eval_tol(torch.float32, lay)
    assert float(terms.median()) / float(terms.sum()) > 2 * tol
    f32 = group_eval_ref(vals.float(), tri.float(), M, x, lay)
    f32_err = abs(float(f32) - float(group_eval_ref(vals.float().double(),
                                                    tri.float().double(), M, x, lay)))
    assert f32_err / (math.factorial(rank) * float(terms.sum())) < tol / 10


def _butterfly(values) -> float:
    """Lane 0's result of a warp's xor-shuffle sum over 32 lanes
    (``__shfl_xor_sync`` with offsets 16, 8, 4, 2, 1)."""
    v = np.zeros(32)
    v[: len(values)] = values
    for o in (16, 8, 4, 2, 1):
        v = v + v[np.arange(32) ^ o]
    return float(v[0])


def _emulate_eval(vals, tri, M, x, heads, corr, tiles, dim, rank, grid):
    """csrc/group_pass.cu's evaluation mode in NumPy: each block walks its
    chunks of tiles (from chunk_starts) in the kernel's order; a whole-row
    tile's rows go to the consumer lanes of ``whole_rows`` (rows past the
    tile's end reread row 0 and are not weighted), a split row's pieces
    are carried by consumer thread 0 and weighted at the LAST piece; then
    lanes, warps and blocks are reduced in the kernel's fixed order. Sums
    are float64. Returns the result and how often each (group, head) row
    was weighted."""
    ntiles = len(tiles)
    starts = chunk_starts(tiles)
    nchunks = -(-ntiles // CHUNK)
    weighted = {}

    def weigh(j, p, full, row, cell):
        weighted[(j, p)] = weighted.get((j, p), 0) + 1
        h = int(heads[p])
        q = h & (HEAD_SHIFT - 1) if h >> 8 == j else 0
        c = corr[q]
        return M[p] * x[j] * (c[0] * full + c[1] * row + c[2] * cell)

    partials = np.zeros(grid)
    for blk in range(grid):
        acc = np.zeros(CONSUMERS)  # each consumer thread's accumulator
        carry, rot = None, 0
        for chunk in range(blk, nchunks, grid):
            for t in range(starts[chunk], starts[chunk + 1]):
                j, row0, nrows, c0, c1, T, start, count, toff, prow, L, flags = (
                    int(v) for v in tiles[t])
                sv = vals[start : start + count]
                tri_s = tri[toff + c0 : toff + c1]
                row_len = dim - j - c0
                if flags == FIRST | LAST:
                    V = sv.reshape(nrows, T)
                    per_warp, per_pass = 32 // L, CONSUMERS // L
                    for warp in range(CONSUMER_WARPS):
                        slot = (warp - rot) % CONSUMER_WARPS
                        base = 0
                        while base + slot * per_warp < nrows:
                            for lane in range(0, 32, L):  # sub-lane 0 of each row
                                r = base + (slot * 32 + lane) // L
                                if r >= nrows:
                                    continue  # reread row 0, not weighted
                                part = V[r, :row_len] @ tri_s[:row_len]
                                rest = V[r, row_len:] @ tri_s[row_len:]
                                acc[warp * 32 + lane] += weigh(
                                    j, row0 + r, part + rest, part, V[r, 0] * tri_s[0])
                            base += per_pass
                    rot = (rot + (nrows - 1) % per_pass // per_warp + 1) % CONSUMER_WARPS
                    continue
                if flags & FIRST:
                    carry = np.array([0.0, 0.0, sv[0] * tri_s[0]])
                assert carry is not None, "a block starts inside a split row"
                xs = sv * tri_s
                carry += (xs.sum(), xs[: max(row_len, 0)].sum(), 0.0)
                if flags & LAST:
                    acc[0] += weigh(j, row0, *carry)
                    carry = None
        warps = [_butterfly(acc[w * 32 : (w + 1) * 32]) for w in range(CONSUMER_WARPS)]
        partials[blk] = _butterfly(warps)
    lanes = [sum(partials[k::32]) for k in range(32)]  # lane k: blocks k, k + 32, ...
    return _butterfly(lanes) * math.factorial(rank), weighted


@functools.lru_cache(maxsize=None)
def _eval_case(rank, dim):
    """Seeded float64 values, tri, M and x, the kernel's static inputs,
    and the twin's result and term scale on them."""
    rng = np.random.default_rng(50 + rank)
    lay = comb.gflat_layout(rank, dim)
    vals, tri = rng.normal(size=lay.n), rng.normal(size=comb.tri_size(dim))
    M, x = rng.normal(size=int(lay.P[-1])), rng.normal(size=dim)
    args = [torch.from_numpy(a) for a in (vals, tri, M, x)] + [lay]
    terms = group_eval_terms(*args)
    scale = math.factorial(rank) * float(terms.abs().sum())
    heads, corr = gp.head_codes(lay, torch.device("cpu"))
    return (vals, tri, M, x, heads.numpy(), corr.numpy(), float(group_eval_ref(*args)),
            scale)


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32, torch.bfloat16])
@pytest.mark.parametrize("rank,dim,grid", [(3, 9, 1), (3, 9, 4), (4, 6, 7), (4, 40, 5),
                                           (5, 7, 2), (6, 4, 3), (6, 20, 5),
                                           (3, 300, 132)])
def test_kernel_walk_emulation_matches_twin(rank, dim, grid, dtype):
    lay = comb.gflat_layout(rank, dim)
    vals, tri, M, x, heads, corr, want, scale = _eval_case(rank, dim)
    tiles = tile_table(lay, dtype)
    flags = tiles[:, FIELDS.index("flags")]
    if dim == 300:  # rows longer than a stage: split into pieces
        assert (flags != FIRST | LAST).any()
    if (rank, dim) == (6, 20):  # tiles of more rows than one pass takes
        assert (tiles[:, FIELDS.index("nrows")] > CONSUMERS // tiles[:, FIELDS.index("L")]).any()
    got, weighted = _emulate_eval(vals, tri, M, x, heads, corr, tiles, dim, rank, grid)
    # every row of every group weighted exactly once
    assert sorted(weighted) == [(j, p) for j in range(dim) for p in range(int(lay.P[j]))]
    assert set(weighted.values()) == {1}
    assert abs(got - want) <= 1e-12 * scale


def _spy(monkeypatch):
    """Count the route's calls of group_eval, group_pass and the
    differentiable epilogue."""
    calls = {"group_eval": 0, "group_pass": 0, "epilogue": 0}

    def counting(name, fn):
        def wrapper(*args, **kw):
            calls[name] += 1
            return fn(*args, **kw)
        return wrapper

    monkeypatch.setattr(tpe, "group_eval", counting("group_eval", tpe.group_eval))
    monkeypatch.setattr(tpe, "group_pass", counting("group_pass", tpe.group_pass))
    monkeypatch.setattr(tpe._Epilogue, "apply",
                        counting("epilogue", tpe._Epilogue.apply))
    return calls


@pytest.mark.parametrize("rank,dim", [(3, 5), (4, 4), (6, 3)])
def test_no_grad_calls_take_group_eval(rank, dim, monkeypatch):
    calls = _spy(monkeypatch)
    _, At, x, _ = _route_inputs(rank, dim, 60 + rank)
    a = At.data.clone().requires_grad_()
    xt = torch.from_numpy(x).requires_grad_()
    op = stt.symalg.contract_all_indices_with_vector
    want = float(tpe.poly_eval_flat(At, torch.from_numpy(x)))
    calls.update(dict.fromkeys(calls, 0))
    plain = op(At, torch.from_numpy(x))  # nothing requires a gradient
    with torch.no_grad():  # grad mode off, though both require one
        off = op(stt.FlatSymmetricTensor._raw(rank, dim, a), xt)
    assert calls == {"group_eval": 2, "group_pass": 0, "epilogue": 0}
    for y in (plain, off):
        assert not y.requires_grad
        np.testing.assert_allclose(float(y), want, rtol=1e-10)


def _strided_x(kind, dim, rng):
    """A float64 x of `dim` entries that is not contiguous: a column of a
    matrix, every second entry of a buffer, or one value broadcast."""
    if kind == "column":
        return torch.from_numpy(rng.normal(size=(dim, 3)))[:, 1]
    if kind == "step":
        return torch.from_numpy(rng.normal(size=2 * dim))[::2]
    return torch.tensor(rng.normal(), dtype=torch.float64).expand(dim)


@pytest.mark.parametrize("fmt", ["flat", "permcls"])
@pytest.mark.parametrize("kind", ["column", "step", "broadcast"])
@pytest.mark.parametrize("rank,dim", [(3, 6), (4, 5), (5, 4), (6, 4)])
def test_public_op_takes_strided_and_broadcast_x(rank, dim, kind, fmt):
    """A non-contiguous float64 x reaches group_eval contiguous: the
    public op gives the JAX package's result in float64 (rtol 1e-10), and
    with float32 values (x stays float64) the same bits as a contiguous
    copy of x."""
    rng = np.random.default_rng(300 + 10 * rank + dim)
    data = rng.normal(size=comb.indep_size(rank, dim))
    x = _strided_x(kind, dim, rng)
    assert not x.is_contiguous() and x.dtype == torch.float64
    Aj = st.FlatSymmetricTensor._raw(rank, dim, jnp.asarray(data))
    want = float(st.symalg.contract_all_indices_with_vector(Aj, jnp.asarray(x.numpy())))
    op = stt.symalg.contract_all_indices_with_vector
    for storage in (np.float64, np.float32):
        A = flat_from_numpy(rank, dim, data.astype(storage), device="cpu")
        if fmt == "permcls":
            A = A.topermcls()
        got = op(A, x)
        assert got.dtype == torch.float64
        assert torch.equal(got, op(A, x.contiguous()))
        if storage is np.float64:
            np.testing.assert_allclose(float(got), want, rtol=1e-10)


@functools.lru_cache(maxsize=None)
def _jax_grads(rank, dim):
    def single(data, x):
        A = st.FlatSymmetricTensor._raw(rank, dim, data)
        return st.symalg.contract_all_indices_with_vector(A, x)

    return jax.jit(jax.grad(single, argnums=(0, 1)))


@pytest.mark.parametrize("needs", ["values", "x", "both"])
@pytest.mark.parametrize("rank,dim", [(3, 5), (4, 4), (6, 3)])
def test_grad_calls_take_group_pass_and_epilogue(rank, dim, needs, monkeypatch):
    calls = _spy(monkeypatch)
    rng = np.random.default_rng(70 + rank)
    data, x = rng.normal(size=comb.indep_size(rank, dim)), rng.normal(size=dim)
    ga, gx = _jax_grads(rank, dim)(jnp.asarray(data), jnp.asarray(x))
    a = torch.tensor(data, requires_grad=needs in ("values", "both"))
    xt = torch.tensor(x, requires_grad=needs in ("x", "both"))
    y = stt.symalg.contract_all_indices_with_vector(
        stt.FlatSymmetricTensor._raw(rank, dim, a), xt)
    assert calls == {"group_eval": 0, "group_pass": 1, "epilogue": 1}
    y.backward()
    for leaf, want in ((a, ga), (xt, gx)):
        if leaf.requires_grad:
            np.testing.assert_allclose(leaf.grad.numpy(), np.asarray(want),
                                       rtol=1e-10, atol=1e-12)


def test_group_eval_cpu_uses_twin_and_counts_no_launch():
    _, _, _, inputs = _route_inputs(4, 4, 3)
    before = gp.group_eval.launches
    assert torch.equal(group_eval(*inputs), group_eval_ref(*inputs))
    assert gp.group_eval.launches == before


BAD_EVAL = {
    "float32 M": ("M", lambda v: v.float(), ValueError),
    "short M": ("M", lambda v: v[:-1], ValueError),
    "long x": ("x", lambda v: torch.cat([v, v[:1]]), ValueError),
    "strided x": ("x", lambda v: torch.stack([v, v], 1)[:, 0], ValueError),
    "meta x": ("x", lambda v: v.to("meta"), ValueError),
    "x needs a gradient": ("x", lambda v: v.clone().requires_grad_(), RuntimeError),
    "values need a gradient": ("vals", lambda v: v.clone().requires_grad_(), RuntimeError),
}


@pytest.mark.parametrize("case", sorted(BAD_EVAL))
def test_group_eval_rejects_what_the_kernel_does_not_take(case):
    which, change, err = BAD_EVAL[case]
    _, _, _, inputs = _route_inputs(5, 4, 8)
    args = dict(zip(("vals", "tri", "M", "x", "layout"), inputs))
    args[which] = change(args[which])
    with pytest.raises(err):
        group_eval(**args)


def _c_entries():
    """Each exported C function of csrc/*.cu and its parameter types, read
    from the sources (a macro's functions take the macro's parameters)."""
    import ctypes
    import re

    from symtensor_tpu_torch.kernels import _build

    ctype = {"void*": ctypes.c_void_p, "int64_t": ctypes.c_int64,
             "int": ctypes.c_int, "double": ctypes.c_double}
    entries = {}
    for src in sorted(_build.SRC_DIR.glob("*.cu")):
        text = src.read_text().split('extern "C" {', 1)[1].replace("\\\n", " ")
        for name, params in re.findall(r"\bint\s+(\w+)\(([^)]*)\)\s*\{", text):
            types = [ctype["".join(re.sub(r"\bconst\b", "", p).split()[:-1])]
                     for p in params.split(",")]
            entries[name] = types
        for macro in re.findall(r"#define\s+(\w+)\(name,", text):
            for name in re.findall(rf"^{macro}\((\w+),", text, flags=re.M):
                entries[name] = entries["name"]
        entries.pop("name", None)
    return entries


def test_every_kernel_entry_is_declared_with_its_c_types():
    """ctypes passes an undeclared pointer as a 32-bit int and a double as
    nothing it can convert: every entry point of the sources, the
    evaluation mode's too, is in SIGNATURES with its C parameter types."""
    from symtensor_tpu_torch.kernels import _build

    entries = _c_entries()
    assert {f"group_eval_{t}" for t in ("f32", "bf16", "f64")} <= set(entries)
    assert set(entries) == set(_build.SIGNATURES)
    for name, types in entries.items():
        assert _build.SIGNATURES[name] == types, name


@pytest.mark.parametrize("case", [(3, 7, torch.float32, 1), (4, 6, torch.float64, 2),
                                  (6, 5, torch.bfloat16, 0), (2, 4, torch.float32, 3)])
def test_property_check_runs_both_modes_on_the_cpu(case, monkeypatch):
    """The card's property check (``testing.kernel_properties``) on CPU
    tensors, where each entry runs its twin: both modes against their
    twins and the public op against the float64 port; the op (on the
    case, its float64 copy and |A| at |x|) takes group_eval at rank ≥ 3."""
    from symtensor_tpu_torch.testing import kernel_properties as kp

    calls = _spy(monkeypatch)
    rank = case[0]
    out = kp.check_group_pass(*case, seed=rank, device="cpu")
    assert out["twin_err"] == 0.0  # the twins on the CPU
    assert out["oracle_err"] <= kp.ORACLE_TOL[case[2]]
    assert calls == {"group_eval": 3 * (rank >= 3), "group_pass": 0, "epilogue": 0}
