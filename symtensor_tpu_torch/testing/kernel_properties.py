"""Property checks of the two hand-written kernels, for random shapes.

Each ``check_*`` function makes seeded inputs for one drawn case on a
device, runs the kernel's wrapper, and holds the result against the
kernel's plain twin on the same device and against a float64 oracle on
the CPU (the port's own CPU path in float64, itself held to the dense
contraction where the dense tensor is small). It raises
``AssertionError`` naming the case on any miss, and returns the errors
and the kernel branches the case reached, read from the kernel's launch
tables (``group_pass.tile_table``, the gather kernel's weight chunks and
launch plans), so that a caller can count which branches its draws
covered.

``tests/test_torch_property_cuda.py`` draws the cases with hypothesis;
``chip_smoke.py`` (phase 31) draws a fixed number from a seed. On a CPU
device the wrappers run their twins, which is how these checks are
rehearsed without a card.
"""

from __future__ import annotations

import contextlib
import math

import numpy as np
import torch

from ..core.flat import FlatSymmetricTensor
from ..kernels import gather_mm as gm
from ..kernels.group_pass import (
    FIELDS, FIRST, LAST, TRI_BYTES, acc_dtype, group_eval, group_eval_ref,
    group_eval_terms, group_pass, group_pass_ref, tile_table,
)
from ..ops import contract, outer
from ..utils import combinatorics as comb

f64, f32, bf16, f16 = torch.float64, torch.float32, torch.bfloat16, torch.float16

# kernel against twin, normalised max|Δ|/max|twin| (chip_smoke.py phase 3's
# tolerances): both sum in the accumulation type, in different orders
GROUP_PASS_TWIN_TOL = {f64: 1e-12, f32: 1e-5, bf16: 1e-5}
# group_eval against its twin, |Δ| over r!·Σ|weighted rows|: one average
# row is 1/ΣP_j of that scale, so the limit is at most this share of one
# row, and a row dropped or weighted wrongly shows at any size
GROUP_EVAL_ROW_SHARE = 0.05


def group_eval_tol(dtype: torch.dtype, layout) -> float:
    """The normalised limit of ``group_eval`` against its twin at a layout:
    the group pass's, or ``GROUP_EVAL_ROW_SHARE``/ΣP_j where that is less
    (rank 6 dim 100: 1.1e-8)."""
    return min(GROUP_PASS_TWIN_TOL[dtype], GROUP_EVAL_ROW_SHARE / float(layout.P.sum()))
# against the float64 oracle on the same stored values: what the
# accumulation type (float32 for float32, bfloat16 and float16 storage)
# and a 16-bit output's rounding leave
ORACLE_TOL = {f64: 1e-12, f32: 1e-5, bf16: 2e-2, f16: 2e-2}
# the largest packed tensor a group-pass case draws, and its widest dim
GROUP_PASS_MAX_N, GROUP_PASS_MAX_DIM = 2**25, 200
# a dense float64 oracle is built up to this many elements
DENSE_ORACLE_ELEMS = 2**20
# the gather kernel stages its weights in shared memory, this many rows at
# a time (csrc/gather_combine.cu: kWChunk)
GATHER_W_CHUNK = 1024
# operand bytes of the gather cases are drawn on both sides of this size
GATHER_OPERAND_BYTES = 32 * 1024

GROUP_PASS_BRANCHES = ("whole rows", "split rows", "sliced tri",
                       "unaligned head/tail")
GATHER_BRANCHES = (("operands <= 32 KB", "operands > 32 KB",
                    "weights in one chunk", "weights in several chunks")
                   + tuple(f"plan {i} x {t}" for i, t in gm.TILE_CHOICES))


def nerr(got: torch.Tensor, ref: torch.Tensor) -> float:
    """Normalised error max|got − ref| / max|ref|, in float64 on the
    CPU."""
    got, ref = got.detach().double().cpu(), ref.detach().double().cpu()
    scale = float(ref.abs().max()) if ref.numel() else 0.0
    return float((got - ref).abs().max()) / scale if scale else float((got - ref).abs().max())


def _require(ok: bool, what: str) -> None:
    if not ok:
        raise AssertionError(what)


def max_dim(rank: int, max_n: int = GROUP_PASS_MAX_N,
            cap: int = GROUP_PASS_MAX_DIM) -> int:
    """The largest dim ≤ cap whose rank-`rank` tensor has ≤ max_n values."""
    d = 1
    while d < cap and comb.indep_size(rank, d + 1) <= max_n:
        d += 1
    return d


# ---------------------------------------------------------------- group pass


def group_pass_branches(layout: comb.GflatLayout, dtype: torch.dtype,
                        address: int) -> set:
    """The kernel's branches one launch reaches, from its tile table: tiles
    of whole rows, pieces of a row wider than a stage or than the tri
    buffer ("split rows", ``csrc/group_pass.cu``'s split-row reduction), tri
    reloaded a slice at a time because the whole of it passes TRI_BYTES
    ("sliced tri"), and a tile's span starting or ending off the 16-byte
    grid of the bulk copies ("unaligned head/tail", ``split_span``), for
    values whose first element sits at `address`."""
    tiles = tile_table(layout, dtype)
    flags = tiles[:, FIELDS.index("flags")]
    whole = FIRST | LAST
    out = set()
    if (flags == whole).any():
        out.add("whole rows")
    if (flags != whole).any():
        out.add("split rows")
    if comb.tri_size(layout.dim) * acc_dtype(dtype).itemsize > TRI_BYTES:
        out.add("sliced tri")
    size = dtype.itemsize
    start = address + tiles[:, FIELDS.index("start")] * size
    end = start + tiles[:, FIELDS.index("count")] * size
    if ((start % 16) != 0).any() or ((end % 16) != 0).any():
        out.add("unaligned head/tail")
    return out


def _values(n: int, dtype, offset: int, gen, device) -> torch.Tensor:
    """n seeded values of `dtype` as a view `offset` elements into a
    buffer, so that the first need not sit on the 16-byte grid."""
    store = f64 if dtype == f64 else f32
    buf = torch.randn(n + offset, generator=gen, device=device, dtype=store)
    return buf.to(dtype)[offset:]


def check_group_pass(rank: int, dim: int, dtype: torch.dtype, offset: int,
                     seed: int, device) -> dict:
    """One case of the evaluation path at (rank, dim, storage type, value
    offset): at rank ≥ 3 the kernel against its twin (the same bits on a
    second launch) and against the twin in float64 on the CPU, in both of
    its modes (``group_pass``; ``group_eval`` on seeded float64 M̃ and x,
    its scalar normalised by r!·Σ|weighted rows|); at every rank the
    public ``contract_all_indices_with_vector`` (``group_eval`` at rank ≥
    3) on `device` against the CPU port in float64, normalised by the same
    contraction of |A| at |x|, the size of the sum's terms. Returns
    {"dtype", "branches", "twin_err", "oracle_err"}, the worst of both
    modes."""
    device = torch.device(device)
    case = f"group pass rank {rank} dim {dim} {dtype} offset {offset} seed {seed}"
    gen = torch.Generator(device=device).manual_seed(seed)
    n = comb.indep_size(rank, dim)
    vals = _values(n, dtype, offset, gen, device)
    ct = acc_dtype(dtype)
    out = {"dtype": dtype, "branches": set(), "twin_err": 0.0, "oracle_err": 0.0}
    vals64 = vals.double().cpu()
    if rank >= 3:
        lay = comb.gflat_layout(rank, dim)
        out["branches"] = group_pass_branches(lay, dtype, vals.data_ptr())
        tri = torch.randn(comb.tri_size(dim), generator=gen, device=device, dtype=ct)
        got = group_pass(vals, tri, lay)
        again = group_pass(vals, tri, lay)
        ref = group_pass_ref(vals, tri, lay)
        _require(got.dtype == ref.dtype == ct and got.shape == ref.shape,
                 f"{case}: result {got.dtype} {tuple(got.shape)}")
        _require(torch.equal(got, again), f"{case}: two launches differ")
        out["twin_err"] = nerr(got, ref)
        _require(out["twin_err"] <= GROUP_PASS_TWIN_TOL[dtype],
                 f"{case}: kernel against twin {out['twin_err']:.3e}")
        oracle = group_pass_ref(vals64, tri.double().cpu(), lay)
        out["oracle_err"] = nerr(got, oracle)
        del got, again, ref, oracle
        M = torch.randn(int(lay.P[-1]), generator=gen, device=device, dtype=f64)
        xe = torch.randn(dim, generator=gen, device=device, dtype=f64)
        got = group_eval(vals, tri, M, xe, lay)
        again = group_eval(vals, tri, M, xe, lay)
        _require(got.dtype == f64 and got.shape == (),
                 f"{case}: evaluation mode {got.dtype} {tuple(got.shape)}")
        _require(torch.equal(got, again), f"{case}: two evaluation launches differ")
        ref = group_eval_ref(vals, tri, M, xe, lay)
        cpu = (vals64, tri.double().cpu(), M.cpu(), xe.cpu(), lay)
        scale = math.factorial(rank) * float(group_eval_terms(*cpu).abs().sum())
        err = abs(float(got) - float(ref)) / max(scale, 1e-300)
        _require(err <= group_eval_tol(dtype, lay),
                 f"{case}: evaluation mode against twin {err:.3e}")
        out["twin_err"] = max(out["twin_err"], err)
        err = abs(float(got) - float(group_eval_ref(*cpu))) / max(scale, 1e-300)
        out["oracle_err"] = max(out["oracle_err"], err)
        del got, again, ref, M, xe, tri
    x = torch.randn(dim, generator=gen, device=device, dtype=ct)
    A = FlatSymmetricTensor._raw(rank, dim, vals)
    y = contract.contract_all_indices_with_vector(A, x)
    x64 = x.double().cpu()
    A64 = FlatSymmetricTensor._raw(rank, dim, vals64)
    y64 = contract.contract_all_indices_with_vector(A64, x64)
    scale = float(contract.contract_all_indices_with_vector(
        FlatSymmetricTensor._raw(rank, dim, vals64.abs()), x64.abs()))
    if dim**rank <= DENSE_ORACLE_ELEMS:
        dense = A64.todense()
        for _ in range(rank):
            dense = dense @ x64
        _require(abs(float(y64) - float(dense)) <= 1e-10 * max(scale, 1e-300),
                 f"{case}: CPU float64 oracle against the dense contraction")
    err = abs(float(y) - float(y64)) / max(scale, 1e-300)
    out["oracle_err"] = max(out["oracle_err"], err)
    _require(out["oracle_err"] <= ORACLE_TOL[dtype],
             f"{case}: against the float64 oracle {out['oracle_err']:.3e}")
    return out


# ------------------------------------------------------------ gather combine


@contextlib.contextmanager
def launch_plan(items: int, threads: int):
    """Launch the gather kernel with one (items, threads) plan inside the
    block, in place of ``gather_mm.launch_plan``'s choice."""
    chosen = gm.launch_plan
    gm.launch_plan = lambda n_out, sms: gm.LaunchPlan(
        items, threads, -(-n_out // (items * threads)))
    try:
        yield
    finally:
        gm.launch_plan = chosen


def gather_branches(n_a: int, n_b: int, R: int, dtype: torch.dtype) -> set:
    """The operand size class and weight-chunk branch of one case; every
    case runs every launch plan."""
    size = (n_a + n_b) * dtype.itemsize
    return {"operands <= 32 KB" if size <= GATHER_OPERAND_BYTES else "operands > 32 KB",
            "weights in one chunk" if R <= GATHER_W_CHUNK else "weights in several chunks",
            *(f"plan {i} x {t}" for i, t in gm.TILE_CHOICES)}


def check_gather(n_a: int, n_b: int, R: int, n_out: int, dtype: torch.dtype,
                 seed: int, device) -> dict:
    """One case of the gather kernel: seeded operands and int32 tables, the
    kernel under every launch plan of ``TILE_CHOICES`` against the twin bit
    for bit, and against the twin in float64 on the CPU. Returns
    {"dtype", "branches", "oracle_err"}."""
    device = torch.device(device)
    case = f"gather n_a {n_a} n_b {n_b} R {R} n_out {n_out} {dtype} seed {seed}"
    gen = torch.Generator(device=device).manual_seed(seed)
    a = torch.randn(n_a, generator=gen, device=device, dtype=f64).to(dtype)
    b = torch.randn(n_b, generator=gen, device=device, dtype=f64).to(dtype)
    ia = torch.randint(0, n_a, (R, n_out), generator=gen, device=device, dtype=torch.int32)
    ib = torch.randint(0, n_b, (R, n_out), generator=gen, device=device, dtype=torch.int32)
    w = torch.rand(R, generator=gen, device=device, dtype=f64).to(gm.acc_dtype(dtype))
    ref = gm.gather_combine_ref(a, b, ia, ib, w)
    for items, threads in gm.TILE_CHOICES:
        with launch_plan(items, threads):
            got = gm.gather_combine(a, b, ia, ib, w)
        _require(got.dtype == dtype and got.shape == (n_out,),
                 f"{case}: result {got.dtype} {tuple(got.shape)}")
        _require(torch.equal(got, ref),
                 f"{case} plan {items} x {threads}: not the twin's bits "
                 f"(normalised error {nerr(got, ref):.3e})")
    oracle = gm.gather_combine_ref(a.double().cpu(), b.double().cpu(), ia.cpu(),
                                   ib.cpu(), w.double().cpu())
    err = nerr(ref, oracle)
    _require(err <= ORACLE_TOL[dtype], f"{case}: against the float64 oracle {err:.3e}")
    return {"dtype": dtype, "branches": gather_branches(n_a, n_b, R, dtype),
            "oracle_err": err}


# ---------------------------------------------------------------- public ops


def check_public_ops(ra: int, rb: int, dim: int, d_out: int, seed: int,
                     device) -> dict:
    """``multiply.outer``, ``tensordot`` (axes 1, the table route through
    the gather kernel) and the basis change to `d_out` on `device`, each
    against the same op of the CPU port in float64. Returns {op: normalised
    error}."""
    from ..ops.contract import contract_all_indices_with_matrix

    device = torch.device(device)
    rng = np.random.default_rng(seed)

    def pair(rank):
        data = torch.from_numpy(rng.normal(size=comb.indep_size(rank, dim)))
        return (FlatSymmetricTensor._raw(rank, dim, data),
                FlatSymmetricTensor._raw(rank, dim, data.to(device)))

    (A, Ad), (B, Bd) = pair(ra), pair(rb)
    W = torch.from_numpy(rng.normal(size=(dim, d_out)))
    ops = {
        "outer": lambda X, Y, V: outer.symmetric_outer(X, Y, "multiply", stream=False),
        "tensordot": lambda X, Y, V: outer.tensordot(X, Y, axes=1, stream=False),
        "basis change": lambda X, Y, V: contract_all_indices_with_matrix(X, V),
    }
    errs = {}
    before = gm.gather_combine.launches
    for name, op in ops.items():
        got = op(Ad, Bd, W.to(device))
        want = op(A, B, W)
        _require(got.device == device and got.rank == want.rank and got.dim == want.dim,
                 f"{name} ranks {ra}, {rb} dim {dim}: {got.rank}/{got.dim} on {got.device}")
        errs[name] = nerr(got.data, want.data)
        _require(errs[name] <= ORACLE_TOL[f64],
                 f"{name} ranks {ra}, {rb} dim {dim} d_out {d_out}: {errs[name]:.3e}")
    # the outer product and tensordot's table route launch the kernel once
    # each on a card, tensordot only for a result of rank ≥ 1 (a CPU device
    # runs the twin, which counts nothing)
    want = before + 1 + (ra + rb > 2)
    _require(device.type != "cuda" or gm.gather_combine.launches == want,
             f"ranks {ra}, {rb} dim {dim}: {gm.gather_combine.launches - before} "
             f"gather kernel launches, not {want - before}")
    return errs


def draw_group_pass_case(rng: np.random.Generator, i: int):
    """Case i of a seeded run: ranks 0-7 and the three storage types in
    turn, an offset of 0-3 elements, and the dim uniform up to
    ``max_dim(rank)``, from its top quarter in every other round of 24
    cases, where rank 3 reaches rows wider than a stage and the sliced
    tri in every storage type."""
    rank = i % 8
    dtype = (f32, bf16, f64)[(i // 8) % 3]
    hi = max_dim(rank)
    lo = 1 if (i // 24) % 2 == 0 else max(1, 3 * hi // 4)
    return rank, int(rng.integers(lo, hi + 1)), dtype, int(rng.integers(0, 4))


def draw_gather_case(rng: np.random.Generator, i: int):
    """Case i of a seeded run: the four operand types in turn; operands of
    at most a quarter of 32 KB each, or of half to twice that, in
    alternate rounds of 4; R within one weight chunk, or past it, in
    alternate rounds of 8; R·n_out under 2**22."""
    dtype = (f32, bf16, f64, f16)[i % 4]
    per = GATHER_OPERAND_BYTES // dtype.itemsize
    lo, hi = (1, per // 4) if (i // 4) % 2 == 0 else (per // 2, 2 * per)
    n_a, n_b = (int(rng.integers(lo, hi + 1)) for _ in "ab")
    R = int(rng.integers(1, GATHER_W_CHUNK + 1) if (i // 8) % 2 == 0
            else rng.integers(GATHER_W_CHUNK + 1, 2 * GATHER_W_CHUNK + 200))
    n_out = int(rng.integers(1, max(2, 2**22 // R)))
    return n_a, n_b, R, n_out, dtype


def summary_counts(results, names) -> dict:
    """How many results reached each named branch."""
    return {b: sum(b in r["branches"] for r in results) for b in names}


def worst(results, key: str) -> float:
    return max((r[key] for r in results), default=math.nan)
