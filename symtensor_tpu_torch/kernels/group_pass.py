"""The fused group pass of packed evaluation: kernel wrapper and plain twin.

Replaces the TPU kernel ``symtensor_tpu/kernels/pallas_poly.py:_group_pass``.
For every gflat group j, with value block V_j (P_j × T_j, read in place
from the packed values) and triangle-monomial slice tri_j, it computes

    u[0, s_j + p] = Σ_t V_j[p, t]·tri_j[t]            (full)
    u[1, s_j + p] = Σ_{t<d−j} V_j[p, t]·tri_j[t]      (row: tails touching j)
    u[2, s_j + p] = V_j[p, 0]·tri_j[0]                (cell: the (j, j) tail)

with s_j = Σ_{i<j} P_i, into one (3, ΣP_j) tensor in the accumulation type
(float64 for float64 values, float32 for float32 and bfloat16 values).

The op is bound by the bytes it reads: every value is used once. On a CUDA
tensor, ``group_pass`` launches the hand-written kernel
(``csrc/group_pass.cu``) once over all groups: one pass over the packed
values, in place, streamed through a ring of shared-memory stages by
Hopper's bulk copies, one tile (``tile_table``) per stage. On a
CPU tensor it runs the plain twin ``group_pass_ref``: three ``torch.mv``
products per group on zero-copy views. Nothing falls back from the kernel
to the twin.

Both are differentiable through one ``torch.autograd.Function`` whose
backward is plain torch (the JAX package has no backward kernel either):
per group, ∂/∂V_j is one product of the incoming (3, P_j) row weights with
the three (T_j,) rows tri_j, tri_j on its first d − j entries and tri_j[0]
on entry 0, written into that group's slice of one n-sized buffer, and
∂/∂tri_j one product of the row weights with V_j, which reads V_j once
(``group_pass_backward``). The backward is once differentiable: under
``create_graph=True`` it raises.

The single-input evaluation without a gradient needs only the weighted sum
of those rows, which the TPU kernel left to a jnp epilogue:

    group_eval = r!·Σ_j Σ_{p<P_j} M̃[p]·x_j·(c1(q)·u_full + c2(q)·u_row
                                            + c3(q)·u_cell)

over the same rows (row p of group j is head p in colex order), with q
the head's trailing run of j (``head_runs``) and c(q) the ``corrections``
at x_j = 1. On a CUDA tensor ``group_eval`` launches the same kernel in its
evaluation mode: each row's three sums are weighted in float64 where the
pass would store them, and a fixed-order reduction leaves one float64
scalar, the same bits on every call, with nothing of ΣP_j entries written.
On a CPU tensor it runs the twin ``group_eval_ref`` (``group_pass_ref``,
then the weighting and the sum in float64). It has no backward: a caller
that needs a gradient takes ``group_pass`` and weights its rows.
"""

from __future__ import annotations

import functools
import math

import numpy as np
import torch

from ..core.base import require_local
from ..utils import combinatorics as comb
from ..utils.precision import full_fp32_matmul
from ..utils.profiling import spanned
from ..utils.tables import tables

# Bytes of values one stage of the kernel's ring holds, and bytes of its
# tri buffer, which holds the whole of tri where it fits and else the
# tile's slice (csrc/group_pass.cu: kStageBytes, kTriBytes). A tile is as
# many whole rows as fill a stage, or, for a row wider than a stage or
# than the tri buffer, one column range of one row. A block takes chunks of
# CHUNK tiles in turn (kChunk), each starting at a row's first piece
# (``chunk_starts``).
STAGE_BYTES = 32 * 1024
TRI_BYTES = 40 * 1024
CHUNK = 8
# Values each of a row's L lanes sums, at least, where T_j allows: fewer
# lanes per row mean fewer shuffle steps per row, which bound the kernel's
# consumers (PERF.md).
LANE_VALUES = 32
# Fields of a tile entry (csrc/group_pass.cu: kTileFields and the enum).
FIELDS = ("j", "row0", "nrows", "c0", "c1", "T", "start", "count", "toff",
          "prow", "L", "flags")
FIRST, LAST = 1, 2  # flags: a row's first piece, its last piece

_STORAGE = (torch.float32, torch.bfloat16, torch.float64)
_SYMBOL = {
    torch.float32: "group_pass_f32",
    torch.bfloat16: "group_pass_bf16",
    torch.float64: "group_pass_f64",
}
_EVAL_SYMBOL = {
    torch.float32: "group_eval_f32",
    torch.bfloat16: "group_eval_bf16",
    torch.float64: "group_eval_f64",
}
# A head's code for the evaluation mode: maxel · HEAD_SHIFT + maxrun
# (int32; csrc/group_pass.cu:Weights decodes it with >> 8 and & 255).
HEAD_SHIFT = 256


def acc_dtype(storage: torch.dtype) -> torch.dtype:
    """Accumulation (and output) type of the pass for a storage type."""
    return torch.float64 if storage == torch.float64 else torch.float32


def row_offsets(layout: comb.GflatLayout) -> np.ndarray:
    """prow_off: the first output column of each group (exclusive cumsum
    of P_j)."""
    return np.concatenate(([0], np.cumsum(layout.P)[:-1])).astype(np.int64)


def tile_table(layout: comb.GflatLayout, storage: torch.dtype) -> np.ndarray:
    """(ntiles, 12) int64 host table of the kernel's tiles, one row each:
    (j, row0, nrows, c0, c1, T, start, count, toff, prow, L, flags), as
    named in ``FIELDS``.

    A tile is one contiguous span of the values, ``count`` values from
    element ``start``: columns [c0, c1) of rows row0 .. row0+nrows of
    group j. Where T_j values fit a stage (STAGE_BYTES of the storage
    type) and tri_j fits TRI_BYTES of the accumulation type, a tile holds
    as many whole rows as fit a stage (c0 = 0, c1 = T_j, flags
    FIRST | LAST; a group's last tile takes the rest). A wider row is cut
    into pieces of one column range each, the first flagged FIRST and the
    last LAST; the kernel carries the row's sums across them. L, the lanes
    that share a row, is the largest power of two ≤ T_j / LANE_VALUES,
    at least 1 and at most 32."""
    stage = STAGE_BYTES // storage.itemsize
    cols = min(stage, TRI_BYTES // acc_dtype(storage).itemsize)
    prow = row_offsets(layout)
    out = []
    for j in range(len(layout.P)):
        P, T = int(layout.P[j]), int(layout.T[j])
        L = min(32, 1 << (max(1, T // LANE_VALUES).bit_length() - 1))
        if T <= cols:
            rows = stage // T
            row0 = np.arange(0, P, rows, dtype=np.int64)
            nrows = np.minimum(rows, P - row0)
            c0 = np.zeros_like(row0)
            c1 = np.full_like(row0, T)
            flags = np.full_like(row0, FIRST | LAST)
        else:
            npc = -(-T // cols)
            row0 = np.repeat(np.arange(P, dtype=np.int64), npc)
            piece = np.tile(np.arange(npc, dtype=np.int64), P)
            nrows = np.ones_like(row0)
            c0 = piece * cols
            c1 = np.minimum(c0 + cols, T)
            flags = FIRST * (piece == 0) + LAST * (piece == npc - 1)
        blk = np.empty((len(row0), len(FIELDS)), dtype=np.int64)
        blk[:, 0] = j
        blk[:, 1] = row0
        blk[:, 2] = nrows
        blk[:, 3] = c0
        blk[:, 4] = c1
        blk[:, 5] = T
        blk[:, 6] = layout.group_off[j] + row0 * T + c0
        blk[:, 7] = nrows * (c1 - c0)
        blk[:, 8] = layout.tri_off[j]
        blk[:, 9] = prow[j]
        blk[:, 10] = L
        blk[:, 11] = flags
        out.append(blk)
    return np.concatenate(out)


def chunk_starts(tiles: np.ndarray) -> np.ndarray:
    """The first tile of each of the ceil(ntiles / CHUNK) chunks, then
    ntiles: chunk c starts at the first row-starting tile (flag FIRST) at
    or after c · CHUNK, so that no split row is cut between blocks. A chunk
    inside a long split row is empty."""
    n = len(tiles)
    first = np.flatnonzero(tiles[:, FIELDS.index("flags")] & FIRST)
    want = np.arange(0, n, CHUNK, dtype=np.int64)
    at = np.searchsorted(first, want)
    starts = np.where(at < len(first), first[np.minimum(at, len(first) - 1)], n)
    return np.append(starts, n).astype(np.int64)



def once_differentiable(backward):
    """Mark an ``autograd.Function`` backward as differentiable once: it
    runs without a graph, and under ``create_graph=True`` it raises rather
    than return gradients that a second derivative would silently cut off
    from the values and the input. (``torch.autograd.function.
    once_differentiable`` defers the error to a node that ``autograd.grad``
    prunes when only a saved input needs the gradient.)"""

    @functools.wraps(backward)
    def wrapper(ctx, *grads):
        if torch.is_grad_enabled():
            raise RuntimeError(
                f"{type(ctx).__name__[:-len('Backward')]} is differentiable "
                "once: its backward does not run under create_graph=True "
                "(a second derivative would drop its terms)")
        return backward(ctx, *grads)

    return wrapper


def _check(vals: torch.Tensor, tri: torch.Tensor, layout: comb.GflatLayout):
    if layout.rank < 3:
        raise ValueError(f"group_pass needs rank >= 3; got {layout.rank}")
    if vals.dtype not in _STORAGE:
        raise TypeError(
            f"group_pass takes float32, bfloat16 or float64 values; got "
            f"{vals.dtype}"
        )
    if vals.ndim != 1 or vals.shape[0] != layout.n:
        raise ValueError(
            f"values must have shape ({layout.n},) for rank {layout.rank} "
            f"dim {layout.dim}; got {tuple(vals.shape)}"
        )
    ntri = comb.tri_size(layout.dim)
    if tri.ndim != 1 or tri.shape[0] != ntri:
        raise ValueError(
            f"tri must have shape ({ntri},); got {tuple(tri.shape)}"
        )
    if tri.dtype != acc_dtype(vals.dtype):
        raise TypeError(
            f"tri must be {acc_dtype(vals.dtype)} for {vals.dtype} values; "
            f"got {tri.dtype}"
        )
    if vals.device != tri.device:
        raise ValueError(
            f"values on {vals.device} and tri on {tri.device}: one device"
        )
    if not (vals.is_contiguous() and tri.is_contiguous()):
        raise ValueError("group_pass needs contiguous values and tri")


def _twin(vals: torch.Tensor, tri: torch.Tensor, layout: comb.GflatLayout
          ) -> torch.Tensor:
    """The twin's forward: ``torch.mv`` on zero-copy (P_j, T_j) views into
    one preallocated result (``out=``, so never under autograd)."""
    ct = tri.dtype
    out = torch.empty((3, int(layout.P.sum())), dtype=ct, device=vals.device)
    prow = row_offsets(layout)
    d = layout.dim
    with full_fp32_matmul():
        for j in range(len(layout.P)):
            P, T = int(layout.P[j]), int(layout.T[j])
            g, s, to = int(layout.group_off[j]), int(prow[j]), int(layout.tri_off[j])
            V = vals[g : g + P * T].view(P, T)
            if V.dtype != ct:  # bfloat16 storage: accumulate in float32
                V = V.to(ct)
            tri_j = tri[to : to + T]
            rl = d - j
            torch.mv(V, tri_j, out=out[0, s : s + P])
            torch.mv(V[:, :rl], tri_j[:rl], out=out[1, s : s + P])
            torch.mul(V[:, 0], tri_j[0], out=out[2, s : s + P])
    return out


def _tri_maps(layout: comb.GflatLayout, device: torch.device):
    """Static maps of the groups' tri slices laid end to end (ΣT_j
    columns), memoized: each column's tri index, the (3, ΣT_j) float64
    mask [1, t < d − j, t = 0] of the three row sums, and each group's
    first column (host ints)."""
    t = tables(layout.rank, layout.dim, device)

    def build():
        T = layout.T.astype(np.int64)
        first = np.concatenate(([0], np.cumsum(T)[:-1]))
        col = np.arange(T.sum(), dtype=np.int64) - np.repeat(first, T)
        rl = np.repeat(layout.dim - np.arange(len(T), dtype=np.int64), T)
        mask = np.stack([np.ones(len(col)), col < rl, col == 0]).astype(np.float64)
        return (torch.as_tensor(np.repeat(layout.tri_off, T) + col, device=device),
                torch.as_tensor(mask, device=device), first.tolist())

    return t.memo("group_pass_tri_maps", build)


def group_pass_backward(vals: torch.Tensor, tri: torch.Tensor,
                        grad: torch.Tensor, layout: comb.GflatLayout,
                        need_vals: bool = True, need_tri: bool = True):
    """(∂/∂vals, ∂/∂tri) of ⟨grad, group_pass(vals, tri)⟩, plain torch.

    With h_j = grad[:, s_j : s_j + P_j] (3, P_j) and m_j the (3, T_j) rows
    tri_j, tri_j on its first d − j entries, tri_j[0] on entry 0, group j's
    slice of ∂/∂vals is one product h_jᵀ·m_j, written in place into one
    n-sized buffer in the accumulation type, and ∂/∂tri gathers
    Σ_k (h_j·V_j)[k, t]·mask[k, t], one product that reads V_j once, into
    tri's entries with one ``index_add_``. Either is None when not needed."""
    ct = tri.dtype
    grad = grad.to(ct)
    prow = row_offsets(layout)
    tidx, mask, first = _tri_maps(layout, vals.device)
    mask = mask.to(ct)
    dvals = torch.empty(layout.n, dtype=ct, device=vals.device) if need_vals else None
    m = tri[tidx] * mask if need_vals else None
    parts = []
    with full_fp32_matmul():
        for j in range(len(layout.P)):
            P, T = int(layout.P[j]), int(layout.T[j])
            g, s, a = int(layout.group_off[j]), int(prow[j]), first[j]
            h = grad[:, s : s + P]
            if need_vals:
                torch.mm(h.t(), m[:, a : a + T], out=dvals[g : g + P * T].view(P, T))
            if need_tri:
                V = vals[g : g + P * T].view(P, T)
                parts.append(torch.mm(h, V if V.dtype == ct else V.to(ct)))
    dtri = None
    if need_tri:
        dtri = torch.zeros_like(tri).index_add_(0, tidx, (torch.cat(parts, 1) * mask).sum(0))
    if dvals is not None and dvals.dtype != vals.dtype:
        dvals = dvals.to(vals.dtype)
    return dvals, dtri


class _GroupPass(torch.autograd.Function):
    """The group pass with its plain-torch backward; the forward is the
    kernel (``kernel=True``) or the twin."""

    @staticmethod
    def forward(ctx, vals, tri, layout, kernel):
        ctx.layout = layout
        ctx.save_for_backward(vals, tri)
        return _launch(vals, tri, layout) if kernel else _twin(vals, tri, layout)

    @staticmethod
    @once_differentiable
    def backward(ctx, grad):
        vals, tri = ctx.saved_tensors
        need_vals, need_tri = ctx.needs_input_grad[:2]
        dvals, dtri = group_pass_backward(vals, tri, grad, ctx.layout,
                                          need_vals, need_tri)
        return dvals, dtri, None, None


def group_pass_ref(
    vals: torch.Tensor, tri: torch.Tensor, layout: comb.GflatLayout
) -> torch.Tensor:
    """Plain twin of the kernel: the same (3, ΣP_j) result from
    ``torch.mv`` on zero-copy (P_j, T_j) views, on any device;
    differentiable."""
    _check(vals, tri, layout)
    return _GroupPass.apply(vals, tri, layout, False)


def _device_tiles(layout: comb.GflatLayout, storage: torch.dtype,
                  device: torch.device):
    """What the kernel reads as ``tiles`` (the tile table, row by row, then
    its chunk starts) on the device, and the number of tiles; memoized."""
    t = tables(layout.rank, layout.dim, device)

    def build():
        tiles = tile_table(layout, storage)
        flat = np.concatenate((tiles.ravel(), chunk_starts(tiles)))
        return torch.as_tensor(flat, device=device), len(tiles)

    return t.memo(f"group_pass_tiles_{storage}", build)


def _launch(vals: torch.Tensor, tri: torch.Tensor, layout: comb.GflatLayout
            ) -> torch.Tensor:
    """One launch of the kernel over all groups; adds one to
    ``group_pass.launches``."""
    from ._build import load_library

    lib = load_library()
    tiles, ntiles = _device_tiles(layout, vals.dtype, vals.device)
    ncols = int(layout.P.sum())
    out = torch.empty((3, ncols), dtype=tri.dtype, device=vals.device)
    with torch.cuda.device(vals.device):
        stream = torch.cuda.current_stream(vals.device).cuda_stream
        err = getattr(lib, _SYMBOL[vals.dtype])(
            vals.data_ptr(), tri.data_ptr(), tiles.data_ptr(),
            ntiles, layout.dim, ncols, out.data_ptr(), stream,
        )
    if err != 0:
        raise RuntimeError(f"group_pass launch failed: CUDA error {err}")
    group_pass.launches += 1
    return out


def group_pass(
    vals: torch.Tensor, tri: torch.Tensor, layout: comb.GflatLayout
) -> torch.Tensor:
    """(3, ΣP_j) fused group reductions, differentiable. CUDA tensors
    launch the kernel (adding one to ``group_pass.launches``) or raise; CPU
    tensors run ``group_pass_ref``."""
    require_local("group_pass", vals, tri)
    if vals.device.type == "cpu":
        return group_pass_ref(vals, tri, layout)
    _check(vals, tri, layout)
    if vals.device.type != "cuda":
        raise ValueError(f"group_pass runs on CPU or CUDA; got {vals.device}")
    return _GroupPass.apply(vals, tri, layout, True)


group_pass.launches = 0


# ------------------------------------------------------------ evaluation


def head_runs(t):
    """(maxel, maxrun) int64 per head (colex, N_{r−3} heads) of the tables'
    rank: each head's largest value and its run length, which give the
    head's trailing run q of group j (q = maxrun where maxel = j, else 0).
    Rank 3 has one empty head, which equals no j."""
    if t.rank == 3:
        return (
            torch.full((1,), -1, dtype=torch.int64, device=t.device),
            torch.zeros((1,), dtype=torch.int64, device=t.device),
        )
    _, maxel, maxrun = t.mono_tables_weighted(t.rank - 3)[-1]
    return maxel, maxrun


def corrections(q, xj):
    """(c1, c2, c3) for trailing run q and input value x_j: the weights of
    a row's full, row and cell sums."""
    c1 = xj / (q + 1)
    c2 = c1 * (1.0 / (q + 2) - 1.0)
    c3 = c1 * (2.0 / ((q + 2) * (q + 3)) - 1.0 / (q + 2))
    return c1, c2, c3


def row_maps(layout: comb.GflatLayout, device: torch.device):
    """Each of the ΣP_j rows' group j and head p (int64, on the device;
    memoized): group j's rows are heads 0 … P_j − 1 in colex order."""
    t = tables(layout.rank, layout.dim, device)

    def build():
        P = layout.P
        rg = np.repeat(np.arange(len(P), dtype=np.int64), P)
        rh = np.arange(int(P.sum()), dtype=np.int64) - np.repeat(row_offsets(layout), P)
        return torch.as_tensor(rg, device=device), torch.as_tensor(rh, device=device)

    return t.memo("group_pass_rows", build)


def _eval_static(layout: comb.GflatLayout, device: torch.device):
    """The evaluation mode's static inputs on the device (memoized): each
    head's code maxel · HEAD_SHIFT + maxrun (int32, N_{r−3}), and the
    (r − 2, 3) float64 ``corrections`` at x_j = 1 for q = 0 … r − 3, row
    by row."""
    t = tables(layout.rank, layout.dim, device)

    def build():
        maxel, maxrun = head_runs(t)
        heads = (maxel * HEAD_SHIFT + maxrun).to(torch.int32)
        q = torch.arange(layout.rank - 2, dtype=torch.float64)
        corr = torch.stack(corrections(q, 1.0), 1).contiguous()
        return heads.contiguous(), corr.to(device)

    return t.memo("group_eval_static", build)


def _check_eval(vals, tri, M, x, layout: comb.GflatLayout):
    _check(vals, tri, layout)
    if layout.rank - 3 >= HEAD_SHIFT:
        raise ValueError(f"group_eval takes rank < {HEAD_SHIFT + 3}; got {layout.rank}")
    nheads = int(layout.P[-1])
    for name, v, size in (("M", M, nheads), ("x", x, layout.dim)):
        if v.dtype != torch.float64 or v.ndim != 1 or v.shape[0] != size:
            raise ValueError(
                f"{name} must be float64 of shape ({size},); got {v.dtype} "
                f"{tuple(v.shape)}")
        if v.device != vals.device or not v.is_contiguous():
            raise ValueError(f"{name} must be contiguous on {vals.device}")
    if torch.is_grad_enabled() and any(
            v.requires_grad for v in (vals, tri, M, x)):
        raise RuntimeError(
            "group_eval has no backward: a gradient takes group_pass and "
            "weights its rows")


def row_weights(layout: comb.GflatLayout, device: torch.device) -> torch.Tensor:
    """The ``corrections`` (c1, c2, c3) at x_j = 1 of each of the ΣP_j
    rows, a (ΣP_j, 3) float64 tensor on the device, decoded from the
    evaluation mode's own inputs (``_eval_static``) as the kernel decodes
    them: row p of group j has q = maxrun[p] where maxel[p] = j, else 0.
    The unfused epilogue and the batched route weight their rows by it."""
    rg, rh = row_maps(layout, device)
    heads, corr = _eval_static(layout, device)
    h = heads[rh]
    return corr[torch.where(h // HEAD_SHIFT == rg, h % HEAD_SHIFT, 0)]


def group_eval_terms(vals, tri, M, x, layout: comb.GflatLayout) -> torch.Tensor:
    """The ΣP_j weighted rows M̃[p]·x_j·(c1·u_full + c2·u_row + c3·u_cell)
    (float64) from ``group_pass_ref``'s rows and ``row_weights``; r! times
    their sum is ``group_eval``."""
    u = group_pass_ref(vals, tri, layout).to(torch.float64)
    rg, rh = row_maps(layout, vals.device)
    c = row_weights(layout, vals.device)
    return M[rh] * x[rg] * (c[:, 0] * u[0] + c[:, 1] * u[1] + c[:, 2] * u[2])


def group_eval_ref(vals, tri, M, x, layout: comb.GflatLayout) -> torch.Tensor:
    """Plain twin of the evaluation mode: the same 0-d float64 result,
    r!·Σ ``group_eval_terms``, on any device."""
    _check_eval(vals, tri, M, x, layout)
    return float(math.factorial(layout.rank)) * group_eval_terms(vals, tri, M, x, layout).sum()


@functools.lru_cache(maxsize=None)
def _capacity(index: int) -> int:
    """Partials the evaluation mode may write: one per SM, the kernel's
    resident blocks (one a multiprocessor)."""
    return torch.cuda.get_device_properties(index).multi_processor_count


_WORK: dict = {}


def _work(dev: torch.device, stream: int) -> tuple:
    """The evaluation mode's work buffer for launches on `stream`: the
    float64 partials, one a block, then the done counter, zeroed once here
    and set back to zero by the last block of every launch. Launches on one
    stream run in order, so they share it; each stream has its own."""
    key = (dev.index, stream)
    if key not in _WORK:
        cap = _capacity(dev.index)
        _WORK[key] = (torch.zeros(cap + 1, dtype=torch.float64, device=dev), cap)
    return _WORK[key]


def _launch_eval(vals, tri, M, x, layout: comb.GflatLayout) -> torch.Tensor:
    """The checks and one launch of the kernel's evaluation mode; adds one
    to ``group_eval.launches``."""
    from ._build import load_library

    _check_eval(vals, tri, M, x, layout)
    if vals.device.type != "cuda":
        raise ValueError(f"group_eval runs on CPU or CUDA; got {vals.device}")
    lib = load_library()
    dev = vals.device
    tiles, ntiles = _device_tiles(layout, vals.dtype, dev)
    heads, corr = _eval_static(layout, dev)
    out = torch.empty((), dtype=torch.float64, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        work, cap = _work(dev, stream)
        err = getattr(lib, _EVAL_SYMBOL[vals.dtype])(
            vals.data_ptr(), tri.data_ptr(), tiles.data_ptr(), ntiles,
            layout.dim, M.data_ptr(), heads.data_ptr(), x.data_ptr(),
            corr.data_ptr(), float(math.factorial(layout.rank)),
            work.data_ptr(), cap, out.data_ptr(), stream,
        )
    if err != 0:
        raise RuntimeError(f"group_eval launch failed: CUDA error {err}")
    group_eval.launches += 1
    return out


def group_eval(vals, tri, M, x, layout: comb.GflatLayout) -> torch.Tensor:
    """r!·Σ_rows M̃[p]·x_j·(c1·u_full + c2·u_row + c3·u_cell), a 0-d
    float64 tensor, from one pass over the values: M the (N_{r−3},)
    float64 head monomials, x the (d,) float64 input, vals and tri as for
    ``group_pass``. CUDA tensors launch the kernel's evaluation mode
    (adding one to ``group_eval.launches``) or raise; CPU tensors run
    ``group_eval_ref``. No backward: it raises where a gradient is
    needed."""
    require_local("group_eval", vals, tri, M, x)
    if vals.device.type == "cpu":
        return group_eval_ref(vals, tri, M, x, layout)
    return spanned("group_eval.launch", _launch_eval, vals, tri, M, x, layout)


group_eval.launches = 0
