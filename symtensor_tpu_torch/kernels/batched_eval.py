"""Batched evaluation of a packed rank ≥ 3 tensor in one launch: the
wrapper of ``csrc/batched_fold.cu`` and its tile list.

For B inputs x_b it computes the fold of ``poly_eval._batched_forward``,

    out[b] = r!·Σ_j x_bj·Σ_p M̃[b, p]·Σ_t tri[b, toff_j + t]·V_j[p, t]·ω_j(p, t)
    ω_j(p, t) = w1[p] + w2[p]·[t < d − j] + w3[p]·[t = 0]

over all d groups in one launch, to float32 accuracy on the tensor cores
(a split-TF32 product: each operand as two TF32 halves, three products),
with the fold weights applied as the value tiles load and the M̃·x_j
weighting in registers: no folded copy of a block, no (B, P_j) product and
no per-group launch. The kernel replaces no TPU kernel (the JAX package
leaves the batched route to XLA's matmul); ``.cu``'s note says what bounds
it and how it is built. ``_batched_forward`` is its plain twin: CPU tensors
and other types run it (``poly_eval._BatchedEval`` routes by device and
type); this wrapper raises on anything but float32 CUDA tensors.

Tiles. Output tiles run over (b, p), BM inputs by BN rows of one group,
and reduce over a run of at most ``ENTRY_COLUMNS`` columns of t.
``tile_list`` is the host table of one entry per (group, BN rows, run),
ordered by the run's length from the largest down; the kernel pairs each
entry with every one of the Bp / BM batch tiles (Bp, the batch padded to a
multiple of BM, is the width of the transposed tri). ``tile_shape`` picks
BM from the batch and BN from the widest group.
"""

from __future__ import annotations

import functools
import math

import numpy as np
import torch

from ..core.base import require_local
from ..utils import combinatorics as comb
from ..utils.tables import tables
from .group_pass import head_codes

# csrc/batched_fold.cu: the blocks an SM its launch bounds keep resident,
# and the int64 fields of a table entry (kTileFields, the enum).
BLOCKS_PER_SM = 2
FIELDS = ("j", "p0", "np", "T", "voff", "toff", "t0", "nt")
# Columns of t an entry takes at most. The tensor cores add each product
# into their float32 sums with a truncating addition, whose error drifts
# one way; the kernel adds each entry's sums into float64, so the drift
# runs over at most this many columns (3 products of 8 each a wgmma).
ENTRY_COLUMNS = 256


def padded_work(layout: comb.GflatLayout, bn: int) -> int:
    """Σ_j ⌈P_j / BN⌉·BN·T_j: the products a batch row costs with tiles of
    BN rows, masked rows included."""
    P, T = layout.P.astype(np.int64), layout.T.astype(np.int64)
    return int((-(-P // bn) * bn * T).sum())


@functools.lru_cache(maxsize=None)
def _tile_rows(rank: int, dim: int) -> int:
    layout = comb.gflat_layout(rank, dim)
    return 32 if 2 * padded_work(layout, 32) <= padded_work(layout, 128) else 128


def tile_shape(batch: int, layout: comb.GflatLayout) -> tuple:
    """(BM, BN): 16, 64 or 128 inputs a tile, the fewest that hold the
    batch, else 128; 32 rows a tile where tiles of 128 would at least
    double the products (rank 3's groups have one row each, rank 4's at
    most d), else 128."""
    bm = next((m for m in (16, 64) if batch <= m), 128)
    return bm, _tile_rows(layout.rank, layout.dim)


def padded_batch(batch: int, layout: comb.GflatLayout) -> int:
    """Bp: the batch rounded up to a multiple of the tile's BM."""
    bm = tile_shape(batch, layout)[0]
    return bm * -(-batch // bm)


def tile_list(layout: comb.GflatLayout, bn: int) -> np.ndarray:
    """(nentries, 8) int64 host table, one entry per BN rows of a group and
    ``ENTRY_COLUMNS`` columns of its t: (j, p0, np, T_j, goff_j + p0·T_j,
    toff_j, t0, nt) as named in ``FIELDS``, np = min(BN, P_j − p0),
    nt = min(ENTRY_COLUMNS, T_j − t0). Entries are ordered by nt from the
    largest down (then groups, rows and t0 in order), so that persistent
    blocks taking every grid-th tile start on the longest ones."""
    out = []
    for j in range(len(layout.P)):
        P, T = int(layout.P[j]), int(layout.T[j])
        p0, t0 = np.meshgrid(np.arange(0, P, bn, dtype=np.int64),
                             np.arange(0, T, ENTRY_COLUMNS, dtype=np.int64),
                             indexing="ij")
        p0, t0 = p0.ravel(), t0.ravel()
        blk = np.empty((len(p0), len(FIELDS)), dtype=np.int64)
        blk[:, 0] = j
        blk[:, 1] = p0
        blk[:, 2] = np.minimum(bn, P - p0)
        blk[:, 3] = T
        blk[:, 4] = int(layout.group_off[j]) + p0 * T
        blk[:, 5] = int(layout.tri_off[j])
        blk[:, 6] = t0
        blk[:, 7] = np.minimum(ENTRY_COLUMNS, T - t0)
        out.append(blk)
    tiles = np.concatenate(out)
    return tiles[np.argsort(-tiles[:, 7], kind="stable")]


def _device_tiles(layout: comb.GflatLayout, bn: int, device: torch.device):
    """``tile_list`` on the device and its number of entries; memoized
    per (rank, dim, BN, device)."""
    t = tables(layout.rank, layout.dim, device)

    def build():
        tiles = tile_list(layout, bn)
        return torch.as_tensor(tiles, device=device), len(tiles)

    return t.memo(("batched_eval_tiles", bn), build)


def _check(vals, tri_t, M, xs, layout: comb.GflatLayout) -> None:
    if layout.rank < 3:
        raise ValueError(f"batched_eval needs rank >= 3; got {layout.rank}")
    named = (("values", vals), ("tri", tri_t), ("M", M), ("xs", xs))
    for name, v in named:
        if v.device.type != "cuda" or v.dtype != torch.float32:
            raise TypeError(
                f"batched_eval takes float32 CUDA tensors; {name} is {v.dtype} "
                f"on {v.device} (CPU tensors and other types take "
                "poly_eval._batched_forward)")
        if v.device != vals.device or not v.is_contiguous():
            raise ValueError(f"{name} must be contiguous on {vals.device}")
    B, d = len(xs), layout.dim
    Bp = padded_batch(B, layout)
    for name, v, shape in (("values", vals, (layout.n,)), ("xs", xs, (B, d)),
                           ("tri", tri_t, (comb.tri_size(d), Bp)),
                           ("M", M, (B, int(layout.P[-1])))):
        if tuple(v.shape) != shape:
            raise ValueError(f"{name} must have shape {shape}; got {tuple(v.shape)}")
    if tri_t.data_ptr() % 16:
        raise ValueError("tri must start on a 16-byte boundary")
    if torch.is_grad_enabled() and any(v.requires_grad for _, v in named):
        raise RuntimeError("batched_eval has no backward: poly_eval._BatchedEval "
                           "carries the gradient")


def batched_eval(vals, tri_t, M, xs, layout: comb.GflatLayout) -> torch.Tensor:
    """(B,) float32 r!·Σ_j x_bj·Σ_p M̃[b, p]·(tri_j·Ṽ_jᵀ)[b, p] in one
    launch of the kernel: vals the packed float32 values, tri_t the
    (Ttri, Bp) triangle monomials of the batch (column b for input b, zero
    past B; Bp = ``padded_batch``), M the (B, N_{r−3}) head monomials, xs
    the (B, d) inputs; all float32, contiguous, on one CUDA device. Adds one
    to ``batched_eval.launches``; raises on anything else."""
    from ._build import capacity, done_counter, load_library

    require_local("batched_eval", vals, tri_t, M, xs)
    _check(vals, tri_t, M, xs, layout)
    B, dev = len(xs), vals.device
    out = torch.empty(B, dtype=torch.float32, device=dev)
    if B == 0:
        return out
    bm, bn = tile_shape(B, layout)
    Bp = tri_t.shape[1]
    tiles, nentries = _device_tiles(layout, bn, dev)
    heads, corr = head_codes(layout, dev)
    cap = capacity(dev.index, BLOCKS_PER_SM)
    partials = torch.empty((cap, Bp), dtype=torch.float64, device=dev)
    lib = load_library()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.batched_fold_f32(
            vals.data_ptr(), tri_t.data_ptr(), M.data_ptr(), xs.data_ptr(),
            heads.data_ptr(), corr.data_ptr(), tiles.data_ptr(), nentries, B,
            Bp, M.shape[1], layout.dim, bm, bn, float(math.factorial(layout.rank)),
            partials.data_ptr(), cap, done_counter(dev, stream).data_ptr(),
            out.data_ptr(), stream,
        )
    if err != 0:
        raise RuntimeError(f"batched_eval launch failed: CUDA error {err}")
    batched_eval.launches += 1
    return out


batched_eval.launches = 0
