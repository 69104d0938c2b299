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
values, in place, with no view copies and no transposed narrow groups. On a
CPU tensor it runs the plain twin ``group_pass_ref``: three ``torch.mv``
products per group on zero-copy views. Nothing falls back from the kernel
to the twin.
"""

from __future__ import annotations

import numpy as np
import torch

from ..utils import combinatorics as comb
from ..utils.precision import full_fp32_matmul
from ..utils.tables import tables

# Threads per block and rows per lane segment of the CUDA kernel
# (csrc/group_pass.cu: kThreads, kRows). The tile table sizes its tiles by
# them; any tile split is correct, these make it a whole number of passes.
THREADS = 256
ROWS = 4
# Values per tile the table aims at: enough blocks to fill the card many
# times over, few enough that the table stays small.
TILE_VALUES = 32768

_STORAGE = (torch.float32, torch.bfloat16, torch.float64)
_SYMBOL = {
    torch.float32: "group_pass_f32",
    torch.bfloat16: "group_pass_bf16",
    torch.float64: "group_pass_f64",
}


def acc_dtype(storage: torch.dtype) -> torch.dtype:
    """Accumulation (and output) type of the pass for a storage type."""
    return torch.float64 if storage == torch.float64 else torch.float32


def row_offsets(layout: comb.GflatLayout) -> np.ndarray:
    """prow_off: the first output column of each group (exclusive cumsum
    of P_j)."""
    return np.concatenate(([0], np.cumsum(layout.P)[:-1])).astype(np.int64)


def tile_table(layout: comb.GflatLayout) -> np.ndarray:
    """(ntiles, 8) int64 host table, one row per CUDA block:
    (j, first row, row count, T_j, goff_j, toff_j, prow_off_j, L).

    L, the lanes that share one row, is the largest power of two ≤ T_j,
    capped at 32. A tile holds a whole number of passes of the block (its
    THREADS/L row segments, ROWS rows each) and about TILE_VALUES values,
    so wide groups are split by rows and narrow groups pack many rows per
    block."""
    prow = row_offsets(layout)
    out = []
    for j in range(len(layout.P)):
        P, T = int(layout.P[j]), int(layout.T[j])
        L = min(32, 1 << (T.bit_length() - 1))
        per_pass = THREADS // L * ROWS
        rows = per_pass * max(1, TILE_VALUES // (per_pass * T))
        row0 = np.arange(0, P, rows, dtype=np.int64)
        blk = np.empty((len(row0), 8), dtype=np.int64)
        blk[:, 0] = j
        blk[:, 1] = row0
        blk[:, 2] = np.minimum(rows, P - row0)
        blk[:, 3] = T
        blk[:, 4] = layout.group_off[j]
        blk[:, 5] = layout.tri_off[j]
        blk[:, 6] = prow[j]
        blk[:, 7] = L
        out.append(blk)
    return np.concatenate(out)


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


def group_pass_ref(
    vals: torch.Tensor, tri: torch.Tensor, layout: comb.GflatLayout
) -> torch.Tensor:
    """Plain twin of the kernel: the same (3, ΣP_j) result from
    ``torch.mv`` on zero-copy (P_j, T_j) views, on any device."""
    _check(vals, tri, layout)
    ct = tri.dtype
    ncols = int(layout.P.sum())
    out = torch.empty((3, ncols), dtype=ct, device=vals.device)
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


def _device_tiles(layout: comb.GflatLayout, device: torch.device):
    t = tables(layout.rank, layout.dim, device)
    return t.memo(
        "group_pass_tiles",
        lambda: torch.as_tensor(tile_table(layout), device=device),
    )


def group_pass(
    vals: torch.Tensor, tri: torch.Tensor, layout: comb.GflatLayout
) -> torch.Tensor:
    """(3, ΣP_j) fused group reductions. CUDA tensors launch the kernel
    (adding one to ``group_pass.launches``) or raise; CPU tensors run
    ``group_pass_ref``."""
    _check(vals, tri, layout)
    if vals.device.type == "cpu":
        return group_pass_ref(vals, tri, layout)
    if vals.device.type != "cuda":
        raise ValueError(f"group_pass runs on CPU or CUDA; got {vals.device}")
    from ._build import load_library

    lib = load_library()
    tiles = _device_tiles(layout, vals.device)
    ncols = int(layout.P.sum())
    out = torch.empty((3, ncols), dtype=tri.dtype, device=vals.device)
    with torch.cuda.device(vals.device):
        stream = torch.cuda.current_stream(vals.device).cuda_stream
        err = getattr(lib, _SYMBOL[vals.dtype])(
            vals.data_ptr(), tri.data_ptr(), tiles.data_ptr(),
            tiles.shape[0], layout.dim, ncols, out.data_ptr(), stream,
        )
    if err != 0:
        raise RuntimeError(f"group_pass launch failed: CUDA error {err}")
    group_pass.launches += 1
    return out


group_pass.launches = 0
