"""Weighted gather-combine: kernel wrapper, plain twin and gradient.

Replaces the TPU kernel ``symtensor_tpu/kernels/gather_mm.py:_build_op``
(inner ``kernel``; entry ``gather_combine``). For R index rows over n_out
outputs,

    out[o] = Σ_{r<R} w[r] · a[idxA[r, o]] · b[idxB[r, o]]

with w = 1/R by default. The symmetrized outer product (R = position
subsets) and tensordot's table route (R = subsets × contraction multisets)
run through it.

The op is bound by the bytes of its index tables: every (r, o) reads two
indices once, against small operand tables that every output reuses. On a
CUDA tensor ``gather_combine`` launches the hand-written kernel
(``csrc/gather_combine.cu``): a thread per few outputs (``launch_plan``)
loops over r with coalesced index loads issued several rows ahead, and a
and b are read through the read-only cache. On a
CPU tensor it runs the plain twin ``gather_combine_ref``, a loop over r
that keeps its memory at O(n_out). Nothing falls back from the kernel to
the twin.

Index tables are int32 here: the one deliberate exception to the port's
int64 rule, since int32 halves the bytes that bound the kernel. A source
under the table guard has far fewer than 2**31 entries; ``_check`` refuses
n_a or n_b ≥ 2**31.

Accumulation is float64 for float64 operands and float32 for float32,
bfloat16 and float16 ones; the result has the operands' promoted type
(a 16-bit result is rounded once after the float32 sum). The gradient is a
``torch.autograd.Function`` whose backward is plain torch, as the JAX
package computes its VJP in XLA (``segment_sum``), outside Pallas.

The TPU kernel's one-hot MXU gathers, its 128-lane split and its
``_MAX_SRC``/``_MAX_ROWS`` caps are TPU facts and have no counterpart.
"""

from __future__ import annotations

from functools import lru_cache
from typing import NamedTuple

import torch

from ..core.base import require_local

# The kernel's entry point per operand type.
_SYMBOL = {
    torch.float32: "gather_combine_f32",
    torch.bfloat16: "gather_combine_bf16",
    torch.float16: "gather_combine_f16",
    torch.float64: "gather_combine_f64",
}
# The kernel's (outputs per thread, threads per block) choices, from the
# largest tile down; smaller tiles make more blocks for a small n_out.
# Timed as device time on the H100 (chip_smoke.py phase 11, PERF.md),
# each is the fastest of the four at some rank-3 x rank-3 size: 4 × 256
# at the dim-36 subset tables, 2 × 256 at dim 30, 1 × 256 at dim 18,
# 1 × 128 at tensordot's table route.
TILE_CHOICES = ((4, 256), (2, 256), (1, 256), (1, 128))
# Blocks per SM the plan aims at before it takes a smaller tile.
BLOCKS_PER_SM = 2
INDEX_LIMIT = 2**31


def acc_dtype(dtype: torch.dtype) -> torch.dtype:
    """Accumulation type of the combine for an operand type."""
    return torch.float64 if dtype == torch.float64 else torch.float32


def usable(a: torch.Tensor, b: torch.Tensor) -> bool:
    """The routing gate, the JAX package's: floating operands, since the
    weighted combine would truncate integers. A floating type the kernel
    does not take (float8) raises in ``gather_combine``."""
    return torch.result_type(a, b).is_floating_point


class LaunchPlan(NamedTuple):
    items: int    # outputs per thread
    threads: int  # threads per block
    tiles: int    # output tiles of items × threads outputs


def launch_plan(n_out: int, sm_count: int) -> LaunchPlan:
    """The kernel's tile for n_out outputs on a card of sm_count SMs: the
    largest of ``TILE_CHOICES`` that still gives BLOCKS_PER_SM tiles per
    SM, else the smallest. The kernel's persistent grid (the blocks that
    fit the card at once) walks the tiles, so every n_out is covered."""
    for items, threads in TILE_CHOICES:
        tiles = -(-n_out // (items * threads))
        if tiles >= BLOCKS_PER_SM * sm_count:
            break
    return LaunchPlan(items, threads, tiles)


@lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def _check(a, b, w, idxA, idxB) -> None:
    if a.dtype not in _SYMBOL or b.dtype != a.dtype or w.dtype != acc_dtype(a.dtype):
        raise TypeError(
            "gather_combine takes float32, bfloat16, float16 or float64 "
            "operands of one type and weights in its accumulation type; got "
            f"{a.dtype}, "
            f"{b.dtype}, weights {w.dtype}"
        )
    if idxA.dtype != torch.int32 or idxB.dtype != torch.int32:
        raise TypeError(
            f"index tables must be int32; got {idxA.dtype}, {idxB.dtype}"
        )
    if a.ndim != 1 or b.ndim != 1 or idxA.ndim != 2 or idxA.shape != idxB.shape:
        raise ValueError(
            "gather_combine needs 1-D a and b and two (R, n_out) index "
            f"tables; got {tuple(a.shape)}, {tuple(b.shape)}, "
            f"{tuple(idxA.shape)}, {tuple(idxB.shape)}"
        )
    R, n_out = idxA.shape
    if R < 1 or n_out < 1 or w.shape != (R,):
        raise ValueError(
            f"need R ≥ 1, n_out ≥ 1 and weights of shape ({R},); got "
            f"({R}, {n_out}) tables and weights {tuple(w.shape)}"
        )
    if not (0 < a.shape[0] < INDEX_LIMIT and 0 < b.shape[0] < INDEX_LIMIT):
        raise ValueError(
            f"int32 index tables address sources of 1 to 2**31 − 1 entries; "
            f"got n_a = {a.shape[0]}, n_b = {b.shape[0]}"
        )
    devices = {t.device for t in (a, b, w, idxA, idxB)}
    if len(devices) != 1:
        raise ValueError(f"gather_combine needs one device; got {devices}")
    if not all(t.is_contiguous() for t in (a, b, w, idxA, idxB)):
        raise ValueError("gather_combine needs contiguous tensors")


def gather_combine_ref(a, b, idxA, idxB, w) -> torch.Tensor:
    """Plain twin of the kernel, on any device: a loop over the R rows,
    summing w[r]·a[idxA[r]]·b[idxB[r]] in the accumulation type."""
    _check(a, b, w, idxA, idxB)
    at = acc_dtype(a.dtype)
    acc = torch.zeros(idxA.shape[1], dtype=at, device=a.device)
    for r in range(idxA.shape[0]):
        acc += w[r] * a[idxA[r]].to(at) * b[idxB[r]].to(at)
    return acc.to(a.dtype)


def _launch(a, b, idxA, idxB, w) -> torch.Tensor:
    """One kernel launch (CUDA) or the twin (CPU)."""
    if a.device.type == "cpu":
        return gather_combine_ref(a, b, idxA, idxB, w)
    if a.device.type != "cuda":
        raise ValueError(f"gather_combine runs on CPU or CUDA; got {a.device}")
    from ._build import load_library

    lib = load_library()
    R, n_out = idxA.shape
    out = torch.empty(n_out, dtype=a.dtype, device=a.device)
    with torch.cuda.device(a.device):
        plan = launch_plan(n_out, _sm_count(torch.cuda.current_device()))
        stream = torch.cuda.current_stream(a.device).cuda_stream
        err = getattr(lib, _SYMBOL[a.dtype])(
            a.data_ptr(), b.data_ptr(), w.data_ptr(), idxA.data_ptr(),
            idxB.data_ptr(), R, n_out, a.shape[0], b.shape[0], plan.items,
            plan.threads, out.data_ptr(), stream,
        )
    if err != 0:
        raise RuntimeError(f"gather_combine launch failed: CUDA error {err}")
    gather_combine.launches += 1
    return out


class _GatherCombine(torch.autograd.Function):
    """Forward: the kernel or the twin. Backward (plain torch, after the
    JAX custom VJP, ``gather_mm.py:161-171``): da and db scatter-add
    w·g·(other operand) over their index tables; dw[r] = Σ_o g·a·b."""

    @staticmethod
    def forward(ctx, a, b, w, idxA, idxB):
        _check(a, b, w, idxA, idxB)
        ctx.save_for_backward(a, b, w, idxA, idxB)
        return _launch(a, b, idxA, idxB, w)

    @staticmethod
    def backward(ctx, g):
        a, b, w, idxA, idxB = ctx.saved_tensors
        at = w.dtype
        g = g.to(at)
        ia, ib = idxA.long(), idxB.long()
        av, bv = a.to(at)[ia], b.to(at)[ib]  # (R, n_out)
        da = db = dw = None
        if ctx.needs_input_grad[0]:
            src = (w[:, None] * g[None, :] * bv).reshape(-1)
            da = torch.zeros(a.shape[0], dtype=at, device=a.device)
            da = da.index_add_(0, ia.reshape(-1), src).to(a.dtype)
        if ctx.needs_input_grad[1]:
            src = (w[:, None] * g[None, :] * av).reshape(-1)
            db = torch.zeros(b.shape[0], dtype=at, device=b.device)
            db = db.index_add_(0, ib.reshape(-1), src).to(b.dtype)
        if ctx.needs_input_grad[2]:
            dw = (g[None, :] * av * bv).sum(1)
        return da, db, dw, None, None


def gather_combine(a, b, idxA, idxB, weights=None) -> torch.Tensor:
    """Σ_r w[r] · a[idxA[r]] · b[idxB[r]] per output, in the operands'
    promoted type (the semantics of the JAX package's ``gather_combine``).

    a: (n_a,), b: (n_b,) floating; idxA, idxB: (R, n_out) int32; weights:
    (R,) or None for the mean over rows. Differentiable in a, b and the
    weights. CUDA tensors launch the kernel (adding one to
    ``gather_combine.launches``) or raise; CPU tensors run the twin."""
    require_local("gather_combine", a, b)
    ct = torch.result_type(a, b)
    if not ct.is_floating_point:
        raise TypeError(
            "gather_combine needs floating-point operands (weighted combine "
            f"would truncate {ct})"
        )
    R = idxA.shape[0]
    at = acc_dtype(ct)
    if weights is None:
        w = torch.full((R,), 1.0 / R, dtype=at, device=a.device)
    else:
        w = torch.as_tensor(weights, device=a.device).to(at)
    return _GatherCombine.apply(a.to(ct), b.to(ct), w, idxA, idxB)


gather_combine.launches = 0
