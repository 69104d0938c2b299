"""One-off timings of the whole-level basis change on one CUDA card.

    python3 -m symtensor_tpu_torch.tools.basis_change_probe

Prints, each with the card's name and power limit:

1. at rank 4 dim 100 -> 100 float32 (BASELINE C2), per level: the gather
   through the insert table with int64 and with int32 indices, the product
   in the "pji,ib->pjb" layout (one GEMM, rows picked at a stride) and in
   the "pij,ib->pbj" layout (a batched GEMM, contiguous rows picked), and
   the pick in both layouts;
2. the packed change at rank 5 dim 60 and rank 6 dim 32 under transient
   budgets of 2**24, 2**26 and 2**28 elements: time and peak memory.
"""

from __future__ import annotations

import statistics
import subprocess

import torch

from ..ops import basis_change as bc
from ..utils import combinatorics as comb
from ..utils.precision import full_fp32_matmul
from ..utils.tables import tables


def median_ms(fn, warmup: int = 3, iters: int = 10) -> float:
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(iters):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def main() -> None:
    dev = torch.device("cuda", 0)
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    r, d = 4, 100
    T = tables(r, d, dev)
    W = torch.randn(d, d, generator=gen, device=dev) / d**0.5
    U = torch.randn(1, comb.indep_size(r, d), generator=gen, device=dev)
    with full_fp32_matmul():
        for t in range(r):
            k = r - t - 1
            par, mx = T.mono_tables(t + 1)
            if k >= 1:
                tbl = T.insert_table(k)
                tbl32, tblT = tbl.int(), tbl.T.contiguous()
                G = U[:, tbl]
                GT = U[:, tblT]
                times = {
                    "gather int64": median_ms(lambda: U[:, tbl]),
                    "gather int32": median_ms(lambda: U[:, tbl32]),
                    "gather (p, i, j)": median_ms(lambda: U[:, tblT]),
                }
            else:
                G = U.reshape(-1, 1, d)
                GT = U.reshape(-1, d, 1)
                times = {}
            H = torch.einsum("pji,ib->pjb", G, W)
            HT = torch.einsum("pij,ib->pbj", GT, W)
            times["product pjb"] = median_ms(
                lambda: torch.einsum("pji,ib->pjb", G, W))
            times["product pbj"] = median_ms(
                lambda: torch.einsum("pij,ib->pbj", GT, W))
            times["pick pjb"] = median_ms(lambda: H[par, :, mx])
            times["pick pbj"] = median_ms(lambda: HT[par, mx])
            err = float((H[par, :, mx] - HT[par, mx]).abs().max())
            print(f"[probe] rank {r} dim {d} level {t}: parent "
                  f"{tuple(U.shape)}, gathered {G.numel()} elements, child "
                  f"{par.shape[0]} x {H.shape[1]}; " + ", ".join(
                      f"{k_} {v:.4f} ms" for k_, v in times.items())
                  + f"; layouts differ by {err:.2e} [{card}]", flush=True)
            U = H[par, :, mx]
            del G, GT, H, HT
    for r, d in ((5, 60), (6, 32)):
        A = torch.randn(comb.indep_size(r, d), generator=gen, device=dev)
        W = torch.randn(d, d, generator=gen, device=dev) / d**0.5
        ref = None
        for budget in (2**24, 2**26, 2**28):
            call = lambda: bc._basis_change_levels(  # noqa: E731
                A, W, r, d, d, torch.float32, torch.float32, budget)
            out = call()
            ref = out if ref is None else ref
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            before = torch.cuda.memory_allocated()
            call()
            torch.cuda.synchronize()
            peak = torch.cuda.max_memory_allocated()
            print(f"[probe] rank {r} dim {d} -> {d} float32, budget {budget}: "
                  f"{median_ms(call, iters=5):.4f} ms, peak "
                  f"{peak / 1e9:.3f} GB ({before / 1e9:.3f} GB before the "
                  f"call), projected "
                  f"{bc._small_peak_elems(r, d, d, budget) * 4 / 1e9:.3f} GB; "
                  f"against the first budget's result "
                  f"{float((out - ref).abs().max() / ref.abs().max()):.2e} "
                  f"[{card}]", flush=True)
        del A, W, ref, out
        torch.cuda.empty_cache()


if __name__ == "__main__":
    main()
