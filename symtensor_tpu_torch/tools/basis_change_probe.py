"""One-off timings of the packed basis change on one CUDA card.

    python3 -m symtensor_tpu_torch.tools.basis_change_probe [section ...]

Each line carries the card's name and power limit. Sections (default: all
but ``whole`` and ``full``):

``whole``   the whole-level route: at rank 4 dim 100 -> 100 float32
            (BASELINE C2) per level the gather through the insert table
            with int64 and int32 indices, the product in the "pji,ib->pjb"
            and "pij,ib->pbj" layouts and the pick in both; then rank 5 dim
            60 and rank 6 dim 32 under transient budgets 2**24 … 2**28.
``pick``    three forms of a chunk's product and pick at the shapes of a
            rank-6 dim-100 chunk, in turns: (a) the product (prefix,
            columns, window) and the strided pick ``H[par, :, b]``; (b) the
            product staged transposed (columns, prefix · window) and one
            shared-index column gather; (c) the product computed transposed
            (window, prefix · columns) and one gather of whole rows.
``parts``   the blocked route at rank 6 dim 50 -> 50 float32 under 2**28
            block and 2**26 transient elements: time per level and part
            (selectors, table or ranking, gather, product, pick, root pass,
            emit) from CUDA events around each part, beside the call's time
            without the timer, its chunk counts and its launches (torch ops
            counted by a dispatch mode).
``sweep``   the same call under block_elems × transient_elems: time, peak
            memory beside the projection, chunks and segments.
``rowpass`` level 1 of rank 6 dim 50 through the per-row root pass against
            the generic step with positions ranked on the device.
``full``    rank 6 dim 100 -> D_OUT (``--d-out``, default 100) through the
            blocked route (``--block-elems``, ``--transient-elems``,
            ``--row-pass-incid``) in float32 and, unless ``--float32-only``,
            with bfloat16 blocks: first call,
            second call, peak memory beside the projection, chunk counts,
            parts per level, and p_C(y) against p_A(W y) through the public
            evaluation.
"""

from __future__ import annotations

import argparse
import statistics
import subprocess
import time
from collections import defaultdict
from contextlib import contextmanager

import torch
from torch.utils._python_dispatch import TorchDispatchMode

from .. import ops as symalg
from ..core.flat import FlatSymmetricTensor
from ..ops import basis_change as bc
from ..utils import combinatorics as comb
from ..utils.precision import full_fp32_matmul
from ..utils.tables import tables

SECTIONS = ("whole", "pick", "parts", "sweep", "rowpass", "full")
MID = (6, 50)  # the shape of ``parts``, ``sweep`` and ``rowpass``
FULL = (6, 100)
# ``pick``: (prefix rows, columns, window) of two chunks of rank 6 dim 100
PICK_CHUNKS = ((3000, 512, 60), (60, 20000, 40))
SWEEP_BLOCKS = (2**26, 2**28, 2**30, 2**32)
SWEEP_TRANSIENTS = (2**24, 2**26, 2**28)


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


class PartTimer:
    """CUDA events around every part of the blocked route; ``totals`` sums
    them per (level, part) in ms after one synchronize."""

    def __init__(self):
        self.events = defaultdict(list)

    @contextmanager
    def __call__(self, name, t):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        yield
        end.record()
        self.events[(t, name)].append((start, end))

    def totals(self):
        torch.cuda.synchronize()
        return {key: (sum(s.elapsed_time(e) for s, e in evs), len(evs))
                for key, evs in sorted(self.events.items())}


class OpCount(TorchDispatchMode):
    """Counts the torch ops dispatched under it: about a launch each."""

    def __init__(self):
        super().__init__()
        self.n = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.n += 1
        return func(*args, **(kwargs or {}))


def timed_parts(call):
    """One call under a ``PartTimer``: its (level, part) totals."""
    timer = PartTimer()
    bc.part_timer = timer
    try:
        call()
    finally:
        bc.part_timer = None
    return timer.totals()


def parts_lines(tag, totals, card):
    by_level = defaultdict(list)
    for (t, name), (ms, n) in totals.items():
        by_level[t].append(f"{name} {ms:.2f} ms ({n})")
    for t, items in sorted(by_level.items()):
        print(f"[probe] {tag} level {t}: " + ", ".join(items) + f" [{card}]",
              flush=True)
    by_part = defaultdict(float)
    for (_, name), (ms, _) in totals.items():
        by_part[name] += ms
    print(f"[probe] {tag} all levels: " + ", ".join(
        f"{k} {v:.2f} ms" for k, v in sorted(by_part.items()))
        + f"; sum {sum(by_part.values()):.2f} ms [{card}]", flush=True)


def peak_of(call):
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    before = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    out = call()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    return out, wall, before / 1e9, torch.cuda.max_memory_allocated() / 1e9


def stats_text():
    lc = bc.last_call
    if lc.get("route") != "blocked":
        return f"route {lc.get('route')}"
    return (f"rows a level {lc['rows']}, {lc['chunks']} chunks "
            f"({lc['root_windows']} root windows, {lc['row_windows']} row "
            f"windows, {lc['emits']} emits), {lc['segments']} segments, "
            f"projected {lc['projected_elems']:,} elements")


def whole(dev, gen, card):
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
            out, _, before, peak = peak_of(call)
            ref = out if ref is None else ref
            print(f"[probe] rank {r} dim {d} -> {d} float32, budget {budget}: "
                  f"{median_ms(call, iters=5):.4f} ms, peak "
                  f"{peak:.3f} GB ({before:.3f} GB before the "
                  f"call), projected "
                  f"{bc._small_peak_elems(r, d, d, budget) * 4 / 1e9:.3f} GB; "
                  f"against the first budget's result "
                  f"{float((out - ref).abs().max() / ref.abs().max()):.2e} "
                  f"[{card}]", flush=True)
        del A, W, ref, out
        torch.cuda.empty_cache()


def pick(dev, gen, card):
    """A chunk of rank 6 dim 100: level 3 -> 4 (prefix 3 000 rows, 512
    columns of N_2 = 5 050, window 60) and level 1 -> 2 (prefix 60 rows,
    20 000 columns of N_4, window 40)."""
    d = FULL[1]
    for npref, cols, width in PICK_CHUNKS:
        G = torch.randn(npref * cols, d, generator=gen, device=dev)
        W = torch.randn(d, width, generator=gen, device=dev)
        WT = W.T.contiguous()
        # children (b, p): for column b of the window the first
        # npref · (b + 1) / width rows, as in a block sorted by max element
        cnts = torch.tensor([max(1, npref * (b + 1) // width)
                             for b in range(width)], device=dev)
        nsel = int(cnts.sum())
        sel_b = torch.repeat_interleave(torch.arange(width, device=dev), cnts)
        sel_p = torch.arange(nsel, device=dev) - torch.repeat_interleave(
            torch.cumsum(cnts, 0) - cnts, cnts)
        rows_c = sel_b * npref + sel_p
        cols_b = sel_p * width + sel_b

        def prod_a():
            return (G @ W).view(npref, cols, width)

        def pick_a(H):
            return H[sel_p, :, sel_b]

        def stage_b(H):
            return H.permute(1, 0, 2).reshape(cols, npref * width)

        def pick_b(Ht):
            return Ht.index_select(1, cols_b).T.contiguous()

        def prod_c():
            return WT @ G.T

        def pick_c(H2):
            return H2.view(width * npref, cols).index_select(0, rows_c)

        with full_fp32_matmul():
            H, H2 = prod_a(), prod_c()
            Ht = stage_b(H)
            err_b = float((pick_b(Ht) - pick_a(H)).abs().max())
            err_c = float((pick_c(H2) - pick_a(H)).abs().max())
            rounds = []
            for _ in range(3):
                rounds.append({
                    "a product": median_ms(prod_a, iters=5),
                    "a strided pick": median_ms(lambda: pick_a(H), iters=5),
                    "b staging": median_ms(lambda: stage_b(H), iters=5),
                    "b column gather": median_ms(lambda: pick_b(Ht), iters=5),
                    "c product": median_ms(prod_c, iters=5),
                    "c row gather": median_ms(lambda: pick_c(H2), iters=5),
                })
        med = {k: statistics.median(r_[k] for r_ in rounds) for k in rounds[0]}
        flop = 2 * npref * cols * d * width
        print(f"[probe] pick forms, prefix {npref} x {cols} columns x window "
              f"{width} ({nsel} children, {flop:.2e} flop): " + ", ".join(
                  f"{k} {v:.4f} ms" for k, v in med.items())
              + f"; a {med['a product'] + med['a strided pick']:.4f}, b "
              f"{med['a product'] + med['b staging'] + med['b column gather']:.4f}"
              f", c {med['c product'] + med['c row gather']:.4f} ms in all; "
              f"b and c differ from a by {err_b:.2e}, {err_c:.2e} [{card}]",
              flush=True)
        del G, H, H2, Ht
        torch.cuda.empty_cache()


def operands(r, d, d_out, gen, dev):
    A = FlatSymmetricTensor._raw(
        r, d, torch.randn(comb.indep_size(r, d), generator=gen, device=dev))
    W = torch.randn(d, d_out, generator=gen, device=dev) / d**0.5
    return A, W


def parts(dev, gen, card):
    r, d = MID
    A, W = operands(r, d, d, gen, dev)
    kw = dict(block_elems=2**28, transient_elems=2**26)
    call = lambda: bc.basis_change_packed(A, W, **kw)  # noqa: E731
    t0 = time.perf_counter()
    ref = call()
    torch.cuda.synchronize()
    first = time.perf_counter() - t0
    ms = median_ms(call, warmup=1, iters=3)
    with OpCount() as ops:
        call()
    whole_lvl = bc.basis_change_packed(A, W)
    route = bc.last_call["route"]
    err = float((ref.data - whole_lvl.data).abs().max() / whole_lvl.data.abs().max())
    call()
    print(f"[probe] blocked rank {r} dim {d} -> {d} float32, {kw}: first call "
          f"{first:.3f} s, then {ms:.2f} ms a call; {ops.n} torch ops a call; "
          f"{stats_text()}; against the all-default call ({route}, "
          f"{median_ms(lambda: bc.basis_change_packed(A, W), warmup=1, iters=3):.2f}"
          f" ms) {err:.2e} [{card}]", flush=True)
    parts_lines(f"blocked rank {r} dim {d}", timed_parts(call), card)


def sweep(dev, gen, card):
    r, d = MID
    A, W = operands(r, d, d, gen, dev)
    ref = None
    for block in SWEEP_BLOCKS:
        for transient in SWEEP_TRANSIENTS:
            call = lambda: bc.basis_change_packed(  # noqa: E731
                A, W, block_elems=block, transient_elems=transient)
            out, wall, before, peak = peak_of(call)
            ref = out.data if ref is None else ref
            err = float((out.data - ref).abs().max() / ref.abs().max())
            del out
            ms = median_ms(call, warmup=0, iters=3)
            print(f"[probe] sweep rank {r} dim {d} block 2**"
                  f"{block.bit_length() - 1} transient 2**"
                  f"{transient.bit_length() - 1}: {ms:.2f} ms a call (first "
                  f"{wall * 1e3:.2f} ms), peak {peak:.3f} GB ({before:.3f} GB "
                  f"before), {stats_text()} (= "
                  f"{bc.last_call['projected_elems'] * 4 / 1e9:.3f} GB); against "
                  f"the first setting {err:.2e} [{card}]", flush=True)


def rowpass(dev, gen, card):
    r, d = MID
    A, W = operands(r, d, d, gen, dev)
    # rank on the device from k = 4 up, as rank 6 dim 100 does by default
    above = comb.indep_size(3, d) * d
    kw = dict(block_elems=2**28, transient_elems=2**26, onthefly_above=above)
    call = lambda: bc.basis_change_packed(A, W, **kw)  # noqa: E731
    keep = bc._ROW_PASS_INCID
    try:
        for name, incid in (("generic step, ranked", 2**62), ("per-row root pass", 1)):
            bc._ROW_PASS_INCID = incid
            call()
            ms = median_ms(call, warmup=0, iters=3)
            print(f"[probe] level 1 of rank {r} dim {d} by the {name}: "
                  f"{ms:.2f} ms a call; {stats_text()} [{card}]", flush=True)
            totals = {k: v for k, v in timed_parts(call).items() if k[0] == 1}
            parts_lines(f"{name}", totals, card)
    finally:
        bc._ROW_PASS_INCID = keep


def full(dev, gen, card, d_out, budgets, stores=(None, torch.bfloat16)):
    r, d = FULL
    A, W = operands(r, d, d_out, gen, dev)
    ys = torch.randn(4, d_out, generator=gen, device=dev) / d_out**0.5
    want = torch.stack([symalg.contract_all_indices_with_vector(A, W @ y)
                        for y in ys])
    for store in stores:
        kw = dict(budgets, store_dtype=store) if store else dict(budgets)
        call = lambda: bc.basis_change_packed(A, W, **kw)  # noqa: E731
        C, wall, before, peak = peak_of(call)
        got = torch.stack([symalg.contract_all_indices_with_vector(C, y.to(C.dtype))
                           for y in ys])
        err = float((got.float() - want).abs().max() / want.abs().max())
        del C
        _, wall2, _, peak2 = peak_of(call)
        print(f"[probe] rank {r} dim {d} -> {d_out}, blocks in "
              f"{store or torch.float32}: first call {wall:.2f} s, second "
              f"{wall2:.2f} s; peak {peak:.2f} / {peak2:.2f} GB ({before:.2f} GB "
              f"before: A); {stats_text()}; p_C(y) vs p_A(W y) {err:.3e} "
              f"[{card}]", flush=True)
        parts_lines(f"rank {r} dim {d} -> {d_out} {store or torch.float32}",
                    timed_parts(call), card)
        torch.cuda.empty_cache()


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("sections", nargs="*",
                    help="of " + ", ".join(SECTIONS) + " (default: pick, "
                    "parts, sweep, rowpass)")
    ap.add_argument("--d-out", type=int, default=FULL[1])
    ap.add_argument("--block-elems", type=int, help="of ``full`` (default: "
                    "the route's)")
    ap.add_argument("--transient-elems", type=int)
    ap.add_argument("--row-pass-incid", type=int, help="of ``full``: the "
                    "insert positions a row from which a level is swept row "
                    "by row (default: the route's)")
    ap.add_argument("--float32-only", action="store_true", help="of ``full``")
    args = ap.parse_args()
    sections = args.sections or ["pick", "parts", "sweep", "rowpass"]
    if set(sections) - set(SECTIONS):
        ap.error(f"unknown section among {sections}")
    dev = torch.device("cuda", 0)
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    for name in sections:
        fn = globals()[name]
        if name == "full":
            budgets = {k: v for k, v in (("block_elems", args.block_elems), (
                "transient_elems", args.transient_elems)) if v}
            if args.row_pass_incid is not None:
                bc._ROW_PASS_INCID = args.row_pass_incid
            stores = (None,) if args.float32_only else (None, torch.bfloat16)
            fn(dev, gen, card, args.d_out, budgets, stores)
        else:
            fn(dev, gen, card)
        torch.cuda.empty_cache()


if __name__ == "__main__":
    main()
