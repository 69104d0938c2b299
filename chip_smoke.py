#!/usr/bin/env python3
"""Drive symtensor_tpu_torch's main path once on one CUDA card.

    python3 chip_smoke.py

Phases, one line each; any failure raises and the script exits non-zero:

1. device — require CUDA (there is no CPU fallback); print the card's name
   and power limit as nvidia-smi reports them.
2. build — compile csrc/*.cu with nvcc into symtensor_tpu_torch/_build/.
3. kernel — group_pass (hand-written CUDA) against group_pass_ref (plain
   torch) on the card, float64/float32/bfloat16, small shapes and the full
   rank-6 dim-100 shape in float32.
4. oracle — the public op at rank 6, dim 8, float64 against the EGF oracle
   and the dense contraction.
5. full — the public op at rank 6, dim 100 (1 609 344 100 float32 values):
   the launch count, the plain path, and x = e_k against single elements.
6. batched — rank 4, dim 100, B = 1024 against single-input evaluations.
7. times — CUDA events, 3 warm-up calls, median of 20.
8. gather — gather_combine (hand-written CUDA) against gather_combine_ref
   (plain torch) on the card, float64/float32/bfloat16/float16, random
   indices at small shapes (a ragged last tile, a source too large for
   shared memory, two weight chunks) and the rank-3 × rank-3 dim-30 subset
   tables in float32; the autograd gradient on the card against the CPU
   twin's.
9. outer — BASELINE C1: multiply/add/subtract.outer of two rank-3 dim-30
   float32 flat tensors (n_out = 1 623 160): the launch count of the
   multiply op, the plain subset loop and the streamed route; at dim 6,
   float64 against the dense oracle.
10. tensordot — rank 3 × rank 3, dim 30, axes = 1 by the paired, table
   (the kernel, R = 180) and streamed routes; at dim 6, float64 against
   the dense oracle.
11. gather times — CUDA events: the kernel (as gated, and with a and b
   staged in shared memory) and its twin at C1 and at dim 36, per launch
   over 20 back-to-back launches and per single call; the C1 outer op and
   the three tensordot routes per single call (3 warm-ups, median of 20).

The last three lines are a JSON object with each kernel's launches, error
and times (``ms`` and ``plain_ms``: the median of single calls; for
gather_combine also ``ms_per_launch`` and ``plain_ms_per_launch``), the
card's name and power limit, and
{"ok": true, "device": {...}}.
"""

from __future__ import annotations

import json
import os
import statistics
import subprocess
import sys
import time

import torch

SEED = 0
SMALL_SHAPES = [(3, 5), (4, 4), (5, 6), (6, 3), (6, 12), (7, 3)]
FULL = (6, 100)
TOL = {"float64": 1e-12, "float32": 1e-5, "bfloat16": 1e-5, "float16": 1e-5}
# gather_combine: (n_a, n_b, R, n_out); n_out 1000 leaves a ragged last
# tile, n_a 100 000 does not fit shared memory, R 1500 spans two chunks
GATHER_SHAPES = [(21, 21, 6, 126), (300, 250, 12, 1000),
                 (100_000, 300, 7, 5000), (64, 64, 1500, 300)]
C1 = (3, 30)  # BASELINE C1: rank-3 x rank-3, dim 30
DIM36 = 36  # the largest rank-3 x rank-3 dim under the default table guard


def say(phase: str, msg: str) -> None:
    print(f"[{phase}] {msg}", flush=True)


def smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return out.stdout.strip().splitlines()[0]


def median_ms(fn, warmup: int = 3, iters: int = 20) -> float:
    """Median of per-call CUDA-event times (ms) after warm-up calls."""
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


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; this script "
              "runs only on a CUDA card", file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    import symtensor_tpu_torch as stt
    from symtensor_tpu_torch.kernels import _build
    from symtensor_tpu_torch.kernels.group_pass import (
        acc_dtype, group_pass, group_pass_ref,
    )
    from symtensor_tpu_torch.kernels.poly_eval import poly_eval_flat
    from symtensor_tpu_torch.ops.contract import _contract_vec_flat_simple
    from symtensor_tpu_torch.utils import gflat_layout, indep_size

    dev = torch.device("cuda", 0)
    symalg = stt.symalg

    # 1. device --------------------------------------------------------
    card = smi()
    kind = torch.cuda.get_device_name(0)
    say("device", f"nvidia-smi: {card}; torch: {kind}; "
        f"torch {torch.__version__} cuda {torch.version.cuda}")

    # 2. build ---------------------------------------------------------
    t0 = time.perf_counter()
    so = _build.build()
    _build.load_library()
    log = so.with_suffix(".log")
    ptxas = [ln.strip() for ln in log.read_text().splitlines()
             if "registers" in ln or "spill" in ln] if log.exists() else []
    say("build", f"{so.name} ready in {time.perf_counter() - t0:.2f} s")
    for ln in ptxas:
        say("build", ln)

    # 3. kernel against its plain twin --------------------------------
    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED)
    full_err = None
    cases = [(r, d, dt) for r, d in SMALL_SHAPES
             for dt in ("float64", "float32", "bfloat16")]
    cases.append((*FULL, "float32"))
    for r, d, dt in cases:
        lay = gflat_layout(r, d)
        store = torch.float64 if dt == "float64" else torch.float32
        vals = torch.randn(lay.n, generator=gen, device=dev, dtype=store)
        if dt == "bfloat16":
            vals = vals.to(torch.bfloat16)
        tri = torch.randn(d * (d + 1) // 2, generator=gen, device=dev,
                          dtype=acc_dtype(vals.dtype))
        got = group_pass(vals, tri, lay)
        torch.cuda.synchronize()
        ref = group_pass_ref(vals, tri, lay)
        torch.cuda.synchronize()
        abs_err = float((got - ref).abs().max())
        err = abs_err / float(ref.abs().max())
        say("kernel", f"rank {r} dim {d} {dt}: normalised error {err:.3e} "
            f"(max abs {abs_err:.3e}, tolerance {TOL[dt]:g})")
        if not err <= TOL[dt]:
            raise AssertionError(f"group_pass disagrees at {(r, d, dt)}")
        if (r, d) == FULL:
            full_err = abs_err
        del vals, tri, got, ref
    torch.cuda.empty_cache()

    # 4. the public op at small size against independent oracles -------
    r, d = 6, 8
    A = stt.FlatSymmetricTensor._raw(
        r, d, torch.randn(indep_size(r, d), generator=gen, device=dev,
                          dtype=torch.float64))
    x = torch.randn(d, generator=gen, device=dev, dtype=torch.float64)
    before = group_pass.launches
    got = float(symalg.contract_all_indices_with_vector(A, x))
    simple = float(_contract_vec_flat_simple(A, x))
    dense = A.todense()
    for _ in range(r):
        dense = dense @ x
    for name, want in (("EGF oracle", simple), ("dense", float(dense))):
        rel = abs(got - want) / abs(want)
        say("oracle", f"rank {r} dim {d} float64 vs {name}: {got!r} vs "
            f"{want!r}, rel {rel:.3e} (tolerance 1e-10)")
        if not rel <= 1e-10:
            raise AssertionError(f"public op disagrees with the {name}")
    if group_pass.launches <= before:
        raise AssertionError("the public op did not launch group_pass")

    # 5. full size --------------------------------------------------------
    r, d = FULL
    n = indep_size(r, d)
    torch.cuda.reset_peak_memory_stats()
    gen.manual_seed(SEED + 1)
    vals = torch.randn(n, generator=gen, device=dev)
    A = stt.FlatSymmetricTensor._raw(r, d, vals)
    x = torch.randn(d, generator=gen, device=dev)
    torch.cuda.synchronize()
    group_pass.launches = 0
    y = symalg.contract_all_indices_with_vector(A, x)
    torch.cuda.synchronize()
    main_launches = group_pass.launches
    if main_launches < 1:
        raise AssertionError("the main path did not launch group_pass")
    plain = poly_eval_flat(A, x)
    rel = float((y - plain).abs() / plain.abs())
    say("full", f"rank {r} dim {d} float32, n = {n}: op {float(y)!r}, "
        f"plain {float(plain)!r}, normalised error {rel:.3e} (tolerance "
        f"1e-4); group_pass launches in the op: {main_launches}")
    if not (torch.isfinite(y) and y.shape == () and rel <= 1e-4):
        raise AssertionError("full-size op disagrees with the plain path")
    for k in (0, 37, d - 1):
        ek = torch.zeros(d, device=dev)
        ek[k] = 1.0
        got = float(symalg.contract_all_indices_with_vector(A, ek))
        want = float(A.element((k,) * r))
        rel = abs(got - want) / abs(want)
        say("full", f"x = e_{k}: {got!r} vs A[{k},..,{k}] = {want!r}, "
            f"rel {rel:.3e} (tolerance 1e-6)")
        if not rel <= 1e-6:
            raise AssertionError(f"e_{k} check failed")
    peak = torch.cuda.max_memory_allocated() / 1e9
    say("full", f"peak device memory {peak:.3f} GB")
    del A, vals, x, y, plain
    torch.cuda.empty_cache()

    # 6. batched (BASELINE C5) ------------------------------------------
    r4, B = 4, 1024
    gen.manual_seed(SEED + 2)
    A4 = stt.FlatSymmetricTensor._raw(
        r4, d, torch.randn(indep_size(r4, d), generator=gen, device=dev))
    xs = torch.randn(B, d, generator=gen, device=dev)
    yb = symalg.contract_all_indices_with_vector_batched(A4, xs)
    ys = torch.stack([symalg.contract_all_indices_with_vector(A4, xs[i])
                      for i in range(8)])
    err = float((yb[:8] - ys).abs().max() / ys.abs().max())
    say("batched", f"rank {r4} dim {d} B {B} float32: shape "
        f"{tuple(yb.shape)}, normalised error vs 8 single inputs {err:.3e} "
        "(tolerance 1e-5)")
    if not (yb.shape == (B,) and bool(torch.isfinite(yb).all())
            and err <= 1e-5):
        raise AssertionError("batched op disagrees with single inputs")

    # 7. times --------------------------------------------------------------
    ms = {"batched_op": median_ms(
        lambda: symalg.contract_all_indices_with_vector_batched(A4, xs))}
    del A4, xs, yb, ys
    torch.cuda.empty_cache()
    lay = gflat_layout(r, d)
    gen.manual_seed(SEED + 1)
    vals = torch.randn(n, generator=gen, device=dev)
    A = stt.FlatSymmetricTensor._raw(r, d, vals)
    x = torch.randn(d, generator=gen, device=dev)
    tri = torch.randn(d * (d + 1) // 2, generator=gen, device=dev)
    ms["kernel_f32"] = median_ms(lambda: group_pass(vals, tri, lay))
    ms["twin_f32"] = median_ms(lambda: group_pass_ref(vals, tri, lay))
    ms["op"] = median_ms(
        lambda: symalg.contract_all_indices_with_vector(A, x))
    ms["plain_op"] = median_ms(lambda: poly_eval_flat(A, x))
    vals16 = vals.to(torch.bfloat16)
    ms["kernel_bf16"] = median_ms(lambda: group_pass(vals16, tri, lay))
    ms["twin_bf16"] = median_ms(lambda: group_pass_ref(vals16, tri, lay))
    for key, nbytes in (("kernel_f32", 4 * n), ("twin_f32", 4 * n),
                        ("op", 4 * n), ("plain_op", 4 * n),
                        ("kernel_bf16", 2 * n), ("twin_bf16", 2 * n),
                        ("batched_op", None)):
        rate = f", {nbytes / ms[key] / 1e6:.1f} GB/s of values read" \
            if nbytes else ""
        say("times", f"{key}: {ms[key]:.4f} ms{rate} [{card}]")
    del A, vals, vals16, x, tri
    torch.cuda.empty_cache()

    gather = gather_phases(dev, card)

    print(json.dumps({"kernels": [{
        "name": "group_pass",
        "route": "cuda",
        "source": "symtensor_tpu_torch/csrc/group_pass.cu",
        "replaces": "symtensor_tpu/kernels/pallas_poly.py:44",
        "launches": main_launches,
        "max_abs_err": full_err,
        "ms": ms["kernel_f32"],
        "plain_ms": ms["twin_f32"],
    }, {
        "name": "gather_combine",
        "route": "cuda",
        "source": "symtensor_tpu_torch/csrc/gather_combine.cu",
        "replaces": "symtensor_tpu/kernels/gather_mm.py:96",
        **gather,
    }]}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count(),
    }}))
    return 0


def per_launch_ms(fn, warmup: int = 3, launches: int = 20,
                  runs: int = 5) -> float:
    """Median over runs of (CUDA-event time of `launches` back-to-back
    calls) / launches."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(runs):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(launches):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / launches)
    return statistics.median(times)


def nerr(got, ref) -> float:
    """Normalised error max|got − ref| / max|ref|, in float64."""
    got, ref = got.double(), ref.double()
    return float((got - ref).abs().max() / ref.abs().max())


def check(phase: str, what: str, err: float, tol: float) -> None:
    say(phase, f"{what}: normalised error {err:.3e} (tolerance {tol:g})")
    if not err <= tol:
        raise AssertionError(f"{phase}: {what} disagrees")


def gather_phases(dev, card) -> dict:
    """Phases 8-11; returns the gather_combine entry of the kernels line."""
    import symtensor_tpu_torch as stt
    from symtensor_tpu_torch.kernels import gather_mm as gm
    from symtensor_tpu_torch.ops.outer import _subset_tables as subset_tables
    from symtensor_tpu_torch.ops.outer import symmetric_outer
    from symtensor_tpu_torch.utils import indep_size

    symalg = stt.symalg
    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED + 3)
    dtypes = (torch.float64, torch.float32, torch.bfloat16, torch.float16)

    def rand(*shape, dtype=torch.float64):
        return torch.randn(*shape, generator=gen, device=dev,
                           dtype=torch.float64).to(dtype)

    def rand_idx(n, R, n_out):
        return torch.randint(0, n, (R, n_out), generator=gen, device=dev,
                             dtype=torch.int32)

    def dense_pair(ra, rb, dim):
        """Two float64 flat tensors at a small dim and their dense forms."""
        da = symalg.symmetrize(rand(*(dim,) * ra))
        db = symalg.symmetrize(rand(*(dim,) * rb))
        return (stt.FlatSymmetricTensor.from_dense(da),
                stt.FlatSymmetricTensor.from_dense(db), da, db)

    # 8. the kernel against its twin ---------------------------------------
    for n_a, n_b, R, n_out in GATHER_SHAPES:
        for dt in dtypes:
            a, b = rand(n_a, dtype=dt), rand(n_b, dtype=dt)
            ia, ib = rand_idx(n_a, R, n_out), rand_idx(n_b, R, n_out)
            w = rand(R, dtype=gm.acc_dtype(dt)).abs()
            got = gm.gather_combine(a, b, ia, ib, w)
            torch.cuda.synchronize()
            ref = gm.gather_combine_ref(a, b, ia, ib, w)
            stage = gm.stage_in_shared(n_a, n_b, dt)
            check("gather", f"n_a {n_a} n_b {n_b} R {R} n_out {n_out} "
                  f"{str(dt)[6:]} ({'shared' if stage else 'read-only cache'}"
                  f", bit-identical {torch.equal(got, ref)})",
                  nerr(got, ref), TOL[str(dt)[6:]])
    r, d = C1
    n3 = indep_size(r, d)
    ta, tb = subset_tables(r, r, d, dev)
    a, b = rand(n3, dtype=torch.float32), rand(n3, dtype=torch.float32)
    got = gm.gather_combine(a, b, ta, tb)
    torch.cuda.synchronize()
    ref = gm.gather_combine_ref(a, b, ta, tb,
                                torch.full((ta.shape[0],), 1 / ta.shape[0],
                                           device=dev))
    c1_err = float((got - ref).abs().max())
    check("gather", f"C1 subset tables {tuple(ta.shape)} float32 "
          f"(bit-identical {torch.equal(got, ref)})", nerr(got, ref), 1e-5)
    # gradient on the card against the CPU twin's autograd
    a, b, w = rand(40), rand(30), rand(5)
    ia, ib, g = rand_idx(40, 5, 200), rand_idx(30, 5, 200), rand(200)
    grads = []
    for where in (dev, torch.device("cpu")):
        leaves = [t.detach().to(where).requires_grad_() for t in (a, b, w)]
        out = gm.gather_combine(leaves[0], leaves[1], ia.to(where),
                                ib.to(where), leaves[2])
        (out * g.to(where)).sum().backward()
        grads.append([t.grad.cpu() for t in leaves])
    for name, got, want in zip("abw", *grads):
        check("gather", f"gradient d{name} float64, card against CPU",
              nerr(got, want), 1e-12)
    del ia, ib, got, ref
    torch.cuda.empty_cache()

    # 9. outer at C1 -------------------------------------------------------
    torch.cuda.reset_peak_memory_stats()
    A = stt.FlatSymmetricTensor._raw(r, d, rand(n3, dtype=torch.float32))
    B = stt.FlatSymmetricTensor._raw(r, d, rand(n3, dtype=torch.float32))
    torch.cuda.synchronize()
    gm.gather_combine.launches = 0
    out = symalg.multiply.outer(A, B)
    torch.cuda.synchronize()
    launches = gm.gather_combine.launches
    say("outer", f"multiply.outer rank {r} x {r} dim {d} float32: "
        f"n_out = {out.data.shape[0]}, gather_combine launches in the op: "
        f"{launches}")
    if launches < 1 or out.data.shape != (indep_size(2 * r, d),):
        raise AssertionError("multiply.outer did not launch gather_combine")
    if not bool(torch.isfinite(out.data).all()):
        raise AssertionError("multiply.outer gave non-finite values")
    loop = sum(A.data[ta[s]] * B.data[tb[s]] for s in range(ta.shape[0]))
    check("outer", "multiply vs the plain subset loop",
          nerr(out.data, loop / ta.shape[0]), 1e-5)
    for fn in ("multiply", "add", "subtract"):
        table = getattr(symalg, fn).outer(A, B).data
        streamed = symmetric_outer(A, B, fn, stream=True).data
        check("outer", f"{fn} table route vs streamed", nerr(table, streamed),
              1e-5)
    say("outer", f"peak device memory {torch.cuda.max_memory_allocated() / 1e9:.3f} GB")
    del out, loop, table, streamed, ta, tb
    torch.cuda.empty_cache()
    small = dense_pair(3, 3, 6)
    for fn in ("multiply", "add", "subtract"):
        oracle = symalg.symmetrize(
            getattr(torch, fn)(small[2][(...,) + (None,) * 3], small[3]))
        for stream in (False, True):
            got = symmetric_outer(small[0], small[1], fn, stream=stream)
            check("outer", f"{fn} dim 6 float64 (stream={stream}) vs dense "
                  "oracle", nerr(got.todense(), oracle), 1e-12)

    # 10. tensordot at C1 --------------------------------------------------
    routes = {"paired": None, "table": False, "streamed": True}
    td = {}
    for name, stream in routes.items():
        gm.gather_combine.launches = 0
        td[name] = symalg.tensordot(A, B, axes=1, stream=stream).data
        torch.cuda.synchronize()
        say("tensordot", f"{name} route: n_out = {td[name].shape[0]}, "
            f"gather_combine launches {gm.gather_combine.launches}")
        if (name == "table") != (gm.gather_combine.launches == 1):
            raise AssertionError(f"tensordot {name} route: wrong launches")
    for name in ("table", "streamed"):
        check("tensordot", f"{name} vs paired", nerr(td[name], td["paired"]),
              1e-5)
    oracle = symalg.symmetrize(torch.tensordot(small[2], small[3], dims=1))
    for name, stream in routes.items():
        got = symalg.tensordot(small[0], small[1], axes=1, stream=stream)
        check("tensordot", f"{name} dim 6 float64 vs dense oracle",
              nerr(got.todense(), oracle), 1e-12)

    # 11. times --------------------------------------------------------------
    # A kernel's time is per launch over a run of back-to-back launches
    # (its device time: the host's per-call work overlaps it); the median
    # of single calls, each from an idle card, adds that host work.
    t = {}
    for dim in (C1[1], DIM36):
        n = indep_size(r, dim)
        ta, tb = subset_tables(r, r, dim, dev)
        a, b = rand(n, dtype=torch.float32), rand(n, dtype=torch.float32)
        w = torch.full((ta.shape[0],), 1 / ta.shape[0], device=dev)
        idx_bytes = 2 * ta.numel() * ta.element_size()
        prev = gm.STAGE_BYTES
        for key, stage_bytes, fn in (
            ("kernel", prev, gm.gather_combine),
            ("kernel_staged", 10**9, gm.gather_combine),
            ("twin", prev, gm.gather_combine_ref),
        ):
            gm.STAGE_BYTES = stage_bytes
            call = lambda: fn(a, b, ta, tb, w)  # noqa: E731
            ms_ = t[f"{key}_d{dim}_per_launch"] = per_launch_ms(call)
            single = t[f"{key}_d{dim}"] = median_ms(call)
            say("gather times", f"{key} rank {r} x {r} dim {dim} float32 "
                f"(R {ta.shape[0]}, n_out {ta.shape[1]}): {ms_:.4f} ms per "
                f"launch, {idx_bytes / ms_ / 1e6:.1f} GB/s of index bytes; "
                f"single call {single:.4f} ms [{card}]")
        gm.STAGE_BYTES = prev
        del ta, tb, a, b
        torch.cuda.empty_cache()
    t["outer_op"] = median_ms(lambda: symalg.multiply.outer(A, B))
    for name, stream in routes.items():
        t[f"tensordot_{name}"] = median_ms(
            lambda: symalg.tensordot(A, B, axes=1, stream=stream))
    for key in ("outer_op", *(f"tensordot_{n}" for n in routes)):
        say("gather times", f"{key} C1 float32: {t[key]:.4f} ms [{card}]")
    # ms and plain_ms are single-call medians, as group_pass's are
    return {"launches": launches, "max_abs_err": c1_err,
            "ms": t[f"kernel_d{C1[1]}"], "plain_ms": t[f"twin_d{C1[1]}"],
            "ms_per_launch": t[f"kernel_d{C1[1]}_per_launch"],
            "plain_ms_per_launch": t[f"twin_d{C1[1]}_per_launch"]}


if __name__ == "__main__":
    sys.exit(main())
