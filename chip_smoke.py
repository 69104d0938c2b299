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

The last three lines are a JSON object with each kernel's launches, error
and times, the card's name and power limit, and
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
TOL = {"float64": 1e-12, "float32": 1e-5, "bfloat16": 1e-5}


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

    print(json.dumps({"kernels": [{
        "name": "group_pass",
        "route": "cuda",
        "source": "symtensor_tpu_torch/csrc/group_pass.cu",
        "replaces": "symtensor_tpu/kernels/pallas_poly.py:44",
        "launches": main_launches,
        "max_abs_err": full_err,
        "ms": ms["kernel_f32"],
        "plain_ms": ms["twin_f32"],
    }]}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
