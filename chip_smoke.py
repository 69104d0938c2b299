#!/usr/bin/env python3
"""Drive symtensor_tpu_torch's main path once on one CUDA card.

    python3 chip_smoke.py

Phases, one line each; any failure raises and the script exits non-zero.
On a machine of several cards, ``python3 chip_smoke.py --multi-card`` runs
the parallel layer over NCCL with one rank a card instead (see
``multi_card``).

1. device — require CUDA (there is no CPU fallback); print the card's name
   and power limit as nvidia-smi reports them.
2. build — compile csrc/*.cu with nvcc into symtensor_tpu_torch/_build/.
3. kernel — group_pass (hand-written CUDA) against group_pass_ref (plain
   torch) on the card, and the same kernel's evaluation mode group_eval
   against group_eval_ref on seeded float64 M̃ and x (its scalar
   normalised by r!·Σ|weighted rows|): small shapes in
   float64/float32/bfloat16, values as views 1-3 elements off the 16-byte
   grid, rank 3 dim 300 (rows longer than a stage), the full rank-6
   dim-100 shape in float32 and rank 6 dim 110 in bfloat16 (element
   offsets above 2**31); each call twice, for the same bits.
4. oracle — the public op at rank 6, dim 8, float64 against the EGF oracle
   and the dense contraction.
5. full — the public op at rank 6, dim 100 (1 609 344 100 float32 values):
   group_eval launched once and group_pass never, the plain path, x = e_k
   against single elements; then the op with x requiring a gradient:
   group_pass once and group_eval never, within 1e-10 of the fused op
   (over the contraction of |A| at |x|).
6. batched — rank 4, dim 100, B = 1024 against single-input evaluations.
7. times — CUDA events, 3 warm-up calls, median of 20: the public op,
   its plain path, the batched op; the op's host work (M̃, tri, torch ops
   a call); group_pass in float32, bfloat16 and float64 beside its bound
   (bytes moved / 3.35 TB/s), its twin, and torch.sum over the same
   values as the achievable read rate; group_eval on the op's inputs
   beside its bound and its twin, both entries per launch over 20
   back-to-back launches in turns (pass, eval, eval, pass), and the fused
   op against the unfused one (group_pass + epilogue) in turns (fused,
   unfused, unfused, fused; medians of 10), within 1e-10 of each other,
   the same bits twice.
8. gather — gather_combine (hand-written CUDA) against gather_combine_ref
   (plain torch) on the card, float64/float32/bfloat16/float16, random
   indices at small shapes (a ragged last tile, a large source, two weight
   chunks), as planned and under every launch-plan tile, bit for bit, and
   the rank-3 × rank-3 dim-30 subset tables in float32; the autograd
   gradient on the card against the CPU twin's.
9. outer — BASELINE C1: multiply/add/subtract.outer of two rank-3 dim-30
   float32 flat tensors (n_out = 1 623 160): the launch count of the
   multiply op, the plain subset loop and the streamed route; at dim 6,
   float64 against the dense oracle.
10. tensordot — rank 3 × rank 3, dim 30, axes = 1 by the paired, table
   (the kernel, R = 180) and streamed routes; at dim 6, float64 against
   the dense oracle.
11. gather times — CUDA events: the kernel and its twin at C1, at dim 36
   and at tensordot's table-route tables (R = 180, n_out = 40 920), per
   launch over 20 back-to-back launches and per single call, beside the
   bound; every launch-plan tile's device time per launch (a CUDA graph of
   20 launches) at dim 36, C1, dim 20, dim 18 and the table route, in
   turns over three rounds; the C1 outer op and the three tensordot routes per single call
   (3 warm-ups, median of 20).
12. C3 — BASELINE C3: the rank-6 dim-200 permcls tensor with three scalar
   classes, evaluated from power sums: float32 against float64 on the card
   over 16 inputs, the single-input op against the batched one, no table
   built; at dim 12, float64 against ``expand().toflat()`` through the
   group pass; times of the op (host-bound: a few hundred 0-d ops).
13. vector classes — the permcls tensor of BASELINE C2 (rank 4, dim 100,
   every class a vector) and rank 6 dim 50 (n·r under the table guard):
   the first-use host tables (``rep_np``, class ids, class positions)
   timed on fresh tables; the permcls evaluation (the vector classes
   packed and passed through the group pass) in float64 and float32, and
   with half the classes scalar, against the plain per-group path in
   float64; the times of ``toflat``, ``topermcls``, the permcls evaluation
   and the flat route on ``A.toflat()``.
14. dense — a rank-4 dim-100 dense tensor (1e8 float32 elements, the
   dense guard's limit) evaluated against its ``toflat()`` through the
   group pass; BASELINE C1 on dense operands: ``tensordot(A, B, axes=1)``
   by the default route and the table route (the gather kernel) against
   the flat operands' results bit for bit, ``multiply.outer`` raising
   ``MemoryError`` at dim 30 (a 30⁶ dense result) and running through the
   kernel at dim 21; times.
15. permcls at C1 — ``multiply.outer`` of two rank-3 dim-30 permcls
   tensors through the gather kernel: a permcls result equal bit for bit
   to the flat operands' result; times.

16. C4 — BASELINE C4 (``benchmarks/run_configs.py:89-108``), float32: a
   rank-3 decomp tensor (4 factors, multiplicities (3,)) contracted once
   against dim rank-2 tensors ``from_matrix(eye·(i+1)·0.1, cutoff=0.0)``
   by ``contract_tensor_list(A, chis, n_times=1)`` at dim 64 and dim 100
   (n_out = 4 421 275): the first call with its host tables
   (``insert_table``, the subset tables), then the median call, host wall
   beside device time; against a float64 run, and at dim 64 against
   sampled elements of the closed form.
17. contract list through the gather kernel — ``n_times = 2`` at dim 60
   (result rank 5, n_out = 7 624 512, R = 10): one ``gather_combine``
   launch per contracted value, 60 a call, counted; the kernel against
   its twin at these tables and its time per launch beside its bound; the
   op against a float64 run, and at dim 12 against the same op with the
   twin in the kernel's place; dim 64 once under ``rule="second_half"``
   (32 outer products), where the table guard sends the outer products to
   the streamed route.
18. moments — ``gaussian_moments`` with a full-rank covariance to rank 5
   at dim 32 (m₄ and m₅ in the standard basis) and to rank 4 at dim 100
   (m₄: 405 factors, 6.6e7 weights), float32 and float64; each moment
   contracted with vectors, single and batched (B = 1024), against the
   moments of the scalar Gaussian N(μ·x, xᵀΣx) (float64 to 1e-10, float32
   to 1e-4 at dim 32 and 5e-4 at dim 100, where the float32
   eigendecomposition of the covariance is the error);
   ``polynomial_expectation``
   of flat and decomp coefficients of ranks 1-5 at dim 16 against the
   same closed form.

19. C2 — BASELINE C2: ``contract_all_indices_with_matrix`` of a permcls
   tensor of rank 4, dim 100 (every class a vector) with a seeded 100 × 100
   matrix, float32, through the packed whole-level basis change: the
   first-use host tables (``insert_table(3)``, ``mono_tables``,
   ``colex_perm``), the op's time with the host wall beside it and its
   three parts (``toflat``, the packed change, ``topermcls``), peak memory
   beside the 400 MB of the dense tensor; against a float64 run, against
   the dense route at 1e8 elements, W = identity for A's values exactly,
   and p_C(y) against p_A(W y), both through the group-pass kernel.
20. the route's reach — flat rank 4 dim 100 → 32, rank 5 dim 60 → 60, rank 6
   dim 32 → 32 and rank 4 dim 100 stored in bfloat16: time, peak memory
   beside the projected residency, p_C(y) against p_A(W y).
21. past the insert tables' guard — all-default calls at rank 5 dim 100 →
   100 (blocked route: the storage order of the result is past the guard
   too) and rank 6 dim 50 → 50 (whole-level route, ``insert_table(5)``
   ranked on the device), float32: p_C(y) against p_A(W y) over 8 inputs
   through the group-pass kernel, W = identity for A's values exactly;
   rank 6 dim 50 again under explicit budgets through the blocked route,
   against the all-default result. Each with the first call's seconds and
   torch ops, a call's time by CUDA events and on the host, the chunk
   counts, and peak memory beside the projection.
22. blocked full — the main path's own tensor (rank 6, dim 100, 1 609 344 100
   values) under ``contract_all_indices_with_matrix`` with a 100 × 100
   matrix through the blocked route, with float32 blocks and with
   ``store_dtype=torch.bfloat16``: the same check and figures; then 64
   sampled elements of the result under a W with 4 non-zero rows against
   the float64 sum of the 4⁶ terms each. If one call takes over 90 s the
   rest of the phase runs d_out = 32 and says so.

23. autograd — at rank 6 dim 50, float32, the gradients in the values and
   in x of the public op, single input (the group-pass kernel's forward)
   and B = 64 (the batched Function), against torch.autograd through the
   plain per-group loop, to 1e-5; at rank 6 dim 100 the identities
   ⟨∂y/∂vals, vals⟩ = y (1e-5, also for B = 64) and ⟨∂y/∂x, x⟩ = 6·y
   (1e-4, Euler); forward and backward times by CUDA events.
24. flagship — models.polynomial at BASELINE C5's width: ranks 2-6 at dim
   100 (1 705 904 645 float32 coefficients) from a seeded generator;
   apply_batched over B = 1024, one batched_eval launch for each rank ≥ 3
   (counted), against 16 single apply calls (the group-pass kernel,
   counted) to 1e-5; three Adam steps (lr 1e-3) of
   train_step on a fixed batch, the losses finite and decreasing, with the
   forward, backward and optimizer ms of each step and the peak memory; a
   state_dict round trip through torch.save at dim 30, bit for bit.
25. sparse — from_entries of 1 % of n seeded entries at rank 6 dim 100, the
   first 100 000 entered twice: the single and B = 1024 contractions
   against the group-pass route and the batched route on toflat() (1e-5);
   add_sparse then toflat against 2·toflat() and element at 64 entries
   against toflat() (1e-6), the doubled entries read 1.5× their first
   value; times, nnz and memory_footprint beside the flat tensor's bytes.
26. persistence and NumPy — save/load round trips, bit for bit, of the
   rank-5 dim-100 flat tensor, BASELINE C2's permcls tensor and phase 25's
   sparse tensor (seconds, bytes; files removed); np.multiply, np.exp,
   np.allclose and np.all on the rank-6 dim-100 tensor stay packed on the
   card with no densify warning, while todense at that size raises.
   Phases 23-26 each print their peak device memory; phase 22 frees its
   tensors and tables first.

27. native — csrc/tablegen.cpp built with g++ (``native.available()``, no
   fallback counted); the first-use host tables, the native binding
   (widened to int64) and a fresh ``Tables``' NumPy build
   (``SYMTENSOR_NO_NATIVE=1``) in turns (native, NumPy, native): ``rep_np``
   and class ids at rank 6 dim 50, ``dense_gather`` at rank 6 dim 21,
   ``insert_table(4)`` at dim 60, each equal bit for bit, and which of the
   two ``Tables`` takes.
28. premul — the batched op's fold route (``_BatchedEval``) against the
   premultiplied views (``views_eval_batched_premul``) at rank 4 (C5) and
   rank 6, dim 100, B = 1024, float32 and bfloat16 storage, in turns: the
   median of repeated calls by CUDA events, host wall, torch ops a call,
   the peak over the call, the cache's build time and bytes; float32
   premul within 1e-5 of the fold; at rank 6 dim 100 float32 the
   single-input premul route (``views_eval_premul``) beside the group-pass
   route, within 1e-5.
29. cell — the cell-major GEMMs (``poly_eval_cell_batched``) beside the
   fold and premul routes at C5 (float32, bfloat16) and rank 3 dim 100
   (float32), B = 1024, the same figures; float32 cell within 1e-5 of the
   fold; then the flagship (ranks 2-6 dim 100, B = 1024, Adam) from one
   seed twice, default routes and ``SYMTENSOR_BATCHED_CELL=1`` (ranks 3-4
   through the cell route, counted), losses equal to 1e-4.
   Phases 27-29 each print their peak device memory (phase 27 runs on the
   host).

30. parallel — the parallel layer (``symtensor_tpu_torch.parallel``) in
   worlds of processes started by ``parallel.launch`` (each with a
   deadline; a failure on any rank fails the phase). A world of one rank
   on NCCL, mesh (1, 1), at full width: ``poly_eval_batched_sharded_grouped``
   at ranks 3-6 dim 100, B = 1024, against the premultiplied views'
   unsharded route, bit for bit, both timed; ``poly_eval_batched_sharded``
   (the colex route) at rank 4 dim 100, B = 128, against the batched op,
   and three Adam steps of the dry run's loss at ranks 2-4 dim 100, B = 128,
   against ``train_step``'s losses from the same seed (1e-4); the sharded
   basis change at rank 6 dim 100 -> 100 and rank 6 dim 50, p_C(y) against
   p_A(W y) through the group-pass kernel, time and peak beside phase 22's;
   both tensordot modes at C1 against the streamed route (1e-5). Then a
   world of two ranks that share ``cuda:0`` over gloo (NCCL takes one rank
   a card), meshes (1, 2) and (2, 1): the grouped and colex evaluations at
   C5's tensor (B = 1024 and 128), the sharded basis change at rank 4 dim
   30 and both tensordot modes at C1, each against the unsharded op (1e-5).

31. properties — seeded draws (``PROPERTY_DRAWS``, from SEED, no
   hypothesis run) of ``symtensor_tpu_torch/testing/kernel_properties``,
   the checks of ``tests/test_torch_property_cuda.py``: the group pass at
   ranks 0-7, dims up to 200 (at most 2**25 values), float32/bfloat16/
   float64, values 0-3 elements off a buffer's start, against its twin in
   both modes (group_pass; group_eval on seeded M̃ and x) and the public
   op (group_eval) against the CPU port in float64; the gather kernel at
   operands on both sides of 32 KB and R on both sides of a weight chunk,
   under every launch plan, against its twin bit for bit and a float64
   oracle; ``multiply.outer``, ``tensordot`` and the basis change against
   the CPU port in float64. It prints the draws of each kernel, how many
   reached each group-pass branch (whole rows, split rows, sliced tri,
   unaligned head/tail) and each gather branch (operand size, weight
   chunks, plan), each required > 0, and the worst errors by type. Then it
   runs the python blocks of ``docs/torch_getting_started.md`` with the
   document's device line set to "cuda" and requires every tensor,
   symmetric tensor and model they leave to live on cuda:0.

32. fold — the batched fold kernel (``batched_eval``, one launch a rank)
   against the per-group chain it replaced (``_batched_forward``), per
   rank at dim 100: ranks 3-6 at B = 1024, ranks 6 and 4 at B = 64 and 1.
   Both within 1e-5 of the float64 twin (normalised by the twin at
   |values| and |x|), two launches the same bits; device times in turns,
   the kernel against its FP32 bound (2·B·n operations at 67 TFLOP/s), and
   at rank 6 B = 64 and 1 and rank 4 B = 1024 no slower than the chain.

The last three lines are a JSON object with each kernel's launches, error,
times and bound (``ms`` and ``plain_ms``: the median of single calls;
``bound_ms``: bytes moved over 3.35 TB/s; for group_pass, whose launches
are the main op's with x requiring a gradient, also the bfloat16 and
float64 kernel times and bounds and, per type, the evaluation mode's
time and bound and the fused and unfused ops' times; group_eval's
launches are the main op's; for gather_combine the
per-launch times, the table route's, and the launches and per-launch time
on the contract-list path; for group_pass also ``launches_by_path``, the
launches of each entry on phases 23-25's paths, each counted from 0; for
batched_eval the launches of phase 24's apply_batched call, phase 32's
rank-6 error and times at B = 1024, its bound operations at 67 TFLOP/s,
and every case), the card's name and
power limit,
and
{"ok": true, "device": {...}}.
"""

from __future__ import annotations

import collections
import json
import os
import statistics
import subprocess
import sys
import time

import torch
import torch.utils._python_dispatch

SEED = 0
SMALL_SHAPES = [(3, 5), (4, 4), (5, 6), (6, 3), (6, 12), (7, 3)]
FULL = (6, 100)
TOL = {"float64": 1e-12, "float32": 1e-5, "bfloat16": 1e-5, "float16": 1e-5}
# gather_combine: (n_a, n_b, R, n_out); n_out 1000 leaves a ragged last
# tile, n_a 100 000 is a large source, R 1500 spans two weight chunks
GATHER_SHAPES = [(21, 21, 6, 126), (300, 250, 12, 1000),
                 (100_000, 300, 7, 5000), (64, 64, 1500, 300)]
C1 = (3, 30)  # BASELINE C1: rank-3 x rank-3, dim 30
DIM36 = 36  # the largest rank-3 x rank-3 dim under the default table guard
# BASELINE C3: rank 6, dim 200, three scalar classes
# (benchmarks/run_configs.py:80-87); its float64 check at dim 12 through
# the flat route
C3 = (6, 200)
C3_CLASSES = {"iiiiii": 0.5, "iijjkk": -0.25, "ijklmn": 2.0}
C3_FLAT_DIM = 12
# vector-class permcls tensors: BASELINE C2's (rank 4, dim 100) and rank 6
# dim 50 (n·r = 1.74e8, under config.max_table_entries)
VECTOR_SHAPES = [(4, 100), (6, 50)]
DENSE = (4, 100)  # 1e8 elements: config.max_dense_elements
DENSE_OUTER_DIM = 21  # the largest dim of a dense rank-6 result under the guard
# BASELINE C4 (benchmarks/run_configs.py:89-108): a rank-3 decomp tensor of
# 4 factors against dim rank-2 tensors; dim 64 there, dim 100 the repo's
# headline width
C4_FACTORS = 4
C4_DIMS = (64, 100)
# n_times = 2: the largest dim whose rank-3 × rank-2 subset tables
# (2·10·n_out entries) stay under config.max_table_entries, the dim of the
# twin comparison, and a dim past the guard (the streamed route)
CTL2_DIM, CTL2_TWIN_DIM, CTL2_STREAM_DIM = 60, 12, 64
# the moment hierarchy: to rank 5 where add_decomp's auto-compaction lands
# m4 and m5 in the standard basis, to rank 4 at the headline width
MOMENTS = ((32, 5), (100, 4))
# float32 moments inherit the error of the covariance's float32 eigh, which
# grows with dim (printed beside the checks); float64 is held to 1e-10
MOMENTS_F32_TOL = {32: 1e-4, 100: 5e-4}
MOMENTS_BATCH = 1024
# polynomial_expectation expands each moment with toflat (chains·F^k·n):
# at dim 16 the rank-5 moment costs 16^5·15 504 = 1.6e10 multiply-adds
# and a 4 GB intermediate
EXPECTATION_DIM = 16
# BASELINE C2 (benchmarks/run_configs.py:70-78): a permcls tensor of rank 4, dim
# 100 under contract_all_indices_with_matrix with a dim × dim matrix
C2 = (4, 100)
# the whole-level route's reach with its insert tables: (rank, dim, d_out,
# storage type)
BASIS_SHAPES = [(4, 100, 32, None), (5, 60, 60, None), (6, 32, 32, None),
                (4, 100, 100, "bfloat16")]
# past the insert tables' guard, all-default calls: rank 5 dim 100 (blocked:
# the storage order of its result is past the guard too) and rank 6 dim 50
# (whole-level, insert_table(5) ranked on the device), the latter also
# through the blocked route under these (block, transient) budgets
PAST_TABLES = [(5, 100), (6, 50)]
MID_BUDGETS = (2**28, 2**26)
# the main path's own tensor through the blocked route; D_OUT_CUT stands in
# for d_out = 100 if one call takes longer than CALL_LIMIT_S
BLOCKED_FULL = (6, 100, 100)
D_OUT_CUT, CALL_LIMIT_S = 32, 90.0
SAMPLES, W_ROWS = 64, (3, 41, 57, 99)
# phase 23: gradients through the kernel-forward Functions against plain
# autograd at (rank, dim) with AUTOGRAD_BATCH inputs; the Euler identities
# at the main path's shape
AUTOGRAD_SHAPE, AUTOGRAD_BATCH = (6, 50), 64
# phase 24: the flagship at BASELINE C5's width (ranks 2-6, dim 100,
# 1 705 904 645 coefficients); inputs N(0, (FLAG_INPUT_SCALE / dim)²), so
# that Adam's first, sign-like steps move a prediction by about a sixth of
# its residual (0.8·lr·Σ_r (dim·σ)^r / √B); the checkpoint at CKPT_DIM
FLAG_RANKS, FLAG_DIM, FLAG_BATCH = (2, 3, 4, 5, 6), 100, 1024
FLAG_SINGLE, FLAG_STEPS, FLAG_LR, FLAG_INPUT_SCALE = 16, 3, 1e-3, 4.0
CKPT_DIM = 30
# phase 25: a sparse rank-6 dim-100 tensor of 1 % of n seeded entries, the
# first SPARSE_DUPS of them entered twice
SPARSE_FRACTION, SPARSE_DUPS, SPARSE_BATCH, SPARSE_SAMPLES = 0.01, 100_000, 1024, 64
# phase 26: files of the rank-5 dim-100 flat tensor, C2's permcls tensor and
# phase 25's sparse tensor
SAVE_FLAT = (5, 100)
# phase 27: the native tables' shapes (class ids and rep_np, dense_gather,
# insert_table(4) at dim 60: the (k, dim) of the insert table)
NATIVE_CLASS, NATIVE_DENSE, NATIVE_INSERT = (6, 50), (6, 21), (4, 60)
# phases 28-29: the batched routes at dim GEMM_DIM over GEMM_BATCH inputs;
# (rank, storage type) cases; CUDA-event calls a measurement per rank
GEMM_DIM, GEMM_BATCH = 100, 1024
PREMUL_CASES = [(4, "float32"), (4, "bfloat16"), (6, "float32"), (6, "bfloat16")]
CELL_CASES = [(4, "float32"), (4, "bfloat16"), (3, "float32")]
GEMM_REPS = {3: 10, 4: 10, 6: 3}
CELL_FLAG_STEPS = 3
HBM_BYTES_PER_S = 3.35e12  # H100 SXM data sheet: the bound's memory rate
# phase 32: the batched fold kernel at dim 100, (rank, batch) cases; where
# the kernel must be no slower than the per-group chain it replaced; the
# FP32 rate (outside the tensor cores) and the TF32 rate of the tensor
# cores, whose three products a split-TF32 product takes (H100 SXM data
# sheet)
FOLD_DIM = 100
FOLD_CASES = [(6, 1024), (5, 1024), (4, 1024), (3, 1024), (6, 64), (6, 1),
              (4, 64), (4, 1)]
FOLD_NOT_SLOWER = {(6, 64), (6, 1), (4, 1024)}
FOLD_REPS = {3: 10, 4: 10, 5: 5, 6: 3}
FP32_FLOPS = 67e12
TF32_FLOPS = 495e12
# phase 32's second yardstick: |kernel − float64 reference| over the root
# sum of squares of the terms, the batch benchmark's err; the split-TF32
# kernel reads below it, one TF32 product or a group's whole K in one run of
# the tensor cores' truncating sums above it
FOLD_RSS_TOL = 2e-5
# phase 30: the parallel layer's shapes (symtensor_tpu_torch/testing/
# parallel_smoke.py); each world's deadline in seconds
PARALLEL = {
    "dim": 100, "batch": 1024, "grouped_ranks": (3, 4, 5, 6), "reps": 3,
    "colex_rank": 4, "colex_batch": 128, "train_ranks": (2, 3, 4), "steps": 3,
    "lr": 1e-3, "input_scale": 4.0, "seed": 30, "check_inputs": 4,
    "basis_cases": ((6, 100, 100), (6, 50, 50)), "basis_small": (4, 30, 30),
    "c1": (3, 30),
}
PARALLEL_DEADLINE_S = 420
# phase 22's float32 call, printed beside phase 30's sharded one
PHASE22 = {}
# phase 24: batched_eval launches in one apply_batched call of the flagship
FLAG_FOLD = {}
# phase 31: seeded draws of each property check, and the getting-started
# document it runs on the card with its device line set to "cuda"
PROPERTY_DRAWS = {"group_pass": 48, "gather_combine": 16, "public ops": 6}
DOC = "docs/torch_getting_started.md"
DOC_DEVICE_LINE = 'config.default_device = "cpu"  # the device of every tensor in this document'
# a ```python block of a document, as tests/test_docs.py reads them
DOC_BLOCK = r"^```python[ \t]*(\S*)\s*\n(.*?)^```\s*$"


def group_pass_cases():
    """Phase 3's (rank, dim, type, element offset of the values) cases:
    small shapes in every type, unaligned views, rows longer than a stage
    (rank 3 dim 300), the full rank-6 dim-100 shape, and rank 6 dim 110 in
    bfloat16 (2.6e9 values: element offsets above 2**31)."""
    dts = ("float64", "float32", "bfloat16")
    return ([(r, d, dt, 0) for r, d in SMALL_SHAPES for dt in dts]
            + [(6, 12, dt, k) for dt in dts for k in (1, 2, 3)]
            + [(3, 300, "float64", 1), (3, 300, "float32", 0),
               (*FULL, "float32", 0), (6, 110, "bfloat16", 0)])


def group_pass_bytes(lay, dt: torch.dtype) -> int:
    """Bytes the group pass must move: every value and tri read once, the
    (3, ΣP_j) output written once in the accumulation type."""
    acc = 8 if dt == torch.float64 else 4
    d = lay.dim
    return (lay.n * dt.itemsize + d * (d + 1) // 2 * acc
            + 3 * int(lay.P.sum()) * acc)


def eval_bytes(lay, dt: torch.dtype) -> int:
    """Bytes the evaluation mode must move: every value and tri read once,
    and M̃ (float64), the heads' int32 codes, x (float64) and the
    corrections read once; the float64 result written once."""
    acc = 8 if dt == torch.float64 else 4
    d, heads = lay.dim, int(lay.P[-1])
    return (lay.n * dt.itemsize + d * (d + 1) // 2 * acc + heads * (8 + 4)
            + d * 8 + (lay.rank - 2) * 3 * 8 + 8)


def eval_err(got, args) -> tuple:
    """(|got − twin|, that over r!·Σ|weighted rows|) of a group_eval result
    against group_eval_ref on the same inputs: the scalar is a cancelling
    sum, so it is normalised by the size of its terms."""
    import math

    from symtensor_tpu_torch.kernels.group_pass import (
        group_eval_ref, group_eval_terms,
    )

    ref = group_eval_ref(*args)
    scale = math.factorial(args[-1].rank) * float(group_eval_terms(*args).abs().sum())
    err = abs(float(got) - float(ref))
    return err, err / scale


def launched(fn):
    """({"group_eval": n, "group_pass": m}, result): the launches of each
    entry of the group-pass kernel in one call of fn, counted from 0."""
    from symtensor_tpu_torch.kernels.group_pass import group_eval, group_pass

    group_eval.launches = group_pass.launches = 0
    out = fn()
    torch.cuda.synchronize()
    return {"group_eval": group_eval.launches, "group_pass": group_pass.launches}, out


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
    if sys.argv[1:] == ["--multi-card"]:
        return multi_card()
    import symtensor_tpu_torch as stt
    from symtensor_tpu_torch.kernels import _build
    from symtensor_tpu_torch.kernels.group_pass import (
        acc_dtype, group_eval, group_eval_ref, group_pass, group_pass_ref,
    )
    from symtensor_tpu_torch.kernels.poly_eval import (
        _head_weights, _poly_eval_flat_unfused, _prepare, _tri, poly_eval_flat,
        poly_eval_flat_fast,
    )
    from symtensor_tpu_torch.ops.contract import _contract_vec_flat_simple
    from symtensor_tpu_torch.testing.kernel_properties import group_eval_tol
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
    full_err = full_eval_err = None
    for r, d, dt, offset in group_pass_cases():
        lay = gflat_layout(r, d)
        store = torch.float64 if dt == "float64" else torch.float32
        # values as a view `offset` elements into a buffer: an offset
        # leaves data_ptr off the 16-byte grid
        vals = torch.randn(lay.n + offset, generator=gen, device=dev,
                           dtype=store)
        if dt == "bfloat16":
            vals = vals.to(torch.bfloat16)
        vals = vals[offset:]
        tri = torch.randn(d * (d + 1) // 2, generator=gen, device=dev,
                          dtype=acc_dtype(vals.dtype))
        got = group_pass(vals, tri, lay)
        again = group_pass(vals, tri, lay)
        torch.cuda.synchronize()
        same = torch.equal(got, again)
        del again
        ref = group_pass_ref(vals, tri, lay)
        torch.cuda.synchronize()
        abs_err = float((got - ref).abs().max())
        err = abs_err / float(ref.abs().max())
        say("kernel", f"rank {r} dim {d} {dt} offset {offset} (n = {lay.n}): "
            f"normalised error {err:.3e} (max abs {abs_err:.3e}, tolerance "
            f"{TOL[dt]:g}); same bits on a second call {same}")
        if not (err <= TOL[dt] and same):
            raise AssertionError(f"group_pass disagrees at {(r, d, dt, offset)}")
        # the evaluation mode on seeded float64 M̃ and x
        M = torch.randn(int(lay.P[-1]), generator=gen, device=dev,
                        dtype=torch.float64)
        xe = torch.randn(d, generator=gen, device=dev, dtype=torch.float64)
        e_got = group_eval(vals, tri, M, xe, lay)
        e_same = torch.equal(e_got, group_eval(vals, tri, M, xe, lay))
        e_abs, e_err = eval_err(e_got, (vals, tri, M, xe, lay))
        e_tol = group_eval_tol(vals.dtype, lay)
        say("kernel", f"group_eval rank {r} dim {d} {dt} offset {offset}: "
            f"{float(e_got)!r}, normalised error {e_err:.3e} (abs {e_abs:.3e}, "
            f"tolerance {e_tol:.3g}); same bits on a second call {e_same}")
        if not (e_err <= e_tol and e_same):
            raise AssertionError(f"group_eval disagrees at {(r, d, dt, offset)}")
        if (r, d, dt) == (*FULL, "float32"):
            full_err, full_eval_err = abs_err, e_abs
        del vals, tri, got, ref, M, xe, e_got
        torch.cuda.empty_cache()

    # 4. the public op at small size against independent oracles -------
    r, d = 6, 8
    A = stt.FlatSymmetricTensor._raw(
        r, d, torch.randn(indep_size(r, d), generator=gen, device=dev,
                          dtype=torch.float64))
    x = torch.randn(d, generator=gen, device=dev, dtype=torch.float64)
    before = group_eval.launches
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
    if group_eval.launches <= before:
        raise AssertionError("the public op did not launch group_eval")

    # 5. full size --------------------------------------------------------
    r, d = FULL
    n = indep_size(r, d)
    torch.cuda.reset_peak_memory_stats()
    gen.manual_seed(SEED + 1)
    vals = torch.randn(n, generator=gen, device=dev)
    A = stt.FlatSymmetricTensor._raw(r, d, vals)
    x = torch.randn(d, generator=gen, device=dev)
    torch.cuda.synchronize()
    main_launches, y = launched(lambda: symalg.contract_all_indices_with_vector(A, x))
    if main_launches != {"group_eval": 1, "group_pass": 0}:
        raise AssertionError(f"the main path launched {main_launches}, not "
                             "group_eval once and group_pass never")
    plain = poly_eval_flat(A, x)
    rel = float((y - plain).abs() / plain.abs())
    say("full", f"rank {r} dim {d} float32, n = {n}: op {float(y)!r}, "
        f"plain {float(plain)!r}, normalised error {rel:.3e} (tolerance "
        f"1e-4); launches in the op: {main_launches}")
    if not (torch.isfinite(y) and y.shape == () and rel <= 1e-4):
        raise AssertionError("full-size op disagrees with the plain path")
    # the same op where x needs a gradient: group_pass and the epilogue
    xg = x.clone().requires_grad_()
    grad_launches, y_g = launched(lambda: symalg.contract_all_indices_with_vector(A, xg))
    y_g = y_g.detach()
    if grad_launches != {"group_eval": 0, "group_pass": 1}:
        raise AssertionError(f"the op with a gradient launched {grad_launches}, "
                             "not group_pass once and group_eval never")
    scale = float(symalg.contract_all_indices_with_vector(
        stt.FlatSymmetricTensor._raw(r, d, vals.abs()), x.abs()))
    check("full", f"the fused op {float(y)!r} vs the op with x requiring a "
          f"gradient (group_pass + epilogue: {grad_launches}) {float(y_g)!r}, "
          "over the contraction of |A| at |x|", abs(float(y) - float(y_g)) / scale,
          1e-10)
    del xg, y_g
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
    ms["op"] = median_ms(
        lambda: symalg.contract_all_indices_with_vector(A, x))
    ms["plain_op"] = median_ms(lambda: poly_eval_flat(A, x))
    say("times", f"op: {ms['op']:.4f} ms, plain_op: {ms['plain_op']:.4f} ms, "
        f"batched_op: {ms['batched_op']:.4f} ms [{card}]")
    host_work(A, x, card)
    del A
    bound = {}
    for dt in (torch.float32, torch.bfloat16, torch.float64):
        key = {torch.float32: "f32", torch.bfloat16: "bf16",
               torch.float64: "f64"}[dt]
        v = vals.to(dt)
        tri = torch.randn(d * (d + 1) // 2, generator=gen, device=dev,
                          dtype=acc_dtype(dt))
        nbytes = group_pass_bytes(lay, dt)
        bound[key] = nbytes / HBM_BYTES_PER_S * 1e3
        ms[f"kernel_{key}"] = median_ms(lambda: group_pass(v, tri, lay))
        ms[f"twin_{key}"] = median_ms(lambda: group_pass_ref(v, tri, lay))
        ms[f"sum_{key}"] = median_ms(lambda: v.sum())
        say("times", f"group_pass {key}: kernel {ms[f'kernel_{key}']:.4f} ms "
            f"against its bound {bound[key]:.4f} ms ({nbytes / 1e9:.3f} GB "
            f"/ 3.35 TB/s): {100 * bound[key] / ms[f'kernel_{key}']:.1f} % "
            f"of the bound, {n * dt.itemsize / ms[f'kernel_{key}'] / 1e6:.1f}"
            f" GB/s of values; twin {ms[f'twin_{key}']:.4f} ms; torch.sum "
            f"over the same values {ms[f'sum_{key}']:.4f} ms "
            f"({n * dt.itemsize / ms[f'sum_{key}'] / 1e6:.1f} GB/s) [{card}]")
        del tri
        # the evaluation mode on the op's own inputs, then the fused op and
        # the unfused one (group_pass + epilogue) in turns
        Ad = stt.FlatSymmetricTensor._raw(r, d, v)
        xp, _ = _prepare(Ad, x)
        x64 = xp.double()
        ein = (v, _tri(Ad.tables, xp.to(acc_dtype(dt))),
               _head_weights(Ad.tables, x64, r)[0], x64, lay)
        ebytes = eval_bytes(lay, dt)
        bound[f"eval_{key}"] = ebytes / HBM_BYTES_PER_S * 1e3
        ms[f"eval_{key}"] = median_ms(lambda: group_eval(*ein))
        ms[f"evaltwin_{key}"] = median_ms(lambda: group_eval_ref(*ein))
        # device time: back-to-back launches of each entry, in turns
        launch = {"pass": [], "eval": []}
        for name, fn in (("pass", lambda: group_pass(v, ein[1], lay)),
                         ("eval", lambda: group_eval(*ein)),
                         ("eval", lambda: group_eval(*ein)),
                         ("pass", lambda: group_pass(v, ein[1], lay))):
            launch[name].append(per_launch_ms(fn))

        def fused():
            return poly_eval_flat_fast(Ad, x)

        def unfused():
            return _poly_eval_flat_unfused(Ad, *_prepare(Ad, x))

        turns = {"fused": [], "unfused": []}
        for name, fn in (("fused", fused), ("unfused", unfused),
                         ("unfused", unfused), ("fused", fused)):
            turns[name].append(median_ms(fn, iters=10))
        ms[f"op_{key}"] = statistics.mean(turns["fused"])
        ms[f"unfused_{key}"] = statistics.mean(turns["unfused"])
        first, again, ref = fused(), fused(), unfused()
        torch.cuda.synchronize()
        scale = float(poly_eval_flat_fast(
            stt.FlatSymmetricTensor._raw(r, d, v.abs()), x.abs()))
        say("times", f"group_eval {key}: kernel {ms[f'eval_{key}']:.4f} ms "
            f"against its bound {bound[f'eval_{key}']:.4f} ms ({ebytes / 1e9:.4f} "
            f"GB / 3.35 TB/s): {100 * bound[f'eval_{key}'] / ms[f'eval_{key}']:.1f}"
            f" % of the bound; twin {ms[f'evaltwin_{key}']:.4f} ms; per launch "
            f"over 20 back to back, in turns: group_eval {launch['eval'][0]:.4f} / "
            f"{launch['eval'][1]:.4f} ms, group_pass {launch['pass'][0]:.4f} / "
            f"{launch['pass'][1]:.4f} ms; fused op "
            f"{turns['fused'][0]:.4f} / {turns['fused'][1]:.4f} ms "
            f"({100 * bound[f'eval_{key}'] / ms[f'op_{key}']:.1f} % of the bound), "
            f"unfused op {turns['unfused'][0]:.4f} / {turns['unfused'][1]:.4f} ms "
            f"({100 * bound[f'eval_{key}'] / ms[f'unfused_{key}']:.1f} %), in "
            f"turns, medians of 10 [{card}]")
        check("times", f"{key}: fused op {float(first)!r} vs unfused "
              f"{float(ref)!r}, over the contraction of |A| at |x|; same bits "
              f"on a second call {torch.equal(first, again)}",
              abs(float(first) - float(ref)) / scale, 1e-10)
        if not torch.equal(first, again):
            raise AssertionError(f"times: the fused op gave other bits on a "
                                 f"second call ({key})")
        del v, Ad, ein, first, again, ref
        torch.cuda.empty_cache()
    del vals, x
    torch.cuda.empty_cache()

    gather = gather_phases(dev, card)
    format_phases(dev, card)
    gather.update(decomp_phases(dev, card))
    basis_phases(dev, card)
    blocked_phases(dev, card)
    paths = model_phases(dev, card)
    native_phase(card)
    premul_phase(dev, card)
    cell_phase(dev, card)
    parallel_phase(card)
    property_phase(dev, card)
    fold = fold_phase(dev, card)

    print(json.dumps({"kernels": [{
        "name": "group_pass",
        "route": "cuda",
        "source": "symtensor_tpu_torch/csrc/group_pass.cu",
        "replaces": "symtensor_tpu/kernels/pallas_poly.py:44",
        "launches": grad_launches["group_pass"],
        "max_abs_err": full_err,
        "ms": ms["kernel_f32"],
        "plain_ms": ms["twin_f32"],
        "bound_ms": bound["f32"],
        "bound_by": "bytes",
        "library_ms": None,
        "ms_bf16": ms["kernel_bf16"],
        "bound_ms_bf16": bound["bf16"],
        "ms_f64": ms["kernel_f64"],
        "bound_ms_f64": bound["f64"],
        **{f"{k}{sfx}": ms[f"{m}_{key}"] if m else bound[f"eval_{key}"]
           for key, sfx in (("f32", ""), ("bf16", "_bf16"), ("f64", "_f64"))
           for k, m in (("eval_ms", "eval"), ("eval_bound_ms", None),
                        ("op_ms", "op"), ("unfused_op_ms", "unfused"))},
        "launches_by_path": paths,
    }, {
        "name": "group_eval",
        "route": "cuda",
        "source": "symtensor_tpu_torch/csrc/group_pass.cu",
        "replaces": "symtensor_tpu/kernels/pallas_poly.py:44",
        "launches": main_launches["group_eval"],
        "max_abs_err": full_eval_err,
        "ms": ms["eval_f32"],
        "plain_ms": ms["evaltwin_f32"],
        "bound_ms": bound["eval_f32"],
        "bound_by": "bytes",
        "library_ms": None,
        "ms_bf16": ms["eval_bf16"],
        "bound_ms_bf16": bound["eval_bf16"],
        "ms_f64": ms["eval_f64"],
        "bound_ms_f64": bound["eval_f64"],
    }, {
        "name": "gather_combine",
        "route": "cuda",
        "source": "symtensor_tpu_torch/csrc/gather_combine.cu",
        "replaces": "symtensor_tpu/kernels/gather_mm.py:96",
        **gather,
    }, {
        "name": "batched_eval",
        "route": "cuda",
        "source": "symtensor_tpu_torch/csrc/batched_fold.cu",
        "replaces": None,
        "launches": FLAG_FOLD["launches"],
        "max_abs_err": fold[f"r6_b{FOLD_CASES[0][1]}"]["err"],
        "ms": fold[f"r6_b{FOLD_CASES[0][1]}"]["ms"],
        "plain_ms": fold[f"r6_b{FOLD_CASES[0][1]}"]["chain_ms"],
        "bound_ms": fold[f"r6_b{FOLD_CASES[0][1]}"]["bound_ms"],
        "bound_by": "operations",
        "library_ms": None,
        "cases": fold,
    }]}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count(),
    }}))
    return 0


def host_work(A, x, card: str) -> None:
    """What the fused op does besides its one kernel: M̃'s recursion and
    the triangle monomials (single calls from an idle card, CUDA events,
    medians of 20), and the torch ops each route dispatches a call."""
    from symtensor_tpu_torch.kernels.poly_eval import (
        _head_weights, _poly_eval_flat_unfused, _prepare, _tri,
        poly_eval_flat_fast,
    )

    xp, _ = _prepare(A, x)
    x64, t = xp.double(), A.tables
    heads_ms = median_ms(lambda: _head_weights(t, x64, A.rank))
    tri_ms = median_ms(lambda: _tri(t, xp))
    ops = {}
    for name, fn in (("fused", lambda: poly_eval_flat_fast(A, x)),
                     ("unfused", lambda: _poly_eval_flat_unfused(A, *_prepare(A, x)))):
        with OpCount() as count:
            fn()
        ops[name] = count.n
    torch.cuda.synchronize()
    say("times", f"host work of the op at rank {A.rank} dim {A.dim} "
        f"{str(A.dtype)[6:]}: M̃ {heads_ms:.4f} ms, tri {tri_ms:.4f} ms; torch "
        f"ops a call: fused {ops['fused']}, unfused {ops['unfused']} [{card}]")


def tile_times(gm, sms: int, inputs: dict, r: int, card: str,
               rounds: int = 3) -> None:
    """Every launch-plan tile's device time per launch at five sizes: the
    subset tables of dim 36 (n_out 4 496 388), C1 (1 623 160), dim 20
    (177 100) and dim 18 (100 947), and the table route's (R 180,
    n_out 40 920); the
    tiles in turn, over `rounds` rounds. At the smaller sizes a launch
    takes less device time than the wrapper's host work, so launches are
    replayed from a CUDA graph (`graph_ms`)."""
    from symtensor_tpu_torch.ops.outer import _subset_tables as subset_tables
    from symtensor_tpu_torch.utils import indep_size

    dev = inputs["table_route"][2].device
    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED + 4)
    for dim in (20, 18):
        ta, tb = subset_tables(r, r, dim, dev)
        n = indep_size(r, dim)
        a, b = (torch.randn(n, generator=gen, device=dev) for _ in "ab")
        w = torch.full((ta.shape[0],), 1 / ta.shape[0], device=dev)
        inputs[f"d{dim}"] = (a, b, ta, tb, w)
    names = [f"d{DIM36}", f"d{C1[1]}", "d20", "d18", "table_route"]
    got = {(name, tile): [] for name in names for tile in gm.TILE_CHOICES}
    plan_of = gm.launch_plan
    try:
        for _ in range(rounds):
            for name in names:
                a, b, ta, tb, w = inputs[name]
                for tile in gm.TILE_CHOICES:
                    plan = gm.LaunchPlan(*tile, -(-ta.shape[1] // (tile[0] * tile[1])))
                    gm.launch_plan = lambda *_, p=plan: p
                    got[name, tile].append(graph_ms(
                        lambda: gm.gather_combine(a, b, ta, tb, w)))
    finally:
        gm.launch_plan = plan_of
    for name in names:
        n_out = inputs[name][2].shape[1]
        planned = gm.launch_plan(n_out, sms)
        say("gather tiles", f"{name} float32 (R {inputs[name][2].shape[0]}, "
            f"n_out {n_out}, planned {planned.items} x {planned.threads}), "
            "device ms per launch from a CUDA graph, over rounds: " + "; ".join(
                f"{i} x {th} " + " / ".join(f"{v:.5f}" for v in got[name, (i, th)])
                for i, th in gm.TILE_CHOICES) + f" [{card}]")


def graph_ms(fn, launches: int = 20, runs: int = 5) -> float:
    """Median over runs of (CUDA-event time of one replay of a CUDA graph
    of `launches` calls of fn) / launches: device time, with no host work
    between the launches."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()  # warm-up outside the capture
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(launches):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    times = []
    for _ in range(runs):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        graph.replay()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / launches)
    del graph
    return statistics.median(times)


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


def gather_bytes(ta, n_a: int, n_b: int, dt: torch.dtype) -> int:
    """Bytes the gather-combine must move: both int32 index tables, a, b
    and the weights read once, the output written once."""
    R, n_out = ta.shape
    acc = 8 if dt == torch.float64 else 4
    return (2 * ta.numel() * ta.element_size() + (n_a + n_b) * dt.itemsize
            + R * acc + n_out * dt.itemsize)


def host_s(fn):
    """Wall seconds of one call, the card synchronised after it."""
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return time.perf_counter() - t0, out


def check(phase: str, what: str, err: float, tol: float) -> None:
    say(phase, f"{what}: normalised error {err:.3e} (tolerance {tol:g})")
    if not err <= tol:
        raise AssertionError(f"{phase}: {what} disagrees")


def gather_phases(dev, card) -> dict:
    """Phases 8-11; returns the gather_combine entry of the kernels line."""
    import symtensor_tpu_torch as stt
    from symtensor_tpu_torch.kernels import gather_mm as gm
    from symtensor_tpu_torch.ops.outer import _subset_tables as subset_tables
    from symtensor_tpu_torch.ops.outer import _tensordot_tables
    from symtensor_tpu_torch.ops.outer import symmetric_outer
    from symtensor_tpu_torch.utils import indep_size

    symalg = stt.symalg
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
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

    # 8. the kernel against its twin, under every launch-plan choice ------
    plan_of = gm.launch_plan
    for n_a, n_b, R, n_out in GATHER_SHAPES:
        for dt in dtypes:
            a, b = rand(n_a, dtype=dt), rand(n_b, dtype=dt)
            ia, ib = rand_idx(n_a, R, n_out), rand_idx(n_b, R, n_out)
            w = rand(R, dtype=gm.acc_dtype(dt)).abs()
            ref = gm.gather_combine_ref(a, b, ia, ib, w)
            for forced in (None, *gm.TILE_CHOICES):
                plan = gm.launch_plan(n_out, sms)
                if forced:  # this tile in place of the planned one
                    plan = gm.LaunchPlan(*forced, -(-n_out // (forced[0] * forced[1])))
                    gm.launch_plan = lambda *_, p=plan: p
                got = gm.gather_combine(a, b, ia, ib, w)
                torch.cuda.synchronize()
                gm.launch_plan = plan_of
                same = torch.equal(got, ref)
                check("gather", f"n_a {n_a} n_b {n_b} R {R} n_out {n_out} "
                      f"{str(dt)[6:]} (plan {plan.items} x {plan.threads}"
                      f"{', forced' if forced else ''}; bit-identical "
                      f"{same})", nerr(got, ref), TOL[str(dt)[6:]])
                if not same:
                    raise AssertionError("gather: kernel and twin differ")
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
    t, bounds, inputs = {}, {}, {}
    A_tab, B_tab, gam, n_sub = _tensordot_tables(r, r, 1, C1[1], dev)
    R = n_sub * A_tab.shape[1]
    shapes = {f"d{C1[1]}": subset_tables(r, r, C1[1], dev),
              f"d{DIM36}": subset_tables(r, r, DIM36, dev),
              "table_route": (A_tab.reshape(R, -1), B_tab.reshape(R, -1))}
    for name, (ta, tb) in shapes.items():
        dim = DIM36 if name == f"d{DIM36}" else C1[1]
        n = indep_size(r, dim)
        a, b = rand(n, dtype=torch.float32), rand(n, dtype=torch.float32)
        w = (torch.full((ta.shape[0],), 1 / ta.shape[0], device=dev)
             if name != "table_route" else (gam.repeat(n_sub) / n_sub).float())
        nbytes = gather_bytes(ta, n, n, torch.float32)
        bounds[name] = nbytes / HBM_BYTES_PER_S * 1e3
        plan = gm.launch_plan(ta.shape[1], sms)
        for key, fn in (("kernel", gm.gather_combine),
                        ("twin", gm.gather_combine_ref)):
            call = lambda: fn(a, b, ta, tb, w)  # noqa: E731
            ms_ = t[f"{key}_{name}_per_launch"] = per_launch_ms(call)
            single = t[f"{key}_{name}"] = median_ms(call)
            say("gather times", f"{key} {name} float32 (R {ta.shape[0]}, "
                f"n_out {ta.shape[1]}; plan {plan.items} outputs x "
                f"{plan.threads} threads, {plan.tiles} tiles): {ms_:.4f} ms "
                f"per launch against its bound {bounds[name]:.4f} ms "
                f"({nbytes / 1e6:.1f} MB / 3.35 TB/s), "
                f"{100 * bounds[name] / ms_:.1f} % of the bound; single call "
                f"{single:.4f} ms [{card}]")
        inputs[name] = (a, b, ta, tb, w)
    del shapes, A_tab, B_tab
    tile_times(gm, sms, inputs, r, card)
    del inputs
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
            "bound_ms": bounds[f"d{C1[1]}"], "bound_by": "bytes",
            "library_ms": None,
            "ms_per_launch": t[f"kernel_d{C1[1]}_per_launch"],
            "plain_ms_per_launch": t[f"twin_d{C1[1]}_per_launch"],
            "ms_table_route": t["kernel_table_route_per_launch"],
            "bound_ms_table_route": bounds["table_route"]}


def format_phases(dev, card) -> None:
    """Phases 12-15: the permcls and dense formats at BASELINE sizes."""
    import symtensor_tpu_torch as stt
    from symtensor_tpu_torch.kernels import gather_mm as gm
    from symtensor_tpu_torch.kernels.group_pass import group_eval
    from symtensor_tpu_torch.kernels.poly_eval import poly_eval_flat
    from symtensor_tpu_torch.utils import combinatorics as comb
    from symtensor_tpu_torch.utils import indep_size
    from symtensor_tpu_torch.utils.tables import tables

    symalg = stt.symalg
    PermCls, Dense = stt.PermClsSymmetricTensor, stt.DenseSymmetricTensor
    f32, f64 = torch.float32, torch.float64
    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED + 5)

    def rand(*shape, dtype=f32):
        return torch.randn(*shape, generator=gen, device=dev,
                           dtype=f64).to(dtype)

    def evals(A, xs):
        """The single-input op at each row of xs."""
        return torch.stack([symalg.contract_all_indices_with_vector(A, x)
                            for x in xs])

    # 12. C3 ---------------------------------------------------------------
    r, d = C3
    xs = rand(16, d, dtype=f64)
    A64 = PermCls(r, d, C3_CLASSES, dtype=f64, device=dev)
    A32 = A64.astype(f32)
    ref = symalg.contract_all_indices_with_vector_batched(A64, xs)
    got = symalg.contract_all_indices_with_vector_batched(A32, xs.float())
    check("C3", f"rank {r} dim {d} (n = {indep_size(r, d)}) float32 batched "
          "vs float64 on the card, 16 inputs", nerr(got, ref), 1e-5)
    check("C3", "float32 single-input op vs batched",
          nerr(evals(A32, xs.float()), got), 1e-6)
    if not (bool(torch.isfinite(got).all()) and got.shape == (16,)):
        raise AssertionError("C3: non-finite values or a wrong shape")
    built = sorted(map(str, A64.tables._cache))
    say("C3", f"tables built for rank {r} dim {d}: {built or 'none'}")
    if built:
        raise AssertionError("C3 built a table")
    small = PermCls(r, C3_FLAT_DIM, C3_CLASSES, dtype=f64, device=dev)
    xs_small = rand(8, C3_FLAT_DIM, dtype=f64)
    group_eval.launches = 0
    via_flat = evals(small.expand().toflat(), xs_small)
    launches = group_eval.launches
    check("C3", f"dim {C3_FLAT_DIM} float64 power sums vs expand().toflat() "
          f"through the group-pass kernel ({launches} group_eval launches)",
          nerr(evals(small, xs_small), via_flat), 1e-12)
    if launches < len(xs_small):
        raise AssertionError("C3: the flat route did not launch group_eval")
    for name, A, x in (("float32", A32, xs[0].float()), ("float64", A64, xs[0])):
        ms_ = median_ms(lambda: symalg.contract_all_indices_with_vector(A, x))
        host = statistics.median(
            host_s(lambda: symalg.contract_all_indices_with_vector(A, x))[0]
            for _ in range(20)) * 1e3
        say("C3 times", f"single-input op {name}: {ms_:.4f} ms (CUDA events, "
            f"median of 20); host wall {host:.4f} ms a call [{card}]")
    ms_ = median_ms(lambda: symalg.contract_all_indices_with_vector_batched(
        A32, xs.float()))
    say("C3 times", f"batched op float32, 16 inputs: {ms_:.4f} ms [{card}]")
    del A32, A64, small

    # 13. vector classes ------------------------------------------------------
    for r, d in VECTOR_SHAPES:
        T = tables(r, d, dev)
        T._cache.clear()  # first use: time every host table from nothing
        keys = [c for c in comb.perm_classes(r) if comb.class_size(c, d)]
        t_rep, _ = host_s(T.rep_np)
        t_ids, _ = host_s(lambda: T.class_ids_np)
        t_pos, _ = host_s(lambda: [T.class_positions(k) for k in keys])
        say("vector tables", f"rank {r} dim {d} (n = {T.n}), first use on the "
            f"host: rep_np {t_rep:.3f} s, class ids {t_ids:.3f} s, positions "
            f"of {len(keys)} classes to the card {t_pos:.3f} s [{card}]")
        A64 = PermCls(r, d, {k: rand(comb.class_size(k, d), dtype=f64)
                             for k in keys}, dtype=f64, device=dev)
        xs = rand(4, d, dtype=f64)
        # the plain per-group loop in float64, no kernel: the reference
        ref = torch.stack([poly_eval_flat(A64.toflat(), x) for x in xs])
        for dt, tol in ((f64, 1e-12), (f32, 1e-5)):
            A, x = A64.astype(dt), xs.to(dt)
            group_eval.launches = 0
            got = evals(A, x)
            launches = group_eval.launches
            check("vector", f"rank {r} dim {d} {str(dt)[6:]}: permcls "
                  f"evaluation ({launches} group_eval launches) vs the plain "
                  "path on A.toflat() in float64", nerr(got, ref), tol)
            if launches < len(x):
                raise AssertionError("vector: the permcls evaluation did not "
                                     "launch group_eval")
        # half the classes scalar: power sums and the packed vector classes
        mixed = A64
        for k in keys[::2]:
            mixed = mixed.set_class(k, 0.5)
        want = torch.stack([poly_eval_flat(mixed.expand().toflat(), x)
                            for x in xs])
        check("vector", f"rank {r} dim {d} float64, {len(keys[::2])} of "
              f"{len(keys)} classes scalar: permcls evaluation vs the plain "
              "path on expand().toflat()", nerr(evals(mixed, xs), want), 1e-12)
        A, flat = A64.astype(f32), A64.astype(f32).toflat()
        x = xs[0].float()
        t = {"toflat": median_ms(A.toflat),
             "topermcls": median_ms(flat.topermcls),
             "permcls eval": median_ms(
                 lambda: symalg.contract_all_indices_with_vector(A, x)),
             "flat-route eval": median_ms(
                 lambda: symalg.contract_all_indices_with_vector(flat, x))}
        say("vector times", f"rank {r} dim {d} float32: " + ", ".join(
            f"{k} {v:.4f} ms" for k, v in t.items()) + f" [{card}]")
        del A, A64, mixed, flat
        T._cache.clear()
        torch.cuda.empty_cache()

    # 14. dense ---------------------------------------------------------------
    r, d = DENSE
    t_sym, D = host_s(lambda: Dense(data=symalg.symmetrize(rand(*(d,) * r))))
    t_flat, flat = host_s(D.toflat)
    xs = rand(4, d)
    group_eval.launches = 0
    want = evals(flat, xs)
    launches = group_eval.launches
    say("dense times", f"rank {r} dim {d} float32 ({D.data.numel()} "
        f"elements, {D.memory_footprint() / 1e6:.0f} MB): built and checked "
        f"in {t_sym:.3f} s, first toflat {t_flat:.3f} s [{card}]")
    check("dense", f"rank {r} dim {d} float32: dense evaluation vs toflat() "
          f"through the group-pass kernel ({launches} group_eval launches)",
          nerr(evals(D, xs), want), 1e-5)
    if launches < len(xs):
        raise AssertionError("dense: the flat route did not launch group_eval")
    say("dense times", f"rank {r} dim {d} float32: dense evaluation "
        f"{median_ms(lambda: symalg.contract_all_indices_with_vector(D, xs[0])):.4f}"
        f" ms, toflat {median_ms(D.toflat):.4f} ms [{card}]")
    del D, flat
    torch.cuda.empty_cache()
    r, d = C1
    dense_ops = [Dense(data=symalg.symmetrize(rand(d, d, d))) for _ in "ab"]
    flat_ops = [D.toflat() for D in dense_ops]
    for route, stream in (("default", None), ("table", False)):
        gm.gather_combine.launches = 0
        got = symalg.tensordot(*dense_ops, axes=1, stream=stream)
        torch.cuda.synchronize()
        launches = gm.gather_combine.launches
        want = symalg.tensordot(*flat_ops, axes=1, stream=stream)
        same = torch.equal(got.toflat().data, want.data)
        check("dense", f"C1 tensordot axes=1 on dense operands, {route} route: "
              f"{got.format} rank {got.rank} result (gather_combine launches "
              f"{launches}; bit-identical to the flat operands' {same})",
              nerr(got.toflat().data, want.data), 1e-6)
        if (got.format != "dense" or (route == "table") != (launches == 1)
                or not same):
            raise AssertionError(f"dense: tensordot {route} route")
        say("dense times", f"C1 tensordot {route} route on dense operands: "
            f"{median_ms(lambda: symalg.tensordot(*dense_ops, axes=1, stream=stream)):.4f}"
            f" ms; on flat operands "
            f"{median_ms(lambda: symalg.tensordot(*flat_ops, axes=1, stream=stream)):.4f}"
            f" ms [{card}]")
    try:
        symalg.multiply.outer(*dense_ops)
    except MemoryError as err:
        say("dense", f"C1 multiply.outer of dense operands raises MemoryError: "
            f"{err}")
    else:
        raise AssertionError("dense: a 30^6 dense result did not raise")
    d = DENSE_OUTER_DIM
    dense_ops = [Dense(data=symalg.symmetrize(rand(3 * (d,)))) for _ in "ab"]
    flat_ops = [D.toflat() for D in dense_ops]
    gm.gather_combine.launches = 0
    t_first, got = host_s(lambda: symalg.multiply.outer(*dense_ops))
    launches = gm.gather_combine.launches
    want = symalg.multiply.outer(*flat_ops).todense()
    same = torch.equal(got.data, want)
    say("dense times", f"multiply.outer rank 3 x 3 dim {d} dense operands, "
        f"first call with its host tables: {t_first:.3f} s [{card}]")
    check("dense", f"multiply.outer of rank-3 dim-{d} dense operands: dense "
          f"result of {got.data.numel()} elements (gather_combine launches "
          f"{launches}; bit-identical to the flat operands' {same})",
          nerr(got.data, want), 1e-6)
    if got.format != "dense" or launches < 1 or not same:
        raise AssertionError("dense: multiply.outer of dense operands")
    say("dense times", f"multiply.outer rank 3 x 3 dim {d} dense operands: "
        f"{median_ms(lambda: symalg.multiply.outer(*dense_ops)):.4f} ms; flat "
        f"operands {median_ms(lambda: symalg.multiply.outer(*flat_ops)):.4f} ms"
        f" [{card}]")
    del dense_ops, flat_ops, got, want
    torch.cuda.empty_cache()

    # 15. permcls operands at C1 -------------------------------------------
    r, d = C1
    flat_ops = [stt.FlatSymmetricTensor._raw(r, d, rand(indep_size(r, d)))
                for _ in "ab"]
    perm_ops = [F.topermcls() for F in flat_ops]
    gm.gather_combine.launches = 0
    t_first, got = host_s(lambda: symalg.multiply.outer(*perm_ops))
    launches = gm.gather_combine.launches
    want = symalg.multiply.outer(*flat_ops)
    same = torch.equal(got.toflat().data, want.data)
    if got.format != "permcls" or launches < 1 or not same:
        raise AssertionError("permcls: C1 multiply.outer")
    say("permcls", f"C1 multiply.outer of permcls operands: permcls result of "
        f"{len(got.keys())} classes, n_out = {want.data.shape[0]} "
        f"(gather_combine launches {launches}); bit-identical to the flat "
        "operands' result")
    say("permcls times", f"C1 multiply.outer of permcls operands, first call "
        f"with its host tables: {t_first:.3f} s [{card}]")
    say("permcls times", f"C1 multiply.outer float32: permcls operands "
        f"{median_ms(lambda: symalg.multiply.outer(*perm_ops)):.4f} ms, flat "
        f"operands {median_ms(lambda: symalg.multiply.outer(*flat_ops)):.4f} ms"
        f" [{card}]")


def scalar_gaussian_moments(m, v):
    """E[y^r], r = 1..5, of y ~ N(m, v), elementwise over tensors."""
    return [m, m**2 + v, m**3 + 3 * m * v, m**4 + 6 * m**2 * v + 3 * v**2,
            m**5 + 10 * m**3 * v + 15 * m * v**2]


def decomp_phases(dev, card) -> dict:
    """Phases 16-18: the decomp format, contract_tensor_list and the
    moment hierarchy; returns the contract-list keys of the gather_combine
    entry of the kernels line."""
    import symtensor_tpu_torch as stt
    from symtensor_tpu_torch.kernels import gather_mm as gm
    from symtensor_tpu_torch.models import moments
    from symtensor_tpu_torch.ops.outer import _subset_tables as subset_tables
    from symtensor_tpu_torch.utils import indep_size
    from symtensor_tpu_torch.utils.tables import tables

    symalg = stt.symalg
    Decomp, Flat = stt.DecompSymmetricTensor, stt.FlatSymmetricTensor
    f32, f64 = torch.float32, torch.float64
    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED + 6)

    def rand(*shape, dtype=f32):
        return torch.randn(*shape, generator=gen, device=dev,
                           dtype=f64).to(dtype)

    def c4(dim):
        """BASELINE C4's operands in float64: A, and the dim tensors χ_i."""
        A = Decomp(3, dim, rand(C4_FACTORS, dtype=f64),
                   rand(C4_FACTORS, dim, dtype=f64), (3,), dtype=f64)
        eye = torch.eye(dim, dtype=f64, device=dev)
        chis = [Decomp.from_matrix(eye * ((i + 1) * 0.1), cutoff=0.0)
                for i in range(dim)]
        return A, chis

    # 16. C4 -----------------------------------------------------------------
    for dim in C4_DIMS:
        T = tables(3, dim, dev)
        for key in (("insert", 2), ("insert_np", 2)):  # time a first use
            T._cache.pop(key, None)
        t_ins, _ = host_s(lambda: T.insert_table(2))
        say("C4 tables", f"insert_table(2) at dim {dim} ({indep_size(2, dim)} x "
            f"{dim} entries), first use on the host: {t_ins:.3f} s [{card}]")
        t_ops, (A64, chis64) = host_s(lambda: c4(dim))
        A, chis = A64.astype(f32), [c.astype(f32) for c in chis64]
        torch.cuda.reset_peak_memory_stats()
        t_first, out = host_s(
            lambda: symalg.contract_tensor_list(A, chis, n_times=1))
        n_out = indep_size(4, dim)
        if not (out.format == "flat" and (out.rank, out.dim) == (4, dim)
                and out.data.shape == (n_out,) and out.dtype == f32
                and bool(torch.isfinite(out.data).all())):
            raise AssertionError("C4: wrong shape, type or non-finite values")
        ref = symalg.contract_tensor_list(A64, chis64, n_times=1)
        check("C4", f"dim {dim} float32 (result rank 4, n_out = {n_out}) vs "
              "the same op in float64", nerr(out.data, ref.data), 1e-5)
        if dim == C4_DIMS[0]:
            # closed form: χ_a = c_a·I, so the result is sym(B ⊗ I) with
            # B[i, j] = Σ_a A[i, j, a]·c_a = Σ_f w_f (v_f·c) v_f[i] v_f[j]
            c = torch.arange(1, dim + 1, dtype=f64, device=dev) * 0.1
            Bm = torch.einsum("f,fi,fj->ij", A64.weights * (A64.factors @ c),
                              A64.factors, A64.factors)
            idx = torch.randint(0, dim, (16, 4), generator=gen, device=dev)
            idx[:8, 3] = idx[:8, 2]  # half the samples with a repeated value
            pairs = [(0, 1, 2, 3), (0, 2, 1, 3), (0, 3, 1, 2),
                     (1, 2, 0, 3), (1, 3, 0, 2), (2, 3, 0, 1)]
            want = sum(Bm[idx[:, p], idx[:, q]] * (idx[:, u] == idx[:, v])
                       for p, q, u, v in pairs) / 6
            got = torch.stack([out.element(row.tolist()) for row in idx])
            check("C4", f"dim {dim} float32, 16 sampled elements vs the "
                  "closed form sym(B x I)", nerr(got, want), 1e-5)
        call = lambda: symalg.contract_tensor_list(A, chis, n_times=1)  # noqa: E731
        ms_ = median_ms(call)
        wall = statistics.median(host_s(call)[0] for _ in range(10)) * 1e3
        say("C4 times", f"contract_tensor_list n_times=1 dim {dim} float32: "
            f"operands built in {t_ops:.3f} s ({dim} eigh calls), first call "
            f"{t_first:.3f} s (its host tables included), then {ms_:.4f} ms a "
            f"call (CUDA events, median of 20), host wall {wall:.4f} ms; peak "
            f"device memory {torch.cuda.max_memory_allocated() / 1e9:.3f} GB "
            f"[{card}]")
        del A, chis, A64, chis64, out, ref
        torch.cuda.empty_cache()

    # 17. n_times = 2 through the gather kernel --------------------------------
    dim = CTL2_DIM
    n3, n2, n_out = indep_size(3, dim), indep_size(2, dim), indep_size(5, dim)
    t_tab, (ta, tb) = host_s(lambda: subset_tables(3, 2, dim, dev))
    say("contract list", f"rank-3 x rank-2 subset tables at dim {dim} "
        f"{tuple(ta.shape)}, first use on the host: {t_tab:.3f} s [{card}]")
    a, b = rand(n3), rand(n2)
    w = torch.full((ta.shape[0],), 1 / ta.shape[0], device=dev)
    got, ref = gm.gather_combine(a, b, ta, tb), gm.gather_combine_ref(a, b, ta, tb, w)
    same = torch.equal(got, ref)
    check("contract list", f"gather_combine vs its twin at these tables, "
          f"float32 (bit-identical {same})", nerr(got, ref), 1e-5)
    if not same:
        raise AssertionError("contract list: kernel and twin differ")
    nbytes = gather_bytes(ta, n3, n2, f32)
    bound = nbytes / HBM_BYTES_PER_S * 1e3
    ms_launch = per_launch_ms(lambda: gm.gather_combine(a, b, ta, tb, w))
    twin_launch = per_launch_ms(lambda: gm.gather_combine_ref(a, b, ta, tb, w),
                                launches=5, runs=3)
    say("contract list times", f"gather_combine at the dim-{dim} rank-3 x "
        f"rank-2 tables float32 (R {ta.shape[0]}, n_out {n_out}): "
        f"{ms_launch:.4f} ms per launch against its bound {bound:.4f} ms "
        f"({nbytes / 1e6:.1f} MB / 3.35 TB/s), {100 * bound / ms_launch:.1f} % "
        f"of the bound; twin {twin_launch:.4f} ms per launch [{card}]")
    del a, b, got, ref
    A64, chis64 = c4(dim)
    A, chis = A64.astype(f32), [c.astype(f32) for c in chis64]
    torch.cuda.reset_peak_memory_stats()
    torch.cuda.synchronize()
    gm.gather_combine.launches = 0
    t_first, out = host_s(lambda: symalg.contract_tensor_list(A, chis, n_times=2))
    launches = gm.gather_combine.launches
    say("contract list", f"n_times=2 dim {dim} float32: result rank "
        f"{out.rank}, n_out = {out.data.shape[0]}, gather_combine launches in "
        f"the call: {launches}")
    if launches != dim:
        raise AssertionError(f"contract list: {launches} launches, not {dim}")
    if not ((out.rank, out.dim) == (5, dim) and out.data.shape == (n_out,)
            and bool(torch.isfinite(out.data).all())):
        raise AssertionError("contract list: wrong shape or non-finite values")
    ref = symalg.contract_tensor_list(A64, chis64, n_times=2)
    check("contract list", f"n_times=2 dim {dim} float32 vs the same op in "
          "float64", nerr(out.data, ref.data), 1e-5)
    del ref
    call = lambda: symalg.contract_tensor_list(A, chis, n_times=2)  # noqa: E731
    ms_ = median_ms(call, warmup=1, iters=5)
    wall = statistics.median(host_s(call)[0] for _ in range(5)) * 1e3
    say("contract list times", f"n_times=2 dim {dim} float32: first call "
        f"{t_first:.3f} s, then {ms_:.4f} ms a call (CUDA events, median of "
        f"5), host wall {wall:.4f} ms, {launches} launches of {ms_launch:.4f} "
        f"ms; peak device memory "
        f"{torch.cuda.max_memory_allocated() / 1e9:.3f} GB [{card}]")
    del A, chis, A64, chis64, out, ta, tb
    tables(5, dim, dev)._cache.clear()
    torch.cuda.empty_cache()
    # the same op with the twin in the kernel's place, at a smaller dim
    A64, chis64 = c4(CTL2_TWIN_DIM)
    A, chis = A64.astype(f32), [c.astype(f32) for c in chis64]
    gm.gather_combine.launches = 0
    by_kernel = symalg.contract_tensor_list(A, chis, n_times=2).data
    if gm.gather_combine.launches != CTL2_TWIN_DIM:
        raise AssertionError("contract list: wrong launches at the twin's dim")
    launch = gm._launch
    gm._launch = lambda a, b, ia, ib, w: gm.gather_combine_ref(a, b, ia, ib, w)
    try:
        by_twin = symalg.contract_tensor_list(A, chis, n_times=2).data
    finally:
        gm._launch = launch
    check("contract list", f"n_times=2 dim {CTL2_TWIN_DIM} float32, the kernel "
          f"vs its twin in its place (bit-identical "
          f"{torch.equal(by_kernel, by_twin)})", nerr(by_kernel, by_twin), 1e-5)
    check("contract list", f"n_times=2 dim {CTL2_TWIN_DIM} float32 vs float64",
          nerr(by_kernel, symalg.contract_tensor_list(A64, chis64, n_times=2).data),
          1e-5)
    # past the table guard the outer products stream; the 'second_half'
    # rule contracts half the values, halving this one timing
    A64, chis64 = c4(CTL2_STREAM_DIM)
    A, chis = A64.astype(f32), [c.astype(f32) for c in chis64]
    gm.gather_combine.launches = 0
    t_stream, out = host_s(lambda: symalg.contract_tensor_list(
        A, chis, n_times=2, rule="second_half"))
    route = "gather kernel" if gm.gather_combine.launches else "streamed"
    say("contract list times", f"n_times=2 rule='second_half' dim "
        f"{CTL2_STREAM_DIM} float32 ({CTL2_STREAM_DIM // 2} outer products, "
        f"n_out = {out.data.shape[0]}, subset tables past the table guard): "
        f"{route} route, gather_combine launches "
        f"{gm.gather_combine.launches}, one call {t_stream:.3f} s [{card}]")
    if route != "streamed" or not bool(torch.isfinite(out.data).all()):
        raise AssertionError("contract list: the guard did not stream")
    del A, chis, A64, chis64, out
    torch.cuda.empty_cache()

    # 18. the moment hierarchy ---------------------------------------------------
    for dim, top in MOMENTS:
        mean = rand(dim, dtype=f64) / dim**0.5
        root = rand(dim, dim, dtype=f64) / dim**0.5
        cov = root @ root.T + 0.1 * torch.eye(dim, dtype=f64, device=dev)
        xs = rand(MOMENTS_BATCH, dim, dtype=f64) / dim**0.5
        closed = scalar_gaussian_moments(
            xs @ mean, torch.einsum("bi,ij,bj->b", xs, cov, xs))
        eigh = nerr(Decomp.from_matrix(cov.float()).todense(), cov)
        say("moments", f"dim {dim}: the float32 eigendecomposition rebuilds "
            f"the covariance to {eigh:.3e} (normalised)")
        for dt, tol in ((f64, 1e-10), (f32, MOMENTS_F32_TOL[dim])):
            torch.cuda.reset_peak_memory_stats()
            t_build, ms = host_s(
                lambda: moments.gaussian_moments(mean.to(dt), cov.to(dt), top))
            say("moments", f"dim {dim} {str(dt)[6:]}: " + "; ".join(
                f"m{m.rank}: {m.num_factors} factors, multiplicities "
                f"{m.multiplicities}, {m.weights.numel()} weights" for m in ms)
                + f"; built in {t_build:.3f} s [{card}]")
            for m, want in zip(ms, closed):
                got = symalg.contract_all_indices_with_vector_batched(m, xs.to(dt))
                one = symalg.contract_all_indices_with_vector(m, xs[0].to(dt))
                if not (got.shape == (MOMENTS_BATCH,) and got.dtype == dt
                        and bool(torch.isfinite(got).all()) and one.shape == ()):
                    raise AssertionError("moments: wrong shape or type")
                check("moments", f"dim {dim} {str(dt)[6:]} <m{m.rank}, x^{m.rank}> "
                      f"batched (B = {MOMENTS_BATCH}) vs the scalar Gaussian's "
                      f"moment", nerr(got, want), tol)
                check("moments", f"dim {dim} {str(dt)[6:]} <m{m.rank}, x^{m.rank}> "
                      "single input vs batched",
                      float((one - got[0]).abs() / want.abs().max()), tol)
            if dt == f32:
                x0, xb = xs[0].float(), xs.float()
                say("moments times", f"dim {dim} float32, single / batched "
                    f"(B = {MOMENTS_BATCH}) evaluation: " + "; ".join(
                        f"m{m.rank} "
                        f"{median_ms(lambda: symalg.contract_all_indices_with_vector(m, x0), iters=10):.4f}"
                        f" / {median_ms(lambda: symalg.contract_all_indices_with_vector_batched(m, xb), iters=10):.4f}"
                        " ms" for m in ms)
                    + f"; peak device memory "
                    f"{torch.cuda.max_memory_allocated() / 1e9:.3f} GB [{card}]")
            del ms
            torch.cuda.empty_cache()
    # polynomial_expectation: E[Σ_r <a^r, x^r>] = Σ_r E[(a·x)^r]
    dim = EXPECTATION_DIM
    mean = rand(dim, dtype=f64) / dim**0.5
    root = rand(dim, dim, dtype=f64) / dim**0.5
    cov = root @ root.T + 0.1 * torch.eye(dim, dtype=f64, device=dev)
    a = rand(dim, dtype=f64) / dim**0.5
    want = sum(scalar_gaussian_moments(a @ mean, a @ cov @ a))
    for dt, tol in ((f64, 1e-10), (f32, 1e-4)):
        ms = moments.gaussian_moments(mean.to(dt), cov.to(dt), 5)
        powers = [Decomp.from_vector(a.to(dt), r) for r in range(1, 6)]
        torch.cuda.reset_peak_memory_stats()
        for name, coeffs in (("decomp", powers),
                             ("flat", [p.toflat() for p in powers])):
            t_call, got = host_s(
                lambda: moments.polynomial_expectation(coeffs, ms))
            if not (got.shape == () and got.dtype == dt and got.device.type == dev.type):
                raise AssertionError("expectation: wrong shape, type or device")
            say("expectation", f"dim {dim} {str(dt)[6:]}, ranks 1-5, {name} "
                f"coefficients: {float(got)!r} vs closed form {float(want)!r}, "
                f"rel {float((got - want).abs() / want.abs()):.3e} (tolerance "
                f"{tol:g}); one call {t_call * 1e3:.3f} ms; peak device memory "
                f"{torch.cuda.max_memory_allocated() / 1e9:.3f} GB [{card}]")
            if not float((got - want).abs() / want.abs()) <= tol:
                raise AssertionError("expectation disagrees with the closed form")
    return {"launches_contract_list": launches,
            "ms_per_launch_contract_list": ms_launch,
            "plain_ms_per_launch_contract_list": twin_launch,
            "bound_ms_contract_list": bound}


def peak_of(fn):
    """(result, GB allocated before the call, peak GB during it)."""
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    before = torch.cuda.memory_allocated() / 1e9
    out = fn()
    torch.cuda.synchronize()
    return out, before, torch.cuda.max_memory_allocated() / 1e9


def check_through_w(phase, what, A, C, W, tol, rand, inputs: int = 4) -> None:
    """p_C(y) = p_A(W y) over seeded y, both sides through the group-pass
    kernel's evaluation mode; `rand(*shape, dtype=)` draws the inputs."""
    import symtensor_tpu_torch as stt
    from symtensor_tpu_torch.kernels.group_pass import group_eval

    def evals(T, ys):
        return torch.stack([stt.symalg.contract_all_indices_with_vector(T, y)
                            for y in ys])

    ys = rand(inputs, C.dim, dtype=W.dtype) / C.dim**0.5
    ys = ys.to(C.dtype).to(W.dtype)  # the same inputs in C's type
    group_eval.launches = 0
    got, want = evals(C, ys.to(C.dtype)), evals(A, ys @ W.T)
    launches = group_eval.launches
    check(phase, f"{what}: p_C(y) vs p_A(W y), {inputs} inputs ({launches} "
          "group_eval launches)", nerr(got, want), tol)
    if launches < 2 * len(ys):
        raise AssertionError(f"{phase}: the evaluations did not launch "
                             "group_eval")


def basis_phases(dev, card) -> None:
    """Phases 19-20: the packed basis change at BASELINE C2 and over the
    whole-level route's reach."""
    import symtensor_tpu_torch as stt
    from symtensor_tpu_torch.ops import basis_change as bc
    from symtensor_tpu_torch.utils import combinatorics as comb
    from symtensor_tpu_torch.utils import indep_size
    from symtensor_tpu_torch.utils.tables import tables

    symalg = stt.symalg
    op = symalg.contract_all_indices_with_matrix
    PermCls, Dense, Flat = (stt.PermClsSymmetricTensor,
                            stt.DenseSymmetricTensor, stt.FlatSymmetricTensor)
    f32, f64 = torch.float32, torch.float64
    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED + 7)

    def rand(*shape, dtype=f32):
        return torch.randn(*shape, generator=gen, device=dev,
                           dtype=f64).to(dtype)

    def through_w(phase, what, A, C, W, tol):
        return check_through_w(phase, what, A, C, W, tol, rand)

    def table_bytes(r, d, d_out):
        """Bytes of the int64 device tables the route holds."""
        return 8 * (sum(indep_size(k, d) * d for k in range(1, r))
                    + 2 * sum(comb.multiset_count(d_out, s)
                              for s in range(1, r + 1))
                    + indep_size(r, d_out))

    # 19. BASELINE C2 ------------------------------------------------------------
    r, d = C2
    T = tables(r, d, dev)
    T._cache.clear()  # first use: time the route's host tables from nothing
    tables(r - 1, d, dev)._cache.clear()
    t_ins, _ = host_s(lambda: T.insert_table(r - 1))
    t_low, _ = host_s(lambda: [T.insert_table(k) for k in range(1, r - 1)])
    t_mono, _ = host_s(lambda: [T.mono_tables(s) for s in range(1, r + 1)])
    t_perm, _ = host_s(lambda: T.colex_perm)
    say("C2 tables", f"rank {r} dim {d}, first use on the host: "
        f"insert_table({r - 1}) ({indep_size(r - 1, d)} x {d} int64, "
        f"{indep_size(r - 1, d) * d * 8 / 1e6:.0f} MB) {t_ins:.3f} s, the "
        f"smaller insert tables {t_low:.3f} s, mono_tables(1..{r}) "
        f"{t_mono:.3f} s, colex_perm {t_perm:.3f} s [{card}]")
    keys = [c for c in comb.perm_classes(r) if comb.class_size(c, d)]
    A64 = PermCls(r, d, {k: rand(comb.class_size(k, d), dtype=f64)
                         for k in keys}, dtype=f64, device=dev)
    W64 = rand(d, d, dtype=f64) / d**0.5
    A, W = A64.astype(f32), W64.float()
    C, before, peak = peak_of(lambda: op(A, W))
    n = indep_size(r, d)
    if not (C.format == "permcls" and (C.rank, C.dim) == (r, d)
            and C.dtype == f32 and C.device.type == "cuda"
            and sum(v.numel() for v in C.values()) == n
            and all(bool(torch.isfinite(v).all()) for v in C.values())):
        raise AssertionError("C2: wrong format, shape, type, device or "
                             "non-finite values")
    proj = bc._small_peak_elems(r, d, d, bc._SMALL_BUDGET)
    say("C2", f"rank {r} dim {d} -> {d} float32: permcls result of "
        f"{len(C.keys())} classes, {n} values, on {C.device}; peak device "
        f"memory {peak:.3f} GB, {peak - before:.3f} GB over the {before:.3f} "
        f"GB allocated before the call (operands, tables, the caches of "
        f"earlier phases; projected residency {proj} elements = "
        f"{proj * 4 / 1e9:.3f} GB, tables {table_bytes(r, d, d) / 1e9:.3f} GB) "
        f"beside the {d**r * 4 / 1e6:.0f} MB of the dense tensor [{card}]")
    Cf = C.toflat().data
    check("C2", "float32 vs the same op in float64",
          nerr(Cf, op(A64, W64).toflat().data), 1e-5)
    D = Dense(data=A.todense(), check=False)
    CD, _, peak_dense = peak_of(lambda: op(D, W))
    check("C2", f"float32 vs the dense route ({D.data.numel()} elements, "
          f"peak device memory {peak_dense:.3f} GB)",
          nerr(Cf, CD.toflat().data), 1e-5)
    if CD.format != "dense":
        raise AssertionError("C2: the dense route gave another format")
    t_dense = median_ms(lambda: op(D, W), iters=10)
    del D, CD
    torch.cuda.empty_cache()
    same = op(A, torch.eye(d, device=dev))
    exact = all(torch.equal(same.data[k], A.data[k]) for k in A.data)
    say("C2", f"W = identity returns A's values exactly: {exact}")
    if not exact:
        raise AssertionError("C2: the identity changed the values")
    through_w("C2", f"rank {r} dim {d} float32", A, C, W, 1e-4)
    flat = A.toflat()
    packed = bc.basis_change_packed(flat, W)
    t = {"op": median_ms(lambda: op(A, W)),
         "toflat": median_ms(A.toflat),
         "packed change": median_ms(lambda: bc.basis_change_packed(flat, W)),
         "topermcls": median_ms(packed.topermcls)}
    wall = statistics.median(host_s(lambda: op(A, W))[0]
                             for _ in range(20)) * 1e3
    flop = 2 * d * sum(comb.multiset_count(d, s) * indep_size(r - s - 1, d) * d
                       for s in range(r))
    say("C2 times", f"contract_all_indices_with_matrix permcls rank {r} dim "
        f"{d} float32: {t['op']:.4f} ms a call (CUDA events, median of 20), "
        f"host wall {wall:.4f} ms; parts: " + ", ".join(
            f"{k} {v:.4f} ms" for k, v in t.items() if k != "op")
        + f"; {flop:.3e} flop in the products "
        f"({flop / t['packed change'] / 1e9:.1f} TFLOP/s over the packed "
        f"change); the dense route {t_dense:.4f} ms [{card}]")
    del A64, W64, A, W, C, Cf, flat, packed, same
    T._cache.pop("dense_gather", None)  # 800 MB, the dense route's only
    torch.cuda.empty_cache()

    # 20. the route's reach ----------------------------------------------------
    for r, d, d_out, store in BASIS_SHAPES:
        store_dt = getattr(torch, store) if store else None
        kw = {"store_dtype": store_dt} if store else {}
        A = Flat._raw(r, d, rand(indep_size(r, d)))
        W = rand(d, d_out) / d**0.5
        t_first, C = host_s(lambda: op(A, W, **kw))
        if not (C.format == "flat" and (C.rank, C.dim) == (r, d_out)
                and C.dtype == (store_dt or f32) and C.device.type == "cuda"
                and C.data.shape == (indep_size(r, d_out),)
                and bool(torch.isfinite(C.data).all())):
            raise AssertionError("reach: wrong format, shape, type, device "
                                 "or non-finite values")
        what = (f"rank {r} dim {d} -> {d_out} float32"
                + (f" stored in {store}" if store else ""))
        through_w("reach", what, A, C, W, 2e-2 if store else 1e-4)
        del C
        _, before, peak = peak_of(lambda: op(A, W, **kw))
        proj = bc._small_peak_elems(r, d, d_out, bc._SMALL_BUDGET)
        ms_ = median_ms(lambda: op(A, W, **kw), iters=10)
        say("reach times", f"{what}: first call {t_first:.3f} s (its host "
            f"tables included), then {ms_:.4f} ms a call (CUDA events, median "
            f"of 10); peak device memory {peak:.3f} GB, {peak - before:.3f} GB "
            f"over the {before:.3f} GB allocated before the call (projected "
            f"residency {proj} elements "
            f"= {proj * 4 / 1e9:.3f} GB, tables "
            f"{table_bytes(r, d, d_out) / 1e9:.3f} GB) [{card}]")
        del A, W
        tables(r, d, dev)._cache.clear()
        tables(r, d_out, dev)._cache.clear()
        torch.cuda.empty_cache()


class OpCount(torch.utils._python_dispatch.TorchDispatchMode):
    """Counts the torch ops dispatched under it: about a launch each."""

    def __init__(self):
        super().__init__()
        self.n = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.n += 1
        return func(*args, **(kwargs or {}))


def blocked_phases(dev, card) -> None:
    """Phases 21-22: the basis change past the insert tables' guard, and
    the main path's own tensor through the blocked route."""
    import symtensor_tpu_torch as stt
    from symtensor_tpu_torch.ops import basis_change as bc
    from symtensor_tpu_torch.utils import indep_size
    from symtensor_tpu_torch.utils.tables import tables

    op = stt.symalg.contract_all_indices_with_matrix
    Flat = stt.FlatSymmetricTensor
    f32, f64 = torch.float32, torch.float64
    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED + 8)

    def rand(*shape, dtype=f32):
        # float32 draws: a float64 draw of the main path's tensor is 12.9 GB
        return torch.randn(*shape, generator=gen, device=dev).to(dtype)

    def route_text():
        lc = bc.last_call
        if lc["route"] != "blocked":
            return "whole-level route"
        return (f"blocked route, rows a level {lc['rows']}, {lc['chunks']} "
                f"chunks ({lc['root_windows']} root windows, "
                f"{lc['row_windows']} row windows, {lc['emits']} emits), "
                f"{lc['segments']} column segments")

    def run(phase, what, A, W, tol, **kw):
        """First call (tables included, torch ops counted), the checks of
        its result, then one call's peak memory and timed calls."""
        r, d, d_out = A.rank, A.dim, W.shape[1]
        with OpCount() as ops:
            t_first, C = host_s(lambda: op(A, W, **kw))
        store = kw.get("store_dtype") or f32
        if not (C.format == "flat" and (C.rank, C.dim) == (r, d_out)
                and C.dtype == store and C.device.type == "cuda"
                and C.data.shape == (indep_size(r, d_out),)
                and bool(torch.isfinite(C.data).all())):
            raise AssertionError(f"{phase}: wrong format, shape, type, device "
                                 "or non-finite values")
        route = bc.last_call["route"]
        check_through_w(phase, what, A, C, W, tol, rand, inputs=8)
        del C
        C, before, peak = peak_of(lambda: op(A, W, **kw))
        calls = 1 if t_first > 3 else 3
        times = []
        for _ in range(calls):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            wall, _ = host_s(lambda: op(A, W, **kw))
            end.record()
            end.synchronize()
            times.append((start.elapsed_time(end) / 1e3, wall))
        ev, wall = sorted(times)[len(times) // 2]
        if phase == "blocked full" and store == f32:
            PHASE22.update(s=ev, peak=peak - before)
        if route == "blocked":
            proj = bc.last_call["projected_elems"]
        else:
            proj = bc._small_peak_elems(r, d, d_out, bc._SMALL_BUDGET)
        say(f"{phase} times", f"{what}: {route_text()}; first call "
            f"{t_first:.3f} s (its tables included), {ops.n} torch ops; then "
            f"{ev:.4f} s a call by CUDA events, host wall {wall:.4f} s (median "
            f"of {calls}); peak device memory {peak:.3f} GB, {peak - before:.3f} "
            f"GB over the {before:.3f} GB allocated before the call (projected "
            f"residency {proj} elements = {proj * store.itemsize / 1e9:.3f} GB "
            f"at {store.itemsize} bytes) [{card}]")
        return C, ev

    # 21. past the insert tables' guard ---------------------------------------
    for r, d in PAST_TABLES:
        A = Flat._raw(r, d, rand(indep_size(r, d)))
        W = rand(d, d) / d**0.5
        what = f"rank {r} dim {d} -> {d} float32, all default"
        C, _ = run("past tables", what, A, W, 1e-4)
        default_route = bc.last_call["route"]
        same = op(A, torch.eye(d, device=dev))
        exact = torch.equal(same.data, A.data)
        say("past tables", f"{what}: W = identity returns A's values exactly: "
            f"{exact}")
        if not exact:
            raise AssertionError("past tables: the identity changed the values")
        del same
        if default_route == "whole-level":
            kw = dict(block_elems=MID_BUDGETS[0], transient_elems=MID_BUDGETS[1])
            what = (f"rank {r} dim {d} -> {d} float32, block_elems "
                    f"{kw['block_elems']}, transient_elems {kw['transient_elems']}")
            B, _ = run("past tables", what, A, W, 1e-4, **kw)
            if bc.last_call["route"] != "blocked":
                raise AssertionError("past tables: explicit budgets did not "
                                     "select the blocked route")
            check("past tables", f"{what}: blocked route vs the all-default "
                  f"call ({default_route})", nerr(B.data, C.data), 1e-5)
            del B
        del A, W, C
        tables(r, d, dev)._cache.clear()
        torch.cuda.empty_cache()

    # 22. the main path's tensor ---------------------------------------------
    r, d, d_out = BLOCKED_FULL
    gen.manual_seed(SEED + 1)
    A = Flat._raw(r, d, rand(indep_size(r, d)))
    pos_of = tables(r, d_out, dev).position_T
    for store in (None, torch.bfloat16):
        kw = {"store_dtype": store} if store else {}
        name = "bfloat16" if store else "float32"
        W = rand(d, d_out) / d**0.5
        what = f"rank {r} dim {d} -> {d_out}, blocks in {name}"
        C, ev = run("blocked full", what, A, W, 2e-2 if store else 1e-4, **kw)
        del C
        if bc.last_call["route"] != "blocked":
            raise AssertionError("blocked full: the call did not take the "
                                 "blocked route")
        if ev > CALL_LIMIT_S and d_out > D_OUT_CUT:
            d_out = D_OUT_CUT
            say("blocked full", f"one call took {ev:.1f} s (> {CALL_LIMIT_S} "
                f"s): the remaining calls of this phase run d_out = {d_out}")
            pos_of = tables(r, d_out, dev).position_T
    # sampled elements against the float64 sum over the 4**6 index tuples
    # that a W with four non-zero rows leaves
    rows = torch.tensor(W_ROWS, device=dev)
    W4 = torch.zeros(d, d_out, device=dev)
    W4[rows] = rand(len(rows), d_out)
    C = op(A, W4)
    beta = torch.sort(torch.randint(0, d_out, (SAMPLES, r), generator=gen,
                                    device=dev), dim=1).values
    beta[0], beta[1] = 0, d_out - 1
    tuples = torch.cartesian_prod(*[torch.arange(len(rows), device=dev)] * r)
    a_pos = tables(r, d, dev).position_T(torch.sort(rows[tuples], dim=1).values.T)
    a_val = A.data[a_pos].double()  # (4**6,)
    w = W4[rows].double()  # (4, d_out)
    want = torch.stack([
        (a_val * torch.stack([w[tuples[:, s], b[s]] for s in range(r)]).prod(0)).sum()
        for b in beta])
    got = C.data[pos_of(beta.T)]
    check("blocked full", f"rank {r} dim {d} -> {d_out} float32, W of "
          f"{len(rows)} non-zero rows: {SAMPLES} sampled elements vs the "
          f"float64 sum of {len(tuples)} terms each", nerr(got, want), 1e-4)
    # free the phase's tensors and the tables it built before the next phases
    del A, C, W, W4, got, want, a_val, a_pos, tuples, pos_of
    for rr, dd in {(r, d), (r, d_out), (r, BLOCKED_FULL[2])} | {
            (k, dd) for k in range(1, r) for dd in (d, d_out)}:
        tables(rr, dd, dev)._cache.clear()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    say("blocked full", f"freed: {torch.cuda.memory_allocated() / 1e9:.3f} GB "
        "still allocated")


def big_nerr(got, ref) -> float:
    """``nerr`` for tensors too large to copy in float64: max|Δ| and
    max|ref| in the tensors' own type."""
    return float((got - ref).abs().max()) / float(ref.abs().max())


def dot64(a, b, chunk: int = 2**27) -> float:
    """⟨a, b⟩ summed in float64 over chunks (no n-sized float64 copy)."""
    return sum(float(torch.dot(a[i : i + chunk].double(), b[i : i + chunk].double()))
               for i in range(0, a.numel(), chunk))


def events_ms(fn, reps: int = 5):
    """(median ms of `reps` calls by CUDA events, the last result)."""
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        out = fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times), out


# the largest peak of a phase seen before a per-call reset inside it
HELD_PEAK = [0]


def phase_peak(phase: str, card: str) -> None:
    """Print the phase's peak device memory and reset the counter."""
    torch.cuda.synchronize()
    peak = max(HELD_PEAK[0], torch.cuda.max_memory_allocated())
    say(phase, f"peak device memory over the phase {peak / 1e9:.3f} GB [{card}]")
    HELD_PEAK[0] = 0
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()


def model_phases(dev, card) -> dict:
    """Phases 23-26: autograd of the public op, the flagship model at
    BASELINE C5's width, the sparse format at the main path's shape,
    persistence and NumPy on the card. Returns the launches of each entry
    of the group-pass kernel on each path, counted from 0 just before the
    path ran: group_pass where a gradient is taken, group_eval where
    not."""
    import tempfile

    import numpy as np

    import symtensor_tpu_torch as stt
    from symtensor_tpu_torch import serialization as ser
    from symtensor_tpu_torch.kernels import batched_eval as be
    from symtensor_tpu_torch.kernels.poly_eval import poly_eval_flat
    from symtensor_tpu_torch.models import polynomial
    from symtensor_tpu_torch.testing import does_not_warn
    from symtensor_tpu_torch.utils import combinatorics as comb
    from symtensor_tpu_torch.utils import indep_size

    symalg = stt.symalg
    op, op_b = (symalg.contract_all_indices_with_vector,
                symalg.contract_all_indices_with_vector_batched)
    Flat = stt.FlatSymmetricTensor
    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED + 9)
    paths = {}

    def rand(*shape):
        return torch.randn(*shape, generator=gen, device=dev)

    def counted(path, fn, kernel="group_eval"):
        paths[path], out = launched(fn)
        other = "group_pass" if kernel == "group_eval" else "group_eval"
        if paths[path][kernel] < 1 or paths[path][other]:
            raise AssertionError(f"{path}: launched {paths[path]}, not {kernel} "
                                 f"alone")
        return out

    torch.cuda.reset_peak_memory_stats()

    # 23. autograd of the public op --------------------------------------------
    r, d = AUTOGRAD_SHAPE
    vals, x = rand(indep_size(r, d)), rand(d)
    xs, v = rand(AUTOGRAD_BATCH, d), rand(AUTOGRAD_BATCH)

    def grads(fn, inp):
        a, xx = vals.clone().requires_grad_(), inp.clone().requires_grad_()
        fn(Flat._raw(r, d, a), xx).backward()
        return a.grad, xx.grad

    g_fn = counted("autograd single", lambda: grads(op, x), "group_pass")
    g_plain = grads(poly_eval_flat, x)
    for name, got, want in zip(("values", "x"), g_fn, g_plain):
        check("autograd", f"rank {r} dim {d} float32, single input, ∂y/∂{name}: "
              f"the kernel-forward Function vs autograd of the plain loop "
              f"(launches {paths['autograd single']})",
              nerr(got, want), 1e-5)
    gb_fn = grads(lambda A, xx: op_b(A, xx) @ v, xs)
    gb_plain = grads(lambda A, xx: sum(v[b] * poly_eval_flat(A, xx[b])
                                       for b in range(len(xx))), xs)
    for name, got, want in zip(("values", "xs"), gb_fn, gb_plain):
        check("autograd", f"rank {r} dim {d} float32, B = {AUTOGRAD_BATCH}, "
              f"∂(v·y)/∂{name}: the batched Function vs autograd of "
              f"{AUTOGRAD_BATCH} plain loops", nerr(got, want), 1e-5)
    del vals, x, xs, v, g_fn, g_plain, gb_fn, gb_plain

    r, d = FULL
    n = indep_size(r, d)
    vals = rand(n).requires_grad_()
    x = rand(d).requires_grad_()
    A = Flat._raw(r, d, vals)
    y = counted("autograd full", lambda: op(A, x), "group_pass")
    y.backward()
    lhs_v, lhs_x = dot64(vals.grad, vals.detach()), float(x.grad.double() @ x.detach().double())
    yv = float(y.detach())
    for name, got, want, tol in (("⟨∂y/∂vals, vals⟩ = y", lhs_v, yv, 1e-5),
                                 (f"⟨∂y/∂x, x⟩ = {r}·y", lhs_x, r * yv, 1e-4)):
        check("autograd", f"rank {r} dim {d} float32 (n = {n}): {name}: "
              f"{got!r} vs {want!r}", abs(got - want) / abs(want), tol)
    xb = rand(AUTOGRAD_BATCH, d)
    vb = rand(AUTOGRAD_BATCH)
    vals.grad = None
    yv_b = op_b(A, xb) * vb
    yv_b.sum().backward()
    yb, scale = float(yv_b.detach().sum()), float(yv_b.detach().abs().sum())
    check("autograd", f"rank {r} dim {d} float32, B = {AUTOGRAD_BATCH}: "
          f"⟨∂(v·y)/∂vals, vals⟩ = v·y, over Σ_b |v_b·y_b|",
          abs(dot64(vals.grad, vals.detach()) - yb) / scale, 1e-5)
    vals.grad, x.grad = None, None
    fwd_ms, y = events_ms(lambda: op(A, x))
    bwd_ms, _ = events_ms(lambda: torch.autograd.grad(op(A, x), (vals, x)))
    with torch.no_grad():
        plain_fwd, _ = events_ms(lambda: op(Flat._raw(r, d, vals.detach()), x.detach()))
    bfwd_ms, _ = events_ms(lambda: op_b(A, xb), reps=3)
    bbwd_ms, _ = events_ms(lambda: torch.autograd.grad(op_b(A, xb) @ vb, (vals,)), reps=3)
    say("autograd times", f"rank {r} dim {d} float32: single input forward "
        f"{fwd_ms:.4f} ms (with a graph; {plain_fwd:.4f} ms without), forward + "
        f"backward {bwd_ms:.4f} ms; B = {AUTOGRAD_BATCH} forward {bfwd_ms:.4f} "
        f"ms, forward + backward {bbwd_ms:.4f} ms (CUDA events, medians) [{card}]")
    del vals, x, A, y, xb, vb, yv_b
    phase_peak("autograd", card)

    # 24. the flagship at BASELINE C5's width -----------------------------------
    ranks, d, B = FLAG_RANKS, FLAG_DIM, FLAG_BATCH
    t_init, model = host_s(lambda: polynomial.init(ranks, d, generator=gen, device=dev))
    nparams = sum(p.numel() for p in model.parameters())
    xs = rand(B, d) * (FLAG_INPUT_SCALE / d)
    ys = rand(B)
    say("flagship", f"SymmetricPolynomial ranks {ranks} dim {d}: {nparams} float32 "
        f"parameters ({nparams * 4 / 1e9:.3f} GB), drawn in {t_init:.3f} s")
    with torch.no_grad():
        be.batched_eval.launches = 0
        polynomial.apply_batched(model, xs)
        torch.cuda.synchronize()
        FLAG_FOLD["launches"] = be.batched_eval.launches
        folds = sum(r >= 3 for r in ranks)
        say("flagship", f"apply_batched over B = {B}: {FLAG_FOLD['launches']} "
            f"batched_eval launches, one for each of the {folds} ranks >= 3 [{card}]")
        if FLAG_FOLD["launches"] != folds:
            raise AssertionError(f"flagship: apply_batched launched batched_eval "
                                 f"{FLAG_FOLD['launches']} times, not {folds}")
        serve_ms, yb = events_ms(lambda: polynomial.apply_batched(model, xs), reps=3)
        ys1 = counted("flagship serve", lambda: torch.stack(
            [polynomial.apply(model, xs[i]) for i in range(FLAG_SINGLE)]))
    if not (yb.shape == (B,) and bool(torch.isfinite(yb).all())):
        raise AssertionError("flagship: batched predictions malformed")
    check("flagship", f"apply_batched over B = {B} vs {FLAG_SINGLE} single apply "
          f"calls through the group-pass kernel ({paths['flagship serve']} "
          f"launches)", nerr(yb[:FLAG_SINGLE], ys1), 1e-5)
    say("flagship times", f"apply_batched over B = {B}: {serve_ms:.4f} ms (CUDA "
        f"events, median of 3) [{card}]")
    opt = torch.optim.Adam(model.parameters(), lr=FLAG_LR)
    marks = {}

    def mark(key):
        def hook(*_):
            marks[key] = torch.cuda.Event(enable_timing=True)
            marks[key].record()
        return hook

    hooks = [model.register_forward_pre_hook(mark("f0")),
             model.register_forward_hook(mark("f1")),
             opt.register_step_pre_hook(mark("o0")),
             opt.register_step_post_hook(mark("o1"))]
    losses, parts = [], []
    torch.cuda.reset_peak_memory_stats()
    for step in range(FLAG_STEPS):
        t0 = time.perf_counter()
        losses.append(float(polynomial.train_step(model, opt, xs, ys)))
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
        parts.append((marks["f0"].elapsed_time(marks["f1"]),
                      marks["f1"].elapsed_time(marks["o0"]),
                      marks["o0"].elapsed_time(marks["o1"]), wall))
        say("flagship train", f"step {step}: loss {losses[-1]!r}; forward "
            f"{parts[-1][0]:.1f} ms, backward {parts[-1][1]:.1f} ms, optimizer "
            f"{parts[-1][2]:.1f} ms (CUDA events), step {wall:.1f} ms on the "
            f"host [{card}]")
    for h in hooks:
        h.remove()
    step_peak = torch.cuda.max_memory_allocated() / 1e9
    with torch.no_grad():
        losses.append(float(polynomial.loss_fn(model, xs, ys)))
    say("flagship train", f"Adam lr {FLAG_LR}, {FLAG_STEPS} steps on a fixed batch "
        f"of {B}: losses {losses} (the last after the last step); peak device "
        f"memory {step_peak:.3f} GB over the steps, beside "
        f"{4 * nparams * 4 / 1e9:.3f} GB of parameters, gradients and Adam "
        f"state [{card}]")
    if not (all(np.isfinite(losses))
            and all(a > b for a, b in zip(losses, losses[1:]))):
        raise AssertionError("flagship: losses not finite and decreasing")
    del model, opt, xs, ys, yb, ys1
    torch.cuda.empty_cache()
    small = polynomial.init(ranks, CKPT_DIM, generator=gen, device=dev)
    root = os.path.dirname(os.path.abspath(__file__))
    with tempfile.TemporaryDirectory(dir=root) as tmp:
        path = os.path.join(tmp, "ckpt.pt")
        torch.save(small.state_dict(), path)
        fresh = polynomial.SymmetricPolynomial(ranks, CKPT_DIM, device=dev)
        fresh.load_state_dict(torch.load(path, weights_only=True))
        same = all(torch.equal(a, b) for a, b in zip(
            small.state_dict().values(), fresh.state_dict().values()))
        size = os.path.getsize(path)
    say("flagship", f"state_dict round trip at dim {CKPT_DIM} ({size} bytes): "
        f"bit for bit {same}")
    if not same:
        raise AssertionError("flagship: the checkpoint changed the parameters")
    del small, fresh
    phase_peak("flagship", card)

    # 25. sparse at the main path's shape ---------------------------------------
    r, d = FULL
    n = indep_size(r, d)
    base = int(n * SPARSE_FRACTION)
    idx = torch.randint(0, d, (base, r), generator=gen, device=dev)
    ent = rand(base)
    idx = torch.cat([idx, idx[:SPARSE_DUPS]])
    ent = torch.cat([ent, 0.5 * ent[:SPARSE_DUPS]])
    t_build, S = host_s(lambda: stt.SparseFlatSymmetricTensor.from_entries(r, d, idx, ent))
    t_flat, F = host_s(S.toflat)
    x, xs = rand(d), rand(SPARSE_BATCH, d)
    ys_ms, y_s = events_ms(lambda: op(S, x), reps=3)
    y_f = counted("sparse vs flat", lambda: op(F, x))
    check("sparse", f"rank {r} dim {d}, nnz {S.nnz} ({SPARSE_DUPS} entered twice): "
          f"single contraction in O(nnz·r) vs the group-pass route on toflat()",
          abs(float(y_s) - float(y_f)) / abs(float(y_f)), 1e-5)
    yb_ms, yb_s = events_ms(lambda: op_b(S, xs), reps=1)
    check("sparse", f"B = {SPARSE_BATCH} contraction over blocks of entries vs "
          f"the batched route on toflat()", nerr(yb_s, op_b(F, xs)), 1e-5)
    F2 = S.add_sparse(S).toflat().data
    check("sparse", "add_sparse then toflat: the duplicates summed, 2·toflat()",
          big_nerr(F2, 2 * F.data), 1e-6)
    del F2
    pick = torch.cat([torch.arange(SPARSE_SAMPLES // 2, device=dev),
                      torch.randint(SPARSE_DUPS, base, (SPARSE_SAMPLES // 2,),
                                    generator=gen, device=dev)])
    rows = idx[pick].tolist()
    got = torch.stack([S.element(i) for i in rows])
    want = torch.stack([F.element(i) for i in rows])
    check("sparse", f"element at {SPARSE_SAMPLES} entries ({SPARSE_SAMPLES // 2} "
          f"entered twice): the O(nnz) masked sum vs toflat()", nerr(got, want), 1e-6)
    doubled = got[: SPARSE_SAMPLES // 2].double() / ent[pick[: SPARSE_SAMPLES // 2]].double()
    say("sparse", f"the entries given twice read 1.5× their first value at "
        f"{int((doubled - 1.5).abs().lt(1e-6).sum())} of {SPARSE_SAMPLES // 2} "
        "samples (the rest share a position with another entry)")
    if not bool((doubled - 1.5).abs().lt(1e-6).any()):
        raise AssertionError("sparse: duplicates were not summed")
    say("sparse times", f"nnz {S.nnz}: from_entries {t_build:.3f} s, toflat "
        f"{t_flat:.3f} s, single contraction {ys_ms:.4f} ms, B = {SPARSE_BATCH} "
        f"{yb_ms:.4f} ms (CUDA events); memory_footprint {S.memory_footprint()} "
        f"bytes beside {F.memory_footprint()} of the flat tensor [{card}]")
    del F, idx, ent, x, xs, y_s, y_f, yb_s, got, want
    phase_peak("sparse", card)

    # 26. persistence and NumPy on the card -------------------------------------
    rf, df = SAVE_FLAT
    keys = [c for c in comb.perm_classes(C2[0]) if comb.class_size(c, C2[1])]
    cases = [("flat", Flat._raw(rf, df, rand(indep_size(rf, df)))),
             ("permcls (C2)", stt.PermClsSymmetricTensor(
                 C2[0], C2[1], {k: rand(comb.class_size(k, C2[1])) for k in keys},
                 device=dev)),
             ("sparse (phase 25)", S)]

    def leaves(t):
        return ([t.vals, t.positions, t.rep, t.gamma] if t.format == "sparse_flat"
                else list(t.values()))

    with tempfile.TemporaryDirectory(dir=root) as tmp:
        for name, t in cases:
            path = os.path.join(tmp, "t.npz")
            t_save, _ = host_s(lambda: ser.save(path, t))
            size = os.path.getsize(path)
            t_load, back = host_s(lambda: ser.load(path, device=dev))
            same = back.format == t.format and all(
                a.dtype == b.dtype and a.device == b.device and torch.equal(a, b)
                for a, b in zip(leaves(t), leaves(back)))
            say("persistence", f"{name} rank {t.rank} dim {t.dim}: save "
                f"{t_save:.3f} s, {size} bytes, load {t_load:.3f} s; bit for "
                f"bit {same} [{card}]")
            if not same:
                raise AssertionError(f"persistence: {name} changed in a round trip")
            os.remove(path)
            del back
    del cases, S
    torch.cuda.empty_cache()
    r, d = FULL
    A = Flat._raw(r, d, rand(indep_size(r, d)))
    with does_not_warn(match="densifying"):
        t_mul, M = host_s(lambda: np.multiply(A, 2.0))
        ok_mul = M.format == "flat" and M.device == A.device and torch.equal(M.data, 2 * A.data)
        del M
        t_exp, E = host_s(lambda: np.exp(A))
        ok_exp = (E.format == "flat" and E.device == A.device
                  and torch.equal(E.data[: 2**20], torch.exp(A.data[: 2**20])))
        del E
        t_close, close = host_s(lambda: np.allclose(A, A))
        t_all, every = host_s(lambda: np.all(A))
    try:
        A.todense()
        raise AssertionError("numpy: todense did not refuse the rank-6 dim-100 tensor")
    except MemoryError:
        pass
    say("numpy", f"rank {r} dim {d} on {A.device}: np.multiply(A, 2.0) "
        f"{t_mul:.3f} s, packed on the card {ok_mul}; np.exp(A) {t_exp:.3f} s, "
        f"{ok_exp}; np.allclose(A, A) {close} in {t_close:.3f} s; np.all(A) "
        f"{every} in {t_all:.3f} s; todense raises MemoryError, so nothing was "
        f"densified [{card}]")
    if not (ok_mul and ok_exp and close is True and every == bool(A.data.all())):
        raise AssertionError("numpy: a NumPy call left the packed path")
    del A
    phase_peak("persistence and numpy", card)
    return paths



def native_phase(card) -> None:
    """Phase 27: the native table generator against NumPy on the host."""
    import numpy as np

    from symtensor_tpu_torch import native
    from symtensor_tpu_torch.utils import profiling
    from symtensor_tpu_torch.utils.tables import Tables, tables

    cpu = torch.device("cpu")
    t0 = time.perf_counter()
    ok = native.available()
    say("native", f"{native.library_path().name}: available {ok}, ready in "
        f"{time.perf_counter() - t0:.2f} s (g++ at first use); native fallbacks "
        f"counted: {profiling.op_counters[native.FALLBACK_SITE]}")
    if not ok or profiling.op_counters[native.FALLBACK_SITE]:
        raise AssertionError("native: the table generator is not available")
    (rc, dc), (rd, dd), (k, di) = NATIVE_CLASS, NATIVE_DENSE, NATIVE_INSERT
    rep_c = tables(rc, dc, cpu).rep_np()
    rep_k = tables(k, di, cpu).rep_np()
    classes = tables(rc, dc, cpu).perm_classes

    def numpy_build(rank, dim, what):
        """A fresh Tables' NumPy build (SYMTENSOR_NO_NATIVE=1), its rep
        built before the clock starts."""
        os.environ["SYMTENSOR_NO_NATIVE"] = "1"
        try:
            t = Tables(rank, dim, cpu)
            if rank > 1 and what != "rep":
                t.rep_np()
            t0 = time.perf_counter()
            out = {"rep": lambda: t.rep_np(), "class ids": lambda: t.class_ids_np,
                   "dense_gather": lambda: t.dense_gather.numpy(),
                   "insert_table": lambda: t.insert_table_np(k)}[what]()
            return time.perf_counter() - t0, out
        finally:
            os.environ.pop("SYMTENSOR_NO_NATIVE", None)

    def timed(fn):
        t0 = time.perf_counter()
        out = fn()
        return time.perf_counter() - t0, out

    # (name, the Tables' route, the native binding widened to int64, NumPy)
    cases = [
        (f"rep_np rank {rc} dim {dc}", "native",
         lambda: native.gflat_rep(rc, dc).astype(np.int64),
         lambda: numpy_build(rc, dc, "rep")),
        (f"class ids rank {rc} dim {dc}", "native",
         lambda: native.row_stats(rep_c, rc, classes)[1].astype(np.int64),
         lambda: numpy_build(rc, dc, "class ids")),
        (f"dense_gather rank {rd} dim {dd}", "NumPy",
         lambda: native.dense_gather(rd, dd).astype(np.int64),
         lambda: numpy_build(rd, dd, "dense_gather")),
        (f"insert_table({k}) dim {di}", "NumPy",
         lambda: native.insert_table(rep_k, k, di).astype(np.int64),
         lambda: numpy_build(k + 1, di, "insert_table")),
    ]
    for name, route, nat, ref in cases:
        t_n1, a = timed(nat)
        t_np, b = ref()
        t_n2, _ = timed(nat)
        same = a.dtype == b.dtype and a.shape == b.shape and bool(np.array_equal(a, b))
        say("native", f"{name}: native {t_n1:.3f} / {t_n2:.3f} s, NumPy {t_np:.3f} s "
            f"(in turns); {a.shape} {a.dtype}, bit for bit {same}; Tables take "
            f"the {route} build [{card}]")
        if not same:
            raise AssertionError(f"native: {name} differs from the NumPy build")
        del a, b
    if profiling.op_counters[native.FALLBACK_SITE]:
        raise AssertionError("native: a fallback to NumPy was counted")
    phase_peak("native", card)


def route_figures(fn, reps: int) -> dict:
    """One route's figures: median ms of `reps` calls by CUDA events (after a
    warm-up call), median host wall ms of a call ending in a synchronise,
    torch ops of one call, and the peak GB over one call above what was
    allocated before it."""
    fn()
    torch.cuda.synchronize()
    ms, out = events_ms(fn, reps=reps)
    walls = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t0) * 1e3)
    with OpCount() as ops:
        fn()
    del out
    torch.cuda.synchronize()
    HELD_PEAK[0] = max(HELD_PEAK[0], torch.cuda.max_memory_allocated())
    _, before, peak = peak_of(fn)
    return {"ms": ms, "wall": statistics.median(walls), "ops": ops.n,
            "peak": peak - before}


def compare_routes(phase, card, label, routes: dict, reps: int, rounds: int = 2):
    """`routes` {name: fn} measured in turns over `rounds` rounds; prints
    each measurement and returns {name: [figures, ...]}."""
    got = {name: [] for name in routes}
    for _ in range(rounds):
        for name, fn in routes.items():
            got[name].append(route_figures(fn, reps))
    for name, figs in got.items():
        say(f"{phase} times", f"{label} {name}: " + "; ".join(
            f"{f['ms']:.4f} ms (host {f['wall']:.3f} ms), {f['ops']} torch ops, "
            f"peak {f['peak']:.3f} GB over the call" for f in figs) + f" [{card}]")
    return got


def gemm_inputs(gen, dev, r: int, dt: str):
    """A rank-r dim-GEMM_DIM tensor of seeded N(0, 1) values in storage type
    `dt` and GEMM_BATCH seeded inputs N(0, 1/dim) in float32."""
    import symtensor_tpu_torch as stt
    from symtensor_tpu_torch.utils import indep_size

    d = GEMM_DIM
    vals = torch.randn(indep_size(r, d), generator=gen, device=dev).to(getattr(torch, dt))
    xs = torch.randn(GEMM_BATCH, d, generator=gen, device=dev) / d**0.5
    return stt.FlatSymmetricTensor._raw(r, d, vals), xs


def fold_route(A, xs):
    """The batched op's fold route (``_BatchedEval``) whatever the cache."""
    from symtensor_tpu_torch.kernels import poly_eval as pe
    from symtensor_tpu_torch.utils.precision import compute_dtype

    ct = compute_dtype(A.data, xs)
    return lambda: pe._BatchedEval.apply(A.data, xs.to(ct), A.tables, A.rank,
                                         A.dim, ct)


def premul_phase(dev, card) -> None:
    """Phase 28: the premultiplied views against the fold route."""
    from symtensor_tpu_torch.kernels import poly_eval as pe

    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED + 28)
    torch.cuda.reset_peak_memory_stats()
    with torch.no_grad():
        for r, dt in PREMUL_CASES:
            A, xs = gemm_inputs(gen, dev, r, dt)
            label = f"rank {r} dim {A.dim} B {len(xs)} {dt}"
            fold = fold_route(A, xs)
            fold()  # the tables and row maps, built once
            torch.cuda.synchronize()
            t_build, views = host_s(lambda: pe.group_views_premul(A))
            cache = sum(V.numel() for V in views.blocks) * A.data.element_size()
            say("premul", f"{label}: views built in {t_build:.3f} s, "
                f"{cache / 1e9:.3f} GB beside the values [{card}]")

            def premul():
                return pe.views_eval_batched_premul(pe.group_views_premul(A), xs)

            yf, yp = fold(), premul()
            if not (yp.shape == (len(xs),) and bool(torch.isfinite(yp).all())):
                raise AssertionError("premul: result malformed")
            tol = 1e-5 if dt == "float32" else 2e-2
            check("premul", f"{label}: premul views vs the fold route", nerr(yp, yf), tol)
            if pe._cache_hit(A, "_group_views_premul") is None:
                raise AssertionError("premul: the views were not cached")
            compare_routes("premul", card, label, {"fold": fold, "premul": premul},
                           GEMM_REPS[r])
            if (r, dt) == (6, "float32"):
                x = xs[0]
                single = {"group pass": lambda: pe.poly_eval_flat_fast(A, x),
                          "premul": lambda: pe.views_eval_premul(views, x)}
                ys = {k: fn() for k, fn in single.items()}
                check("premul", f"{label}: single-input premul vs the group-pass "
                      "route", abs(float(ys["premul"]) - float(ys["group pass"]))
                      / abs(float(ys["group pass"])), 1e-5)
                compare_routes("premul", card, f"rank {r} dim {A.dim} {dt} single input",
                               single, 20)
            del A, xs, views, yf, yp
            torch.cuda.empty_cache()
    phase_peak("premul", card)


def cell_phase(dev, card) -> None:
    """Phase 29: the cell-major GEMMs beside the fold and premul routes, and
    the flagship trained with the cell switch on."""
    import numpy as np

    from symtensor_tpu_torch.kernels import cell_gemm as cg
    from symtensor_tpu_torch.kernels import poly_eval as pe
    from symtensor_tpu_torch.models import polynomial

    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED + 29)
    torch.cuda.reset_peak_memory_stats()
    with torch.no_grad():
        for r, dt in CELL_CASES:
            A, xs = gemm_inputs(gen, dev, r, dt)
            label = f"rank {r} dim {A.dim} B {len(xs)} {dt}"
            blocks = cg._cell_blocks_static(r, A.dim)
            t_build, views = host_s(lambda: cg.cell_views(A))
            stored = sum(V.numel() for V, _, _ in views)
            say("cell", f"{label}: {len(blocks)} blocks, K from {blocks[0][0]} to "
                f"{blocks[-1][0]}, {stored} stored values for n = {A.data.numel()}; "
                f"views built in {t_build:.3f} s (the first call: the blocks' "
                f"upload and the gather) [{card}]")
            fold = fold_route(A, xs)
            pe.group_views_premul(A)
            routes = {"fold": fold,
                      "premul": lambda: pe.views_eval_batched_premul(
                          pe.group_views_premul(A), xs),
                      "cell": lambda: cg.poly_eval_cell_batched(A, xs)}
            ys = {k: fn() for k, fn in routes.items()}
            if not (ys["cell"].shape == (len(xs),) and bool(torch.isfinite(ys["cell"]).all())):
                raise AssertionError("cell: result malformed")
            tol = 1e-5 if dt == "float32" else 2e-2
            check("cell", f"{label}: cell route vs the fold route",
                  nerr(ys["cell"], ys["fold"]), tol)
            flop = 2 * stored * len(xs)
            figs = compare_routes("cell", card, label, routes, GEMM_REPS[r])
            best = min(f["ms"] for f in figs["cell"])
            say("cell", f"{label}: {flop / 1e9:.2f} GFLOP of GEMMs, "
                f"{flop / best / 1e9:.2f} TFLOP/s at the best cell call [{card}]")
            del A, xs, views, ys, routes, fold
            torch.cuda.empty_cache()
    phase_peak("cell", card)

    # the flagship from one seed, default routes and then the cell switch on
    calls = []
    real = cg.poly_eval_cell_batched

    def counted(*args):
        calls.append(args[0].rank)
        return real(*args)

    def train(switch: bool):
        g = torch.Generator(device=dev)
        g.manual_seed(SEED + 290)
        model = polynomial.init(FLAG_RANKS, FLAG_DIM, generator=g, device=dev)
        xs = torch.randn(FLAG_BATCH, FLAG_DIM, generator=g, device=dev) * (
            FLAG_INPUT_SCALE / FLAG_DIM)
        ys = torch.randn(FLAG_BATCH, generator=g, device=dev)
        opt = torch.optim.Adam(model.parameters(), lr=FLAG_LR)
        losses, walls = [], []
        if switch:
            os.environ["SYMTENSOR_BATCHED_CELL"] = "1"
            cg.poly_eval_cell_batched = counted
        try:
            for _ in range(CELL_FLAG_STEPS):
                t0 = time.perf_counter()
                losses.append(float(polynomial.train_step(model, opt, xs, ys)))
                torch.cuda.synchronize()
                walls.append((time.perf_counter() - t0) * 1e3)
            with torch.no_grad():
                losses.append(float(polynomial.loss_fn(model, xs, ys)))
        finally:
            os.environ.pop("SYMTENSOR_BATCHED_CELL", None)
            cg.poly_eval_cell_batched = real
        del model, opt, xs, ys
        torch.cuda.empty_cache()
        return losses, walls

    base, base_ms = train(False)
    if calls:
        raise AssertionError("cell: the default route reached the cell GEMMs")
    cell, cell_ms = train(True)
    say("cell flagship", f"ranks {FLAG_RANKS} dim {FLAG_DIM} B {FLAG_BATCH}, Adam "
        f"lr {FLAG_LR}, {CELL_FLAG_STEPS} steps from one seed: default routes "
        f"losses {base}, steps {[round(w, 1) for w in base_ms]} ms; "
        f"SYMTENSOR_BATCHED_CELL=1 losses {cell}, steps "
        f"{[round(w, 1) for w in cell_ms]} ms (host wall, synchronised); cell "
        f"route calls by rank {dict(sorted(collections.Counter(calls).items()))} "
        f"[{card}]")
    want = {r: CELL_FLAG_STEPS + 1 for r in FLAG_RANKS if cg.cell_eligible(r, FLAG_DIM)}
    if dict(collections.Counter(calls)) != want:
        raise AssertionError(f"cell: the eligible ranks {sorted(want)} did not "
                             "train through the cell route")
    rel = max(abs(a - b) / abs(b) for a, b in zip(cell, base))
    check("cell flagship", "losses with the switch vs the default routes", rel, 1e-4)
    if not (all(np.isfinite(cell)) and all(a > b for a, b in zip(cell, cell[1:]))):
        raise AssertionError("cell: losses not finite and decreasing")
    phase_peak("cell flagship", card)


def fold_phase(dev, card) -> dict:
    """Phase 32: ``batched_eval`` (one launch a rank) against the per-group
    chain it replaced (``_batched_forward`` on the card, its twin), per
    rank at dim 100: both against the float64 twin, normalised by the
    twin at |values| and |x| (the fold's weights are positive, so that
    bounds every partial sum); two launches the same bits; device times by
    CUDA events in turns (kernel, chain, kernel, chain); both also against
    the plain reference by the root sum of squares of the terms (the batch
    benchmark's err, at FOLD_RSS_TOL for the kernel); the kernel's rate
    against the FP32 bound (2·B·n operations at 67 TFLOP/s) and against its
    split-TF32 bound (three TF32 products of 2·B·n operations at 495
    TFLOP/s), and in FOLD_NOT_SLOWER no slower than the chain."""
    import symtensor_tpu_torch as stt
    from portbench.reference import poly
    from symtensor_tpu_torch.kernels import batched_eval as be
    from symtensor_tpu_torch.kernels import poly_eval as pe
    from symtensor_tpu_torch.utils import indep_size

    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED + 32)
    d, out, vals = FOLD_DIM, {}, {}
    torch.cuda.reset_peak_memory_stats()
    for r, B in FOLD_CASES:
        if r not in vals:
            vals.clear()
            torch.cuda.empty_cache()
            vals[r] = torch.randn(indep_size(r, d), generator=gen, device=dev) * 1e-2
        A = stt.FlatSymmetricTensor._raw(r, d, vals[r])
        xs = torch.randn(B, d, generator=gen, device=dev) * (4 / d)
        label = f"rank {r} dim {d} B {B}"

        def kernel():
            return pe._BatchedEval.apply(A.data, xs, A.tables, r, d, torch.float32)

        def chain():
            with pe.full_fp32_matmul():
                return pe._batched_forward(A.data, xs, A.tables, r, d, torch.float32)

        be.batched_eval.launches = 0
        first, again = kernel(), kernel()
        torch.cuda.synchronize()
        if be.batched_eval.launches != 2 or not torch.equal(first, again):
            raise AssertionError(f"fold: {label}: {be.batched_eval.launches} launches "
                                 "for 2 calls, or other bits on the second")
        ref = pe._batched_forward(A.data.double(), xs.double(), A.tables, r, d,
                                  torch.float64)
        scale = pe._batched_forward(A.data.double().abs(), xs.double().abs(),
                                    A.tables, r, d, torch.float64)
        plain, rss = poly.evaluate({r: A.data}, None, xs)
        err, rss_err = {}, {}
        for name, y in (("kernel", first), ("chain", chain())):
            err[name] = float(((y.double() - ref).abs() / scale).max())
            check("fold", f"{label}: {name} vs the float64 twin", err[name], 1e-5)
            rss_err[name] = float(((y.double() - plain).abs() / rss).max())
        say("fold", f"{label}: err over the root sum of squares of the terms: kernel "
            f"{rss_err['kernel']:.3e}, chain {rss_err['chain']:.3e} [{card}]")
        check("fold", f"{label}: kernel vs the plain reference by its terms' root "
              "sum of squares", rss_err["kernel"], FOLD_RSS_TOL)
        del ref, scale, plain, rss, first, again
        times = {"kernel": [], "chain": []}
        for _ in range(2):
            for name, fn in (("kernel", kernel), ("chain", chain)):
                fn()
                times[name].append(events_ms(fn, FOLD_REPS[r])[0])
        ms = {k: statistics.median(v) for k, v in times.items()}
        bound = 2.0 * B * A.data.numel() / FP32_FLOPS * 1e3
        tf32 = 3 * 2.0 * B * A.data.numel() / TF32_FLOPS * 1e3
        say("fold times", f"{label}: kernel {times['kernel'][0]:.3f} / "
            f"{times['kernel'][1]:.3f} ms ({bound / ms['kernel'] * 100:.1f} % of the FP32 "
            f"bound {bound:.3f} ms, {tf32 / ms['kernel'] * 100:.1f} % of its split-TF32 "
            f"bound {tf32:.3f} ms), chain {times['chain'][0]:.3f} / "
            f"{times['chain'][1]:.3f} ms, in turns, medians of {FOLD_REPS[r]}; kernel "
            f"err {err['kernel']:.3e}, by the terms {rss_err['kernel']:.3e} [{card}]")
        if (r, B) in FOLD_NOT_SLOWER and ms["kernel"] > ms["chain"]:
            raise AssertionError(f"fold: {label}: the kernel is slower than the chain")
        out[f"r{r}_b{B}"] = {"ms": ms["kernel"], "chain_ms": ms["chain"], "bound_ms": tf32,
                             "fp32_bound_ms": bound, "err": err["kernel"],
                             "rss_err": rss_err["kernel"]}
        del A, xs
    del vals
    torch.cuda.empty_cache()
    B = FOLD_CASES[0][1]
    ranks = [r for r, b in FOLD_CASES if b == B]
    say("fold", f"ranks {ranks} at B {B}: kernel "
        f"{sum(out[f'r{r}_b{B}']['ms'] for r in ranks):.3f} ms, chain "
        f"{sum(out[f'r{r}_b{B}']['chain_ms'] for r in ranks):.3f} ms, FP32 bound "
        f"{sum(out[f'r{r}_b{B}']['fp32_bound_ms'] for r in ranks):.3f} ms, split-TF32 "
        f"bound {sum(out[f'r{r}_b{B}']['bound_ms'] for r in ranks):.3f} ms [{card}]")
    phase_peak("fold", card)
    return out


def parallel_phase(card) -> None:
    """Phase 30: the parallel layer in a world of one rank (NCCL) and a
    world of two ranks on one card (gloo); every line with the card."""
    from symtensor_tpu_torch.parallel.launch import spawn_world
    from symtensor_tpu_torch.testing import parallel_smoke

    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    say("parallel", f"this process holds {torch.cuda.memory_allocated() / 1e9:.3f} GB "
        f"on the card; phase 22's float32 call at rank 6 dim 100: "
        f"{PHASE22.get('s', float('nan')):.3f} s by CUDA events, peak "
        f"{PHASE22.get('peak', float('nan')):.3f} GB over its inputs [{card}]")
    for world, backend, fn in ((1, "nccl", parallel_smoke.world1),
                               (2, "gloo", parallel_smoke.world2)):
        t0 = time.perf_counter()
        lines = spawn_world(fn, world, backend=backend, device="cuda",
                            timeout_s=PARALLEL_DEADLINE_S, args=(PARALLEL,))[0]
        for line in lines:
            say("parallel", f"{line} [{card}]")
        say("parallel", f"world of {world} on {backend}, every rank on cuda:0: "
            f"{time.perf_counter() - t0:.1f} s with its start [{card}]")


def property_phase(dev, card) -> None:
    """Phase 31: seeded draws of the kernels' property checks, then the
    getting-started document on the card."""
    import numpy as np

    from symtensor_tpu_torch.testing import kernel_properties as kp

    t0 = time.perf_counter()
    rng = np.random.default_rng(SEED + 31)
    runs = {
        "group_pass": (kp.draw_group_pass_case, kp.check_group_pass,
                       kp.GROUP_PASS_BRANCHES),
        "gather_combine": (kp.draw_gather_case, kp.check_gather, kp.GATHER_BRANCHES),
    }
    for name, (draw, check, branches) in runs.items():
        t = time.perf_counter()
        cases = [draw(rng, i) for i in range(PROPERTY_DRAWS[name])]
        results = [check(*c, seed=SEED + i, device=dev) for i, c in enumerate(cases)]
        counts = kp.summary_counts(results, branches)
        say("properties", f"{name}: {len(cases)} draws in "
            f"{time.perf_counter() - t:.1f} s; draws a branch: " + ", ".join(
                f"{b} {k}" for b, k in counts.items()) + f" [{card}]")
        for dt in sorted({r["dtype"] for r in results}, key=str):
            of = [r for r in results if r["dtype"] == dt]
            twin = ("bit for bit" if name == "gather_combine"
                    else f"{kp.worst(of, 'twin_err'):.3e} (group_pass and "
                    f"group_eval; tolerance {kp.GROUP_PASS_TWIN_TOL[dt]:g}, "
                    f"group_eval's at most {kp.GROUP_EVAL_ROW_SHARE:g}/ΣP_j)")
            say("properties", f"{name} {str(dt)[6:]}: {len(of)} draws; worst "
                f"normalised error against the twin {twin}, against the "
                f"float64 oracle {kp.worst(of, 'oracle_err'):.3e} (tolerance "
                f"{kp.ORACLE_TOL[dt]:g})")
        if not all(counts.values()):
            raise AssertionError(f"properties: {name}'s draws missed a branch: {counts}")
    t = time.perf_counter()
    errs = collections.defaultdict(float)
    for i in range(PROPERTY_DRAWS["public ops"]):
        ra, rb = (int(v) for v in rng.integers(1, 4, size=2))
        dim, d_out = (int(v) for v in rng.integers(2, 13, size=2))
        for op, e in kp.check_public_ops(ra, rb, dim, d_out, SEED + i, dev).items():
            errs[op] = max(errs[op], e)
    say("properties", f"public ops, float64 on the card against the CPU port: "
        f"{PROPERTY_DRAWS['public ops']} draws in {time.perf_counter() - t:.1f} s; "
        "worst normalised error " + ", ".join(f"{k} {v:.3e}" for k, v in errs.items())
        + f" (tolerance {kp.ORACLE_TOL[torch.float64]:g})")
    run_doc(dev, card)
    say("properties", f"phase 31 in {time.perf_counter() - t0:.1f} s [{card}]")


def run_doc(dev, card) -> None:
    """Execute the document's python blocks in one namespace, in order,
    with its device line set to dev's type ("cuda"); every tensor,
    symmetric tensor and model left in the namespace must live on dev
    (cuda:0)."""
    import re

    from symtensor_tpu_torch.config import config
    from symtensor_tpu_torch.core.base import SymmetricTensor

    path = os.path.join(os.path.dirname(os.path.abspath(__file__)), DOC)
    with open(path) as f:
        text = f.read()
    if text.count(DOC_DEVICE_LINE) != 1:
        raise AssertionError(f"{DOC}: its device line {DOC_DEVICE_LINE!r} "
                             "is not there exactly once")
    text = text.replace(DOC_DEVICE_LINE, DOC_DEVICE_LINE.replace('"cpu"', f'"{dev.type}"'))
    before = config.default_device
    t0 = time.perf_counter()
    ns = {"__name__": "docs.torch_getting_started"}
    blocks = [code for tag, code in re.findall(DOC_BLOCK, text, re.M | re.S)
              if tag != "noexec"]
    for k, code in enumerate(blocks):
        exec(compile(code, f"{path}, python block {k + 1}", "exec"), ns)
    torch.cuda.synchronize()
    devices = collections.Counter()
    for v in ns.values():
        if isinstance(v, (torch.Tensor, SymmetricTensor)):
            devices[str(v.device)] += 1
        elif isinstance(v, torch.nn.Module):
            devices.update(str(p.device) for p in v.parameters())
    say("properties", f"{DOC}: {len(blocks)} blocks on the card in "
        f"{time.perf_counter() - t0:.1f} s; tensors, symmetric tensors and "
        f"parameters it made, by device: {dict(devices)}; "
        f"config.default_device back to {config.default_device!r} [{card}]")
    if set(devices) != {str(dev)} or config.default_device != before:
        raise AssertionError(f"{DOC}: not every tensor on {dev}, or the "
                             "device not put back")


def multi_card() -> int:
    """``python3 chip_smoke.py --multi-card``, on a machine of n ≥ 2 cards:
    the parallel layer in a world of one rank a card over NCCL (meshes
    (1, n) and (2, n/2), ``parallel_smoke.cards``), then the dry run
    (``dryrun_multichip(n)``). Every line with every card's name and power
    limit."""
    from symtensor_tpu_torch.kernels import _build
    from symtensor_tpu_torch.parallel.dryrun import dryrun_multichip
    from symtensor_tpu_torch.parallel.launch import spawn_world
    from symtensor_tpu_torch.testing import parallel_smoke

    n = torch.cuda.device_count()
    if n < 2:
        print(f"chip_smoke --multi-card: {n} card; this needs two or more",
              file=sys.stderr)
        return 1
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         timeout=60, check=True).stdout.strip().splitlines()
    cards = "; ".join(out)
    _build.build()  # once, before the ranks load it
    t0 = time.perf_counter()
    lines = spawn_world(parallel_smoke.cards, n, backend="nccl", device="cuda",
                        timeout_s=3 * PARALLEL_DEADLINE_S, args=(PARALLEL,))[0]
    for line in lines:
        say("multi-card", f"{line} [{cards}]")
    say("multi-card", f"world of {n} on nccl, one rank a card: "
        f"{time.perf_counter() - t0:.1f} s with its start [{cards}]")
    dryrun_multichip(n)
    print(cards)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": n}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
