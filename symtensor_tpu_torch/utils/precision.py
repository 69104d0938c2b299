"""Matmul precision policy for value-path products.

One policy: a float32 matrix product on the value path runs in full
float32, with TF32 off. This matches the accuracy the JAX package asks of
its value-path dots (``Precision.HIGHEST`` for single-input evaluation,
``HIGH`` for the batched GEMMs, ``symtensor_tpu/utils/precision.py``), and
the upstream library's plain NumPy arithmetic. bfloat16 storage is
upcast to float32 before a product, so its products follow the same rule;
float64 products are unaffected by the setting.

Each call site applies the policy explicitly with :func:`full_fp32_matmul`.
There is no environment knob: a caller who wants TF32 speed calls the
kernels' plain versions under their own precision setting.

:func:`compute_dtype` is the type an evaluation of values at inputs
computes in, whichever layer runs it.
"""

from __future__ import annotations

import contextlib

import torch


@contextlib.contextmanager
def full_fp32_matmul():
    """Run the enclosed float32 matrix products in full float32.

    Sets ``torch.set_float32_matmul_precision("highest")`` and restores the
    caller's setting on exit. The setting is process-wide, so a thread
    that runs float32 products concurrently sees it too."""
    prev = torch.get_float32_matmul_precision()
    torch.set_float32_matmul_precision("highest")
    try:
        yield
    finally:
        torch.set_float32_matmul_precision(prev)


def compute_dtype(vals: torch.Tensor, x: torch.Tensor) -> torch.dtype:
    """The evaluation's type: the promotion of values and input, at least
    float32 (bfloat16 values accumulate in float32)."""
    ct = torch.promote_types(vals.dtype, x.dtype)
    if not ct.is_floating_point or ct in (torch.bfloat16, torch.float16):
        ct = torch.promote_types(ct, torch.float32)
    return ct
