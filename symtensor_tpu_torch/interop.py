"""Carry packed tensors across between the JAX package and this one.

Both packages store a flat tensor as the same 1-D gflat-ordered array, so
the packed values (this library's "weights") cross over unchanged:

    A_torch = flat_from_numpy(6, 100, np.asarray(A_jax.data), device="cuda")
    data = flat_to_numpy(A_torch)    # → FlatSymmetricTensor(6, 100, data)

NumPy has no bfloat16 of its own; the JAX package's bfloat16 arrays (an
``ml_dtypes`` dtype) are taken bit for bit.
"""

from __future__ import annotations

import numpy as np
import torch

from .core.flat import FlatSymmetricTensor


def flat_from_numpy(
    rank: int, dim: int, data, *, device, dtype=None
) -> FlatSymmetricTensor:
    """A ``FlatSymmetricTensor`` on `device` from packed NumPy values. The
    values are copied: a JAX array's host view is read-only."""
    arr = np.array(data, copy=True, order="C")
    if arr.dtype.name == "bfloat16":
        t = torch.from_numpy(arr.view(np.uint16)).view(torch.bfloat16)
    else:
        t = torch.from_numpy(arr)
    return FlatSymmetricTensor(
        rank=rank, dim=dim, data=t.to(device=device, dtype=dtype)
    )


def flat_to_numpy(A: FlatSymmetricTensor) -> np.ndarray:
    """The packed values as a NumPy array on the host. bfloat16 values come
    back as float32 (exact: every bfloat16 is a float32)."""
    data = A.toflat().data.detach()
    if data.dtype == torch.bfloat16:
        data = data.to(torch.float32)
    return data.cpu().numpy()
