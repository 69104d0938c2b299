"""Dense symmetrization and symmetry checking.

The counterpart of ``symtensor_tpu/ops/symmetrize.py``: the correctness
oracles of the package, which ``from_dense`` uses at small sizes.

- ``symmetrize`` uses the coset recursion S_r = S'_{r-1} ∘ avg_k(moveaxis
  k→0): O(r²) transposes instead of r!.
- ``is_symmetric`` checks invariance under the r−1 adjacent transpositions,
  which generate S_r.

A ``torch.Tensor`` keeps its device; other data (NumPy arrays, lists) goes
to ``config.default_device``.
"""

from __future__ import annotations

import torch

from ..core.base import default_device


def _as_tensor(arr) -> torch.Tensor:
    if isinstance(arr, torch.Tensor):
        return arr
    return torch.as_tensor(arr, device=default_device())


def symmetrize(arr: torch.Tensor) -> torch.Tensor:
    """Project a dense tensor onto its symmetric part:
    out = (1/r!) Σ_σ permute(arr, σ)."""
    arr = _as_tensor(arr)
    r = arr.ndim
    if r <= 1:
        return arr

    def _sym_trailing(a: torch.Tensor, start: int) -> torch.Tensor:
        """Symmetrize axes start..r-1 of `a`."""
        k = r - start
        if k <= 1:
            return a
        acc = a
        for ax in range(start + 1, r):
            acc = acc + torch.movedim(a, ax, start)
        acc = acc / k
        return _sym_trailing(acc, start + 1)

    return _sym_trailing(arr, 0)


def is_symmetric(arr, rtol: float = 1e-5, atol: float = None) -> bool:
    """True if `arr` is (numerically) invariant under axis permutations.

    The default absolute tolerance is dtype-aware (100·eps·max|arr|), so an
    array produced by `symmetrize` in float32 passes despite the rounding
    of the averaging recursion."""
    arr = _as_tensor(arr)
    r = arr.ndim
    if len(set(arr.shape)) > 1:
        return False
    if atol is None:
        if arr.is_floating_point():
            scale = float(arr.abs().max()) if arr.numel() else 0.0
            atol = 100.0 * torch.finfo(arr.dtype).eps * max(scale, 1e-30)
        else:
            atol = 0.0
    if not arr.is_floating_point():
        arr = arr.to(torch.float64)
    for ax in range(r - 1):
        if not torch.allclose(
            arr, arr.transpose(ax, ax + 1), rtol=rtol, atol=atol
        ):
            return False
    return True
