"""Moment hierarchies: the field-theory workload around
``contract_tensor_list`` (BASELINE config 4).

The counterpart of ``symtensor_tpu/models/moments.py``. Symmetric moment
tensors m_r = E[x^⊗r] of a Gaussian are built exactly in the decomposed
format by the Isserlis recursion

    m_r = sym(μ ⊗ m_{r-1}) + (r−1)·sym(Σ ⊗ m_{r-2})

from structural decomp ops alone (outer, scale, add): no dense tensor is
formed. The block-embedded weights grow as (F_a+F_b)^k, and
``add_decomp``'s auto-compaction turns a moment into the standard basis
(dim**rank weights) where that is smaller, so the reachable size is set by
that rule (``config.decomp_autoreduce_elems``). Expectations of symmetric
polynomials follow by full contraction ⟨A_r, m_r⟩.
"""

from __future__ import annotations

from typing import List, Sequence

import torch

from ..core.base import default_device, default_dtype, leaf_device
from ..core.decomp import DecompSymmetricTensor
from ..ops import contract_tensor_list, tensordot


def gaussian_moments(mean, cov, max_rank: int) -> List[DecompSymmetricTensor]:
    """[m_1, …, m_max_rank] as decomp tensors (exact, Isserlis). `mean` and
    `cov` keep their device if they are tensors; other data goes to
    ``config.default_device``."""
    dev = leaf_device([mean, cov])
    mean = torch.as_tensor(mean, device=dev)
    cov = torch.as_tensor(cov, device=dev)
    d = mean.shape[0]
    if tuple(cov.shape) != (d, d):
        raise ValueError("cov must be (d, d)")
    m1 = DecompSymmetricTensor.from_vector(mean, 1)
    cov_t = DecompSymmetricTensor.from_matrix(cov)
    out = [m1]
    if max_rank >= 2:
        out.append(cov_t.add_decomp(DecompSymmetricTensor.from_vector(mean, 2)))
    for r in range(3, max_rank + 1):
        term1 = m1.outer_decomp(out[r - 2])  # symmetrized lazily
        term2 = cov_t.outer_decomp(out[r - 3]).scale(float(r - 1))
        out.append(term1.add_decomp(term2))
    return out


def polynomial_expectation(coeffs: Sequence, moments: Sequence) -> torch.Tensor:
    """E[Σ_r ⟨A_r, x^⊗r⟩] = Σ_r ⟨A_r, m_r⟩: the full contraction of matching
    ranks (tensordot over all axes), as a 0-d tensor of the results' type,
    on their device."""
    total = None
    for A in coeffs:
        m = moments[A.rank - 1]
        if m.rank != A.rank:
            raise ValueError("moments list must be indexed by rank-1")
        res = tensordot(A, m, axes=A.rank).todense().reshape(())
        total = res if total is None else total + res
    if total is None:  # no coefficients: zero, where new tensors go
        return torch.zeros((), dtype=default_dtype(), device=default_device())
    return total


def hierarchy_step(A, chi_list: Sequence, n_times: int = 1, rule: str = "all"):
    """One step of a moment-hierarchy propagation: contract `n_times`
    indices of the coupling tensor A against the per-index tensors χ_i
    (``contract_tensor_list``)."""
    return contract_tensor_list(A, chi_list, n_times=n_times, rule=rule)
