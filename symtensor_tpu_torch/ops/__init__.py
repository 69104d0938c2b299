"""symalg — the symmetrized algebra namespace.

The ported part of ``symtensor_tpu.symalg``: the full contraction with a
vector, single-input and batched, and the dense symmetrization oracles.
The rest of the namespace waits for its ROADMAP items.
"""

from .contract import (
    contract_all_indices_with_vector,
    contract_all_indices_with_vector_batched,
)
from .symmetrize import is_symmetric, symmetrize

__all__ = [
    "contract_all_indices_with_vector",
    "contract_all_indices_with_vector_batched",
    "is_symmetric",
    "symmetrize",
]
