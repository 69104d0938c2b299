"""Global configuration for symtensor_tpu_torch.

The counterpart of ``symtensor_tpu/config.py:17-46``: the default dtype and
the size guards for host-built tables and dense materialization. The JAX
package's compile-cache plumbing has no counterpart here: PyTorch runs
eagerly, and the hand-written kernels are built once per source hash
(``kernels/_build.py``).
"""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass
class Config:
    # Default dtype for newly-created tensors (a ``torch`` dtype name).
    # Tests that need 1e-12 agreement pass float64 explicitly.
    default_dtype: str = "float32"

    # Maximum number of entries allowed in a host-built static table
    # (index tables, gather maps). Ops that would exceed it raise.
    max_table_entries: int = 200_000_000

    # Maximum dense size (d**r) that todense() will materialize before
    # raising.
    max_dense_elements: int = 100_000_000


config = Config()
