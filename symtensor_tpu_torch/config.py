"""Global configuration for symtensor_tpu_torch.

The counterpart of ``symtensor_tpu/config.py:17-46``: the default dtype and
the default device (the card), the size guards for host-built tables and
dense materialization, the decomp auto-compaction threshold and the
slow-path warning switch. The JAX
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

    # Device of newly-created tensors whose data is not already a torch
    # tensor (constructors, ``zeros``, ``from_dense`` of NumPy data). The
    # port runs on the card; CPU runs ask for the CPU by setting "cpu"
    # here or passing ``device=``. Without CUDA, "cuda" raises.
    default_device: str = "cuda"

    # Maximum number of entries allowed in a host-built static table
    # (index tables, gather maps). Ops that would exceed it raise.
    max_table_entries: int = 200_000_000

    # Maximum dense size (d**r) that todense() will materialize before
    # raising.
    max_dense_elements: int = 100_000_000

    # Warn (once per site) when an op leaves a compressed format for a
    # slower one (``utils/profiling.count_fallback``).
    warn_on_densify: bool = True

    # Decomp ``add_decomp`` auto-compaction: when the block-embedded
    # weights would exceed this many elements and the exact standard-basis
    # form (dim**rank coefficients) is smaller, the sum is returned in the
    # standard basis. Bounds the growth of long add chains; 0 disables it.
    decomp_autoreduce_elems: int = 65536


config = Config()
