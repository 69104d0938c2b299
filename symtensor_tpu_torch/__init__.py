"""symtensor_tpu_torch: the PyTorch and CUDA port of symtensor_tpu.

Packed symmetric tensors on ``torch`` tensors, with a hand-written CUDA
kernel (``csrc/group_pass.cu``) for the grouped pass of polynomial
evaluation. The JAX package ``symtensor_tpu`` is the reference the port is
tested against; this package imports neither it nor jax.

Importing the package builds and loads no kernel: the CUDA library is
compiled at the first CUDA use (``kernels/_build.py``).
"""

from .config import config
from .core import FlatSymmetricTensor, SymmetricTensor
from . import ops
from . import ops as symalg
from . import utils

__version__ = "0.1.0"

__all__ = [
    "config",
    "FlatSymmetricTensor",
    "SymmetricTensor",
    "ops",
    "symalg",
    "utils",
]
