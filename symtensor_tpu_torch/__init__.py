"""symtensor_tpu_torch: the PyTorch and CUDA port of symtensor_tpu.

Packed symmetric tensors on ``torch`` tensors in five storage formats
(flat, per-σ-class with scalar compression, dense, outer-product
decomposition, sparse), with hand-written CUDA kernels (``csrc/``) for the
grouped pass of polynomial evaluation and the gather-combine of the
symmetrized products; ``serialization`` (JSON, ``.npz`` files in the JAX
package's layout), NumPy dispatch and pydantic fields, and the models
(``models.polynomial``, ``models.moments``). The JAX package
``symtensor_tpu`` is the reference the port is tested against; this
package imports neither it nor jax.

Importing the package builds and loads no kernel: the CUDA library is
compiled at the first CUDA use (``kernels/_build.py``).
"""

from .config import config
from .core import (
    DecompSymmetricTensor,
    DenseSymmetricTensor,
    FlatSymmetricTensor,
    FlatSymmetricTensorSlice,
    PermClsSymmetricTensor,
    SparseFlatSymmetricTensor,
    SymmetricTensor,
)
from . import ops
from . import ops as symalg
from . import utils

__version__ = "0.1.0"

__all__ = [
    "config",
    "DecompSymmetricTensor",
    "DenseSymmetricTensor",
    "FlatSymmetricTensor",
    "FlatSymmetricTensorSlice",
    "PermClsSymmetricTensor",
    "SparseFlatSymmetricTensor",
    "SymmetricTensor",
    "ops",
    "symalg",
    "utils",
]
