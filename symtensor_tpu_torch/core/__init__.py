from .base import SymmetricTensor
from .decomp import DecompSymmetricTensor
from .dense import DenseSymmetricTensor
from .flat import FlatSymmetricTensor, FlatSymmetricTensorSlice
from .permcls import PermClsSymmetricTensor
from .sparse_flat import SparseFlatSymmetricTensor

__all__ = [
    "SymmetricTensor",
    "DecompSymmetricTensor",
    "DenseSymmetricTensor",
    "FlatSymmetricTensor",
    "FlatSymmetricTensorSlice",
    "PermClsSymmetricTensor",
    "SparseFlatSymmetricTensor",
]
