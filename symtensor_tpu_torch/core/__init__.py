from .base import SymmetricTensor
from .dense import DenseSymmetricTensor
from .flat import FlatSymmetricTensor, FlatSymmetricTensorSlice
from .permcls import PermClsSymmetricTensor

__all__ = [
    "SymmetricTensor",
    "DenseSymmetricTensor",
    "FlatSymmetricTensor",
    "FlatSymmetricTensorSlice",
    "PermClsSymmetricTensor",
]
