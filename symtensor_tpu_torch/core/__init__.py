from .base import SymmetricTensor
from .flat import FlatSymmetricTensor

__all__ = ["SymmetricTensor", "FlatSymmetricTensor"]
