from .api_suite import SymTensorSuite
from .utils import does_not_warn, random_symmetric

__all__ = ["SymTensorSuite", "does_not_warn", "random_symmetric"]
