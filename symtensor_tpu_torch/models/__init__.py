from . import moments

__all__ = ["moments"]
