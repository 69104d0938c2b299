from . import moments, polynomial

__all__ = ["moments", "polynomial"]
