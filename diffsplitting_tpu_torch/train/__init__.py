from .trainer import DiffusionModel

__all__ = ["DiffusionModel"]
