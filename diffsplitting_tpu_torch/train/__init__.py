from .trainer import DiffusionModel, create_model

__all__ = ["DiffusionModel", "create_model"]
