from .loader import NoneDict, dict_to_nonedict, load_json

__all__ = ["NoneDict", "dict_to_nonedict", "load_json"]
