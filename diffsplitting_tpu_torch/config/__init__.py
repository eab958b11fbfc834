from .loader import (NoneDict, apply_debug_overrides, dict2str, dict_to_nonedict, load_json,
                     parse, parse_config)

__all__ = ["NoneDict", "apply_debug_overrides", "dict2str", "dict_to_nonedict", "load_json",
           "parse", "parse_config"]
