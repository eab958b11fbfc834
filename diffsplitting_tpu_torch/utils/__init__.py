from .experiment import get_model_name, get_new_model_version, get_workdir
from .logging_utils import mkdirs, setup_logger
from .weights import load_reference_checkpoint, state_dict_from_jax

__all__ = ["get_model_name", "get_new_model_version", "get_workdir",
           "load_reference_checkpoint", "mkdirs", "setup_logger", "state_dict_from_jax"]
