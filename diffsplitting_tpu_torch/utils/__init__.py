from .weights import load_reference_checkpoint, state_dict_from_jax

__all__ = ["load_reference_checkpoint", "state_dict_from_jax"]
