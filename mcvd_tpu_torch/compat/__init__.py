from .bridge import load_flax_params, torch_state_dict_from_flax

__all__ = ["load_flax_params", "torch_state_dict_from_flax"]
