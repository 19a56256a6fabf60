"""Weight carry-over between the JAX package's param tree and the port."""

from .flax_params import flax_gpt_params_to_state_dict, state_dict_to_flax_gpt_params

__all__ = ["flax_gpt_params_to_state_dict", "state_dict_to_flax_gpt_params"]
