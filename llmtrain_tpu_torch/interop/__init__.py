"""Weight carry-over from the JAX package's checkpoints."""

from .flax_params import flax_gpt_params_to_state_dict

__all__ = ["flax_gpt_params_to_state_dict"]
