"""Weight carry-over between the JAX package's param trees and the port
(flax_params.py), and the reference torch GPT layout that
``export-checkpoint``/``import-checkpoint`` read and write
(torch_interop.py)."""

from .flax_params import (
    flax_gpt_params_to_state_dict,
    flax_params_to_state_dict,
    state_dict_to_flax_gpt_params,
    state_dict_to_flax_params,
)
from .torch_interop import params_from_torch_state_dict, params_to_torch_state_dict

__all__ = [
    "flax_gpt_params_to_state_dict",
    "flax_params_to_state_dict",
    "params_from_torch_state_dict",
    "params_to_torch_state_dict",
    "state_dict_to_flax_gpt_params",
    "state_dict_to_flax_params",
]
