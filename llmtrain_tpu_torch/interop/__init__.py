"""Weight carry-over between the JAX package's param trees and the port
(flax_params.py), and the layouts that ``export-checkpoint`` and
``import-checkpoint`` read and write: the reference torch GPT's
(torch_interop.py) and HF Llama's (llama_hf.py)."""

from .flax_params import (
    flax_gpt_params_to_state_dict,
    flax_params_to_state_dict,
    is_lora_tree,
    state_dict_to_flax_gpt_params,
    state_dict_to_flax_params,
)
from .llama_hf import (
    is_llama_tree,
    llama_params_from_hf_state_dict,
    llama_params_to_hf_state_dict,
)
from .torch_interop import params_from_torch_state_dict, params_to_torch_state_dict

__all__ = [
    "flax_gpt_params_to_state_dict",
    "flax_params_to_state_dict",
    "is_llama_tree",
    "is_lora_tree",
    "llama_params_from_hf_state_dict",
    "llama_params_to_hf_state_dict",
    "params_from_torch_state_dict",
    "params_to_torch_state_dict",
    "state_dict_to_flax_gpt_params",
    "state_dict_to_flax_params",
]
