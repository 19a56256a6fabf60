"""Weight carry-over between the JAX package's param trees and the port
(flax_params.py), and the layouts that ``export-checkpoint`` and
``import-checkpoint`` read and write: the reference torch GPT's
(torch_interop.py) and HF Llama's (llama_hf.py); pipeline_convert.py
maps a ``gpt_pipeline`` tree to the ``gpt`` tree and back."""

from .flax_params import (
    flax_gpt_params_to_state_dict,
    flax_params_to_state_dict,
    is_lora_tree,
    state_dict_to_flax_gpt_params,
    state_dict_to_flax_params,
)
from .pipeline_convert import gpt_params_to_pipeline, is_pipeline_tree, pipeline_params_to_gpt
from .llama_hf import (
    is_llama_tree,
    llama_params_from_hf_state_dict,
    llama_params_to_hf_state_dict,
)
from .torch_interop import params_from_torch_state_dict, params_to_torch_state_dict

__all__ = [
    "flax_gpt_params_to_state_dict",
    "flax_params_to_state_dict",
    "gpt_params_to_pipeline",
    "is_llama_tree",
    "is_lora_tree",
    "is_pipeline_tree",
    "llama_params_from_hf_state_dict",
    "llama_params_to_hf_state_dict",
    "params_from_torch_state_dict",
    "pipeline_params_to_gpt",
    "params_to_torch_state_dict",
    "state_dict_to_flax_gpt_params",
    "state_dict_to_flax_params",
]
